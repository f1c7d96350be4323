"""Block LDL^T factorization with min-fill pivot ordering.

Accelerator-native re-design of ``src/epsilon/vector/block_cholesky.{h,cc}``: the
symbolic analysis (greedy min-fill ordering using the structured-operator
nonzero cost model, ``block_cholesky.cc:11-64``) and the numeric elimination
(Schur complement ``A <- A - V D^{-1} V^T``, ``:119-133``) both run eagerly on
the host at solver-init time, because problem data is concrete there.  What
remains for the hot loop is ``solve(b)``: forward substitution, block-diagonal
solve, back substitution (``:86-136``) — a chain of structured matvecs over
cached factors that traces into a single fused XLA computation.

Used by the ZERO / AFFINE / SUM_SQUARE prox operators and by the two-block
ADMM consensus projection (``zero.cc:14-30``, ``prox_admm_two_block.cc:52-77``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .block import BlockMatrix, BlockVector
from .linop import LinOp

__all__ = ["BlockCholesky"]


class BlockCholesky:
    """Factor a symmetric quasi-definite BlockMatrix; solve many times."""

    def __init__(self, A: BlockMatrix):
        self.A = A
        self._factorized = False
        # Elimination data: per-pivot (key, D_inv LinOp, {row_key: L block})
        self._steps: List[Tuple[str, LinOp, Dict[str, LinOp]]] = []
        self._dims: Dict[str, int] = {}

    # -- symbolic + numeric factorization (host, eager) --------------------
    def factor(self) -> "BlockCholesky":
        # Work on a mutable copy of the block structure.
        blocks: Dict[Tuple[str, str], LinOp] = dict(self.A.blocks)
        keys = sorted({r for r, _ in blocks} | {c for _, c in blocks})
        for k in keys:
            self._dims[k] = _dim_of(blocks, k)

        remaining = set(keys)
        # Whole-ordering pass in native code when available: the Python
        # per-step heuristic is O(pivots * col^2) interpreter loops, which
        # dominates solver build on many-block systems (>=50 blocks).
        order = self._native_order(blocks, keys)
        while remaining:
            pivot = None
            if order is not None:
                while order and order[0] not in remaining:
                    order.pop(0)
                # the native order predicts fill structurally; if its next
                # pivot has no concrete diagonal block yet, defer to the
                # per-step heuristic for this step
                if order and (order[0], order[0]) in blocks:
                    pivot = order.pop(0)
            if pivot is None:
                pivot = self._min_fill_pivot(blocks, remaining)
            D = blocks.get((pivot, pivot))
            if D is None:
                raise ValueError(
                    f"BlockCholesky: zero diagonal block at {pivot!r}; "
                    "system is not factorizable in this ordering")
            D_inv = D.inverse()

            # Off-diagonal column under the pivot: rows i != pivot with A[i,p]
            col = {r: op for (r, c), op in blocks.items()
                   if c == pivot and r != pivot and r in remaining}

            # L[i,p] = A[i,p] D^{-1}
            L = {r: op @ D_inv for r, op in col.items()}

            # Schur complement update: A[i,j] -= A[i,p] D^{-1} A[p,j]
            for i, Aip in col.items():
                for (r, j), Apj in list(blocks.items()):
                    if r != pivot or j == pivot or j not in remaining:
                        continue
                    update = (L[i] @ Apj).scale(-1.0)
                    key = (i, j)
                    if key in blocks:
                        blocks[key] = blocks[key] + update
                    else:
                        blocks[key] = update

            # Remove pivot row/col from the active system.
            for key in [k for k in blocks if pivot in k]:
                del blocks[key]
            remaining.discard(pivot)
            self._steps.append((pivot, D_inv, L))

        self._factorized = True
        return self

    def _native_order(self, blocks, keys) -> Optional[List[str]]:
        """Compute the full elimination order with the C++ min-fill kernel
        (``native/ordering.cc`` ≙ ``block_cholesky.cc:11-64``); None when the
        native library is absent or the system is trivially small."""
        if len(keys) < 3:
            return None
        from .. import native
        if not native.available():
            return None
        idx = {k: i for i, k in enumerate(keys)}
        n = len(keys)
        nnz = np.zeros((n, n), dtype=np.int64)
        for (r, c), op in blocks.items():
            nnz[idx[r], idx[c]] = max(1, op.nnz())
        dims = np.asarray([self._dims[k] for k in keys], dtype=np.int64)
        order = native.min_fill_order(nnz, dims)
        if order is None:
            return None
        return [keys[i] for i in order]

    def _min_fill_pivot(self, blocks, remaining) -> str:
        """Greedy min-fill: pick the pivot whose elimination creates the
        least predicted fill, using the nnz cost model
        (``block_cholesky.cc:11-64``, ``linear_map.cc:141-164``)."""
        best, best_cost = None, None
        for p in sorted(remaining):
            if (p, p) not in blocks:
                continue
            col = [(r, op) for (r, c), op in blocks.items()
                   if c == p and r != p and r in remaining]
            # fill cost ~ sum over pairs (i,j) of nnz(A[i,p]) * nnz(A[p,j]) / dim
            cost = 0
            for i, Aip in col:
                for j, Apj in col:
                    cost += Aip.nnz() * Apj.nnz() // max(1, self._dims[p])
            if best_cost is None or cost < best_cost:
                best, best_cost = p, cost
        if best is None:
            # no diagonal block available; fall back to any remaining key
            raise ValueError(
                f"BlockCholesky: no pivot with diagonal block among {sorted(remaining)}")
        return best

    def factor_nnz(self) -> int:
        """Cost-model size of the stored factor (per-solve traffic): nnz of
        every D^{-1} and L block the substitution chain touches."""
        total = 0
        for _pivot, D_inv, L in self._steps:
            total += D_inv.nnz()
            for op in L.values():
                total += op.nnz()
        return total

    def solve_mat(self, B: Dict[str, "object"]) -> Dict[str, "object"]:
        """:meth:`solve` for matrix right-hand sides: ``B`` maps row key ->
        ``(dim_key, R)`` arrays.  Used to collapse the factored system into
        an explicit solve operator (basis solves)."""
        if not self._factorized:
            raise RuntimeError("call factor() before solve_mat()")
        import jax.numpy as jnp
        from .. import config
        R = next(iter(B.values())).shape[1]
        dtype = config.default_dtype()

        y: Dict[str, "object"] = {}
        work = dict(B)
        for pivot, D_inv, L in self._steps:
            yp = work.get(pivot)
            if yp is None:
                yp = jnp.zeros((self._dims[pivot], R), dtype=dtype)
            y[pivot] = yp
            for i, Lip in L.items():
                upd = Lip.matmat(yp)
                work[i] = work[i] - upd if i in work else -upd

        z = {p: D_inv.matmat(y[p]) for p, D_inv, _ in self._steps}

        x: Dict[str, "object"] = {}
        for pivot, D_inv, L in reversed(self._steps):
            xp = z[pivot]
            for i, Lip in L.items():
                if i in x:
                    xp = xp - Lip.T.matmat(x[i])
            x[pivot] = xp
        return x

    # -- solve (JAX-traceable) ---------------------------------------------
    def solve(self, b: BlockVector) -> BlockVector:
        if not self._factorized:
            raise RuntimeError("call factor() before solve()")

        # Forward substitution: y_p = b_p - sum_i L[i,p]^T ... actually
        # eliminate in pivot order: y = L^{-1} b with unit block lower L
        # (L[i,p] stored for rows i eliminated after p).
        y: Dict[str, "jnp.ndarray"] = {}
        work = dict(b.data)
        for pivot, D_inv, L in self._steps:
            yp = work.get(pivot)
            if yp is None:
                import jax.numpy as jnp
                from .. import config
                yp = jnp.zeros(self._dims[pivot], dtype=config.default_dtype())
            y[pivot] = yp
            for i, Lip in L.items():
                upd = Lip.matvec(yp)
                work[i] = work[i] - upd if i in work else -upd

        # Diagonal solve: z_p = D_p^{-1} y_p
        z = {p: D_inv.matvec(y[p]) for p, D_inv, _ in self._steps}

        # Back substitution: x_p = z_p - sum_i L[i,p]^T x_i, reverse order.
        x: Dict[str, "jnp.ndarray"] = {}
        for pivot, D_inv, L in reversed(self._steps):
            xp = z[pivot]
            for i, Lip in L.items():
                if i in x:
                    xp = xp - Lip.T.matvec(x[i])
            x[pivot] = xp

        return BlockVector(x)


def _dim_of(blocks, key: str) -> int:
    for (r, c), op in blocks.items():
        if r == key:
            return op.m
        if c == key:
            return op.n
    raise KeyError(key)
