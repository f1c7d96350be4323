"""Generalized prox operators over block affine structure.

The generalized problem every operator solves (``prox/prox.cc:1-12``):

    Apply(v)  =  argmin_x  alpha * f(H(x))  +  1/2 ||A(x) - v||^2

where ``H`` (the function's affine argument) and ``A`` (the scaled constraint
columns) are block linear operators.  Three operator families, mirroring the
reference:

- :class:`VectorProxOperator` — reduces to the canonical kernel when H^T H
  and H A^T A H^T are scalar/diagonal (``vector_prox.cc:51-116``), with the
  pre/post transforms v' = B v + g, x = C (y - g) + D v.
- KKT operators (:class:`ZeroProxOperator`, :class:`AffineProxOperator`,
  :class:`SumSquareProxOperator`) — cached block-Cholesky solves
  (``zero.cc``, ``affine.cc``, ``sum_square.cc``).
- :class:`SecondOrderConeProxOperator` — row-wise SOC projection with
  scalar scalings (``second_order_cone.cc``).

All ``apply`` methods are JAX-traceable; all structure analysis and
factorization happens eagerly at construction.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ... import config
from ...ir import AffineOperator, ProxFunctionSpec, ProxKind, arg_key
from .. import linop
from ..block import BlockMatrix, BlockVector
from ..cholesky import BlockCholesky
from . import vector as veckernels
from .registry import KernelEntry, epigraph_via_bisection, get_kernel


class ProxOperator:
    """Base class (``prox.h:37-49``)."""

    def apply(self, v: BlockVector) -> BlockVector:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# structure probes
# ---------------------------------------------------------------------------

def _block_scalar(M: BlockMatrix) -> Optional[float]:
    """If M is alpha*I on every diagonal block (no off-diagonal blocks),
    return alpha (``vector_prox.cc:GetScalar``)."""
    alpha = None
    for (r, c), op in M.blocks.items():
        if r != c:
            return None
        sv = op.scalar_value()
        if sv is None:
            return None
        if alpha is None:
            alpha = sv
        elif not np.isclose(alpha, sv):
            return None
    return alpha


def _block_diagonal(M: BlockMatrix) -> Optional[np.ndarray]:
    """If M is diag(d) with the same d on every diagonal block, return d
    (``vector_prox.cc:GetDiagonal``)."""
    d = None
    for (r, c), op in M.blocks.items():
        if r != c:
            return None
        dv = op.diag_value()
        if dv is None:
            return None
        if d is None:
            d = dv
        elif d.shape != dv.shape or not np.allclose(d, dv):
            return None
    return d


# ---------------------------------------------------------------------------
# VectorProxOperator
# ---------------------------------------------------------------------------

class VectorProxOperator(ProxOperator):
    """Canonical-kernel wrapper with scalar/diagonal reduction."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        self.spec = spec
        self.entry: KernelEntry = get_kernel(spec.kind)
        H, A = affine_arg.A, affine_constraint.A
        self.g = affine_arg.b
        HT, AT = H.T, A.T

        self.elementwise = False
        self.D: Optional[BlockMatrix] = None

        beta_s = _block_scalar(HT @ H)
        gamma_s = _block_scalar(H @ AT @ A @ HT)
        if beta_s is not None and gamma_s is not None:
            # scalar reduction (vector_prox.cc:51-70)
            self.B = (H @ AT).scale(beta_s / gamma_s)
            self.C = HT.scale(1.0 / beta_s)
            self.lam = spec.alpha * beta_s * beta_s / gamma_s
        else:
            beta = _block_diagonal(HT @ H)
            gamma = _block_diagonal(H @ AT @ A @ HT)
            if beta is None or gamma is None:
                raise ValueError(
                    f"affine structure not scalar/diagonal for {spec.kind}")
            if not self.entry.elementwise:
                raise ValueError(
                    f"{spec.kind} requires scalar affine scaling")
            # diagonal reduction w/ zero handling (vector_prox.cc:72-116)
            lam = np.zeros_like(beta)
            delta = np.zeros_like(beta)
            nz = gamma != 0
            lam[nz] = spec.alpha * beta[nz] ** 2 / gamma[nz]
            beta = np.where(nz, beta, 1.0)
            gamma = np.where(nz, gamma, 1.0)
            delta[~nz] = 1.0
            B0 = BlockMatrix({(k, k): linop.diagonal(beta / gamma)
                              for k in H.col_keys()})
            C0 = BlockMatrix({(k, k): linop.diagonal(1.0 / beta)
                              for k in H.col_keys()})
            D0 = BlockMatrix({(k, k): linop.diagonal(delta)
                              for k in H.col_keys()})
            self.B = H @ B0 @ AT
            self.C = C0 @ HT
            self.D = (AT @ A).inverse() @ D0 @ AT
            self.lam = lam
            self.elementwise = True

        if spec.epigraph and self.elementwise:
            raise ValueError("epigraph projection requires isotropic metric "
                             "(scalar affine scaling)")

        # argument bookkeeping
        self.n_args = len(spec.arg_sizes) if spec.arg_sizes else 1
        self.arg_dims = [int(np.prod(s)) if s else 1 for s in (spec.arg_sizes or [None])]
        if not spec.arg_sizes:
            # infer from H row dims
            self.arg_dims = [affine_arg.A.row_dim(arg_key(0))]

    # -- kernel invocation -------------------------------------------------
    def _params(self) -> Dict:
        p = dict(self.spec.scaled_zone_params or {})
        if self.spec.k is not None:
            p["k"] = self.spec.k
        return p

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        """Apply at a traced penalty rho:  argmin alpha f(H x + g)
        + rho/2 ||x - v||^2.  Only valid when the operator was built with
        A = I (unit constraint metric): then B/C/D are rho-independent and
        the penalty enters solely through lam -> lam/rho (epigraph
        projections are rho-invariant).  This is what makes residual-
        balancing adaptive rho free of refactorizations."""
        return self.apply(v, rho=rho)

    def _kernel_args(self, u: BlockVector):
        dtype = config.default_dtype()
        vals = []
        for i in range(self.n_args):
            key = arg_key(i)
            dim = self.arg_dims[i]
            if key in u:
                vals.append(u[key])
            else:
                vals.append(jnp.zeros(dim, dtype=dtype))
        return vals

    def _apply_kernel(self, vals: List[jnp.ndarray], rho=None):
        spec, entry, p = self.spec, self.entry, self._params()
        lam = self.lam if rho is None else self.lam / rho

        if spec.epigraph:
            epi = entry.epi or epigraph_via_bisection(spec.kind)
            if entry.matrix:
                s = vals[-1][0]
                m, n = spec.arg_sizes[0]
                V = linop.jmat(vals[0], (m, n))
                X, t = epi(V, s, **p)
                return [linop.jvec(X), jnp.reshape(t, (1,))]
            if entry.nargs == 2:
                s = vals[-1][0]
                x, y, t = epi((vals[0], vals[1]), s, **p)
                return [x, y, jnp.reshape(t, (1,))]
            if spec.axis is not None:
                # per-slice epigraph projection: vmap the (vector, scalar)
                # kernel over rows/cols (vector_prox.cc:147-183 axis mode)
                m, n = spec.arg_sizes[0]
                V = linop.jmat(vals[0], (m, n))
                s = vals[-1]
                kern = lambda v, si: epi(v, si, **p)
                if spec.axis == 0:
                    X, t = jax.vmap(kern, in_axes=(1, 0), out_axes=(1, 0))(V, s)
                else:
                    X, t = jax.vmap(kern, in_axes=(0, 0), out_axes=(0, 0))(V, s)
                return [linop.jvec(X), t]
            if entry.elementwise_epi:
                # per-coordinate epigraph (EXP, exp.cc:12-77): t is the
                # same size as x, no scalar reduction
                x, t = epi(vals[0], vals[-1], **p)
                return [x, t]
            s = vals[-1][0]
            x, t = epi(vals[0], s, **p)
            return [x, jnp.reshape(t, (1,))]

        if entry.matrix:
            m, n = spec.arg_sizes[0]
            V = linop.jmat(vals[0], (m, n))
            X = entry.prox(V, lam, **p)
            return [linop.jvec(X)]
        if entry.nargs == 2:
            x, y = entry.prox((vals[0], vals[1]), lam, **p)
            return [x, y]
        if spec.axis is not None and entry.elementwise:
            # separable kernel: prox of a per-slice sum == prox of the flat
            # sum — skip the pointless vmap (epigraph mode above still
            # projects per slice, where axis DOES change the set)
            return [entry.prox(vals[0], lam, **p)]
        if spec.axis is not None:
            # axis-mode batching: vmap the vector kernel over rows/cols of
            # mat(v) (replaces the serial loop vector_prox.cc:147-183)
            m, n = spec.arg_sizes[0]
            V = linop.jmat(vals[0], (m, n))
            # axis = reduction axis: axis=0 -> kernel along columns
            kern = lambda col: entry.prox(col, lam, **p)
            if self.spec.axis == 0:
                X = jax.vmap(kern, in_axes=1, out_axes=1)(V)
            else:
                X = jax.vmap(kern, in_axes=0, out_axes=0)(V)
            return [linop.jvec(X)]
        return [entry.prox(vals[0], lam, **p)]

    def apply(self, v: BlockVector, rho=None) -> BlockVector:
        g = self.g.to_device()
        u = self.B.apply(v) + g
        vals = self._kernel_args(u)
        outs = self._apply_kernel(vals, rho=rho)
        y = BlockVector({arg_key(i): outs[i] for i in range(len(outs))})
        x = self.C.apply(y - g)
        if self.D is not None:
            x = x + self.D.apply(v)
        return x

    # -- warm-startable (stateful) kernels ---------------------------------
    def kernel_state_init(self):
        """Cold state for kernels that warm-start across ADMM sweeps
        (TV-1D: the PDAS dual), or None when this operator's mode cannot
        thread state (epigraph / diagonal metric / axis batching / multi-
        arg use the stateless kernel)."""
        if (self.entry.stateful_prox is None or self.spec.epigraph
                or self.elementwise or self.spec.axis is not None
                or self.n_args != 1):
            return None
        return self.entry.state_init(self.arg_dims[0],
                                     config.default_dtype())

    def apply_stateful(self, v: BlockVector, kstate, rho=None):
        """Like :meth:`apply` but threading the kernel's warm state;
        returns ``(x, new_state)``.  Only valid when
        :meth:`kernel_state_init` returned non-None."""
        g = self.g.to_device()
        u = self.B.apply(v) + g
        vals = self._kernel_args(u)
        lam = self.lam if rho is None else self.lam / rho
        x_k, st = self.entry.stateful_prox(vals[0], lam, kstate,
                                           **self._params())
        y = BlockVector({arg_key(0): x_k})
        x = self.C.apply(y - g)
        if self.D is not None:
            x = x + self.D.apply(v)
        return x, st

    def feval(self, u: BlockVector):
        vals = self._kernel_args(u)
        p = self._params()
        if self.entry.nargs == 2:
            return self.entry.feval((vals[0], vals[1]), **p)
        if self.entry.matrix:
            m, n = self.spec.arg_sizes[0]
            return self.entry.feval(linop.jmat(vals[0], (m, n)), **p)
        return self.entry.feval(vals[0], **p)


# ---------------------------------------------------------------------------
# KKT-based operators
# ---------------------------------------------------------------------------

import os as _os

_COLLAPSE_MAX_ENTRIES = float(_os.environ.get(
    "EPSILON_TPU_COLLAPSE_MAX_ENTRIES", "1.6e7"))


class _CollapsedKKT:
    """Explicit solve operator ``x = S v + c`` folded out of a factored
    KKT system by basis solves.  The reference applies its cached LDL^T by
    block substitution every iteration (``block_cholesky.cc:86-137``); on
    a device that chain is a dozen small kernel launches and re-reads every
    factor block from HBM, while the folded form — when it is SMALLER than
    the factor (``factor_nnz`` cost model) — is ONE matmul per apply."""

    def __init__(self, chol, rhs0, out_dims: Dict[str, int],
                 in_dims: Dict[str, int]):
        import numpy as np
        dtype = config.default_np_dtype()
        self.in_keys = sorted(in_dims)
        self.out_keys = sorted(out_dims)
        self.in_dims = dict(in_dims)
        self.out_dims = dict(out_dims)
        n_in = sum(in_dims.values())
        basis = {}
        off = 0
        for k in self.in_keys:
            nk = in_dims[k]
            E = np.zeros((nk, n_in), dtype=dtype)
            E[:, off:off + nk] = np.eye(nk, dtype=dtype)
            basis[k] = jnp.asarray(E)
            off += nk
        sol = chol.solve_mat(basis)
        self.S = jnp.concatenate([sol[k][:, :] for k in self.out_keys],
                                 axis=0)
        csol = chol.solve(rhs0.to_device())
        zero = jnp.zeros((), self.S.dtype)
        self.c = jnp.concatenate([
            jnp.broadcast_to(csol[k] if k in csol else zero,
                             (out_dims[k],)).astype(self.S.dtype)
            for k in self.out_keys])
        self._offs = {}
        off = 0
        for k in self.out_keys:
            self._offs[k] = off
            off += out_dims[k]

    @staticmethod
    def viable(chol, out_dims, in_dims) -> bool:
        entries = float(sum(in_dims.values())) * sum(out_dims.values())
        return (entries <= _COLLAPSE_MAX_ENTRIES
                and entries < chol.factor_nnz())

    def apply(self, v: BlockVector) -> BlockVector:
        from ..linop import _to_device
        flat = jnp.concatenate([v.get(k, self.in_dims[k])
                                for k in self.in_keys])
        y = _to_device(self.S) @ flat + _to_device(self.c)
        return BlockVector({k: y[self._offs[k]:self._offs[k]
                                 + self.out_dims[k]]
                            for k in self.out_keys})


def _maybe_collapse(chol, rhs0, A: BlockMatrix, var_keys, var_dims_of):
    """Build the collapsed solve operator when it beats the factor chain;
    ``A`` supplies the input (metric-row) key space, ``var_keys`` the
    output selection."""
    in_dims = {r: A.row_dim(r) for r in A.row_keys()}
    out_dims = {k: var_dims_of(k) for k in var_keys}
    if not in_dims or not out_dims:
        return None
    if not _CollapsedKKT.viable(chol, out_dims, in_dims):
        return None
    return _CollapsedKKT(chol, rhs0, out_dims, in_dims)


def _kkt_blocks(*mats: BlockMatrix) -> Dict:
    out = BlockMatrix()
    for M in mats:
        for (r, c), op in M.blocks.items():
            out.insert(r, c, op)
    return out


def _metric_change_of_vars(A: BlockMatrix, *others: BlockMatrix):
    """De-collide (k, k)-keyed per-variable metrics in the assembled KKT.

    The solvers pass the prox metric as ``A = w_k * I`` keyed ``(k, k)``
    per variable ``k``; ``_kkt_blocks`` then merges A, A', and the -I slack
    into ONE slot (``BlockMatrix.insert`` adds on collision), and the
    merged system equals the true 3-block KKT of ``zero.cc:8-36`` iff
    every colliding weight is 1.  Rather than growing the factor with
    distinct slack rows (hot path: the two-block z-update), substitute
    ``x~_k = w_k x_k`` — an EXACT change of variables: the colliding
    metric becomes identity, every block column over ``k`` scales by
    ``1/w_k``, the rhs is unchanged (the solver convention already feeds
    ``v = A(point)``), and solutions de-scale by ``1/w_k``.

    Returns ``{k: 1/w_k}`` for the colliding non-unit scalar blocks
    (empty for the N-block usage, whose metric rows are constraint keys).
    Raises on a colliding non-scalar metric — silently skewed algebra is
    how this bug survived three rounds.
    """
    cols = {c for (_, c) in A.blocks}
    for M in others:
        cols |= {c for (_, c) in M.blocks}
    descale = {}
    for (r, c), op in A.blocks.items():
        if r == c and r in cols:
            w = op.scalar_value()
            if w is None:
                raise ValueError(
                    f"non-scalar prox metric collides with variable {r!r}: "
                    "the assembled KKT would merge A/A'/-I incorrectly")
            if w != 1.0:
                descale[c] = 1.0 / w
    return descale


def _scale_cols(M: BlockMatrix, descale: Dict) -> BlockMatrix:
    if not descale:
        return M
    return BlockMatrix({
        (r, c): (op.scale(descale[c]) if c in descale else op)
        for (r, c), op in M.blocks.items()})


def _descale_solution(x: BlockVector, descale: Dict) -> BlockVector:
    if not descale:
        return x
    return BlockVector({k: (descale[k] * v if k in descale else v)
                        for k, v in x.items()})


class ZeroProxOperator(ProxOperator):
    """Projection onto {H(x) + g = 0} in the metric ||A(x) - v||
    (``zero.cc:8-36``): solve
        [ 0   H'  A'][x]   [ 0]
        [ H   0   0 ][y] = [-g]
        [ A   0  -I ][z]   [ v]
    """

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        H, g = affine_arg.A, affine_arg.b
        A = affine_constraint.A
        self._descale = _metric_change_of_vars(A, H)
        H = _scale_cols(H, self._descale)
        A = _scale_cols(A, self._descale)
        M = _kkt_blocks(H, H.T, A, A.T,
                        A.left_identity().scale(-1.0))
        self.chol = BlockCholesky(M).factor()
        self.rhs0 = -1.0 * g
        self.var_keys = H.col_keys()
        self._collapsed = _maybe_collapse(
            self.chol, self.rhs0, A, self.var_keys,
            lambda k: self.chol._dims[k])

    def apply(self, v: BlockVector) -> BlockVector:
        if self._collapsed is not None:
            return _descale_solution(self._collapsed.apply(v), self._descale)
        x = self.chol.solve(self.rhs0.to_device() + v).select(self.var_keys)
        return _descale_solution(x, self._descale)


class AffineProxOperator(ProxOperator):
    """f(x) = c'x (+ const): solve [0 A'; A -I][x; z] = [-c; v - b]
    (``affine.cc:20-49``). The linear functional c comes from H's 1-row
    blocks scaled by alpha."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        A, b = affine_constraint.A, affine_constraint.b
        self._descale = _metric_change_of_vars(A)
        A = _scale_cols(A, self._descale)
        M = _kkt_blocks(A, A.T, A.left_identity().scale(-1.0))
        self.chol = BlockCholesky(M).factor()
        c = BlockVector()
        if spec.kind == ProxKind.AFFINE:
            for (r, ckey), op in affine_arg.A.blocks.items():
                dense = op.as_dense()
                assert dense.shape[0] == 1, "affine arg must be 1-row"
                # linear functional in the x~ = w x variables: c' D^-1 x~
                vec = dense[0] * spec.alpha * self._descale.get(ckey, 1.0)
                c[ckey] = c[ckey] + vec if ckey in c else vec
        self.rhs0 = -1.0 * b - c
        self.var_keys = A.col_keys()
        self._collapsed = _maybe_collapse(
            self.chol, self.rhs0, A, self.var_keys,
            lambda k: self.chol._dims[k])

    def apply(self, v: BlockVector) -> BlockVector:
        if self._collapsed is not None:
            return _descale_solution(self._collapsed.apply(v), self._descale)
        x = self.chol.solve(self.rhs0.to_device() + v).select(self.var_keys)
        return _descale_solution(x, self._descale)


class SumSquareProxOperator(ProxOperator):
    """f = alpha*||H(x) + g||^2: solve
        [ 0    aH'  A'][x]   [  0 ]
        [ aH   -I   0 ][y] = [-ag ]
        [ A    0   -I ][z]   [  v ]
    with a = sqrt(2*alpha) (``sum_square.cc:9-44``)."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        H, g = affine_arg.A, affine_arg.b
        A = affine_constraint.A
        self._descale = _metric_change_of_vars(A, H)
        H = _scale_cols(H, self._descale)
        A = _scale_cols(A, self._descale)
        a = float(np.sqrt(2.0 * spec.alpha))
        Ha = BlockMatrix({k: op.scale(a) for k, op in H.blocks.items()})
        M = _kkt_blocks(Ha, Ha.T, A, A.T,
                        H.left_identity().scale(-1.0),
                        A.left_identity().scale(-1.0))
        self.chol = BlockCholesky(M).factor()
        self.rhs0 = (-a) * g
        self.var_keys = H.col_keys()
        self._collapsed = _maybe_collapse(
            self.chol, self.rhs0, A, self.var_keys,
            lambda k: self.chol._dims[k])

    def apply(self, v: BlockVector) -> BlockVector:
        if self._collapsed is not None:
            return _descale_solution(self._collapsed.apply(v), self._descale)
        x = self.chol.solve(self.rhs0.to_device() + v).select(self.var_keys)
        return _descale_solution(x, self._descale)


# ---------------------------------------------------------------------------
# Second-order cone
# ---------------------------------------------------------------------------

class SecondOrderConeProxOperator(ProxOperator):
    """Row-wise SOC projection ||ax*x_i + bx|| <= at*t_i + bt_i
    (``second_order_cone.cc:29-112``); arg0 = t (m,), arg1 = X (m, n)."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 affine_constraint: AffineOperator):
        assert len(spec.arg_sizes) == 2
        self.m, self.n = spec.arg_sizes[1]
        H, g = affine_arg.A, affine_arg.b
        A = affine_constraint.A
        # find var keys for t and x rows
        self.t_key = self.x_key = None
        at = ax = None
        for (r, c), op in H.blocks.items():
            if r == arg_key(0):
                self.t_key, at = c, op.scalar_value()
            elif r == arg_key(1):
                self.x_key, ax = c, op.scalar_value()
            else:
                raise ValueError(f"unexpected arg row {r}")
        if at is None or ax is None:
            raise ValueError("SOC scalings must be scalar")
        ATA = A.T @ A
        alphat = ATA[(self.t_key, self.t_key)].scalar_value()
        alphax = ATA[(self.x_key, self.x_key)].scalar_value()
        if alphat is None or alphax is None or not np.isclose(alphat, alphax):
            raise ValueError("A'A not scalar for SOC")
        self.AT = A.T.scale(1.0 / alphat)
        self.a = at / abs(ax)
        g_np = {k: np.asarray(val) for k, val in g.items()}
        bt = g_np.get(arg_key(0), np.zeros(self.m))
        bx = g_np.get(arg_key(1), np.zeros(self.m * self.n))
        self._bt_host = np.asarray(bt, dtype=np.float64) / abs(ax)
        self._bx_host = np.asarray(bx, dtype=np.float64) / ax

    def apply(self, v: BlockVector) -> BlockVector:
        from ..linop import _to_device
        dtype = config.default_dtype()
        bt = _to_device(self._bt_host).astype(dtype)
        bx = _to_device(self._bx_host).astype(dtype)
        u = self.AT.apply(v)
        X = linop.jmat(u[self.x_key] + bx, (self.m, self.n))
        t = u[self.t_key] + bt / self.a
        Xp, tp = veckernels.project_soc_rows(X, t, self.a)
        out = BlockVector()
        out[self.x_key] = linop.jvec(Xp) - bx
        out[self.t_key] = tp - bt / self.a
        return out


# ---------------------------------------------------------------------------
# rho-parameterized operators (adaptive-rho two-block ADMM)
# ---------------------------------------------------------------------------
#
# These solve  argmin_x alpha*f(H x + g) + rho/2 ||x - v||^2  with rho a
# *traced* scalar, so residual-balancing adaptive rho (Boyd et al. 3.4.1)
# costs no refactorization.  The reference cannot do this at all: its
# factorizations bake sqrt(rho) into the KKT systems (prox_admm.cc:51
# hard-requires rho == 1).  The device-side trick is the same one the
# consensus solver uses: projections are rho-invariant, canonical kernels
# take lam/rho, and quadratics apply through a cached eigendecomposition
# (Q diag(1/(w+rho)) Q') instead of a Cholesky factor.


class RhoProjectionOperator(ProxOperator):
    """Wrapper for rho-invariant operators (indicators / projections:
    ZERO, SOC, every epigraph): apply_rho ignores rho."""

    def __init__(self, inner: ProxOperator):
        self.inner = inner

    def apply(self, v: BlockVector) -> BlockVector:
        return self.inner.apply(v)

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        return self.inner.apply(v)


class RhoAffineProxOperator(ProxOperator):
    """f(x) = alpha*c'x (+ const) at penalty rho:  x = v - c/rho
    (closed form of ``affine.cc:20-49`` in the unit metric)."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 var_dims: Dict[str, int]):
        self.var_dims = dict(var_dims)
        c: Dict[str, np.ndarray] = {}
        if spec.kind == ProxKind.AFFINE:
            for (r, ckey), op in affine_arg.A.blocks.items():
                dense = op.as_dense()
                assert dense.shape[0] == 1, "affine arg must be 1-row"
                vec = dense[0] * spec.alpha
                c[ckey] = c[ckey] + vec if ckey in c else vec
        self._c_host = {k: np.asarray(v, dtype=np.float64)
                        for k, v in c.items()}

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        from ..linop import _to_device
        dtype = config.default_dtype()
        out = {}
        for k, n in self.var_dims.items():
            vk = v.get(k, n)
            if k in self._c_host:
                ck = _to_device(self._c_host[k]).astype(dtype)
                vk = vk - ck / rho
            out[k] = vk
        return BlockVector(out)

    def apply(self, v: BlockVector) -> BlockVector:
        return self.apply_rho(v, 1.0)


class RhoSumSquareProxOperator(ProxOperator):
    """f = alpha*||H x + g||^2 at penalty rho:
        x = Q diag(1/(w + rho)) Q' (rho v - 2 alpha H'g),
    where Q w Q' = eigh(2 alpha H'H), cached once at init — the
    eigendecomposition analogue of the reference's cached Cholesky
    (``sum_square.cc:12-31``) that stays valid for every rho."""

    def __init__(self, spec: ProxFunctionSpec, affine_arg: AffineOperator,
                 var_dims: Dict[str, int]):
        H, g = affine_arg.A, affine_arg.b
        self.col_keys = sorted(var_dims)
        self.var_dims = dict(var_dims)
        # dense H with rows/cols in sorted-key order (cols may include
        # variables H never touches; pad with zero columns)
        rows = H.row_keys()
        m = sum(H.row_dim(r) for r in rows)
        n = sum(var_dims[k] for k in self.col_keys)
        Hd = np.zeros((m, n))
        roff = {}
        acc = 0
        for r in rows:
            roff[r] = acc
            acc += H.row_dim(r)
        coff = {}
        acc = 0
        for k in self.col_keys:
            coff[k] = acc
            acc += var_dims[k]
        for (r, c), op in H.blocks.items():
            Hd[roff[r]:roff[r] + op.m, coff[c]:coff[c] + op.n] = op.as_dense()
        g_flat = np.zeros(m)
        for r, val in g.items():
            g_flat[roff[r]:roff[r] + len(np.asarray(val))] = np.asarray(val)
        G = 2.0 * spec.alpha * (Hd.T @ Hd)
        w, Q = np.linalg.eigh(G)
        self._w_host = np.maximum(w, 0.0)  # G is PSD; clip eigh noise
        self._Q_host = Q
        self._r0_host = -2.0 * spec.alpha * (Hd.T @ g_flat)
        self._coff = coff

    def apply_rho(self, v: BlockVector, rho) -> BlockVector:
        from ..linop import _to_device
        dtype = config.default_dtype()
        Q = _to_device(self._Q_host).astype(dtype)
        w = _to_device(self._w_host).astype(dtype)
        r0 = _to_device(self._r0_host).astype(dtype)
        parts = [v.get(k, self.var_dims[k]) for k in self.col_keys]
        flat = jnp.concatenate(parts) if parts else jnp.zeros(0, dtype=dtype)
        t = rho * flat + r0
        x = Q @ ((Q.T @ t) / (w + rho))
        return BlockVector({k: x[self._coff[k]:self._coff[k] + self.var_dims[k]]
                            for k in self.col_keys})

    def apply(self, v: BlockVector) -> BlockVector:
        return self.apply_rho(v, 1.0)


def create_rho_prox_operator(spec: ProxFunctionSpec,
                             affine_arg: AffineOperator,
                             var_dims: Dict[str, int]) -> ProxOperator:
    """Factory for rho-parameterized operators in the unit constraint
    metric (A = I over ``var_dims``); every returned operator supports
    ``apply_rho(v, rho)`` with traced rho."""
    kind = spec.kind
    eye = BlockMatrix({(k, k): linop.identity(n)
                       for k, n in var_dims.items()})
    unit = AffineOperator(eye, BlockVector())
    if kind == ProxKind.ZERO:
        return RhoProjectionOperator(ZeroProxOperator(spec, affine_arg, unit))
    if kind in (ProxKind.AFFINE, ProxKind.CONSTANT):
        return RhoAffineProxOperator(spec, affine_arg, var_dims)
    if kind == ProxKind.SUM_SQUARE and not spec.epigraph:
        return RhoSumSquareProxOperator(spec, affine_arg, var_dims)
    if kind == ProxKind.SECOND_ORDER_CONE:
        return RhoProjectionOperator(
            SecondOrderConeProxOperator(spec, affine_arg, unit))
    op = VectorProxOperator(spec, affine_arg, unit)
    if spec.epigraph:
        return RhoProjectionOperator(op)
    return op  # VectorProxOperator.apply_rho handles lam/rho


# ---------------------------------------------------------------------------
# factory (CreateProxOperator, prox.cc:29-45)
# ---------------------------------------------------------------------------

def create_prox_operator(spec: ProxFunctionSpec,
                         affine_arg: AffineOperator,
                         affine_constraint: AffineOperator) -> ProxOperator:
    kind = spec.kind
    if kind == ProxKind.ZERO:
        return ZeroProxOperator(spec, affine_arg, affine_constraint)
    if kind in (ProxKind.AFFINE, ProxKind.CONSTANT):
        return AffineProxOperator(spec, affine_arg, affine_constraint)
    if kind == ProxKind.SUM_SQUARE and not spec.epigraph:
        return SumSquareProxOperator(spec, affine_arg, affine_constraint)
    if kind == ProxKind.SECOND_ORDER_CONE:
        return SecondOrderConeProxOperator(spec, affine_arg, affine_constraint)
    return VectorProxOperator(spec, affine_arg, affine_constraint)
