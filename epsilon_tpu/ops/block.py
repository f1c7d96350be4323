"""Block vector/matrix substrate.

Accelerator-native re-design of ``src/epsilon/vector/block_vector.h:13-81`` and
``block_matrix.{h,cc}``: keyed collections of device arrays / structured
linear operators.  ``BlockVector`` is a JAX pytree (dict of jnp arrays), so
it flows through ``jit``/``lax.while_loop`` directly; ``BlockMatrix`` is a
host-side static structure whose ``apply`` is traceable.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import linop
from .linop import LinOp

__all__ = ["BlockVector", "BlockMatrix"]


@jax.tree_util.register_pytree_node_class
class BlockVector:
    """map<key, vector> with vector-space ops (``block_vector.h:13-81``)."""

    def __init__(self, data: Optional[Dict[str, jnp.ndarray]] = None):
        self.data: Dict[str, jnp.ndarray] = dict(data or {})

    # pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        keys = tuple(sorted(self.data))
        return tuple(self.data[k] for k in keys), keys

    @classmethod
    def tree_unflatten(cls, keys, children):
        return cls(dict(zip(keys, children)))

    # container ------------------------------------------------------------
    def keys(self):
        return self.data.keys()

    def items(self):
        return self.data.items()

    def __contains__(self, key):
        return key in self.data

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, value):
        self.data[key] = value

    def get(self, key, n: Optional[int] = None):
        """Get-or-zero semantics (``block_vector.h:49-55``)."""
        if key in self.data:
            return self.data[key]
        if n is None:
            raise KeyError(key)
        from .. import config
        return jnp.zeros(n, dtype=config.default_dtype())

    def select(self, keys: Iterable[str]) -> "BlockVector":
        return BlockVector({k: self.data[k] for k in keys if k in self.data})

    def to_device(self) -> "BlockVector":
        """Convert numpy leaves for traced use, participating in constant
        lifting (see linop._to_device)."""
        from . import linop
        return BlockVector({
            k: (linop._to_device(v) if isinstance(v, np.ndarray) else v)
            for k, v in self.data.items()})

    # algebra --------------------------------------------------------------
    def _binary(self, other: "BlockVector", f):
        out = dict(self.data)
        for k, v in other.data.items():
            out[k] = f(out[k], v) if k in out else f(jnp.zeros_like(v), v)
        return BlockVector(out)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __mul__(self, alpha):
        return BlockVector({k: alpha * v for k, v in self.data.items()})

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1.0

    def dot(self, other: "BlockVector"):
        terms = [jnp.vdot(v, other.data[k]) for k, v in self.data.items()
                 if k in other.data]
        if not terms:
            return jnp.asarray(0.0)
        return sum(terms)

    def norm(self):
        return jnp.sqrt(self.norm_squared())

    def norm_squared(self):
        terms = [jnp.sum(v * v) for v in self.data.values()]
        if not terms:
            return jnp.asarray(0.0)
        return sum(terms)

    @property
    def total_size(self) -> int:
        return sum(int(np.prod(v.shape)) for v in self.data.values())

    def __repr__(self):
        return f"BlockVector({ {k: v.shape for k, v in self.data.items()} })"

    # flat packing (VariableOffsetMap equivalent, ``var_offset_map.h:8-30``)
    def pack(self, keys=None):
        """Concatenate blocks (sorted keys) into one flat vector + offsets."""
        keys = sorted(self.data) if keys is None else list(keys)
        offsets = {}
        acc = 0
        parts = []
        for k in keys:
            offsets[k] = acc
            acc += int(np.prod(self.data[k].shape))
            parts.append(jnp.ravel(self.data[k]))
        return jnp.concatenate(parts) if parts else jnp.zeros(0), offsets

    @staticmethod
    def unpack(flat, offsets, dims):
        """Inverse of :meth:`pack` given {key: offset} and {key: dim}."""
        return BlockVector({k: flat[off:off + dims[k]]
                            for k, off in offsets.items()})


class BlockMatrix:
    """map<(row_key, col_key), LinOp> (``block_matrix.h:33-86``).

    Host-side static structure; ``apply``/``rmatvec`` are JAX-traceable.
    """

    def __init__(self, blocks: Optional[Dict[Tuple[str, str], LinOp]] = None):
        self.blocks: Dict[Tuple[str, str], LinOp] = dict(blocks or {})

    # construction ---------------------------------------------------------
    def insert(self, row: str, col: str, op: LinOp):
        key = (row, col)
        if key in self.blocks:
            self.blocks[key] = self.blocks[key] + op
        else:
            self.blocks[key] = op
        return self

    def __setitem__(self, key: Tuple[str, str], op: LinOp):
        self.blocks[key] = op

    def __getitem__(self, key: Tuple[str, str]) -> LinOp:
        return self.blocks[key]

    def __contains__(self, key):
        return key in self.blocks

    def row_keys(self):
        return sorted({r for r, _ in self.blocks})

    def col_keys(self):
        return sorted({c for _, c in self.blocks})

    def row_dim(self, row: str) -> int:
        for (r, _), op in self.blocks.items():
            if r == row:
                return op.m
        raise KeyError(row)

    def col_dim(self, col: str) -> int:
        for (_, c), op in self.blocks.items():
            if c == col:
                return op.n
        raise KeyError(col)

    def col_blocks(self, col: str) -> Dict[str, LinOp]:
        return {r: op for (r, c), op in self.blocks.items() if c == col}

    def row_blocks(self, row: str) -> Dict[str, LinOp]:
        return {c: op for (r, c), op in self.blocks.items() if r == row}

    # algebra (host-side, eager) -------------------------------------------
    @property
    def T(self) -> "BlockMatrix":
        return BlockMatrix({(c, r): op.T for (r, c), op in self.blocks.items()})

    def __add__(self, other: "BlockMatrix") -> "BlockMatrix":
        out = BlockMatrix(dict(self.blocks))
        for (r, c), op in other.blocks.items():
            out.insert(r, c, op)
        return out

    def __matmul__(self, other):
        if isinstance(other, BlockVector):
            return self.apply(other)
        if isinstance(other, BlockMatrix):
            return self.matmul(other)
        return NotImplemented

    def matmul(self, other: "BlockMatrix") -> "BlockMatrix":
        """Sparse block matmul (``block_matrix.cc:102-125``)."""
        out = BlockMatrix()
        other_by_row: Dict[str, Dict[str, LinOp]] = {}
        for (r, c), op in other.blocks.items():
            other_by_row.setdefault(r, {})[c] = op
        for (r, k), op1 in self.blocks.items():
            for c, op2 in other_by_row.get(k, {}).items():
                out.insert(r, c, op1 @ op2)
        return out

    def scale(self, alpha: float) -> "BlockMatrix":
        return BlockMatrix({k: op.scale(alpha) for k, op in self.blocks.items()})

    def select_rows(self, rows) -> "BlockMatrix":
        rows = set(rows)
        return BlockMatrix({(r, c): op for (r, c), op in self.blocks.items()
                            if r in rows})

    def select_cols(self, cols) -> "BlockMatrix":
        cols = set(cols)
        return BlockMatrix({(r, c): op for (r, c), op in self.blocks.items()
                            if c in cols})

    # application (traceable) ----------------------------------------------
    def apply(self, x: BlockVector) -> BlockVector:
        out: Dict[str, jnp.ndarray] = {}
        for (r, c), op in self.blocks.items():
            if c not in x:
                continue
            y = op.matvec(x[c])
            out[r] = out[r] + y if r in out else y
        return BlockVector(out)

    def as_dense(self):
        """Materialize as a single dense matrix with rows/cols ordered by
        sorted key (for tests and small KKT systems)."""
        rows = self.row_keys()
        cols = self.col_keys()
        rdims = {r: self.row_dim(r) for r in rows}
        cdims = {c: self.col_dim(c) for c in cols}
        roff, acc = {}, 0
        for r in rows:
            roff[r] = acc
            acc += rdims[r]
        M = acc
        coff, acc = {}, 0
        for c in cols:
            coff[c] = acc
            acc += cdims[c]
        N = acc
        out = np.zeros((M, N))
        for (r, c), op in self.blocks.items():
            out[roff[r]:roff[r] + rdims[r], coff[c]:coff[c] + cdims[c]] = op.as_dense()
        return out

    def left_identity(self) -> "BlockMatrix":
        """Identity on the row space (``block_matrix.cc:76-88``)."""
        return BlockMatrix({(r, r): linop.identity(self.row_dim(r))
                            for r in self.row_keys()})

    def right_identity(self) -> "BlockMatrix":
        return BlockMatrix({(c, c): linop.identity(self.col_dim(c))
                            for c in self.col_keys()})

    def inverse(self) -> "BlockMatrix":
        """Inverse for block-diagonal-permutation matrices
        (``block_matrix.cc:8-27``): each row and column must have exactly
        one block."""
        by_row: Dict[str, Tuple[str, LinOp]] = {}
        by_col: Dict[str, Tuple[str, LinOp]] = {}
        for (r, c), op in self.blocks.items():
            if r in by_row or c in by_col:
                raise ValueError("BlockMatrix.inverse: not block-diagonal/permutation")
            by_row[r] = (c, op)
            by_col[c] = (r, op)
        return BlockMatrix({(c, r): op.inverse() for (r, c), op in self.blocks.items()})

    def __repr__(self):
        return f"BlockMatrix({ {k: v.shape for k, v in self.blocks.items()} })"
