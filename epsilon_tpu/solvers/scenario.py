"""Scenario stacking: memory-sharded term parallelism for two-block ADMM.

The replicated term-bucket path (``admm.py _sharded_x_update``) shards
COMPUTE only: every device holds the full state and all term data.  This
module detects the *consensus template* inside a ProxProblem —

    S isomorphic terms  f(H_i x_i + g_i),   each over a private variable
    x_i tied to one shared variable z by an identity ZERO constraint
    ``x_i - z = 0``

— and lowers it to a stacked representation where per-term operator data
and per-term state shard across the mesh axis (``P(axis)`` on the stack
dim), the x-update runs the SAME traced prox with per-term constants
substituted under ``vmap`` (reusing the constant-lifting machinery,
``linop.py _to_device``), and the z-update folds the ties in closed form:

    proj onto {x_i = z  for all i} + C  of  (w_x1..w_xS, w_z, ...)
      =  project m = (sum_i w_xi + w_z)/(S+1) onto C with metric
         weight sqrt(S+1) on z, then broadcast x_i = z

When SEVERAL groups (isomorphism families) tie to the SAME shared var, the
joint substitution folds them all at once: m = (w_z + sum_g tot_g) /
(1 + sum_g S_g) with metric weight sqrt(1 + sum_g S_g) (solver `_z_update`
accumulates per-shared-var totals before dividing).

(the exact Euclidean projection — substitute x_i = z and complete the
square), with the cross-device sum a single ``psum``.

Isomorphism is decided by jaxpr equality: each candidate term's prox apply
is traced with its lifted constants as explicit arguments; two terms stack
iff the jaxprs print identically (this captures every baked non-lifted
constant — scalar alphas, shapes, kernel parameters — so no term can
silently inherit another's data).

Reference analogue: the vestigial consensus/distributed knobs of
``solver_params.proto:42-56`` (dead code there), realized on the device mesh.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax

from .. import config
from ..ir import Cone, ProxProblem

logger = logging.getLogger("epsilon_tpu")
from ..ops.block import BlockVector
from ..ops.linop import lift_apply, lift_collect

SCN_PREFIX = "scn:"


@dataclasses.dataclass
class ScenarioGroup:
    key: str                 # state key for the stacked private vars
    shared: str              # the consensus variable the terms tie to
    term_idx: List[int]      # indices into problem.terms, stack order
    pv_names: List[str]      # private variable per term, stack order
    d: int                   # per-term private var dim
    S: int                   # number of stacked terms
    op: object               # term_ops[term_idx[0]] — the shared trace
    pv0: str                 # its private var name (canonical input key)
    lifter: object           # _ConstLifter of the shared trace
    host_stacks: List[np.ndarray]        # per-position (S, ...) host stacks
    tie_idx: List[int]

    def local_apply(self, consts, z_i, rho, adaptive: bool, sqrt_rho: float):
        """One scenario's prox at ``z_i`` with ITS constants substituted
        into the shared trace (vmapped over the device-local stack)."""
        with lift_apply(self.lifter, list(consts)):
            bv = BlockVector({self.pv0: z_i})
            if adaptive:
                out = self.op.apply_rho(bv, rho)
            else:
                out = self.op.apply(sqrt_rho * bv)
        return out[self.pv0]


def _scalar_value(op) -> Optional[float]:
    fn = getattr(op, "scalar_value", None)
    if fn is None:
        return None
    return fn()


def _term_trace(op, pv: str, d: int, adaptive: bool, sqrt_rho: float):
    """(lifter, jaxpr_str) of the term's prox apply with lifted constants
    as explicit arguments.  The jaxpr string is the isomorphism signature."""
    dtype = config.default_dtype()
    zeros = {pv: jax.ShapeDtypeStruct((d,), dtype)}
    rho_s = jax.ShapeDtypeStruct((), dtype)

    def f(vdict, rho):
        bv = BlockVector(vdict)
        if adaptive:
            return op.apply_rho(bv, rho)
        return op.apply(sqrt_rho * bv)

    with lift_collect() as lf:
        jax.eval_shape(f, zeros, rho_s)

    arg_shapes = [jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype)
                  for a in lf.arrays]

    def f_pure(vdict, rho, args):
        with lift_apply(lf, args):
            return f(vdict, rho)

    jaxpr = jax.make_jaxpr(f_pure)(zeros, rho_s, arg_shapes)
    # The jaxpr string shows structure but NOT closed-over constant VALUES
    # (e.g. a jnp-array offset bypasses lifting and bakes into the trace) —
    # hash them into the signature or a member could silently inherit the
    # canonical member's baked data.  Compiler-produced problems keep all
    # data as host numpy (lifted), so this only demotes hand-built
    # jnp-data problems to bucket sharding.
    h = hashlib.sha1()
    for c in jaxpr.consts:
        a = np.asarray(c)
        h.update(str((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return lf, str(jaxpr) + h.hexdigest()


def collect_group_stacks(group: ScenarioGroup, term_ops, adaptive: bool,
                         sqrt_rho: float) -> List[np.ndarray]:
    """Re-collect each member term's lifted constants (post data update)
    and restack; positions follow the shared trace's first-touch order."""
    stacks: List[List[np.ndarray]] = [[] for _ in group.lifter.arrays]
    for rank, ti in enumerate(group.term_idx):
        lf, _ = _term_trace(term_ops[ti], group.pv_names[rank], group.d,
                            adaptive, sqrt_rho)
        if len(lf.arrays) != len(group.lifter.arrays):
            raise ValueError("scenario group structure changed under update")
        for p, a in enumerate(lf.arrays):
            stacks[p].append(np.asarray(a))
    return [np.stack(s) for s in stacks]


def refresh_group(group: ScenarioGroup, term_ops, adaptive: bool,
                  sqrt_rho: float) -> None:
    """Rebind a group to freshly built term ops (``update_problem``): new
    shared trace/lifter for the canonical member plus restacked host data.
    Positional order is preserved because ``_term_trace``'s first-touch
    order is deterministic for identical term structure — the compiled
    executable's positional substitution stays valid."""
    group.op = term_ops[group.term_idx[0]]
    lf, _ = _term_trace(group.op, group.pv0, group.d, adaptive, sqrt_rho)
    if len(lf.arrays) != len(group.lifter.arrays):
        raise ValueError("scenario group structure changed under update")
    group.lifter = lf
    group.host_stacks = collect_group_stacks(group, term_ops, adaptive,
                                             sqrt_rho)


def detect_scenario_groups(problem: ProxProblem, term_ops, term_vars,
                           n_devices: int, adaptive: bool, sqrt_rho: float):
    """Find stackable scenario groups.  Returns (groups, stacked_terms,
    tie_constraints) — the term/constraint indices consumed by stacking."""
    if n_devices <= 1:
        return [], set(), set()

    var_term_count: Dict[str, int] = {}
    for tvars in term_vars:
        for v in tvars:
            var_term_count[v] = var_term_count.get(v, 0) + 1
    var_con: Dict[str, List[int]] = {}
    for ci, con in enumerate(problem.constraints):
        for (_, c) in con.op.A.blocks:
            var_con.setdefault(c, []).append(ci)

    # identity ties: a*x + (-a)*z = 0, no offset
    candidates = []  # (term index, pv, shared, tie constraint index)
    for ci, con in enumerate(problem.constraints):
        if con.cone != Cone.ZERO:
            continue
        blocks = con.op.A.blocks
        rows = {r for (r, _) in blocks}
        if len(blocks) != 2 or len(rows) != 1:
            continue
        if any(np.any(np.asarray(v)) for _, v in con.op.b.items()):
            continue
        (k1, op1), (k2, op2) = sorted(blocks.items())
        s1, s2 = _scalar_value(op1), _scalar_value(op2)
        # reject zero coefficients: 0*x + (-0)*z = 0 passes isclose(s1,-s2)
        # but is vacuous, not an identity tie
        if (s1 is None or s2 is None or not np.isclose(s1, -s2)
                or np.isclose(s1, 0.0)):
            continue
        v1, v2 = k1[1], k2[1]
        for pv, sv in ((v1, v2), (v2, v1)):
            if (var_term_count.get(pv, 0) != 1 or
                    len(var_con.get(pv, [])) != 1):
                continue
            owners = [ti for ti, tv in enumerate(term_vars) if pv in tv]
            if len(owners) != 1 or len(term_vars[owners[0]]) != 1:
                continue
            candidates.append((owners[0], pv, sv, ci))
            break

    # group by (shared var, dim, jaxpr signature)
    groups_by_sig: Dict[Tuple, List] = {}
    for ti, pv, sv, ci in candidates:
        d = problem.var_dims[pv]
        lf, jx = _term_trace(term_ops[ti], pv, d, adaptive, sqrt_rho)
        groups_by_sig.setdefault((sv, d, jx), []).append((ti, pv, ci, lf))

    groups: List[ScenarioGroup] = []
    stacked_terms: set = set()
    tie_constraints: set = set()
    claimed_pvs: set = set()
    gi = 0
    for (sv, d, _jx), members in sorted(
            groups_by_sig.items(), key=lambda kv: min(m[0] for m in kv[1])):
        S = len(members)
        if S < n_devices or S % n_devices != 0:
            # no silent caps: a 12-scenario family on 8 devices falls back
            # to bucket sharding (replicated state, psum-combined compute),
            # which is correct but loses the memory sharding — say so
            logger.info(
                "scenario stacking skipped for %d isomorphic terms on %r: "
                "S=%d not a multiple of n_devices=%d (>= one per device "
                "required); falling back to bucket term sharding",
                S, sv, S, n_devices)
            continue
        if sv in claimed_pvs:
            # the shared var was already folded away as another group's
            # private var — cannot anchor a consensus average on it
            continue
        members.sort()  # deterministic stack order by term index
        t0, pv0, _, lf0 = members[0]
        # verify per-position shapes/dtypes line up, then stack
        ok = all(
            len(lf.arrays) == len(lf0.arrays) and
            all(np.shape(a) == np.shape(b) and
                np.asarray(a).dtype == np.asarray(b).dtype
                for a, b in zip(lf.arrays, lf0.arrays))
            for _, _, _, lf in members)
        if not ok:
            continue
        host_stacks = [
            np.stack([np.asarray(m[3].arrays[p]) for m in members])
            for p in range(len(lf0.arrays))]
        groups.append(ScenarioGroup(
            key=f"{SCN_PREFIX}{gi}", shared=sv,
            term_idx=[m[0] for m in members],
            pv_names=[m[1] for m in members],
            d=d, S=S, op=term_ops[t0], pv0=pv0, lifter=lf0,
            host_stacks=host_stacks,
            tie_idx=[m[2] for m in members]))
        stacked_terms.update(m[0] for m in members)
        tie_constraints.update(m[2] for m in members)
        claimed_pvs.update(m[1] for m in members)
        gi += 1
    return groups, stacked_terms, tie_constraints
