"""ADMM operator-splitting solvers, fully jitted.

Accelerator-native re-design of ``src/epsilon/algorithms/``:

- :class:`ProxADMMTwoBlockSolver` — two-block consensus ADMM
  (``prox_admm_two_block.cc``): x-update applies all prox operators at
  ``z - u`` independently (embarrassingly parallel — the scaling path,
  sharded in :mod:`epsilon_tpu.parallel`); z-update projects onto the
  constraint set via a cached block-Cholesky ZERO-prox; ``u += x - z``.
- :class:`ProxADMMSolver` — N-block Gauss-Seidel ADMM (``prox_admm.cc``):
  sequential sweep over terms in the constraint-row space.

Both run either as a single jitted ``lax.while_loop`` over epochs
(``drive='device'``) or as a Python epoch loop around a jitted epoch step
(``drive='host'``, with per-epoch logging/series), with residual checks every
``epoch_iterations`` exactly like the reference.
"""

from __future__ import annotations

import inspect
import logging
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from ..ir import (AffineOperator, Cone, ProxFunctionSpec, ProxKind,
                  ProxProblem, ProxTerm, arg_key, constraint_key)
from ..ops import linop
from ..ops.linop import lift_apply, lift_collect
from ..ops.block import BlockMatrix, BlockVector
from ..ops.prox.operator import create_prox_operator
from . import scenario
from .objective import problem_objective
from .params import SolverParams
from .status import Residuals, SolverState, SolverStatus

logger = logging.getLogger("epsilon_tpu")


def _zeros(dims: Dict[str, int]) -> BlockVector:
    dtype = config.default_dtype()
    return BlockVector({k: jnp.zeros(n, dtype=dtype) for k, n in dims.items()})


def _series_from_buffer(series_buf, start_epoch: int, end_epoch: int):
    """Residuals list from the device drive's fixed-length per-epoch buffer
    (rows outside [start_epoch, end_epoch) were never written)."""
    rows = np.asarray(series_buf)
    return [Residuals(*[float(v) for v in rows[e]])
            for e in range(int(start_epoch), min(int(end_epoch), rows.shape[0]))]


def _rekey_constraint(i: int, affop: AffineOperator):
    """Re-key a constraint's affine operator rows onto constraint_key(i)
    (suffixing when the constraint has several row blocks), mirroring
    ``affine::constraint_key`` row naming (``affine.cc:136-140``)."""
    rows = sorted({r for (r, _) in affop.A.blocks} | set(affop.b.keys()))
    mapping = {}
    for j, r in enumerate(rows):
        mapping[r] = constraint_key(i) if len(rows) == 1 else f"{constraint_key(i)}:{j}"
    A = BlockMatrix({(mapping[r], c): op for (r, c), op in affop.A.blocks.items()})
    b = BlockVector({mapping[r]: v for r, v in affop.b.items()})
    return A, b


class SolverBase:
    """Status plumbing shared by both drivers (``solver.h:42-102``)."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        self.problem = problem
        self.params = params
        self.status = SolverStatus()
        self._warm_state = None
        self._compiled_key = None
        self._stop_callbacks = []
        self._checkpointer = None

    def register_stop_callback(self, cb):
        """External cancellation hook (``solver.h:60-63``,
        ``solver.cc:102-107``): checked between epochs in host drive."""
        self._stop_callbacks.append(cb)

    def attach_checkpointer(self, ckpt):
        """Elastic recovery: durable checkpoints of the loop state (see
        :class:`epsilon_tpu.utils.checkpoint.SolverCheckpointer`).  Host
        drive saves every ``ckpt.every_epochs`` epochs and resumes from the
        latest checkpoint; device drive resumes at start and saves once at
        the end (the loop runs entirely on device between syncs)."""
        self._checkpointer = ckpt

    def _resume_state(self, state):
        """(state, start_iters) from the latest checkpoint, if any."""
        if self._checkpointer is None:
            return state, 0
        restored, step = self._checkpointer.restore(state)
        if restored is None:
            return state, 0
        logger.info("resuming from checkpoint at iteration %d", step)
        return restored, step

    def _has_external_stop(self) -> bool:
        return any(cb() for cb in self._stop_callbacks)

    def _rebuild_full(self):
        """Reconstruct the solver in place for a changed mode (adaptive_rho/
        mesh flip) or fixed rho, preserving user-attached hooks that
        ``__init__`` would reset and migrating the warm-start state to the
        new parameterization where that's well-defined."""
        saved_cbs = self._stop_callbacks
        saved_ckpt = self._checkpointer
        old_warm = self._warm_state
        old_rho = getattr(self, "_init_rho", None)
        old_adaptive = getattr(self, "adaptive", None)
        self.__init__(self.problem, self.params)
        self._stop_callbacks = saved_cbs
        self._checkpointer = saved_ckpt
        self._warm_state = self._migrate_warm_state(old_warm, old_rho,
                                                    old_adaptive)

    def _migrate_warm_state(self, old_state, old_rho, old_adaptive):
        """Map a previous solve's warm state onto the rebuilt solver's
        parameterization; ``None`` when no valid mapping exists."""
        return None

    def objective_value(self, x: BlockVector):
        return problem_objective(self.problem, x)

    def _shard_wrap(self, fn, in_specs=None, out_specs=None):
        """Wrap a traceable fn in shard_map over the term mesh.  Default:
        all inputs/outputs replicated (the sharding is in the lax.switch
        bucket dispatch + psum inside); scenario stacking passes explicit
        per-leaf specs (P(axis) on stacked state keys and stacked term
        data). Identity when no mesh is configured."""
        mesh = getattr(self, "mesh", None)
        if mesh is None:
            return fn
        from jax.sharding import PartitionSpec as P
        if in_specs is None:
            n_in = len(inspect.signature(fn).parameters)
            in_specs = tuple([P()] * n_in)
        if out_specs is None:
            out_specs = P()
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def _lift_constants(self, state):
        """Record every frozen host array the epoch touches and return the
        (lifter, device_args) pair: problem data is passed to jit as
        arguments, not baked into the HLO as constants (keeps compiles fast
        and allows data updates without recompilation)."""
        with lift_collect() as lifter:
            jax.eval_shape(self._shard_wrap(self._epoch), state)
        return lifter, lifter.device_args()

    def _rebuild_operators(self, problem: ProxProblem):
        raise NotImplementedError

    def update_problem(self, problem: ProxProblem):
        """Swap in a problem with identical *structure* but new data
        (Parameter updates) without recompiling: the compiled executable
        takes the lifted constants as arguments, so only the constant
        pytree is refreshed (reference analogue: Solver::SetParameterValue,
        ``solver.cc:109-116`` + warm-start cache ``solvemodule.cc:142-155``).
        """
        self.problem = problem
        self._rebuild_operators(problem)
        if self._compiled is not None:
            run, _old = self._compiled
            _lifter, args = self._lift_constants(self._init_state())
            self._compiled = (run, args)

    def _finish(self, state, iters, res, converged, t_init, t_solve):
        self.status.num_iterations = int(iters)
        self.status.residuals = Residuals(
            float(res[0]), float(res[1]), float(res[2]), float(res[3]))
        self.status.state = (SolverState.OPTIMAL if bool(converged)
                             else SolverState.MAX_ITERATIONS_REACHED)
        self.status.timing.init_usec = int(t_init * 1e6)
        self.status.timing.solve_usec = int(t_solve * 1e6)
        self.status.timing.total_usec = int((t_init + t_solve) * 1e6)
        if self.params.warm_start:
            self._warm_state = state
        if self.params.verbose:
            logger.info(self.status.log_line())


class ProxADMMTwoBlockSolver(SolverBase):
    """Two-block consensus ADMM (``prox_admm_two_block.{h,cc}``)."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        super().__init__(problem, params)
        t0 = time.time()
        self.adaptive = params.adaptive_rho
        self._init_rho = params.rho
        sqrt_rho = 1.0 if self.adaptive else float(np.sqrt(params.rho))
        self.sqrt_rho = sqrt_rho

        # Per-term prox operators with A = sqrt(rho)*I over term variables
        # (prox_admm_two_block.cc:52-88) — built first: scenario detection
        # traces them.
        self._build_term_ops(problem)

        # Scenario stacking (memory-sharded term parallelism): isomorphic
        # terms tied to a shared variable by identity ZERO constraints stack
        # along the mesh axis; their data, state, and x-updates shard with
        # P(axis) and the tie projection folds into a psum average (see
        # solvers/scenario.py).
        self.mesh = params.mesh
        self.axis_name = None
        self.n_dev = 1
        self.buckets: Optional[List[List[int]]] = None
        self.scn_groups: List[scenario.ScenarioGroup] = []
        self._scn_keys: set = set()
        stacked_terms: set = set()
        tie_cons: set = set()
        if self.mesh is not None:
            if len(self.mesh.axis_names) != 1:
                raise ValueError("term sharding requires a 1-D mesh")
            self.axis_name = self.mesh.axis_names[0]
            self.n_dev = int(self.mesh.devices.size)
            self.scn_groups, stacked_terms, tie_cons = \
                scenario.detect_scenario_groups(
                    problem, self.term_ops, self.term_vars, self.n_dev,
                    self.adaptive, sqrt_rho)
            self._scn_keys = {g.key for g in self.scn_groups}
        self._stacked_terms = stacked_terms
        self._folded_pvs = {pv for g in self.scn_groups for pv in g.pv_names}

        # Constraint projection operator over the constraint variables
        # (prox_admm_two_block.cc:21-50), EXCLUDING folded tie constraints;
        # in adaptive-rho mode the metric is the identity (the projection is
        # rho-invariant) and rho enters the term proxes as a traced scalar.
        # Folded shared variables carry metric weight sqrt(S+1) — the exact
        # reduction of the joint projection (scenario.py docstring).
        Hc = BlockMatrix()
        gc = BlockVector()
        self.z_dims: Dict[str, int] = {}   # ALL constraint vars (eps scaling)
        red_z_dims: Dict[str, int] = {}
        for i, con in enumerate(problem.constraints):
            if con.cone != Cone.ZERO:
                raise ValueError(f"two-block ADMM supports ZERO cones only, "
                                 f"got {con.cone}")
            Ai, bi = _rekey_constraint(i, con.op)
            for (r, c), op in Ai.blocks.items():
                self.z_dims[c] = op.n
            if i in tie_cons:
                continue
            for (r, c), op in Ai.blocks.items():
                Hc.insert(r, c, op)
                red_z_dims[c] = op.n
            for r, vec in bi.items():
                gc[r] = vec
        # Joint fold weight per shared variable: several scenario groups may
        # tie to the SAME shared var (two isomorphism families on one z);
        # the exact joint projection substitutes all their copies at once,
        # m = (w_z + sum_g tot_g)/(1 + sum_g S_g), metric sqrt(1 + sum_g S_g)
        self._shared_S: Dict[str, int] = {}
        for g in self.scn_groups:
            self._shared_S[g.shared] = self._shared_S.get(g.shared, 0) + g.S
        self._proj_w = {sv: float(np.sqrt(S + 1.0))
                        for sv, S in self._shared_S.items()}
        Ac = BlockMatrix({(k, k): linop.scalar(
            sqrt_rho * self._proj_w.get(k, 1.0), n)
            for k, n in red_z_dims.items()})
        self.constr_prox = None
        if red_z_dims:
            self.constr_prox = create_prox_operator(
                ProxFunctionSpec(kind=ProxKind.ZERO),
                AffineOperator(Hc, gc), AffineOperator(Ac, BlockVector()))
        self.m = sum(Hc.row_dim(r) for r in Hc.row_keys())
        self.n = sum(self.z_dims.values())

        # State key sets: all_dims has the LOCAL (per-device) dims used by
        # traced code inside shard_map; state_dims the GLOBAL dims used to
        # materialize state outside.  Identical without scenario stacking.
        self.all_dims: Dict[str, int] = {}
        self.state_dims: Dict[str, int] = {}
        for k, n in self.z_dims.items():
            if k not in self._folded_pvs:
                self.all_dims[k] = self.state_dims[k] = n
        for ti, tvars in enumerate(self.term_vars):
            if ti in stacked_terms:
                continue
            for v in tvars:
                self.all_dims[v] = self.state_dims[v] = problem.var_dims[v]
        for g in self.scn_groups:
            self.all_dims[g.key] = (g.S // self.n_dev) * g.d
            self.state_dims[g.key] = g.S * g.d

        # Term sharding for the REMAINING terms: balance into one bucket per
        # mesh device (greedy LPT on the H nnz cost model); each device
        # executes its bucket via lax.switch(axis_index) and the
        # x contributions combine with a psum over the mesh axis.
        if self.mesh is not None:
            rem = [i for i in range(len(problem.terms))
                   if i not in stacked_terms]
            self.buckets = self._partition_terms(self.n_dev, rem) if rem \
                else None

        self._scn_args = self._make_scn_args()
        self._scn_traced = None
        self._heap_traced = None

        # Warm-startable kernel state (TV-1D PDAS duals): threaded through
        # the loop state on the unmeshed path only (bucket lax.switch
        # branches could not keep per-term states replicated-consistent).
        self._kstate0 = None
        if self.mesh is None:
            ks = [op.kernel_state_init()
                  if hasattr(op, "kernel_state_init") else None
                  for op in self.term_ops]
            if any(k is not None for k in ks):
                self._kstate0 = tuple(ks)

        self._t_init = time.time() - t0
        self._compiled = None

    def _unpack_state(self, state):
        """(z, u, rho_or_None, kstates_or_None) from the packed loop state."""
        i = 2
        rho = None
        if self.adaptive:
            rho = state[i]
            i += 1
        ks = state[i] if self._kstate0 is not None else None
        return state[0], state[1], rho, ks

    def _pack_state(self, z, u, rho, ks):
        out = (z, u)
        if self.adaptive:
            out = out + (rho,)
        if self._kstate0 is not None:
            out = out + (ks,)
        return out

    def _make_scn_args(self):
        """Per-group stacked device constants, placed SHARDED along the mesh
        axis at rest (each device holds only its scenarios' data)."""
        if not self.scn_groups:
            return []
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(self.mesh, P(self.axis_name))
        return [[jax.device_put(a, sh) for a in g.host_stacks]
                for g in self.scn_groups]

    def _partition_terms(self, n_buckets: int,
                         indices: Optional[List[int]] = None) -> List[List[int]]:
        idx = range(len(self.problem.terms)) if indices is None else indices
        costs = []
        for i in idx:
            term = self.problem.terms[i]
            nnz = sum(op.nnz() for op in term.H.A.blocks.values())
            # KKT-based operators pay an extra dense solve over their vars
            tn = sum(self.problem.var_dims[v] for v in self.term_vars[i])
            if term.spec.kind in (ProxKind.ZERO, ProxKind.AFFINE,
                                  ProxKind.CONSTANT, ProxKind.SUM_SQUARE):
                nnz += tn * tn
            costs.append((nnz, i))
        buckets: List[List[int]] = [[] for _ in range(n_buckets)]
        loads = [0] * n_buckets
        for cost, i in sorted(costs, reverse=True):
            j = int(np.argmin(loads))
            buckets[j].append(i)
            loads[j] += cost
        return buckets

    def _build_term_ops(self, problem: ProxProblem):
        from ..ops.prox.operator import create_rho_prox_operator
        sqrt_rho = self.sqrt_rho
        self.term_ops = []
        self.term_vars: List[List[str]] = []
        for term in problem.terms:
            tvars = sorted({c for (_, c) in term.H.A.blocks})
            if self.adaptive:
                op = create_rho_prox_operator(
                    term.spec, term.H,
                    {k: problem.var_dims[k] for k in tvars})
            else:
                A = BlockMatrix({(k, k): linop.scalar(sqrt_rho,
                                                      problem.var_dims[k])
                                 for k in tvars})
                op = create_prox_operator(term.spec, term.H,
                                          AffineOperator(A, BlockVector()))
            self.term_ops.append(op)
            self.term_vars.append(tvars)

    def _rebuild_operators(self, problem: ProxProblem):
        self._build_term_ops(problem)
        # constraint structure is data-independent in the supported update
        # path (equality constraints between variables); keep constr_prox.
        if self.scn_groups:
            for g in self.scn_groups:
                scenario.refresh_group(g, self.term_ops, self.adaptive,
                                       self.sqrt_rho)
            self._scn_args = self._make_scn_args()
        # bucket heaps index the OLD ops' buffers by id: rebuild them (the
        # layout is structure-deterministic, so the compiled run's heap
        # pytree keeps its shape and only the data refreshes)
        self._bucket_lifters = None

    # -- iteration bodies (traceable) --------------------------------------
    def _iter_body(self, state):
        z, u, rho, ks = self._unpack_state(state)
        zu = z - u
        x = _zeros(self.all_dims)
        new_ks = ks
        if self.mesh is not None:
            if self.buckets is not None:
                x = x + self._sharded_x_update(zu, rho)
            # stacked scenarios: each device vmaps the shared prox trace
            # over ITS slice of terms with ITS slice of the stacked data
            for g, consts in zip(self.scn_groups, self._scn_traced):
                Z = zu[g.key].reshape(g.S // self.n_dev, g.d)
                fn = lambda c_i, z_i, _g=g: _g.local_apply(
                    c_i, z_i, rho, self.adaptive, self.sqrt_rho)
                x[g.key] = jnp.reshape(jax.vmap(fn)(consts, Z), (-1,))
        else:
            ks_out = []
            for i, op in enumerate(self.term_ops):
                k_i = ks[i] if ks is not None else None
                if k_i is not None:
                    # warm-startable kernel: thread its state (TV PDAS dual)
                    if self.adaptive:
                        xi, k_i = op.apply_stateful(zu, k_i, rho=rho)
                    else:
                        xi, k_i = op.apply_stateful(self.sqrt_rho * zu, k_i)
                    x = x + xi
                elif self.adaptive:
                    x = x + op.apply_rho(zu, rho)
                else:
                    x = x + op.apply(self.sqrt_rho * zu)
                ks_out.append(k_i)
            new_ks = tuple(ks_out) if ks is not None else None
        alpha = self.params.over_relaxation
        x_hat = x if alpha == 1.0 else alpha * x + (1.0 - alpha) * z
        xu = x_hat + u
        z_new = self._z_update(xu)
        u_new = u + x_hat - z_new
        return self._pack_state(z_new, u_new, rho, new_ks), x

    def _z_update(self, xu):
        """Projection onto the constraint set.  With scenario groups, the
        identity ties fold in closed form: the shared variable's projection
        input is the psum average of its scenarios (+ itself), with metric
        weight sqrt(S+1) in the reduced KKT (see scenario.py docstring);
        the stacked copies then broadcast back from the projected shared."""
        if not self.scn_groups:
            if self.constr_prox is None:
                return xu
            zp = self.constr_prox.apply(self.sqrt_rho * xu)
            # variables untouched by constraints pass through unprojected
            return BlockVector({k: (zp[k] if k in zp else xu[k])
                                for k in self.all_dims})
        red = BlockVector({k: v for k, v in xu.items()
                           if k not in self._scn_keys})
        # joint fold across ALL groups tied to each shared var:
        # m = (w_z + sum_g tot_g) / (1 + sum_g S_g)
        tots: Dict[str, object] = {}
        for g in self.scn_groups:
            W = xu[g.key].reshape(g.S // self.n_dev, g.d)
            tot = jax.lax.psum(jnp.sum(W, axis=0), self.axis_name)
            tots[g.shared] = (tot if g.shared not in tots
                              else tots[g.shared] + tot)
        for sv, tot in tots.items():
            red[sv] = (red[sv] + tot) / (self._shared_S[sv] + 1.0)
        if self.constr_prox is not None:
            scaled = BlockVector({
                k: (self.sqrt_rho * self._proj_w.get(k, 1.0)) * v
                for k, v in red.items()})
            zp = self.constr_prox.apply(scaled)
            red = BlockVector({k: (zp[k] if k in zp else red[k])
                               for k in red.keys()})
        z_new = BlockVector({k: red[k] for k in self.all_dims
                             if k not in self._scn_keys})
        for g in self.scn_groups:
            z_new[g.key] = jnp.reshape(jnp.broadcast_to(
                red[g.shared], (g.S // self.n_dev, g.d)), (-1,))
        return z_new

    def _bucket_branch(self, bucket):
        """x-update body over one device bucket's terms (flat-packed)."""
        dims = {k: n for k, n in self.all_dims.items()
                if k not in self._scn_keys}
        keys = sorted(dims)

        def branch(zu, rho):
            x = _zeros(dims)
            for ti in bucket:
                op = self.term_ops[ti]
                if self.adaptive:
                    x = x + op.apply_rho(zu, rho)
                else:
                    x = x + op.apply(self.sqrt_rho * zu)
            flat, _ = x.pack(keys)
            return flat
        return branch

    def _setup_bucket_heaps(self):
        """Memory-shard the heterogeneous bucket path: collect each
        bucket's frozen constants separately and pack them into per-dtype
        (n_dev, L) heaps placed SHARDED along the mesh axis — each device
        holds only ITS bucket's problem data (realizing the consensus
        memory model of ``solver_params.proto:42-56`` for arbitrary mixed-
        kernel terms, not just isomorphic scenario stacks).  Inside the
        epoch, branch j unpacks its lifted arrays from the device-local
        heap row by static (dtype, offset, shape) layout."""
        if (self.buckets is None or not config.bucket_heaps_enabled()
                or getattr(self, "_bucket_lifters", None) is not None):
            return
        from jax.sharding import NamedSharding, PartitionSpec as P
        dtype = config.default_dtype()
        dims = {k: n for k, n in self.all_dims.items()
                if k not in self._scn_keys}
        zu_aval = BlockVector({k: jax.ShapeDtypeStruct((n,), dtype)
                               for k, n in dims.items()})
        rho_aval = (jax.ShapeDtypeStruct((), dtype) if self.adaptive
                    else None)
        lifters, layouts, sizes = [], [], []
        for bucket in self.buckets:
            with lift_collect() as lf:
                jax.eval_shape(self._bucket_branch(bucket), zu_aval, rho_aval)
            lay = []
            cur: Dict = {}
            for a in lf.arrays:
                ah = np.asarray(a)
                dt = np.dtype(ah.dtype)
                off = cur.get(dt, 0)
                lay.append((dt, off, ah.shape))
                cur[dt] = off + ah.size
            lifters.append(lf)
            layouts.append(lay)
            sizes.append(cur)
        dts = sorted({dt for s in sizes for dt in s}, key=str)
        sh = NamedSharding(self.mesh, P(self.axis_name, None))
        heap_args = {}
        for dt in dts:
            L = max(max(s.get(dt, 0) for s in sizes), 1)
            H = np.zeros((self.n_dev, L), dt)
            for j, (lf, lay) in enumerate(zip(lifters, layouts)):
                for a, (adt, off, shp) in zip(lf.arrays, lay):
                    if adt == dt:
                        ah = np.asarray(a)
                        H[j, off:off + ah.size] = ah.ravel()
            heap_args[str(dt)] = jax.device_put(H, sh)
        self._bucket_lifters = lifters
        self._bucket_layouts = layouts
        self._heap_args = heap_args

    def _heap_specs(self):
        from jax.sharding import PartitionSpec as P
        return {k: P(self.axis_name, None)
                for k in getattr(self, "_heap_args", {})}

    def _sharded_x_update(self, zu, rho):
        """x-update under shard_map: each device runs its term bucket
        (lax.switch on the device index) and a psum over the mesh axis
        combines the per-variable contributions — the heterogeneous-term
        analogue of the consensus solver's scenario sharding.  With bucket
        heaps active, each branch rebinds its lifted constants to slices of
        the device-local heap row, so term data is sharded at rest."""
        dims = {k: n for k, n in self.all_dims.items()
                if k not in self._scn_keys}
        keys = sorted(dims)
        offs = {}
        acc = 0
        for k in keys:
            offs[k] = acc
            acc += dims[k]

        heaps = getattr(self, "_heap_traced", None)

        def make_branch(j, bucket):
            base = self._bucket_branch(bucket)
            if heaps is None:
                return lambda zu: base(zu, rho)
            lf = self._bucket_lifters[j]
            lay = self._bucket_layouts[j]

            def fn(zu):
                args = []
                for (dt, off, shp) in lay:
                    row = heaps[str(np.dtype(dt))][0]
                    size = int(np.prod(shp)) if shp else 1
                    args.append(jnp.reshape(row[off:off + size], shp))
                with lift_apply(lf, args):
                    return base(zu, rho)
            return fn

        idx = jax.lax.axis_index(self.axis_name)
        flat = jax.lax.switch(
            idx, [make_branch(j, b) for j, b in enumerate(self.buckets)], zu)
        flat = jax.lax.psum(flat, self.axis_name)
        return BlockVector.unpack(flat, offs, dims)

    def _res_norm_sq(self, bv: BlockVector):
        """||bv||^2 with stacked (device-local) keys psummed over the mesh
        axis and replicated keys counted once."""
        rep = jnp.asarray(0.0, dtype=config.default_dtype())
        loc = jnp.asarray(0.0, dtype=config.default_dtype())
        for k, v in bv.items():
            if k in self._scn_keys:
                loc = loc + jnp.sum(v * v)
            else:
                rep = rep + jnp.sum(v * v)
        if self.scn_groups:
            loc = jax.lax.psum(loc, self.axis_name)
        return rep + loc

    def _residuals(self, state, x, z_prev):
        z, u, rho, _ks = self._unpack_state(state)
        if rho is None:
            rho = self.params.rho
        abs_tol, rel_tol = self.params.abs_tol, self.params.rel_tol
        sqrt_n = float(np.sqrt(max(self.n, 1)))
        r_norm = jnp.sqrt(self._res_norm_sq(x - z))
        s_norm = rho * jnp.sqrt(self._res_norm_sq(z - z_prev))
        eps_p = abs_tol * sqrt_n + rel_tol * jnp.maximum(
            jnp.sqrt(self._res_norm_sq(x)), jnp.sqrt(self._res_norm_sq(z)))
        eps_d = abs_tol * sqrt_n + rel_tol * rho * jnp.sqrt(
            self._res_norm_sq(u))
        return jnp.stack([r_norm, s_norm, eps_p, eps_d])

    def _x_zeros(self):
        return _zeros(self.all_dims)

    def _epoch(self, state):
        """epoch_iterations sweeps + residuals, as a device-side fori_loop
        (keeps the HLO small: one iteration body, not an unrolled epoch).
        The dual residual uses the FINAL sweep's ``z - z_prev`` (one extra z
        carried through the loop), matching the reference's per-iteration
        ``z_prev_ = z_`` snapshot (``prox_admm_two_block.cc:101,135-156``) —
        an epoch-start delta inflates s_norm and can delay declared
        convergence by whole epochs at tight tolerances."""

        def body(_, carry):
            st, _x, _zp = carry
            zp = st[0]
            st, x = self._iter_body(st)
            return st, x, zp

        state, x, z_prev = jax.lax.fori_loop(
            0, self.params.epoch_iterations, body,
            (state, self._x_zeros(), state[0]))
        res = self._residuals(state, x, z_prev)
        conv = (res[0] <= res[2]) & (res[1] <= res[3])
        if self.adaptive:
            # residual balancing: keep ||r|| and ||s|| within a factor mu,
            # rescaling the scaled dual u when rho changes (Boyd 3.4.1)
            z, u, rho, ks = self._unpack_state(state)
            mu, tau = self.params.rho_mu, self.params.rho_tau
            grow = res[0] > mu * res[1]
            shrink = res[1] > mu * res[0]
            factor = jnp.where(grow, tau, jnp.where(shrink, 1.0 / tau, 1.0))
            factor = factor.astype(rho.dtype)
            state = self._pack_state(z, (1.0 / factor) * u, rho * factor, ks)
        return state, x, res, conv

    def _init_state(self):
        if self.params.warm_start and self._warm_state is not None:
            return self._warm_state
        z = _zeros(self.state_dims)
        u = _zeros(self.state_dims)
        rho = (jnp.asarray(self.params.rho, dtype=config.default_dtype())
               if self.adaptive else None)
        return self._pack_state(z, u, rho, self._kstate0)

    def _migrate_warm_state(self, old_state, old_rho, old_adaptive):
        if old_state is None or old_adaptive != self.adaptive:
            return None
        z = old_state[0]
        if set(z.keys()) != set(self.state_dims) or any(
                z[k].shape != (n,) for k, n in self.state_dims.items()):
            return None  # state layout changed (e.g. scenario stacking)
        u = old_state[1]
        rho = old_state[2] if self.adaptive else None
        if not self.adaptive:
            # u is the scaled dual lambda/rho: preserve lambda across the
            # rho change (Boyd 3.4.1 rescaling)
            u = (old_rho / self._init_rho) * u
        # kernel warm state restarts cold across a rebuild (the metric the
        # duals live in changed)
        return self._pack_state(z, u, rho, self._kstate0)

    # -- scenario-stacking plumbing -----------------------------------------
    def _bv_spec(self):
        from jax.sharding import PartitionSpec as P
        return BlockVector({k: (P(self.axis_name) if k in self._scn_keys
                                else P()) for k in self.all_dims})

    def _state_spec(self):
        from jax.sharding import PartitionSpec as P
        bv = self._bv_spec()
        return (bv, bv, P()) if self.adaptive else (bv, bv)

    def _scn_specs(self):
        from jax.sharding import PartitionSpec as P
        return [[P(self.axis_name)] * len(g.host_stacks)
                for g in self.scn_groups]

    def _lift_constants(self, state):
        """Two-block override of the base collection trace: the epoch runs
        under shard_map with the stacked-state/stacked-data specs and
        ``_scn_traced``/``_heap_traced`` bound, so scenario data and bucket
        heaps flow through their per-group/per-bucket inner ``lift_apply``
        contexts (sharded at rest) while everything else lands in the outer
        epoch lifter."""
        from jax.sharding import PartitionSpec as P

        self._setup_bucket_heaps()

        def f(state, stacked, heaps):
            self._scn_traced = stacked
            self._heap_traced = heaps or None
            try:
                return self._epoch(state)
            finally:
                self._scn_traced = None
                self._heap_traced = None

        fn = self._shard_wrap(
            f, in_specs=(self._state_spec(), self._scn_specs(),
                         self._heap_specs()),
            out_specs=(self._state_spec(), self._bv_spec(), P(), P()))
        with lift_collect() as lifter:
            jax.eval_shape(fn, state, self._scn_args,
                           getattr(self, "_heap_args", {}))
        return lifter, lifter.device_args()

    def _unstack_x(self, x: BlockVector) -> BlockVector:
        """Map stacked scenario keys back onto the original per-term
        variable names (global arrays, outside shard_map)."""
        if not self.scn_groups:
            return x
        out = BlockVector({k: v for k, v in x.items()
                           if k not in self._scn_keys})
        for g in self.scn_groups:
            W = jnp.reshape(x[g.key], (g.S, g.d))
            for rank, pv in enumerate(g.pv_names):
                out[pv] = W[rank]
        return out

    def solve(self) -> BlockVector:
        t0 = time.time()
        # iteratively-certified inner kernels (TV-1D) certify one decade
        # tighter than the outer rel_tol instead of to machine precision;
        # baked at trace time, consistent because rel_tol keys the trace
        config.set_prox_inner_tol(
            config.prox_inner_tol_for(self.params.rel_tol))
        if (self.adaptive != self.params.adaptive_rho
                or self.mesh is not self.params.mesh
                or (not self.adaptive and self.params.rho != self._init_rho)):
            # mode or fixed rho changed on a cached solver: rebuild (the
            # state pytree / prox parameterization / sqrt_rho metric differ),
            # preserving attached hooks and rescaling the warm dual
            self._rebuild_full()
        state = self._init_state()
        epoch_iters = self.params.epoch_iterations
        max_epochs = max(1, self.params.max_iterations // epoch_iters)

        from jax.sharding import PartitionSpec as P
        if self.params.drive == "device":
            key = (max_epochs, epoch_iters, self.params.rel_tol,
                   self.params.abs_tol, self.params.over_relaxation,
                   self.adaptive, self.params.rho_mu, self.params.rho_tau,
                   id(self.mesh))
            if self._compiled is None or self._compiled_key != key:
                self._compiled_key = key
                self._compiled = None
            if self._compiled is None:
                lifter, const_args = self._lift_constants(state)

                def run(state, stacked, heaps, consts, start_it):
                    self._scn_traced = stacked
                    self._heap_traced = heaps or None
                    try:
                        with lift_apply(lifter, consts):
                            def cond(carry):
                                state, x, it, res, conv, buf = carry
                                return (~conv) & (it < max_epochs * epoch_iters)

                            def body(carry):
                                state, _, it, _, _, buf = carry
                                state, x, res, conv = self._epoch(state)
                                # per-epoch residual series in a fixed-length
                                # device buffer (log_iterations observability
                                # for device drive, ≙ prox_admm.cc:219-230)
                                buf = jax.lax.dynamic_update_index_in_dim(
                                    buf, res, it // epoch_iters, 0)
                                return (state, x, it + epoch_iters, res, conv,
                                        buf)

                            # initial conv=False guarantees >= 1 epoch without
                            # duplicating the epoch body in the HLO; starting
                            # the counter at the resume step debits the
                            # checkpoint's iterations from the budget
                            dtype = config.default_dtype()
                            carry = (state, self._x_zeros(), start_it,
                                     jnp.zeros(4, dtype=dtype),
                                     jnp.asarray(False),
                                     jnp.zeros((max_epochs, 4), dtype=dtype))
                            return jax.lax.while_loop(cond, body, carry)
                    finally:
                        self._scn_traced = None
                        self._heap_traced = None

                run = jax.jit(self._shard_wrap(
                    run,
                    in_specs=(self._state_spec(), self._scn_specs(),
                              self._heap_specs(),
                              [P()] * len(const_args), P()),
                    out_specs=(self._state_spec(), self._bv_spec(),
                               P(), P(), P(), P())))
                self._compiled = (run, const_args)
            run, const_args = self._compiled
            state, start_iters = self._resume_state(state)
            state, x, iters, res, conv, series_buf = run(
                state, self._scn_args, getattr(self, "_heap_args", {}),
                const_args, jnp.asarray(start_iters))
            x = jax.block_until_ready(x)
            iters = int(iters)
            self.status.series = _series_from_buffer(
                series_buf, start_iters // epoch_iters, iters // epoch_iters)
            if self._checkpointer is not None:
                self._checkpointer.save(iters, state)
        else:
            lifter, const_args = self._lift_constants(state)

            def _epoch_raw(state, stacked, heaps, consts):
                self._scn_traced = stacked
                self._heap_traced = heaps or None
                try:
                    with lift_apply(lifter, consts):
                        return self._epoch(state)
                finally:
                    self._scn_traced = None
                    self._heap_traced = None

            _epoch_jit = jax.jit(self._shard_wrap(
                _epoch_raw,
                in_specs=(self._state_spec(), self._scn_specs(),
                          self._heap_specs(),
                          [P()] * len(const_args)),
                out_specs=(self._state_spec(), self._bv_spec(), P(), P())))

            def epoch_fn(state, _consts=const_args):
                return _epoch_jit(state, self._scn_args,
                                  getattr(self, "_heap_args", {}), _consts)
            state, iters = self._resume_state(state)
            conv = False
            x = res = None
            series = []
            while x is None or (iters < self.params.max_iterations and not conv
                                and not self._has_external_stop()):
                state, x, res, conv = epoch_fn(state)
                conv = bool(conv)
                iters += epoch_iters
                series.append(Residuals(*[float(v) for v in res]))
                if self._checkpointer is not None:
                    self._checkpointer.maybe_save(iters, state)
                if self.params.verbose and (iters % self.params.log_iterations
                                            < epoch_iters):
                    self.status.num_iterations = iters
                    self.status.residuals = series[-1]
                    logger.info(self.status.log_line())
            self.status.series = series

        self._finish(state, iters, res, conv, self._t_init, time.time() - t0)
        return self._unstack_x(x)


class ProxADMMSolver(SolverBase):
    """N-block Gauss-Seidel ADMM (``prox_admm.{h,cc}``).

    Beyond reference parity: the reference hard-requires rho == 1
    (``prox_admm.cc:51``); here any fixed rho is supported by running the
    rho = 1 sweep on the sqrt(rho)-scaled constraint system (A, b) <-
    (sqrt(rho) A, sqrt(rho) b) — the augmented-Lagrangian metric the
    reference's InitProxOperators would have built (``prox_admm.cc:45-94``)
    — with residuals converted back to unscaled units."""

    def __init__(self, problem: ProxProblem, params: SolverParams):
        super().__init__(problem, params)
        if params.adaptive_rho:
            raise ValueError("adaptive_rho is only supported by the "
                             "two-block solver (PROX_ADMM_TWO_BLOCK)")
        if params.mesh is not None:
            raise ValueError("term sharding (mesh) is only supported by the "
                             "two-block solver (PROX_ADMM_TWO_BLOCK)")
        t0 = time.time()
        self.sqrt_rho = float(np.sqrt(params.rho))
        self._init_rho = params.rho

        # Global constraint operator (prox_admm.cc:24-42), sqrt(rho)-scaled
        self.A = BlockMatrix()
        self.b = BlockVector()
        self.row_dims: Dict[str, int] = {}
        for i, con in enumerate(problem.constraints):
            if con.cone != Cone.ZERO:
                raise ValueError("ProxADMM supports ZERO cones only")
            Ai, bi = _rekey_constraint(i, con.op)
            for (r, c), op in Ai.blocks.items():
                if self.sqrt_rho != 1.0:
                    op = op.scale(self.sqrt_rho)
                self.A.insert(r, c, op)
                self.row_dims[r] = op.m
            for r, vec in bi.items():
                self.b[r] = vec if self.sqrt_rho == 1.0 else self.sqrt_rho * vec
        self.AT = self.A.T
        self.m = sum(self.row_dims.values())
        self.n = sum(problem.var_dims[c] for c in self.A.col_keys())

        # Per-term prox operators bound to the sqrt(rho)-scaled constraint
        # columns of the term's variables (prox_admm.cc:45-94)
        self._build_term_ops(problem)

        self._t_init = time.time() - t0
        self._compiled = None

    def _build_term_ops(self, problem: ProxProblem):
        self.term_ops = []
        self.AiT = []
        constr_vars = set(self.A.col_keys())
        for term in problem.terms:
            tvars = sorted({c for (_, c) in term.H.A.blocks})
            Ai = self.A.select_cols([v for v in tvars if v in constr_vars])
            op = create_prox_operator(term.spec, term.H,
                                      AffineOperator(Ai, BlockVector()))
            self.term_ops.append(op)
            self.AiT.append(Ai.T)

    def _rebuild_operators(self, problem: ProxProblem):
        self._build_term_ops(problem)

    # -- iteration (traceable) ---------------------------------------------
    def _sweep(self, state):
        """One Gauss-Seidel sweep (prox_admm.cc:134-148)."""
        u, ys = state
        u = u - self.b.to_device()
        for y in ys:
            u = u - y
        xs = []
        new_ys = []
        for i, op in enumerate(self.term_ops):
            u = u + ys[i]
            x = op.apply(u)
            y = self.A.apply(x)
            # pad to the full constraint row space: terms touching different
            # constraint rows must still carry a stable pytree through the
            # jitted epoch loop
            y = BlockVector({k: y.get(k, n)
                             for k, n in self.row_dims.items()})
            u = u - y
            xs.append(x)
            new_ys.append(y)
        return (u, tuple(new_ys)), tuple(xs)

    def _residuals(self, state, xs, ys_prev):
        """Residuals in UNSCALED units (``prox_admm.cc:178-217``).  The loop
        runs on the sqrt(rho)-scaled system (A_bar = sqrt(rho) A), so:
        primal quantities divide by sqrt(rho); the dual residual
        rho*||A_i' sum dy|| equals ||A_bar_i' dy_bar|| directly (two factors
        of sqrt(rho)); and rho*||A' u_true|| = ||A_bar' u_bar|| since the
        scaled-system dual u_bar carries lambda/sqrt(rho)."""
        u, ys = state
        abs_tol, rel_tol = self.params.abs_tol, self.params.rel_tol
        inv_sqrt_rho = 1.0 / self.sqrt_rho
        N = len(self.term_ops)

        b_dev = self.b.to_device()
        Ax_b = b_dev
        max_norm = b_dev.norm()
        for x in xs:
            Ai_xi = self.A.apply(x)
            max_norm = jnp.maximum(max_norm, Ai_xi.norm())
            Ax_b = Ax_b + Ai_xi
        r_norm = Ax_b.norm() * inv_sqrt_rho
        max_norm = max_norm * inv_sqrt_rho

        s_sq = jnp.asarray(0.0, dtype=config.default_dtype())
        Ax_diff = BlockVector()
        for i in range(N - 2, -1, -1):
            Ax_diff = Ax_diff + (ys[i + 1] - ys_prev[i + 1])
            s_i = self.AiT[i].apply(Ax_diff).norm()
            s_sq = s_sq + s_i * s_i
        s_norm = jnp.sqrt(s_sq)

        eps_p = abs_tol * float(np.sqrt(max(self.m, 1))) + rel_tol * max_norm
        eps_d = (abs_tol * float(np.sqrt(max(self.n, 1)))
                 + rel_tol * self.AT.apply(u).norm())
        return jnp.stack([r_norm, s_norm, eps_p, eps_d])

    def _xs_zeros(self):
        out = []
        for op, term in zip(self.term_ops, self.problem.terms):
            tvars = sorted({c for (_, c) in term.H.A.blocks})
            out.append(_zeros({v: self.problem.var_dims[v] for v in tvars}))
        return tuple(out)

    def _epoch(self, state):
        # dual residual from the FINAL sweep's y deltas (reference snapshots
        # y_prev_ per iteration, ``prox_admm.cc:135,196-201``)
        def body(_, carry):
            st, _xs, _yp = carry
            yp = st[1]
            st, xs = self._sweep(st)
            return st, xs, yp

        state, xs, ys_prev = jax.lax.fori_loop(
            0, self.params.epoch_iterations, body,
            (state, self._xs_zeros(), state[1]))
        res = self._residuals(state, xs, ys_prev)
        conv = (res[0] <= res[2]) & (res[1] <= res[3])
        return state, xs, res, conv

    def _init_state(self):
        if self.params.warm_start and self._warm_state is not None:
            return self._warm_state
        dtype = config.default_dtype()
        u = BlockVector({k: jnp.zeros(n, dtype=dtype)
                         for k, n in self.row_dims.items()})
        ys = tuple(BlockVector({k: jnp.zeros(n, dtype=dtype)
                                for k, n in self.row_dims.items()})
                   for _ in self.term_ops)
        return (u, ys)

    def _migrate_warm_state(self, old_state, old_rho, old_adaptive):
        if old_state is None:
            return None
        # Scaled system: u_bar = lambda/sqrt(rho), ys = sqrt(rho)*A*x.
        # Preserve lambda and x across the rho change.
        s = float(np.sqrt(old_rho / self._init_rho))
        u, ys = old_state
        return (s * u, tuple((1.0 / s) * y for y in ys))

    def solve(self) -> BlockVector:
        t0 = time.time()
        config.set_prox_inner_tol(
            config.prox_inner_tol_for(self.params.rel_tol))
        if self.params.rho != self._init_rho:
            # rho is baked into the scaled constraint system and the cached
            # KKT factorizations: rebuild (the cached-solver analogue of the
            # reference rejecting rho != 1 outright), preserving attached
            # hooks and rescaling the warm state onto the new metric
            self._rebuild_full()
        state = self._init_state()
        epoch_iters = self.params.epoch_iterations
        max_epochs = max(1, self.params.max_iterations // epoch_iters)

        if self.params.drive == "device":
            if self._compiled is None or self._compiled_key != (
                    max_epochs, epoch_iters, self.params.rel_tol,
                    self.params.abs_tol, self._init_rho):
                self._compiled_key = (max_epochs, epoch_iters,
                                      self.params.rel_tol, self.params.abs_tol,
                                      self._init_rho)
                self._compiled = None
            if self._compiled is None:
                lifter, const_args = self._lift_constants(state)

                @jax.jit
                def run(state, consts, start_it):
                    with lift_apply(lifter, consts):
                        def cond(carry):
                            state, xs, it, res, conv, buf = carry
                            return (~conv) & (it < max_epochs * epoch_iters)

                        def body(carry):
                            state, _, it, _, _, buf = carry
                            state, xs, res, conv = self._epoch(state)
                            buf = jax.lax.dynamic_update_index_in_dim(
                                buf, res, it // epoch_iters, 0)
                            return (state, xs, it + epoch_iters, res, conv,
                                    buf)

                        dtype = config.default_dtype()
                        carry = (state, self._xs_zeros(), start_it,
                                 jnp.zeros(4, dtype=dtype),
                                 jnp.asarray(False),
                                 jnp.zeros((max_epochs, 4), dtype=dtype))
                        return jax.lax.while_loop(cond, body, carry)

                self._compiled = (run, const_args)
            run, const_args = self._compiled
            state, start_iters = self._resume_state(state)
            state, xs, iters, res, conv, series_buf = run(
                state, const_args, jnp.asarray(start_iters))
            xs = jax.block_until_ready(xs)
            iters = int(iters)
            self.status.series = _series_from_buffer(
                series_buf, start_iters // epoch_iters, iters // epoch_iters)
            if self._checkpointer is not None:
                self._checkpointer.save(iters, state)
        else:
            lifter, const_args = self._lift_constants(state)

            def epoch_fn(state, _consts=const_args):
                return _epoch_jit(state, _consts)

            @jax.jit
            def _epoch_jit(state, consts):
                with lift_apply(lifter, consts):
                    return self._epoch(state)
            state, iters = self._resume_state(state)
            conv = False
            xs = res = None
            series = []
            while xs is None or (iters < self.params.max_iterations
                                 and not conv
                                 and not self._has_external_stop()):
                state, xs, res, conv = epoch_fn(state)
                conv = bool(conv)
                iters += epoch_iters
                series.append(Residuals(*[float(v) for v in res]))
                if self._checkpointer is not None:
                    self._checkpointer.maybe_save(iters, state)
                if self.params.verbose and (iters % self.params.log_iterations
                                            < epoch_iters):
                    self.status.num_iterations = iters
                    self.status.residuals = series[-1]
                    logger.info(self.status.log_line())
            self.status.series = series

        self._finish(state, iters, res, conv, self._t_init, time.time() - t0)
        # solution = sum_i x_i (prox_admm.cc:171-176)
        out = BlockVector()
        for x in xs:
            out = out + x
        return out


def create_solver(problem: ProxProblem, params: SolverParams):
    from .params import SolverKind
    if params.solver == SolverKind.PROX_ADMM:
        if params.mesh is not None or params.adaptive_rho:
            # The Gauss-Seidel sweep is inherently sequential — each term's
            # prox consumes the previous term's update (prox_admm.cc:141-148)
            # — so it cannot shard over terms, and its cached factorizations
            # bake in rho.  Scaling story: rewrite to the mathematically-
            # equivalent two-block consensus splitting of the SAME
            # prox-affine problem (prox_admm_two_block.h:15-25), whose
            # x-updates are embarrassingly parallel (term buckets over the
            # mesh, psum-combined) and whose proxes are rho-parameterized.
            return ProxADMMTwoBlockSolver(problem, params)
        return ProxADMMSolver(problem, params)
    return ProxADMMTwoBlockSolver(problem, params)
