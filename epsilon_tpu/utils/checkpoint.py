"""Solver-state checkpoint/resume (elastic recovery).

The reference has no on-disk checkpointing — only in-memory warm-start
caches (``solvemodule.cc:142-155``, ``prox_admm.cc:115-120``).  For
long-running / preemptible accelerator jobs this module adds durable checkpoints of
the ADMM loop state (the ``(z, u[, rho])`` / ``(u, ys)`` pytrees) via orbax,
so a killed solve resumes from the last saved epoch instead of iteration 0.

Usage::

    ckpt = SolverCheckpointer("/path/dir", every_epochs=50)
    solver.attach_checkpointer(ckpt)      # host drive saves periodically
    solver.solve()                        # resumes automatically if a
                                          # checkpoint exists

Checkpoints are whole-state atomic (orbax handles tmp-dir renames); ``keep``
bounds retention.  Works for any solver state pytree — BlockVector leaves
flatten to plain arrays.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import jax
import numpy as np

__all__ = ["SolverCheckpointer"]

logger = logging.getLogger("epsilon_tpu")


def _state_fingerprint(state) -> np.ndarray:
    """Identity of the problem behind a solver state: the pytree structure
    (which for BlockVector leaves includes the variable/constraint key names)
    plus every leaf shape+dtype, hashed.  Rejects resuming a checkpoint from
    a *different* problem that happens to have identically-shaped leaves."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    desc = repr(treedef) + "|" + "|".join(
        f"{np.shape(l)}:{np.asarray(l).dtype}" for l in leaves)
    digest = hashlib.sha256(desc.encode()).digest()
    return np.frombuffer(digest, dtype=np.uint8).copy()


class SolverCheckpointer:
    """Periodic orbax checkpointing of a solver's loop state."""

    def __init__(self, directory: str, every_epochs: int = 10,
                 keep: int = 2):
        import orbax.checkpoint as ocp
        self.directory = os.path.abspath(directory)
        self.every_epochs = every_epochs
        self._count = 0
        self._mgr = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(max_to_keep=keep,
                                                 create=True))

    # -- saving --------------------------------------------------------------
    def maybe_save(self, step: int, state) -> bool:
        """Save if an ``every_epochs`` boundary was crossed; returns whether
        a save happened.  ``step`` is the solver's iteration count."""
        self._count += 1
        if self._count % self.every_epochs:
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state) -> None:
        import orbax.checkpoint as ocp
        leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(state)]
        payload = {"leaves": leaves, "fingerprint": _state_fingerprint(state)}
        self._mgr.save(step, args=ocp.args.StandardSave(payload))
        self._mgr.wait_until_finished()

    # -- restoring -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore(self, like_state):
        """Restore the latest checkpoint into the structure of
        ``like_state`` (a freshly-initialized solver state).  Returns
        ``(state, step)`` or ``(None, 0)`` when no checkpoint exists or the
        stored leaves don't match the state structure (e.g. the problem
        changed shape — start fresh rather than resume wrongly)."""
        import orbax.checkpoint as ocp
        step = self._mgr.latest_step()
        if step is None:
            return None, 0
        like_leaves, treedef = jax.tree_util.tree_flatten(like_state)
        fp = _state_fingerprint(like_state)
        template = {"leaves": [np.asarray(l) for l in like_leaves],
                    "fingerprint": fp}
        try:
            out = self._mgr.restore(
                step, args=ocp.args.StandardRestore(template))
        except Exception as e:  # orbax raises on structural mismatch too
            logger.warning(
                "checkpoint restore from %s step %s failed (%s: %s); "
                "starting from iteration 0", self.directory, step,
                type(e).__name__, e)
            return None, 0
        if not np.array_equal(np.asarray(out.get("fingerprint")), fp):
            logger.warning(
                "checkpoint at %s step %s belongs to a different problem "
                "(state fingerprint mismatch); starting from iteration 0",
                self.directory, step)
            return None, 0
        leaves = out["leaves"]
        if len(leaves) != len(like_leaves) or any(
                np.shape(a) != np.shape(b)
                for a, b in zip(leaves, like_leaves)):
            logger.warning(
                "checkpoint at %s step %s has mismatched leaf shapes; "
                "starting from iteration 0", self.directory, step)
            return None, 0
        import jax.numpy as jnp
        dtyped = [jnp.asarray(a, dtype=np.asarray(b).dtype)
                  for a, b in zip(leaves, like_leaves)]
        return jax.tree_util.tree_unflatten(treedef, dtyped), int(step)

    def close(self):
        self._mgr.close()
