"""Multi-host runtime glue.

The reference has no distributed backend (SURVEY §2.4); the replacement
here is the JAX multi-controller runtime: every host calls
:func:`initialize_distributed`, after which ``jax.devices()`` spans every
host's devices and the consensus solvers' ``psum`` reductions run as NCCL
collectives across them.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_distributed"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op when running single-process."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
