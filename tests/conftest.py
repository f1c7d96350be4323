"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is validated
without accelerators) with x64 enabled so numerical oracles match the
reference's float64 accuracy envelope (the reference C++ core is float64
throughout).  Must run before anything imports jax.

Tests marked ``gpu`` need the card: the ``gpu`` fixture skips them unless
JAX's default backend is a GPU, which it is only when the run sets
EPSILON_TPU_TEST_PLATFORM=gpu (``chip_smoke.py`` does, on the card).
"""

import os

_PLATFORM = os.environ.get("EPSILON_TPU_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
# Apply-mode constant-lifting misses are hard errors under test: an operator
# creating fresh host buffers at trace time would otherwise silently embed
# problem data as jit constants (and serve stale data after update_problem).
os.environ.setdefault("EPSILON_TPU_STRICT_LIFTING", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided here, at run
    time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with EPSILON_TPU_TEST_PLATFORM=gpu "
                    "on the card (python chip_smoke.py does)")
    return jax.devices()[0]
