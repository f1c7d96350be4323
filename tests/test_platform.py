"""Platform handling: the capability table, the compile cache location and
backend-free imports (``epsilon_tpu/config.py``)."""

import os
import subprocess
import sys

import jax
import pytest

from epsilon_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_capability_rows(platform):
    row = config.capabilities(platform)
    assert row is config.CAPABILITIES[platform]
    on_gpu = platform == "gpu"
    assert row.explicit_inverse is on_gpu
    assert row.device_algebra is on_gpu
    assert row.device_features is on_gpu
    assert row.debug_callbacks is not on_gpu


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_is_an_error(platform):
    with pytest.raises(RuntimeError, match="no capability row"):
        config.capabilities(platform)


def test_default_row_follows_default_backend():
    assert config.capabilities() is config.CAPABILITIES[jax.default_backend()]


@pytest.mark.parametrize("mode,platform,expect", [
    ("auto", "cpu", False), ("auto", "gpu", True),
    ("inverse", "cpu", True), ("triangular", "gpu", False)])
def test_explicit_inverse_mode(monkeypatch, mode, platform, expect):
    monkeypatch.setattr(config, "FACTOR_SOLVE_MODE", mode)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert config.use_explicit_inverse() is expect


@pytest.mark.parametrize("env,platform,expect", [
    (None, "cpu", True), (None, "gpu", False), ("0", "cpu", False),
    ("1", "gpu", True)])
def test_tv_warn_follows_table_and_override(monkeypatch, env, platform,
                                            expect):
    if env is None:
        monkeypatch.delenv("EPSILON_TPU_TV_WARN", raising=False)
    else:
        monkeypatch.setenv("EPSILON_TPU_TV_WARN", env)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert config.tv_warn_enabled() is expect


def test_mnist_device_features_follow_table(monkeypatch):
    from epsilon_tpu.problems import mnist
    seen = []
    monkeypatch.setattr(mnist, "kitchen_sink_features",
                        lambda X, n, device=False: seen.append(device)
                        or mnist.np.zeros((X.shape[0], n)))
    mnist.create(m=10, n=4, k=3)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    mnist.create(m=10, n=4, k=3)             # too small to generate on device
    mnist.create(m=10_000, n=1_000, k=3)
    assert seen == [False, False, True]


def test_compile_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert config.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])


def test_import_opens_no_backend():
    """Importing the package and its entry modules initialises no JAX
    backend, so a parent process (``benchmark --isolate``) can stay off the
    card while its children use it."""
    code = (
        "import epsilon_tpu, epsilon_tpu.problems.benchmark, chip_smoke\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, xla_bridge._backends\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
