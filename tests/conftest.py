"""Test-suite configuration.

Tests run on the CPU with 8 virtual XLA devices, so sharded (pjit/shard_map)
code paths execute on one host and every worker sees the same devices (the
env vars must be set before JAX is imported anywhere). Numerics funnel
through the same jitted code the GPU runs. Tests that need a GPU carry the
`gpu` marker and skip here (see the `gpu_device` fixture); on a GPU host,
`pytest -m gpu` runs only those, with the platforms the environment names.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return
    # jax may have been imported before this file ran (a site hook, a
    # plugin) with another platform baked into its config: force the CPU
    # regardless, for this process and the subprocesses tests start
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture()
def rng():
    """Per-test seeded RNG so each test draws a deterministic stream
    regardless of execution order (the reference seeds default_rng(12345)
    once per session; a shared stream makes tests order-dependent)."""
    return np.random.default_rng(12345)


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(24)


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip. Decided here, at run time, never while a
    test module is imported: xdist workers must all collect the same
    tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run with `pytest -m gpu` on a GPU host)")
    return gpus[0]
