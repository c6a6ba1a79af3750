"""Guards for the hooks in `__graft_entry__.py`: `dryrun_multichip` must run
on a virtual CPU mesh whatever accelerator the environment names.

The FULL dry run (8-device Mesmer train step + sharded SOM) takes over a
minute on a small host, so the suite checks entry() end-to-end plus the
device-forcing logic, and leaves the complete dryrun to
`.claude/skills/verify`."""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import __graft_entry__ as graft


def test_entry_returns_jittable_forward():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    dist, pix = out
    assert dist.shape == (1, 128, 128, 1)
    assert pix.shape[:3] == (1, 128, 128)
    assert np.isfinite(np.asarray(dist)).all()
    # pixelwise head is a probability distribution over classes
    sums = np.asarray(pix).sum(axis=-1)
    np.testing.assert_allclose(sums, 1.0, atol=1e-4)


def test_entry_is_retraceable_with_new_shapes():
    fn, (variables, _) = graft.entry()
    import jax.numpy as jnp
    x = jnp.ones((2, 64, 64, 2), jnp.float32)
    dist, pix = jax.jit(fn)(variables, x)
    assert dist.shape == (2, 64, 64, 1)


def test_ensure_cpu_devices_never_touches_an_accelerator():
    """Under the test conftest the CPU client already has 8 devices; the
    helper must return exactly n CPU devices and never raise."""
    devices = graft._ensure_cpu_devices(8)
    assert devices is not None and len(devices) == 8
    assert all(d.platform == "cpu" for d in devices)


def test_ensure_cpu_devices_reports_insufficient_client():
    """Asking for more devices than the initialized CPU client can offer
    must return None (triggering the subprocess fallback), not crash."""
    assert graft._ensure_cpu_devices(4096) is None
