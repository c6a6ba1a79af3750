import numpy as np
import pytest

import jax

from ark_tpu.ops import som as som_ops
from ark_tpu.parallel import cohort, mesh as mesh_utils
from ark_tpu.parallel.prefetch import PrefetchLoader

from tests import test_utils


def test_get_mesh_and_sharding():
    mesh = mesh_utils.get_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices
    sharding = mesh_utils.fov_sharding(mesh)
    assert sharding.spec == jax.sharding.PartitionSpec("fov")


def test_map_over_fovs_pads_and_shards(rng):
    mesh = mesh_utils.get_mesh()
    batch = rng.random((5, 16, 16)).astype(np.float32)  # 5 not divisible by 8

    def per_fov(img):
        return img.sum()

    out = cohort.map_over_fovs(per_fov, batch, mesh)
    assert out.shape == (5,)
    np.testing.assert_allclose(out, batch.sum(axis=(1, 2)), rtol=1e-4)


def test_run_pixel_cohort_matches_serial(rng):
    mesh = mesh_utils.get_mesh()
    fovs = rng.random((3, 32, 32, 4)).astype(np.float32)
    channel_norms = np.full(4, 0.9, np.float32)
    post_norms = np.full(4, 0.8, np.float32)
    weights = rng.random((100, 4)).astype(np.float32)
    out = cohort.run_pixel_cohort(fovs, channel_norms, 0.05, post_norms,
                                  weights, mesh=mesh)
    assert out["pixel_mat"].shape == (3, 32 * 32, 4)
    assert out["som_clusters"].shape == (3, 32 * 32)
    # spot check one FOV against the serial pipeline
    from ark_tpu.ops import image_filters
    import jax.numpy as jnp
    x = fovs[0] / channel_norms
    x = np.asarray(image_filters.gaussian_blur(jnp.asarray(x), sigma=2))
    mat = x.reshape(-1, 4)
    rowsums = mat.sum(1)
    valid = (rowsums > 0.05) & (mat != 0).any(1)
    norm = mat / np.where(rowsums == 0, 1, rowsums)[:, None] / post_norms
    clusters, _ = som_ops.som_map(weights, norm)
    expected = np.where(valid, clusters, 0)
    np.testing.assert_array_equal(out["som_clusters"][0], expected)
    # valid rows rowsum to 1 before post-norm; after post-norm still positive
    assert out["valid"][0].sum() > 0


def test_cohort_channel_percentiles(rng):
    mesh = mesh_utils.get_mesh()
    fovs = rng.random((4, 16, 16, 3)).astype(np.float32)
    fovs[fovs < 0.2] = 0
    got = cohort.cohort_channel_percentiles(fovs, 0.99, mesh=mesh)
    expected = np.mean([
        [np.quantile(fovs[i, :, :, c][fovs[i, :, :, c] > 0], 0.99)
         for c in range(3)] for i in range(4)], axis=0)
    np.testing.assert_allclose(got, expected, rtol=1e-4)


def test_prefetch_loader(rng):
    items = list(range(10))
    loaded = []

    def load(i):
        return np.full((4,), i, np.float32)

    out = list(PrefetchLoader(items, load, buffer_size=3))
    assert [i for i, _ in out] == items
    for i, arr in out:
        assert (arr == i).all()


def test_prefetch_loader_propagates_errors():
    def load(i):
        if i == 2:
            raise RuntimeError("corrupt file")
        return i

    loader = PrefetchLoader([0, 1, 2, 3], load, buffer_size=2)
    with pytest.raises(RuntimeError, match="corrupt file"):
        list(loader)


# ---------------------------------------------------------------------------
# Round-2: sharded-vs-serial numerical equivalence + edge shapes
# ---------------------------------------------------------------------------

def test_run_pixel_cohort_equals_host_oracle(rng):
    """The fused sharded pipeline == an explicit scipy/NumPy re-derivation
    (blur -> threshold -> rownorm -> post-norm -> brute-force BMU)."""
    import scipy.ndimage as ndi

    b, h, w, c = 3, 16, 16, 4
    imgs = rng.random((b, h, w, c)).astype(np.float32)
    channel_norms = rng.uniform(0.5, 1.5, c).astype(np.float32)
    post_norms = rng.uniform(0.5, 1.5, c).astype(np.float32)
    weights = rng.random((25, c)).astype(np.float32)
    thresh = 1.0

    out = cohort.run_pixel_cohort(imgs, channel_norms, thresh, post_norms,
                                  weights, mesh=mesh_utils.get_mesh())
    for i in range(b):
        x = imgs[i] / channel_norms
        x = np.stack([ndi.gaussian_filter(x[..., k], 2) for k in range(c)],
                     axis=-1)
        mat = x.reshape(-1, c)
        rowsums = mat.sum(1)
        valid = (rowsums > thresh) & (mat != 0).any(1)
        norm = mat / np.where(rowsums == 0, 1.0, rowsums)[:, None]
        norm = norm / post_norms
        np.testing.assert_array_equal(out["valid"][i], valid)
        np.testing.assert_allclose(out["pixel_mat"][i], norm, rtol=2e-3,
                                   atol=2e-5)
        d = ((norm[:, None, :] - weights[None]) ** 2).sum(-1)
        bmu = d.argmin(1) + 1
        got = out["som_clusters"][i]
        agree = (got[valid] == bmu[valid]).mean()
        assert agree > 0.999  # f32 matmul-vs-direct distance tie-offs only
        assert (got[~valid] == 0).all()


def test_map_over_fovs_single_fov_and_exact_multiple(rng):
    mesh = mesh_utils.get_mesh()
    n_dev = mesh.devices.size

    def double(x):
        return x * 2.0

    one = rng.random((1, 4, 4)).astype(np.float32)
    out = cohort.map_over_fovs(double, one, mesh)
    np.testing.assert_allclose(out, one * 2)

    exact = rng.random((n_dev * 2, 4, 4)).astype(np.float32)
    out2 = cohort.map_over_fovs(double, exact, mesh)
    assert out2.shape == exact.shape
    np.testing.assert_allclose(out2, exact * 2)


def test_map_over_fovs_pytree_outputs(rng):
    mesh = mesh_utils.get_mesh()

    def stats(x):
        return {"mean": x.mean(), "max": x.max()}

    batch = rng.random((5, 8, 8)).astype(np.float32)
    out = cohort.map_over_fovs(stats, batch, mesh)
    np.testing.assert_allclose(out["mean"], batch.mean(axis=(1, 2)),
                               rtol=1e-5)
    np.testing.assert_allclose(out["max"], batch.max(axis=(1, 2)))


def test_cohort_channel_percentiles_matches_numpy(rng):
    imgs = rng.random((4, 12, 12, 3)).astype(np.float32)
    imgs[imgs < 0.2] = 0.0   # real zeros to exercise the nonzero masking
    got = cohort.cohort_channel_percentiles(imgs, 0.9,
                                            mesh=mesh_utils.get_mesh())
    want = []
    for i in range(4):
        flat = imgs[i].reshape(-1, 3)
        want.append([np.quantile(flat[:, k][flat[:, k] > 0], 0.9)
                     for k in range(3)])
    np.testing.assert_allclose(got, np.mean(want, axis=0), rtol=1e-4)


def test_run_pixel_cohort_does_not_retrace_per_call(rng):
    """Cohort batches of the same shape must reuse one compiled program
    (a per-call jit(vmap(closure)) would retrace and compile every
    batch)."""
    from ark_tpu.parallel import cohort
    batch = rng.random((8, 16, 16, 3)).astype(np.float32)
    norms = np.ones(3, np.float32)
    post = np.ones(3, np.float32)
    w = rng.random((100, 3)).astype(np.float32)
    mesh = mesh_utils.get_mesh()
    cohort.run_pixel_cohort(batch, norms, 0.05, post, w, mesh=mesh)
    before = cohort._pixel_cohort_program._cache_size()
    cohort.run_pixel_cohort(batch * 1.5, norms, 0.05, post, w, mesh=mesh)
    assert cohort._pixel_cohort_program._cache_size() == before
    cohort.cohort_channel_percentiles(batch, 0.99, mesh=mesh)
    b2 = cohort._percentile_program._cache_size()
    cohort.cohort_channel_percentiles(batch * 2.0, 0.99, mesh=mesh)
    assert cohort._percentile_program._cache_size() == b2
