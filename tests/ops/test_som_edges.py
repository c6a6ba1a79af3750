"""SOM engine edge cases: wide shapes, init variants, schedule knobs,
and the native watershed's degenerate inputs."""

import numpy as np
import pytest

import jax.numpy as jnp

from ark_tpu.ops import som as som_ops
from ark_tpu.ops import watershed as ws


def test_som_map_empty_and_single_row(rng):
    w = rng.random((100, 4)).astype(np.float32)
    clusters, dists = som_ops.som_map(w, np.empty((0, 4), np.float32))
    assert clusters.shape == (0,)
    one = rng.random((1, 4)).astype(np.float32)
    clusters, dists = som_ops.som_map(w, one)
    assert clusters.shape == (1,) and 1 <= clusters[0] <= 100
    # exact: the nearest row by brute force
    want = np.argmin(((one - w) ** 2).sum(1)) + 1
    assert clusters[0] == want


@pytest.mark.parametrize("k,c", [(30, 130), (200, 8)])
def test_bmu_wide_shapes_match_numpy(rng, k, c):
    """More than 128 nodes or channels: exact argmin against numpy."""
    data = rng.random((64, c)).astype(np.float32)
    w = rng.random((k, c)).astype(np.float32)
    idx, dist = som_ops.bmu_xla(jnp.asarray(w), jnp.asarray(data))
    d_np = ((data[:, None, :].astype(np.float64) - w[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(idx), d_np.argmin(1))
    np.testing.assert_allclose(np.asarray(dist), d_np.min(1), rtol=1e-4)


def test_som_train_weights_init_and_empty(rng):
    data = rng.random((500, 3)).astype(np.float32)
    w0 = rng.random((25, 3)).astype(np.float32)
    w = som_ops.som_train(data, xdim=5, ydim=5, seed=0, weights_init=w0)
    assert w.shape == (25, 3)
    assert not np.allclose(w, w0)          # training moved the codes
    with pytest.raises(ValueError, match="empty"):
        som_ops.som_train(np.empty((0, 3), np.float32))


def test_som_train_device_resident_input_matches_host(rng):
    data = rng.random((800, 4)).astype(np.float32)
    w_host = som_ops.som_train(data, xdim=4, ydim=4, seed=3)
    w_dev = som_ops.som_train(jnp.asarray(data), xdim=4, ydim=4, seed=3)
    np.testing.assert_allclose(w_host, w_dev, rtol=1e-5, atol=1e-6)


def test_som_train_num_passes_and_batch_override(rng):
    # num_passes scales the per-update batch (total visits = 256*bs): at
    # tiny n the floor bs=8 already over-visits (256*8 > 3*600), so passes
    # only differentiate once total/256 clears the floor
    data = rng.random((20000, 4)).astype(np.float32)
    w1 = som_ops.som_train(data, xdim=4, ydim=4, seed=0, num_passes=1)
    w3 = som_ops.som_train(data, xdim=4, ydim=4, seed=0, num_passes=3)
    assert not np.allclose(w1, w3)          # more passes -> different weights
    data = rng.random((600, 4)).astype(np.float32)
    # explicit batch_size override is honored (pow2-rounded) and still trains
    w_bs = som_ops.som_train(data, xdim=4, ydim=4, seed=0, batch_size=32)
    _, d = som_ops.som_map(w_bs, data, return_dist=True)
    _, d1 = som_ops.som_map(w1, data, return_dist=True)
    assert np.mean(np.asarray(d)) < 3 * np.mean(np.asarray(d1)) + 1e-6


def test_schedule_batch_bounds():
    assert som_ops._schedule_batch(100, None) == 8        # floor
    assert som_ops._schedule_batch(10**9, None) == 1 << 16  # cap
    assert som_ops._schedule_batch(256 * 512, None) == 512
    assert som_ops._schedule_batch(1000, 48) == 64        # pow2-rounded
    assert som_ops._schedule_batch(1000, 2) == 8          # clamped up


def test_grid_distance_properties():
    g = som_ops.grid_distances(10, 10)
    assert g.shape == (100, 100)
    assert np.allclose(np.diag(g), 0)
    np.testing.assert_allclose(g, g.T)
    # neighbors on the grid are at distance 1
    coords = som_ops.grid_coordinates(10, 10)
    i, j = 0, 1
    assert g[i, j] == pytest.approx(np.linalg.norm(coords[i] - coords[j]))
    r = som_ops.default_radius_start(10, 10)
    assert 0 < r < g.max()


def test_watershed_degenerate_inputs():
    img = np.zeros((8, 8), np.float32)
    markers = np.zeros((8, 8), np.int32)
    out = ws.watershed(img, markers)            # no markers -> all zero
    assert (out == 0).all()
    mask = np.zeros((8, 8), bool)
    markers[2, 2] = 1
    out2 = ws.watershed(img, markers, mask)     # empty mask -> nothing floods
    assert (out2 == 0).all()
    # single-pixel mask: only the marker labels
    mask[2, 2] = True
    out3 = ws.watershed(img, markers, mask)
    assert out3[2, 2] == 1 and out3.sum() == 1


def test_label_components_degenerate():
    empty = ws.label_components(np.zeros((5, 5), bool))
    assert (empty == 0).all()
    full = ws.label_components(np.ones((5, 5), bool))
    assert (full == 1).all()
    # diagonal pixels are NOT 4-connected
    diag = np.eye(4, dtype=bool)
    out = ws.label_components(diag)
    assert out.max() == 4


def test_som_train_sharded_uneven_and_tiny_inputs(rng):
    """The sharded trainer must accept row counts that don't divide the
    mesh (padding path) and datasets smaller than the device count."""
    import jax
    from ark_tpu.parallel.mesh import get_mesh
    mesh = get_mesh()
    for n, c in [(1001, 16), (5, 16), (3, 16), (17, 3)]:
        x = rng.random((n, c)).astype(np.float32)
        w = som_ops.som_train_sharded(x, mesh, num_passes=1, seed=1)
        w = np.asarray(w)
        assert w.shape == (100, c)
        assert np.isfinite(w).all(), (n, c)
        # trained weights must live inside the data's bounding box (batch
        # Kohonen updates are convex combinations of data rows)
        assert w.min() >= x.min() - 1e-5 and w.max() <= x.max() + 1e-5


def test_som_train_rejects_non_2d_input(rng):
    with pytest.raises(ValueError, match="2-D"):
        som_ops.som_train(rng.random(100).astype(np.float32))
    with pytest.raises(ValueError, match="2-D"):
        som_ops.som_train_and_map(
            rng.random((4, 4, 4)).astype(np.float32))


def test_som_train_sharded_multi_axis_mesh_visits_all_data(rng):
    """On a multi-axis mesh, shard_map splits rows over the DATA axis only
    — sizing the per-device orders by mesh.devices.size left half of every
    shard's rows unvisited (a planted cluster confined there never reached
    the weights)."""
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, axis_names=("fov", "m"))
    # planted far-away cluster in rows that land on ODD logical 8-shards
    n, c = 800, 8
    x = rng.random((n, c)).astype(np.float32)
    shard = np.arange(n) * 8 // n
    x[shard % 2 == 1] += 50.0
    w = np.asarray(som_ops.som_train_sharded(x, mesh, data_axis="fov",
                                             num_passes=1, seed=1))
    assert w.max() > 40.0, (
        "planted cluster never visited: per-device orders sized by the "
        "full mesh instead of the data axis")
    assert np.isfinite(w).all()
