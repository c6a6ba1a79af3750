import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ark_tpu.ops import som


def _clustered_data(rng, n_per=500, c=6, n_clusters=4, spread=0.05):
    centers = rng.uniform(0.2, 1.0, size=(n_clusters, c))
    data = np.concatenate([
        centers[i] + rng.normal(0, spread, size=(n_per, c))
        for i in range(n_clusters)
    ]).astype(np.float32)
    labels = np.repeat(np.arange(n_clusters), n_per)
    return data, labels


def test_bmu_xla_matches_numpy(rng):
    data = rng.random((200, 7)).astype(np.float32)
    w = rng.random((100, 7)).astype(np.float32)
    idx, dist = som.bmu_xla(jnp.asarray(w), jnp.asarray(data))
    d_np = ((data[:, None, :] - w[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(idx), d_np.argmin(1))
    np.testing.assert_allclose(np.asarray(dist), d_np.min(1), rtol=1e-4, atol=1e-4)


def test_som_map_async_matches_som_map(rng):
    """The dispatch-only mapping is the same executable as `som_map`."""
    data = rng.random((300, 10)).astype(np.float32)
    w = rng.random((100, 10)).astype(np.float32)
    idx = np.asarray(som.som_map_async(w, data))
    clusters, _ = som.som_map(w, data, return_dist=False)
    np.testing.assert_array_equal(idx + 1, clusters)
    clusters_d, dist = som.som_map(w, data)
    np.testing.assert_array_equal(clusters_d, clusters)
    assert dist.shape == (300,)


def test_som_map_one_indexed(rng):
    data = rng.random((50, 4)).astype(np.float32)
    w = rng.random((100, 4)).astype(np.float32)
    clusters, dists = som.som_map(w, data)
    assert clusters.min() >= 1 and clusters.max() <= 100
    assert dists.shape == (50,)
    # empty input -> empty output (cluster_helpers.py:159-161 contract)
    c0, d0 = som.som_map(w, np.empty((0, 4)))
    assert c0.size == 0


def test_som_train_separates_clusters(rng):
    data, labels = _clustered_data(rng)
    w = som.som_train(data, xdim=10, ydim=10, num_passes=3, seed=42,
                      batch_size=256)
    assert w.shape == (100, 6)
    assert np.isfinite(w).all()
    clusters, _ = som.som_map(w, data)
    # purity: each true cluster should map to a dominant SOM-node set disjoint
    # from other true clusters' dominant nodes
    node_sets = []
    for i in range(4):
        nodes, counts = np.unique(clusters[labels == i], return_counts=True)
        node_sets.append(set(nodes[counts > counts.sum() * 0.05]))
    for i in range(4):
        for j in range(i + 1, 4):
            assert not (node_sets[i] & node_sets[j]), (i, j)


def test_som_train_deterministic(rng):
    data, _ = _clustered_data(rng, n_per=100)
    w1 = som.som_train(data, seed=42, batch_size=128)
    w2 = som.som_train(data, seed=42, batch_size=128)
    np.testing.assert_array_equal(w1, w2)
    w3 = som.som_train(data, seed=43, batch_size=128)
    assert not np.array_equal(w1, w3)


def test_som_train_quantization_error_improves(rng):
    data, _ = _clustered_data(rng, n_per=300)
    key = jax.random.PRNGKey(0)
    w_rand = np.asarray(jax.random.uniform(key, (100, 6)))
    _, d_rand = som.som_map(w_rand, data)
    w = som.som_train(data, num_passes=2, seed=42)
    _, d_trained = som.som_map(w, data)
    assert d_trained.mean() < 0.5 * d_rand.mean()


def test_sharded_train_step_matches_single_device(rng):
    from jax.sharding import Mesh
    data, _ = _clustered_data(rng, n_per=64, c=4)
    x = data[:256]
    w0 = data[:100].copy()
    gdist = jnp.asarray(som.grid_distances(10, 10))
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, axis_names=("fov",))
    step = som.make_sharded_train_step(mesh, data_axis="fov")
    w_sharded = step(jnp.asarray(w0), jnp.asarray(x), jnp.float32(0.05),
                     jnp.float32(2.0), gdist)
    # single-device oracle
    w2 = jnp.sum(w0 * w0, axis=1)
    d = w2[None, :] - 2.0 * (x @ w0.T)
    bmu = np.argmin(d, axis=1)
    h = (som.grid_distances(10, 10)[bmu] <= 2.0).astype(np.float32)
    num, den = h.T @ x, h.sum(0)
    target = num / np.maximum(den, 1.0)[:, None]
    w_ref = np.where((den > 0)[:, None], w0 + 0.05 * (target - w0), w0)
    np.testing.assert_allclose(np.asarray(w_sharded), w_ref, rtol=1e-4, atol=1e-5)


def test_som_train_sharded_distributionally_matches_single(rng):
    """The one-jitted-scan sharded trainer must land in the same optimum as
    `som_train`: near-equal mean quantization error on held-out data (weights
    differ bitwise — different batch partitioning — but not in quality)."""
    from jax.sharding import Mesh
    data, _ = _clustered_data(rng, n_per=400, c=5)
    held_out, _ = _clustered_data(rng, n_per=100, c=5)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("fov",))
    w_single = som.som_train(data, num_passes=2, seed=42, batch_size=256)
    w_sharded = som.som_train_sharded(data, mesh, num_passes=2, seed=42,
                                      batch_size=256)
    _, d_single = som.som_map(w_single, held_out)
    _, d_sharded = som.som_map(w_sharded, held_out)
    assert d_sharded.mean() < 1.25 * d_single.mean() + 1e-4
    # weights_init path: deterministic given identical init + seed
    w_a = som.som_train_sharded(data, mesh, seed=7, weights_init=w_single)
    w_b = som.som_train_sharded(data, mesh, seed=7, weights_init=w_single)
    np.testing.assert_array_equal(w_a, w_b)


def test_som_train_sharded_full_loop(rng):
    from jax.sharding import Mesh
    data, labels = _clustered_data(rng, n_per=200, c=4)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("fov",))
    w = som.som_train_sharded(data, mesh, num_passes=2, batch_size=256,
                              seed=42)
    assert w.shape == (100, 4)
    clusters, _ = som.som_map(w, data)
    # same purity check as the single-device trainer
    node_sets = []
    for i in range(4):
        nodes, counts = np.unique(clusters[labels == i], return_counts=True)
        node_sets.append(set(nodes[counts > counts.sum() * 0.05]))
    for i in range(4):
        for j in range(i + 1, 4):
            assert not (node_sets[i] & node_sets[j])


def test_som_train_and_map_fused_matches_two_call_path(rng):
    """The fused single-dispatch trainer+mapper must be bitwise identical
    to som_train followed by som_map on the same data."""
    data = rng.random((1000, 16)).astype(np.float32)
    w_fused, clusters_fused, dist_fused = som.som_train_and_map(data, seed=3)
    w_ref = som.som_train(data, seed=3)
    np.testing.assert_array_equal(w_fused, w_ref)
    clusters_ref, dist_ref = som.som_map(w_ref, data)
    np.testing.assert_array_equal(clusters_fused, clusters_ref)
    np.testing.assert_array_equal(dist_fused, dist_ref)
    assert clusters_fused.shape == (1000,)
    assert clusters_fused.min() >= 1 and clusters_fused.max() <= 100


def test_som_train_and_map_device_resident_and_options(rng):
    import jax.numpy as jnp
    data = jnp.asarray(rng.random((300, 5)).astype(np.float32))
    w, clusters, dist = som.som_train_and_map(
        data, xdim=4, ydim=3, num_passes=2, seed=9, batch_size=64)
    assert w.shape == (12, 5)
    assert clusters.shape == (300,) and dist.shape == (300,)
    assert np.isfinite(dist).all()
    w_ref = som.som_train(data, xdim=4, ydim=3, num_passes=2, seed=9,
                          batch_size=64)
    np.testing.assert_array_equal(w, w_ref)
