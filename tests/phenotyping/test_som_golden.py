"""Distributional golden tests for the SOM + consensus clustering engine.

The reference validates its SOM path against pyFlowSOM goldens; a
batch-parallel device SOM converges to different (equally valid) weights, so —
per SURVEY.md §7 hard-part (b) — parity here is asserted at the
*distribution* level: cluster-average tables must recover planted mixture
structure, assignments must be pure, and the Monti consensus matrix must be
block-diagonal on clean groups (reference `cluster_helpers.py:98-163,
436-682`).
"""

import os

import numpy as np
import pandas as pd
import pytest

from ark_tpu.ops import som as som_ops
from ark_tpu.phenotyping import cluster_helpers


def _mixture(rng, n_per: int, means: np.ndarray, scale: float = 0.05):
    """Draw n_per points around each mean; returns (data, component_ids)."""
    k, c = means.shape
    data = (means[:, None, :]
            + rng.normal(0, scale, size=(k, n_per, c))).reshape(-1, c)
    comps = np.repeat(np.arange(k), n_per)
    perm = rng.permutation(len(data))
    return data[perm].astype(np.float32), comps[perm]


def test_som_cluster_averages_recover_planted_means(rng):
    """Every planted mixture mean must be matched by some SOM cluster's
    channel-average row (the som-avg table contract,
    `pixel_som_clustering.py:308-371`), and each SOM cluster must be pure."""
    means = np.array([
        [1.0, 0.1, 0.1, 0.1],
        [0.1, 1.0, 0.1, 0.1],
        [0.1, 0.1, 1.0, 0.1],
        [0.1, 0.1, 0.1, 1.0],
        [0.7, 0.7, 0.1, 0.1],
    ], np.float32)
    data, comps = _mixture(rng, 400, means)
    weights = som_ops.som_train(data, xdim=10, ydim=10, seed=42)
    clusters, _ = som_ops.som_map(weights, data)    # 1-indexed

    df = pd.DataFrame(data, columns=["c0", "c1", "c2", "c3"])
    df["som"] = clusters
    avg = df.groupby("som").mean()

    # (a) every planted mean is approximated by some cluster average
    for mi, mean in enumerate(means):
        d = np.linalg.norm(avg.values - mean, axis=1).min()
        assert d < 0.1, f"mean {mi} unmatched (nearest avg at {d:.3f})"

    # (b) occupied SOM clusters are pure: >=99% of points from one component
    for som_id, grp in df.groupby("som"):
        idx = grp.index.values
        counts = np.bincount(comps[idx], minlength=len(means))
        assert counts.max() / counts.sum() >= 0.99

    # (c) all planted components are separated into different SOM clusters
    cluster_of_comp = {}
    for mi in range(len(means)):
        ids, cnt = np.unique(clusters[comps == mi], return_counts=True)
        cluster_of_comp[mi] = set(ids[cnt > 0.01 * cnt.sum()])
    for a in range(len(means)):
        for b in range(a + 1, len(means)):
            assert not (cluster_of_comp[a] & cluster_of_comp[b])


def test_som_weights_interpolate_data_manifold(rng):
    """Trained codebook vectors live inside the convex range of the data
    (Kohonen update property) and span it — no dead far-away nodes."""
    data = rng.uniform(2.0, 4.0, size=(3000, 3)).astype(np.float32)
    weights = np.asarray(som_ops.som_train(data, xdim=10, ydim=10, seed=1))
    assert weights.min() >= 2.0 - 0.05 and weights.max() <= 4.0 + 0.05
    # codebook covers the volume: every datum is near some node (som_map
    # distances are squared; 100 nodes over a volume-8 cube -> typical
    # nearest-node distance ~0.5, so q99 of d^2 well under 1)
    clusters, dists = som_ops.som_map(weights, data, return_dist=True)
    assert len(np.unique(clusters)) > 50
    assert np.quantile(np.asarray(dists), 0.99) < 1.0


def test_consensus_matrix_block_structure_on_clean_groups(rng):
    """Monti consensus matrix Mk at the true k must be ~1 within planted
    groups and ~0 across (reference's vendored ConsensusCluster,
    `cluster_helpers.py:436-572`)."""
    from sklearn.cluster import AgglomerativeClustering

    means = np.eye(3, 5, dtype=np.float32) * 4
    data, comps = _mixture(rng, 20, means, scale=0.2)
    cc = cluster_helpers.ConsensusCluster(
        cluster=AgglomerativeClustering, L=3, K=4, H=12,
        resample_proportion=0.8)
    np.random.seed(7)
    cc.fit(data)
    M = cc.Mk[0]
    same = comps[:, None] == comps[None, :]
    # every entry must be a valid consensus fraction (the +1e-8-smoothed
    # division keeps never-co-sampled pairs near 0, not NaN/sentinel)
    assert np.isfinite(M).all() and (M >= 0).all() and (M <= 1).all()
    assert M[same].mean() > 0.95
    assert M[~same].mean() < 0.05
    # predict() clusters 1-Mk and must reproduce the planted partition
    labels = cc.predict()
    from sklearn.metrics import adjusted_rand_score
    assert adjusted_rand_score(labels, comps) == 1.0


def test_pixie_consensus_cluster_mapping_golden(rng, tmp_path):
    """PixieConsensusCluster on a SOM-avg table with 3 planted node groups:
    the som->meta mapping must reproduce the groups exactly, 1-indexed
    (reference `cluster_helpers.py:575-682`)."""
    n_nodes = 30
    group = np.repeat([0, 1, 2], 10)
    centers = np.array([[4, 0, 0], [0, 4, 0], [0, 0, 4]], np.float32)
    table = pd.DataFrame(
        centers[group] + rng.normal(0, 0.1, size=(n_nodes, 3)),
        columns=["chan0", "chan1", "chan2"])
    table["pixel_som_cluster"] = np.arange(1, n_nodes + 1)
    table["count"] = 100
    path = tmp_path / "pixel_channel_avg_som_cluster.csv"
    table.to_csv(path, index=False)

    pcc = cluster_helpers.PixieConsensusCluster(
        "pixel", path, ["chan0", "chan1", "chan2"], max_k=3)
    np.random.seed(7)
    pcc.scale_data()
    # z-score + cap applied column-wise
    assert abs(pcc.input_data[["chan0", "chan1", "chan2"]].mean().sum()) < 1e-6
    assert pcc.input_data[["chan0", "chan1", "chan2"]].abs().max().max() <= 3
    pcc.run_consensus_clustering()
    pcc.generate_som_to_meta_map()

    mapping = pcc.mapping
    assert set(mapping.columns) == {"pixel_som_cluster", "pixel_meta_cluster"}
    assert mapping["pixel_meta_cluster"].min() >= 1          # 1-indexed
    assert mapping["pixel_meta_cluster"].nunique() == 3
    # group coherence: every planted group lands in exactly one meta cluster
    metas = mapping["pixel_meta_cluster"].values
    for g in range(3):
        assert len(set(metas[group == g])) == 1
    assert len(set(metas[::10])) == 3                        # groups distinct

    # label join contract
    ext = pd.DataFrame({"pixel_som_cluster": [1, 11, 21, 5]})
    joined = pcc.assign_consensus_labels(ext)
    assert joined.loc[0, "pixel_meta_cluster"] == metas[0]
    assert joined.loc[1, "pixel_meta_cluster"] == metas[10]
    assert joined.loc[2, "pixel_meta_cluster"] == metas[20]
    assert joined.loc[3, "pixel_meta_cluster"] == metas[4]


def test_som_train_distribution_matches_kmeans_quantization(rng):
    """Cross-engine sanity: the SOM's quantization error on blob data must be
    within a small factor of a k-means codebook of the same size (a SOM
    trades quantization for topology — its neighborhood smoothing keeps
    nodes between blobs, measured ~2-4x k-means MSE here; a degenerate
    codebook is 1-2 orders worse)."""
    from ark_tpu.ops import kmeans as km
    import jax.numpy as jnp

    means = rng.uniform(0, 8, size=(6, 4)).astype(np.float32)
    data, _ = _mixture(rng, 500, means, scale=0.3)
    w_som = np.asarray(som_ops.som_train(data, xdim=5, ydim=5, seed=0))
    _, d2_som = som_ops.som_map(w_som, data, return_dist=True)  # squared

    centers, _, _ = km.kmeans_fit(jnp.asarray(data), k=25, seed=0)
    from ark_tpu.ops.distances import pairwise_distances
    d_km = np.asarray(pairwise_distances(jnp.asarray(data), centers)).min(1)
    assert np.mean(np.asarray(d2_som)) < 6.0 * max(np.mean(d_km ** 2), 1e-6)
    # and row order must not matter (the scheduler bug this test caught:
    # a batch-size floor left small shuffled datasets ~frozen at init)
    order = np.random.default_rng(5).permutation(len(data))
    w_shuf = np.asarray(som_ops.som_train(data[order], xdim=5, ydim=5,
                                          seed=0))
    _, d2_shuf = som_ops.som_map(w_shuf, data, return_dist=True)
    assert np.mean(np.asarray(d2_shuf)) < 1.5 * np.mean(np.asarray(d2_som))


def test_weighted_channel_avg_matches_loop_oracle(rng):
    """compute_p2c_weighted_channel_avg is a cells×clusters @ clusters×chans
    matmul / cell size (`weighted_channel_comp.py:121-123`); check against an
    explicit per-cell loop."""
    from ark_tpu.phenotyping import weighted_channel_comp as wcc

    n_clusters, channels = 5, ["c0", "c1"]
    pixel_channel_avg = pd.DataFrame({
        "pixel_som_cluster": np.arange(1, n_clusters + 1),
        "c0": rng.random(n_clusters),
        "c1": rng.random(n_clusters),
    })
    cells = pd.DataFrame({
        "fov": ["f0"] * 6, "segmentation_label": np.arange(1, 7),
        "cell_size": rng.integers(50, 200, 6).astype(float),
    })
    counts = rng.integers(0, 30, size=(6, n_clusters)).astype(float)
    for k in range(n_clusters):
        cells[f"pixel_som_cluster_{k + 1}"] = counts[:, k]

    got = wcc.compute_p2c_weighted_channel_avg(
        pixel_channel_avg, channels, cells.copy(),
        fovs=["f0"], pixel_cluster_col="pixel_som_cluster")
    for i in range(6):
        for ci, ch in enumerate(channels):
            want = (counts[i] * pixel_channel_avg[ch].values).sum() \
                / cells.loc[i, "cell_size"]
            assert got.loc[i, ch] == pytest.approx(want, rel=1e-6)


def test_som_map_chunk_size_invariance(rng):
    """Chunked BMU mapping must be invariant to chunk size (the reference
    parametrizes num_parallel_obs, `cluster_helpers_test.py:372,508`)."""
    data = rng.random((1000, 6)).astype(np.float32)
    w = som_ops.som_train(data[:500], xdim=4, ydim=4, seed=2)
    full, _ = som_ops.som_map(w, data)

    df = pd.DataFrame(data, columns=[f"c{i}" for i in range(6)])

    class _Dummy(cluster_helpers.PixieSOMCluster):
        def __init__(self):
            pass

        def normalize_data(self):
            return df

    dummy = _Dummy()
    dummy.weights = pd.DataFrame(np.asarray(w), columns=df.columns)
    for chunk in (64, 333, 10_000):
        got = dummy.generate_som_clusters(df, num_parallel_obs=chunk)
        np.testing.assert_array_equal(got, full)
    with pytest.raises(ValueError):
        dummy.generate_som_clusters(df, num_parallel_obs=0)
