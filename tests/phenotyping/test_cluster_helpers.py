import os

import numpy as np
import pandas as pd
import pytest

from ark_tpu.io import feather_utils as feather
from ark_tpu.phenotyping import cluster_helpers


CHANNELS = ["chan0", "chan1", "chan2", "chan3"]


def _subset_dir(tmp_path, rng, fovs=("fov0", "fov1"), n=400):
    sub = tmp_path / "subset"
    sub.mkdir()
    for fov in fovs:
        df = pd.DataFrame(rng.random((n, len(CHANNELS))).astype(np.float32),
                          columns=CHANNELS)
        df["fov"] = fov
        df["row_index"] = rng.integers(0, 32, n)
        df["column_index"] = rng.integers(0, 32, n)
        feather.write_dataframe(df, sub / f"{fov}.feather")
    return sub


def _norm_file(tmp_path):
    p = tmp_path / "norm.feather"
    feather.write_dataframe(
        pd.DataFrame([[0.5] * len(CHANNELS)], columns=CHANNELS), p)
    return p


def test_verify_unique_meta_clusters():
    good = pd.DataFrame({"pixel_meta_cluster": [1, 2],
                         "pixel_meta_cluster_rename": ["a", "b"]})
    cluster_helpers.verify_unique_meta_clusters(good, "pixel")
    bad = pd.DataFrame({"pixel_meta_cluster": [1, 2],
                        "pixel_meta_cluster_rename": ["a", "a"]})
    with pytest.raises(ValueError):
        cluster_helpers.verify_unique_meta_clusters(bad, "pixel")


class TestPixelSOMCluster:
    def test_train_and_assign(self, tmp_path, rng):
        sub = _subset_dir(tmp_path, rng)
        norm = _norm_file(tmp_path)
        wpath = tmp_path / "weights.feather"
        psc = cluster_helpers.PixelSOMCluster(
            str(sub), str(norm), str(wpath), fovs=["fov0", "fov1"],
            columns=CHANNELS, seed=42)
        # training data normalized by 0.5 -> doubled
        assert psc.train_data[CHANNELS].values.max() > 1.0
        psc.train_som()
        assert os.path.exists(wpath)
        assert psc.weights.shape == (100, 4)
        # skip-if-trained logic
        with pytest.warns(UserWarning, match="already trained"):
            psc.train_som()
        # retrain on overwrite
        with pytest.warns(UserWarning, match="Overwrite"):
            psc.train_som(overwrite=True)

        ext = pd.DataFrame(rng.random((123, 4)).astype(np.float32),
                           columns=CHANNELS)
        ext["fov"] = "fov0"
        out = psc.assign_som_clusters(ext)
        assert "pixel_som_cluster" in out.columns
        assert out["pixel_som_cluster"].between(1, 100).all()
        assert len(psc.som_clusters_seen) > 0

    def test_assign_chunk_invariance(self, tmp_path, rng):
        sub = _subset_dir(tmp_path, rng)
        norm = _norm_file(tmp_path)
        psc = cluster_helpers.PixelSOMCluster(
            str(sub), str(norm), str(tmp_path / "w.feather"),
            fovs=["fov0"], columns=CHANNELS, seed=42)
        psc.train_som()
        ext = pd.DataFrame(rng.random((777, 4)).astype(np.float32),
                           columns=CHANNELS)
        a = psc.assign_som_clusters(ext.copy(), num_parallel_pixels=100)
        b = psc.assign_som_clusters(ext.copy(), num_parallel_pixels=10**6)
        np.testing.assert_array_equal(a["pixel_som_cluster"].values,
                                      b["pixel_som_cluster"].values)


class TestCellSOMCluster:
    def test_normalize_and_cluster(self, tmp_path, rng):
        cols = [f"pixel_meta_cluster_{i}" for i in range(6)]
        cell_data = pd.DataFrame(rng.random((200, 6)).astype(np.float32),
                                 columns=cols)
        cell_data["fov"] = np.where(np.arange(200) % 2 == 0, "fov0", "fov1")
        csc = cluster_helpers.CellSOMCluster(
            cell_data.copy(), str(tmp_path / "cw.feather"),
            fovs=["fov0", "fov1"], columns=cols, seed=42)
        # 99.9% quantile norm: values mostly <= ~1
        assert csc.cell_data[cols].values.max() < 1.5
        csc.train_som()
        out = csc.assign_som_clusters()
        assert out["cell_som_cluster"].between(1, 100).all()

    def test_fov_subsetting(self, tmp_path, rng):
        cols = ["a", "b"]
        cell_data = pd.DataFrame(rng.random((50, 2)), columns=cols)
        cell_data["fov"] = ["fov0"] * 25 + ["fov1"] * 25
        csc = cluster_helpers.CellSOMCluster(
            cell_data, str(tmp_path / "cw.feather"), fovs=["fov0"],
            columns=cols, normalize=False)
        assert len(csc.cell_data) == 25


class TestConsensusCluster:
    def test_fit_recovers_planted_clusters(self, rng):
        from sklearn.cluster import AgglomerativeClustering
        # 3 well-separated blobs, consensus over k in [2, 6)
        centers = np.array([[0, 0], [5, 5], [10, 0]], float)
        data = np.concatenate([c + rng.normal(0, 0.3, (30, 2)) for c in centers])
        cc = cluster_helpers.ConsensusCluster(
            AgglomerativeClustering, L=2, K=6, H=8, resample_proportion=0.8)
        cc.fit(data)
        assert cc.Mk.shape == (4, 90, 90)
        labels = cc.predict_data(data)
        # planted groups must be pure
        for g in range(3):
            assert len(np.unique(labels[g * 30:(g + 1) * 30])) == 1

    def test_pixie_consensus_cluster(self, tmp_path, rng):
        # SOM-average-like table: 100 SOM clusters x channels
        df = pd.DataFrame(rng.random((100, 4)), columns=CHANNELS)
        df["pixel_som_cluster"] = np.arange(1, 101)
        path = tmp_path / "avg.csv"
        df.to_csv(path, index=False)
        pcc = cluster_helpers.PixieConsensusCluster(
            "pixel", str(path), CHANNELS, max_k=5)
        pcc.scale_data()
        assert pcc.input_data[CHANNELS].values.max() <= 3.0
        assert pcc.input_data[CHANNELS].values.min() >= -3.0
        pcc.run_consensus_clustering()
        pcc.generate_som_to_meta_map()
        assert pcc.mapping["pixel_meta_cluster"].between(1, 5).all()
        ext = pd.DataFrame({"pixel_som_cluster": rng.integers(1, 101, 50)})
        out = pcc.assign_consensus_labels(ext)
        assert out["pixel_meta_cluster"].between(1, 5).all()
        # save + reload map
        pcc.save_som_to_meta_map(tmp_path / "map.feather")
        m = feather.read_dataframe(tmp_path / "map.feather")
        assert list(m.columns) == ["pixel_som_cluster", "pixel_meta_cluster"]


@pytest.mark.parametrize("n,k,dtype,dups", [
    (40, 2, np.float64, False), (120, 7, np.float32, False),
    (60, 20, np.float64, True), (25, 25, np.float64, False),
    (30, 1, np.float32, True)])
def test_ward_agglomerative_labels_match_sklearn(n, k, dtype, dups):
    """Same labels, numbering included, as sklearn's default
    AgglomerativeClustering, which consensus clustering used to call."""
    from sklearn.cluster import AgglomerativeClustering

    rng = np.random.default_rng(n * 31 + k)
    x = rng.normal(size=(n, 5)).astype(dtype)
    if dups:
        x[n // 2:] = x[:n - n // 2]       # exact duplicate rows: tied merges
    want = AgglomerativeClustering(n_clusters=k).fit_predict(x)
    got = cluster_helpers.WardAgglomerative(n_clusters=k).fit_predict(x)
    np.testing.assert_array_equal(got, want)


def test_ward_agglomerative_rejects_bad_cluster_count():
    with pytest.raises(ValueError):
        cluster_helpers.WardAgglomerative(n_clusters=5).fit_predict(np.zeros((3, 2)))
