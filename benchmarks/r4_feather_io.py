"""A/B: arrow-Table per-FOV pixie passes vs the pandas round trip.

The pixel stage is host-IO bound: each of ~5 cohort passes reads and
rewrites a ~70 MB feather per FOV, and the arrow→pandas→arrow conversion
of the ~20 untouched columns is much of that. This bench times one realistic FOV (1024² pixels ×
16 channels + fov/row/col/label columns) through each pass both ways,
on the host only (no accelerator needed for the label passes; the SOM pass runs
its BMU on CPU identically in both engines so the delta is still IO).

Usage: python benchmarks/r4_feather_io.py [--side 1024] [--reps 3]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _timed(fn, reps):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(side=1024, n_chan=16, reps=3):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ark_tpu.io import feather_utils as feather
    from ark_tpu.phenotyping import (pixel_meta_clustering,
                                     pixel_som_clustering)

    rng = np.random.default_rng(0)
    n = side * side
    channels = [f"chan{i}" for i in range(n_chan)]
    df = pd.DataFrame(rng.random((n, n_chan)).astype(np.float32),
                      columns=channels)
    df["fov"] = "fov0"
    df["row_index"] = np.repeat(np.arange(side), side)
    df["column_index"] = np.tile(np.arange(side), side)
    df["label"] = rng.integers(1, 2000, n)
    df["pixel_som_cluster"] = rng.integers(1, 101, n)

    out = {"side": side, "n_chan": n_chan}
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "pixel_mat_data")
        temp_dir = data_dir + "_temp"
        os.makedirs(data_dir)
        os.makedirs(temp_dir)
        fov_path = os.path.join(data_dir, "fov0.feather")
        feather.write_dataframe(df, fov_path, compression="uncompressed")
        out["file_mb"] = round(os.path.getsize(fov_path) / 2**20, 1)

        mapping = pd.DataFrame({
            "pixel_som_cluster": np.arange(1, 101),
            "pixel_meta_cluster": np.arange(1, 101) % 8 + 1})
        remap_dict = dict(
            mapping[["pixel_som_cluster", "pixel_meta_cluster"]].values)
        rename_dict = {m: f"meta_{m}" for m in range(1, 9)}

        class _CC:  # just enough surface for the consensus pass
            som_col, meta_col = "pixel_som_cluster", "pixel_meta_cluster"

            def assign_consensus_labels(self, ext):
                ext[self.meta_col] = ext[self.som_col].map(
                    mapping.set_index(self.som_col)[self.meta_col])
                return ext

            def assign_consensus_labels_table(self, tbl):
                som = tbl.column(self.som_col).to_pandas()
                meta = som.map(mapping.set_index(self.som_col)[self.meta_col])
                return feather.table_set_columns(tbl, {self.meta_col: meta})

        cc = _CC()

        # --- consensus (meta) pass
        def meta_pandas():
            fd = feather.read_dataframe(fov_path)
            fd = cc.assign_consensus_labels(fd)
            feather.write_dataframe(
                fd, os.path.join(temp_dir, "fov0.feather"),
                compression="uncompressed")

        def meta_arrow():
            assert pixel_meta_clustering.run_pixel_consensus_assignment(
                data_dir, cc, "fov0") == ("fov0", 0)

        out["meta_pandas_s"] = round(_timed(meta_pandas, reps), 3)
        out["meta_arrow_s"] = round(_timed(meta_arrow, reps), 3)

        # --- remap pass (input file now carries the meta col)
        feather.write_dataframe(
            cc.assign_consensus_labels(feather.read_dataframe(fov_path)),
            fov_path, compression="uncompressed")

        def remap_pandas():
            fd = feather.read_dataframe(fov_path)
            fd["pixel_meta_cluster"] = fd["pixel_som_cluster"].map(remap_dict)
            fd["pixel_meta_cluster_rename"] = fd["pixel_meta_cluster"].map(
                rename_dict)
            feather.write_dataframe(
                fd, os.path.join(temp_dir, "fov0.feather"),
                compression="uncompressed")

        def remap_arrow():
            assert pixel_meta_clustering.update_pixel_meta_labels(
                data_dir, remap_dict, rename_dict, "fov0") == ("fov0", 0)

        out["remap_pandas_s"] = round(_timed(remap_pandas, reps), 3)
        out["remap_arrow_s"] = round(_timed(remap_arrow, reps), 3)

        # --- SOM assignment pass (BMU compute identical in both; CPU)
        base = tmp
        sub_dir = os.path.join(base, "pixel_mat_subsetted")
        os.makedirs(sub_dir)
        feather.write_dataframe(
            df[channels].sample(10_000, random_state=1),
            os.path.join(sub_dir, "fov0.feather"))
        feather.write_dataframe(
            pd.DataFrame([[0.9] * n_chan], columns=channels),
            os.path.join(base, "post_rowsum_chan_norm.feather"))
        pysom = pixel_som_clustering.train_pixel_som(
            ["fov0"], channels, base)

        def som_pandas():
            # overwrite=True semantics, matching som_arrow below
            fd = feather.read_dataframe(fov_path)
            fd = fd.drop(columns="pixel_som_cluster", errors="ignore")
            fd = pysom.assign_som_clusters(fd, normalize_data=False)
            feather.write_dataframe(
                fd, os.path.join(temp_dir, "fov0.feather"),
                compression="uncompressed")

        def som_arrow():
            assert pixel_som_clustering.run_pixel_som_assignment(
                data_dir, pysom, True, 1_000_000, "fov0") == ("fov0", 0)

        out["som_pandas_s"] = round(_timed(som_pandas, reps), 3)
        out["som_arrow_s"] = round(_timed(som_arrow, reps), 3)

    for k in ("meta", "remap", "som"):
        out[f"{k}_speedup"] = round(
            out[f"{k}_pandas_s"] / out[f"{k}_arrow_s"], 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--side", type=int, default=1024)
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args()
    main(side=a.side, reps=a.reps)
