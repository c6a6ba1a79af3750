"""Sub-substage profile of pixie preprocessing at 1024².

Preprocessing is the largest substage of `r4_pixel_stage_profile.py`
with ms-scale device work per FOV. This times the
pieces inside `create_pixel_matrix`: the two cohort percentile passes,
and per FOV the TIFF load, device blur/rownorm, DataFrame build, feather
writes, and the post-rownorm pandas quantile.

Usage: python benchmarks/r5_preprocess_profile.py [--n 2] [--size 1024]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from r4_pixel_stage_profile import CHANNELS, build_cohort  # noqa: E402


def main(n_fovs=2, size=1024):
    import jax.numpy as jnp
    import pandas as pd
    from ark_tpu.io import feather_utils as feather
    from ark_tpu.io import load_utils
    from ark_tpu.io.image_utils import read_image
    from ark_tpu.phenotyping import pixel_cluster_utils, pixie_preprocessing

    rng = np.random.default_rng(0)
    fovs = [f"fov{i}" for i in range(n_fovs)]
    base = tempfile.mkdtemp(prefix="prep_profile_")
    out = {"n_fovs": n_fovs, "size": size}
    try:
        build_cohort(base, fovs, size, rng)
        tiff_dir = os.path.join(base, "image_data")
        seg_dir = os.path.join(base, "segmentation", "deepcell_output")

        t0 = time.perf_counter()
        channel_norm_df = pixel_cluster_utils.calculate_channel_percentiles(
            tiff_dir=tiff_dir, fovs=fovs, channels=CHANNELS,
            img_sub_folder=None, percentile=0.99)
        out["chan_percentiles_s"] = round(time.perf_counter() - t0, 2)

        t0 = time.perf_counter()
        thresh = pixel_cluster_utils.calculate_pixel_intensity_percentile(
            tiff_dir=tiff_dir, fovs=fovs, channels=CHANNELS,
            img_sub_folder=None, channel_percentiles=channel_norm_df)
        out["pixel_thresh_s"] = round(time.perf_counter() - t0, 2)

        # per-FOV pieces (mirrors preprocess_fov + the driver's quantile)
        acc = {k: 0.0 for k in ["tiff_load", "device_prep", "df_build",
                                "subset_sample", "feather_full",
                                "feather_subset", "quantile"]}
        for fov in fovs:
            t0 = time.perf_counter()
            img_xr = load_utils.load_imgs_from_tree(
                tiff_dir, img_sub_folder=None, fovs=[fov])
            seg_labels = read_image(
                os.path.join(seg_dir, fov + "_whole_cell.tiff"))
            img_data = img_xr.sel(
                fovs=fov, channels=CHANNELS).values.astype(np.float32)
            acc["tiff_load"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            img_data = img_data / channel_norm_df.iloc[0].values.reshape(
                1, 1, -1)
            norm, valid = pixie_preprocessing._prep_fov_device(
                jnp.asarray(img_data, jnp.float32), jnp.float32(thresh),
                blur_factor=2)
            norm = np.asarray(norm)         # honest barrier: full readback
            keep = np.flatnonzero(np.asarray(valid))
            acc["device_prep"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            pixel_mat = pd.DataFrame(norm[keep], columns=CHANNELS)
            pixel_mat["fov"] = fov
            pixel_mat["row_index"] = keep // size
            pixel_mat["column_index"] = keep % size
            pixel_mat["label"] = np.asarray(seg_labels).ravel()[keep]
            acc["df_build"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            np.random.seed(42)
            subset = pixel_mat.sample(frac=0.1)
            acc["subset_sample"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            feather.write_dataframe(
                pixel_mat, os.path.join(base, fov + ".feather"),
                compression="uncompressed")
            acc["feather_full"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            feather.write_dataframe(
                subset, os.path.join(base, fov + "_sub.feather"),
                compression="uncompressed")
            acc["feather_subset"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            fov_vals = pixel_mat.drop(
                columns=["fov", "row_index", "column_index", "label"])
            fov_vals.replace(0, np.nan).quantile(q=0.999, axis=0)
            acc["quantile"] += time.perf_counter() - t0

        for k, v in acc.items():
            out[k + "_s_per_fov"] = round(v / n_fovs, 2)
        out["per_fov_total_s"] = round(sum(acc.values()) / n_fovs, 2)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=2)
    p.add_argument("--size", type=int, default=1024)
    a = p.parse_args()
    main(n_fovs=a.n, size=a.size)
