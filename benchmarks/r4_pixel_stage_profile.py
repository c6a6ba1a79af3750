"""Per-substage profile of the pixie pixel stage at 1024² FOV scale.

An endurance run records only stage-level wall. This driver builds N
synthetic 1024²×16ch FOVs (TIFF tree + label masks, like the endurance
cohort) and times each substage of template 2 separately, so the next IO
optimization targets the real dominator.

Usage: python benchmarks/r4_pixel_stage_profile.py [--n 4] [--size 1024]
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

CHANNELS = [f"chan{i}" for i in range(16)]


def build_cohort(base, fovs, size, rng):
    from ark_tpu.io.image_utils import save_image
    t0 = time.perf_counter()
    seg_dir = os.path.join(base, "segmentation", "deepcell_output")
    os.makedirs(seg_dir, exist_ok=True)
    for fov in fovs:
        d = os.path.join(base, "image_data", fov)
        os.makedirs(d, exist_ok=True)
        for ch in CHANNELS:
            img = (rng.random((size, size)) * 100).astype(np.float32)
            save_image(os.path.join(d, ch + ".tiff"), img)
        # coarse planted labels so the seg column exists
        lab = np.zeros((size, size), np.int32)
        n_cells = 200
        ys, xs = (rng.integers(8, size - 8, n_cells),
                  rng.integers(8, size - 8, n_cells))
        for i, (y, x) in enumerate(zip(ys, xs), start=1):
            lab[y - 6:y + 6, x - 6:x + 6] = i
        save_image(os.path.join(seg_dir, fov + "_whole_cell.tiff"), lab)
    return time.perf_counter() - t0


def main(n_fovs=4, size=1024):
    from ark_tpu.phenotyping import (pixel_meta_clustering,
                                     pixel_som_clustering,
                                     pixie_preprocessing)

    rng = np.random.default_rng(0)
    fovs = [f"fov{i}" for i in range(n_fovs)]
    base = tempfile.mkdtemp(prefix="pixel_profile_")
    out = {"n_fovs": n_fovs, "size": size}
    try:
        out["cohort_build_s"] = round(build_cohort(base, fovs, size, rng), 1)
        os.makedirs(os.path.join(base, "pixel_output_dir"), exist_ok=True)
        seg_dir = os.path.join(base, "segmentation", "deepcell_output")

        t0 = time.perf_counter()
        pixie_preprocessing.create_pixel_matrix(
            fovs, CHANNELS, base, os.path.join(base, "image_data"), seg_dir,
            img_sub_folder=None, seg_suffix="_whole_cell.tiff",
            pixel_output_dir="pixel_output_dir", blur_factor=2,
            subset_proportion=0.1, seed=42)
        out["preprocess_s"] = round(time.perf_counter() - t0, 1)

        t0 = time.perf_counter()
        pysom = pixel_som_clustering.train_pixel_som(
            fovs, CHANNELS, base,
            norm_vals_name="channel_norm_post_rownorm.feather", seed=42)
        out["som_train_s"] = round(time.perf_counter() - t0, 1)

        t0 = time.perf_counter()
        pixel_som_clustering.cluster_pixels(fovs, base, pysom)
        out["som_assign_s"] = round(time.perf_counter() - t0, 1)

        t0 = time.perf_counter()
        pixel_som_clustering.generate_som_avg_files(
            fovs, CHANNELS, base, pysom, data_dir="pixel_mat_data")
        out["som_avg_s"] = round(time.perf_counter() - t0, 1)

        t0 = time.perf_counter()
        pixel_cc = pixel_meta_clustering.pixel_consensus_cluster(
            fovs, CHANNELS, base, max_k=8, seed=42)
        out["consensus_s"] = round(time.perf_counter() - t0, 1)

        t0 = time.perf_counter()
        pixel_meta_clustering.generate_meta_avg_files(
            fovs, CHANNELS, base, pixel_cc, data_dir="pixel_mat_data")
        out["meta_avg_s"] = round(time.perf_counter() - t0, 1)

        stage = sum(v for k, v in out.items()
                    if k.endswith("_s") and k != "cohort_build_s")
        out["stage_total_s"] = round(stage, 1)
        out["per_fov_s"] = round(stage / n_fovs, 1)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--size", type=int, default=1024)
    a = p.parse_args()
    main(n_fovs=a.n, size=a.size)
