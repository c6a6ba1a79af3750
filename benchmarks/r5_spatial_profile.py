"""Spatial stage at cohort scale: bucketed vs per-shape device programs.

The spatial stage's device math is ms-scale per FOV. The dominator
hypothesis is per-FOV executable churn — every FOV has a distinct cell
count N and phenotype count M, so unbucketed cdist/enrichment kernels
trace + compile fresh programs per FOV. This drives the REAL
spatial_enrichment template end-to-end on a synthetic endurance-shaped
cell table and times both arms in one process: the shape-bucketed kernels
(current code), then a no-bucket arm with ``shape_bucket`` monkeypatched
to identity (the bucketed arm runs first so its two compiles don't
benefit from the no-bucket arm's hundred).

Usage: python benchmarks/r5_spatial_profile.py [--n 100] [--cells 250]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import pandas as pd

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def build_cell_table(n_fovs, cells_per_fov, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    phenos = ["tumor", "tcell", "bcell", "macrophage", "stroma", "endo"]
    for i in range(n_fovs):
        # vary N per FOV (the shape-churn driver) around the target
        n = int(cells_per_fov * rng.uniform(0.7, 1.3))
        rows.append(pd.DataFrame({
            "fov": f"fov{i}",
            "label": np.arange(1, n + 1),
            "centroid-0": rng.uniform(0, 1024, n),
            "centroid-1": rng.uniform(0, 1024, n),
            "cell_meta_cluster": rng.choice(phenos, n),
        }))
    return pd.concat(rows, ignore_index=True)


def run_stage(base_dir, ct_path, timings):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "templates"))
    import importlib
    te = importlib.import_module("spatial_enrichment")
    from ark_tpu.analysis import spatial_analysis_utils
    all_data = pd.read_csv(ct_path)
    dist_dir = os.path.join(base_dir, "spatial_analysis", "dist_mats")
    t0 = time.perf_counter()
    spatial_analysis_utils.ensure_dist_matrices(all_data, dist_dir)
    timings["dist_mats_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    te.main(base_dir, ct_path, dist_lim=50, bootstrap_num=100)
    timings["template_total_s"] = round(time.perf_counter() - t0, 1)


def ab_pipeline(n_fovs=100, cells_per_fov=250):
    """A/B the calc_dist_matrix depth-2 readback overlap against a
    forced-serial arm (pairwise_distances materialized to host numpy
    before returning — exactly the accidental behavior the r5 review
    caught, value-identical). ABBA arm order, best-of-2 per arm, one
    process, warm compile cache; only the dist-matrix loop is timed (the
    overlap does not touch enrichment)."""
    import jax.numpy as jnp  # noqa: F401  (ensures jax initialized once)

    from ark_tpu.analysis import spatial_analysis_utils
    from ark_tpu.ops import distances

    ct = build_cell_table(n_fovs, cells_per_fov)
    orig_pd = distances.pairwise_distances

    def sync_pd(a, b, zero_diagonal=False):
        return np.asarray(orig_pd(a, b, zero_diagonal=zero_diagonal))

    def run_arm(serial):
        distances.pairwise_distances = sync_pd if serial else orig_pd
        base = tempfile.mkdtemp(prefix="spatial_ab_")
        try:
            t0 = time.perf_counter()
            spatial_analysis_utils.calc_dist_matrix(
                ct, os.path.join(base))
            return time.perf_counter() - t0
        finally:
            distances.pairwise_distances = orig_pd
            shutil.rmtree(base, ignore_errors=True)

    run_arm(serial=False)                        # compile warmup
    walls = {"pipelined": [], "serial": []}
    for serial in (False, True, True, False):    # ABBA
        walls["serial" if serial else "pipelined"].append(run_arm(serial))
    out = {"n_fovs": n_fovs, "cells_per_fov": cells_per_fov,
           "pipelined_s": round(min(walls["pipelined"]), 3),
           "serial_s": round(min(walls["serial"]), 3),
           "pipelined_runs": [round(w, 3) for w in walls["pipelined"]],
           "serial_runs": [round(w, 3) for w in walls["serial"]]}
    out["pipelined_s_per_fov"] = round(out["pipelined_s"] / n_fovs, 3)
    out["serial_s_per_fov"] = round(out["serial_s"] / n_fovs, 3)
    out["overlap_speedup"] = round(
        out["serial_s"] / max(out["pipelined_s"], 1e-9), 2)
    print(json.dumps(out))
    return out


def main(n_fovs=100, cells_per_fov=250, pershape_n=None):
    """``pershape_n``: FOV count for the no-bucket arm (default: same as
    ``n_fovs``). The no-bucket arm compiles one program per distinct
    (N, M) shape, so the arm can run on a prefix of the cohort and be
    compared per-FOV."""
    from ark_tpu.ops import distances

    ct = build_cell_table(n_fovs, cells_per_fov)
    out = {"n_fovs": n_fovs, "cells_per_fov": cells_per_fov}
    pershape_n = pershape_n or n_fovs
    out["pershape_n_fovs"] = pershape_n
    pershape_fovs = [f"fov{i}" for i in range(pershape_n)]

    for arm in ("bucketed", "per_shape"):
        base = tempfile.mkdtemp(prefix=f"spatial_{arm}_")
        ct_path = os.path.join(base, "cell_table.csv")
        ct_arm = ct if arm == "bucketed" \
            else ct[ct["fov"].isin(pershape_fovs)]
        ct_arm.to_csv(ct_path, index=False)
        arm_n = n_fovs if arm == "bucketed" else pershape_n
        if arm == "per_shape":
            # patch BOTH bindings: the module attribute (dist-matrix path)
            # and spatial_enrichment's import-time alias
            from ark_tpu.analysis import spatial_enrichment as se_mod
            ident = lambda n, floor=128: n  # noqa: E731
            distances.shape_bucket = ident
            se_mod._bucket = ident
        timings = {}
        t0 = time.perf_counter()
        try:
            run_stage(base, ct_path, timings)
            out[arm] = {**timings,
                        "stage_s": round(time.perf_counter() - t0, 1),
                        "s_per_fov": round(
                            (time.perf_counter() - t0) / arm_n, 2)}
        finally:
            shutil.rmtree(base, ignore_errors=True)
    out["speedup_per_fov"] = round(
        out["per_shape"]["s_per_fov"] / out["bucketed"]["s_per_fov"], 2)
    out["bucketed_s_per_fov"] = out["bucketed"]["s_per_fov"]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--cells", type=int, default=250)
    p.add_argument("--pershape-n", type=int, default=None)
    p.add_argument("--ab-pipeline", action="store_true",
                   help="A/B the dist-matrix readback overlap vs a "
                        "forced-serial arm instead of the bucket A/B")
    a = p.parse_args()
    if a.ab_pipeline:
        ab_pipeline(n_fovs=a.n, cells_per_fov=a.cells)
    else:
        main(n_fovs=a.n, cells_per_fov=a.cells, pershape_n=a.pershape_n)
