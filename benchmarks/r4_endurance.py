"""Endurance run: a 100-FOV 1024² cohort through segment → pixel-cluster
→ cell-cluster → spatial enrichment on the accelerator, driven through the
actual template entry points (disk IO included), with a forced mid-run
kill + resume of the segmentation stage to certify crash-resume at scale.

One process per card: template 1 runs in child processes, and this
parent does not import JAX until the last child has exited — a JAX
process reserves most of the card's memory when it first uses it, so a
parent on the card would starve the child. Stages 2-4 then run in this
process.

Wall-clock notes: cohort synthesis + TIFF IO run on the host and
dominate; per-stage times are reported separately so device throughput
and host IO are distinguishable.

Usage: python benchmarks/r4_endurance.py [--fovs 100] [--size 1024]
       [--base DIR]
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "templates"))
sys.path.insert(0, os.path.join(REPO, "tests"))

NUC = ["CD45", "HLADR"]
MEM = ["ECAD", "CD14"]
# natsorted: the pixel feathers carry channels in loader (natsort) order,
# and the SOM column contract is order-sensitive
CHANNELS = ["CD3", "CD4", "CD8", "CD14", "CD20", "CD31", "CD38", "CD45",
            "CD68", "CK17", "Collagen1", "ECAD", "Fibronectin", "HLADR",
            "SMA", "Vim"]
CKPT = os.path.join(REPO, "ark_tpu", "models", "checkpoints",
                    "mesmer_mini_synthetic.npz")


def build_cohort(base, fovs, size):
    import test_utils
    t0 = time.perf_counter()
    tiff_dir = os.path.join(base, "image_data")
    # chunked generation so a retry doesn't redo everything
    done_fovs = set(os.listdir(tiff_dir)) if os.path.isdir(tiff_dir) else ()
    todo = [f for f in fovs if f not in done_fovs]
    for i, fov in enumerate(todo):
        # stable per-FOV seed: str hash() is salted per process, which
        # would mix cohorts from different seeds across a crash-resume
        test_utils.create_image_cohort(
            tiff_dir, [fov], CHANNELS, shape=(size, size),
            seed=12345 + int(fov.removeprefix("fov")), n_cells=150)
        if i % 20 == 0:
            print(f"[cohort] {i}/{len(todo)}", flush=True)
    return time.perf_counter() - t0


def run_segment_with_kill(base, fovs, kill_after_s):
    """Template 1 in a subprocess, killed mid-run, then rerun to
    completion; returns (resume_worked, total_wall, fovs_done_before)."""
    code = (
        "import sys; sys.path[:0] = [{repo!r}, {tpl!r}];\n"
        "mod = __import__('1_segment_image_data');\n"
        "mod.main({base!r}, {nuc!r}, {mem!r}, weights_path={ckpt!r})\n"
    ).format(repo=REPO, tpl=os.path.join(REPO, "templates"), base=base,
             nuc=NUC, mem=MEM, ckpt=CKPT)
    out_dir = os.path.join(base, "segmentation", "deepcell_output")

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code])
    time.sleep(kill_after_s)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    before = len([f for f in os.listdir(out_dir)
                  if f.endswith("_whole_cell.tiff")]) \
        if os.path.isdir(out_dir) else 0

    r = subprocess.run([sys.executable, "-c", code])
    wall = time.perf_counter() - t0
    assert r.returncode == 0, "segment rerun failed"
    after = len([f for f in os.listdir(out_dir)
                 if f.endswith("_whole_cell.tiff")])
    return {"fovs_before_kill": before, "fovs_after_resume": after,
            "segment_wall_s": round(wall, 1),
            "kill_after_s": kill_after_s}


def main(n_fovs=100, size=1024, base=None, fresh=True, kill_after=None):
    base = base or os.path.join(tempfile.gettempdir(), "ark_endurance")
    if fresh and os.path.isdir(base):
        shutil.rmtree(base)
    os.makedirs(base, exist_ok=True)
    fovs = [f"fov{i}" for i in range(n_fovs)]
    res = {"n_fovs": n_fovs, "size": size}

    res["cohort_build_s"] = round(build_cohort(base, fovs, size), 1)
    print(f"[cohort] built in {res['cohort_build_s']}s", flush=True)

    # stage 1: segment with forced mid-run kill + resume (template 1);
    # the kill lands mid-segmentation at full scale (input generation for
    # 100 FOVs takes ~2-3 min first)
    res.update(run_segment_with_kill(
        base, fovs,
        kill_after_s=kill_after or (150 if n_fovs <= 8 else 360)))
    print(f"[segment] {res}", flush=True)

    # stages 2-4 in-process: the template-1 children have exited, so this
    # process is now the only one on the card
    import importlib

    import pandas as pd
    t2 = __import__("2_pixie_cluster_pixels")
    t0 = time.perf_counter()
    t2.main(base, CHANNELS, fovs=fovs, max_k=8,
            seg_dir=os.path.join(base, "segmentation", "deepcell_output"))
    res["pixel_stage_s"] = round(time.perf_counter() - t0, 1)
    print(f"[pixel] {res['pixel_stage_s']}s", flush=True)

    # GUI remap stand-in (the notebook-2 interactive step)
    avg = pd.read_csv(os.path.join(base,
                                   "pixel_channel_avg_som_cluster.csv"))
    remap = avg[["pixel_som_cluster", "pixel_meta_cluster"]].copy()
    remap["pixel_meta_cluster_rename"] = remap["pixel_meta_cluster"].map(
        lambda m: f"pmc_{m}")
    remap.to_csv(os.path.join(base, "pixel_meta_cluster_mapping.csv"),
                 index=False)
    from ark_tpu.phenotyping import pixel_meta_clustering
    pixel_meta_clustering.apply_pixel_meta_cluster_remapping(
        fovs, CHANNELS, base, "pixel_mat_data",
        "pixel_meta_cluster_mapping.csv")
    pixel_meta_clustering.generate_remap_avg_files(
        fovs, CHANNELS, base, "pixel_mat_data",
        "pixel_meta_cluster_mapping.csv",
        "pixel_channel_avg_som_cluster.csv",
        "pixel_channel_avg_meta_cluster.csv")

    ct_path = os.path.join(base, "segmentation", "cell_table",
                           "cell_table_size_normalized.csv")
    t3 = __import__("3_pixie_cluster_cells")
    t0 = time.perf_counter()
    t3.main(base, CHANNELS, ct_path, fovs=fovs, max_k=5)
    res["cell_stage_s"] = round(time.perf_counter() - t0, 1)
    print(f"[cell] {res['cell_stage_s']}s", flush=True)

    # stage 4: spatial — dist mats + enrichment need a phenotype column
    ct = pd.read_csv(ct_path)
    rng = np.random.default_rng(1)
    ct["cell_meta_cluster"] = rng.choice(["A", "B", "C"], len(ct))
    ct_pheno = os.path.join(base, "cell_table_pheno.csv")
    ct.to_csv(ct_pheno, index=False)
    te = importlib.import_module("spatial_enrichment")
    t0 = time.perf_counter()
    te.main(base, ct_pheno, dist_lim=50, bootstrap_num=100)
    res["spatial_stage_s"] = round(time.perf_counter() - t0, 1)

    res["total_pipeline_s"] = round(
        res["segment_wall_s"] + res["pixel_stage_s"] + res["cell_stage_s"]
        + res["spatial_stage_s"], 1)
    res["cells_total"] = int(len(ct))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--fovs", type=int, default=100)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--base", default=None,
                   help="cohort dir (default: <tmpdir>/ark_endurance)")
    p.add_argument("--keep", action="store_true",
                   help="reuse an existing cohort dir")
    p.add_argument("--kill_after", type=int, default=None,
                   help="seconds before the forced mid-segmentation kill")
    a = p.parse_args()
    main(a.fovs, a.size, a.base, fresh=not a.keep, kill_after=a.kill_after)
