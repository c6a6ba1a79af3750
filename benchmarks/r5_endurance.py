"""Full-pipeline endurance run: the protocol of benchmarks/r4_endurance.py
(100×1024²×16 through segment → pixel → cell → spatial on the accelerator,
mid-run SIGKILL + resume) through the template entry points — fused
single-sweep pixel stage (template-2 default), shape-bucketed + pipelined
spatial stage, and per-FOV cell-table checkpointing
(templates/1_segment_image_data.py:50-58) — plus a timed rerun of
template 1 after the pipeline completes. With the per-FOV parts checkpoint
that rerun only re-reads parts + concatenates (`quant_rerun_s`).

One process per card: this parent never imports JAX. The pipeline runs in
one child (benchmarks/r4_endurance.py), the template-1 rerun in another,
each started only after the previous one has exited — a JAX process
reserves most of the card's memory when it first uses it, so two at once
would starve the second.

Usage: python benchmarks/r5_endurance.py [--fovs 100] [--size 1024]
       [--out endurance.json]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import r4_endurance  # noqa: E402  (constants only; imports no JAX)


def rerun_template1(base):
    """Template 1 again, everything already on disk: segmentation masks
    detected per FOV, cell-table parts all checkpointed. Wall time is the
    resume bill a crashed-after-completion rerun pays."""
    code = (
        "import sys; sys.path[:0] = [{repo!r}, {tpl!r}];\n"
        "mod = __import__('1_segment_image_data');\n"
        "mod.main({base!r}, {nuc!r}, {mem!r}, weights_path={ckpt!r})\n"
    ).format(repo=REPO, tpl=os.path.join(REPO, "templates"), base=base,
             nuc=r4_endurance.NUC, mem=r4_endurance.MEM,
             ckpt=r4_endurance.CKPT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code])
    wall = time.perf_counter() - t0
    assert r.returncode == 0, "template-1 rerun failed"
    return round(wall, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fovs", type=int, default=100)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--base", default=os.path.join(tempfile.gettempdir(),
                                                   "ark_endurance_r5"))
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--kill_after", type=int, default=600)
    ap.add_argument("--out", default="endurance.json")
    a = ap.parse_args()

    cmd = [sys.executable, os.path.join(HERE, "r4_endurance.py"),
           "--fovs", str(a.fovs), "--size", str(a.size), "--base", a.base,
           "--kill_after", str(a.kill_after)] + (["--keep"] if a.keep else [])
    run = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
    sys.stdout.write(run.stdout)
    assert run.returncode == 0, "pipeline child failed"
    res = json.loads(run.stdout.strip().splitlines()[-1])
    res["quant_rerun_s"] = rerun_template1(a.base)
    res["date"] = time.strftime("%Y-%m-%d %H:%M")
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
