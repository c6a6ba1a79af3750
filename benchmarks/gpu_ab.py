"""Same-process A/Bs behind the single-path decisions for the GPU.

    python benchmarks/gpu_ab.py

Runs on one GPU and prints one line per measurement:

* quantiles: counting bisection vs XLA's sort, standalone on a 1024^2 x 16
  FOV at q = 0.999;
* training scan: whole-schedule scan vs per-step dispatch, mini Mesmer;
* BMU: `bmu_xla` at 4,194,304 x 16 x 100 — time, its program's temporary
  bytes (is the (N, 100) distance matrix materialised?) and, with
  `pixel_phase`, its share of the kernel time in a profiler trace of the
  pixel template;
* claim rounds: kernels per round in the compiled loop body and time per
  round at 8 x 1024^2, for the minimax and level flood engines;
* stage walls: templates 1 and 2 on 4 FOVs, for comparing processes
  started with and without `--xla_gpu_deterministic_ops` (run the script
  once per setting, e.g. `--only stage_walls` with XLA_FLAGS set).

    python benchmarks/gpu_ab.py --only bmu,claim_rounds
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _best(fn, n=5):
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times), max(times)


def _line(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def quantile_standalone():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ark_tpu.ops import quantiles

    rng = np.random.default_rng(0)
    img = rng.gamma(2.0, 1.0, (1024 * 1024, 16)).astype(np.float32)
    img[rng.random(img.shape) < 0.4] = 0.0
    x = jnp.asarray(img)
    q = 0.999

    @jax.jit
    def sort_path(x):
        cols = x.T
        return jax.vmap(lambda c: jnp.nanquantile(
            jnp.where(c > 0, c, jnp.nan), q))(cols)

    @jax.jit
    def bisect_path(x):
        cols = x.T
        return jax.vmap(lambda c: quantiles._masked_quantile_flat(
            c, c > 0, q))(cols)

    @jax.jit
    def sort_cols(x):
        return jnp.nanquantile(jnp.where(x == 0, jnp.nan, x), q, axis=0)

    @jax.jit
    def bisect_cols(x):
        return quantiles.nonzero_quantile_per_column(x, q)

    a = np.asarray(sort_path(x))
    b = np.asarray(bisect_path(x))
    for name, fn in (("flat_sort", sort_path), ("flat_bisect", bisect_path),
                     ("cols_sort", sort_cols), ("cols_bisect", bisect_cols)):
        lo, hi = _best(lambda: np.asarray(fn(x)), n=10)
        _line("quantile_standalone", path=name, shape="1048576x16", q=q,
              best_ms=f"{lo * 1e3:.3f}", worst_ms=f"{hi * 1e3:.3f}")
    _line("quantile_standalone", flat_paths_bitwise=bool(
        np.array_equal(a, b)))


def _pixel_cohort(work, n_fovs):
    import chip_smoke

    sizes = chip_smoke.Sizes(n_fovs=n_fovs)
    return chip_smoke.build_cohort(work, sizes)


def _run_pixel(base, channels):
    import chip_smoke

    t2 = chip_smoke._template("2_pixie_cluster_pixels")
    t2.main(base, channels)


def training_scan():
    import jax.numpy as jnp
    import numpy as np

    from ark_tpu.models import unet
    from ark_tpu.segmentation import synthetic, train
    from ark_tpu.segmentation.mesmer import _percentile_normalize

    rng = np.random.default_rng(42)
    images, cells, nucs = synthetic.synthetic_cells(rng, 24, hw=64,
                                                    crowding=0.35)
    ct, nt = (synthetic.targets_from_labels(cells),
              synthetic.targets_from_labels(nucs))
    targets = {"whole_cell_inner_distance": ct["inner_distance"],
               "whole_cell_pixelwise": ct["pixelwise"],
               "nuclear_inner_distance": nt["inner_distance"],
               "nuclear_pixelwise": nt["pixelwise"]}
    x = np.asarray(_percentile_normalize(jnp.asarray(images)))
    steps = 400
    for chunk in (steps, 1, steps, 1):
        model, variables = unet.init_mesmer_mini(seed=42,
                                                 input_shape=(1, 64, 64, 2))
        t0 = time.perf_counter()
        _, losses = train.fit(model, variables, x, targets, steps=steps,
                              scan_chunk=chunk)
        wall = time.perf_counter() - t0
        _line("training_scan", scan_chunk=chunk, steps=steps,
              wall_s=f"{wall:.3f}", final_loss=f"{float(losses[-1]):.5f}")


def bmu():
    import jax.numpy as jnp
    import numpy as np

    from ark_tpu.ops import som

    rng = np.random.default_rng(0)
    n, c, k = 4_194_304, 16, 100
    x = jnp.asarray(rng.random((n, c), np.float32))
    w = jnp.asarray(rng.random((k, c), np.float32))
    compiled = som._bmu_idx.lower(w, x).compile()
    ma = compiled.memory_analysis()
    lo, hi = _best(lambda: np.asarray(som._bmu_idx(w, x)[:1]), n=10)
    _line("bmu", rows=n, channels=c, nodes=k, best_ms=f"{lo * 1e3:.3f}",
          worst_ms=f"{hi * 1e3:.3f}", mpix_s=f"{n / lo / 1e6:.1f}",
          temp_bytes=getattr(ma, "temp_size_in_bytes", "n/a"),
          distance_matrix_bytes=n * k * 4)


def _device_events(trace_dir):
    import jax

    paths = []
    for root, _, files in os.walk(trace_dir):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith(".xplane.pb")]
    data = jax.profiler.ProfileData.from_file(paths[0])
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = {str(k): v for k, v in ev.stats}
                yield plane.name, line.name, ev, stats


def bmu_share_of_pixel_phase(work, channels):
    import jax

    base = os.path.join(work, "traced")
    os.makedirs(base)
    os.symlink(os.path.join(work, "image_data"),
               os.path.join(base, "image_data"))
    trace_dir = os.path.join(work, "trace")
    with jax.profiler.trace(trace_dir):
        _run_pixel(base, channels)
    by_module, by_kernel = collections.Counter(), collections.Counter()
    shown = False
    for plane, line, ev, stats in _device_events(trace_dir):
        if not line.startswith("Stream") or ev.name.startswith("Memcpy"):
            continue
        if not shown:
            _line("bmu_share", sample_kernel=ev.name[:60],
                  stats={k: str(v)[:40] for k, v in stats.items()})
            shown = True
        module = next((str(v) for k, v in stats.items()
                       if "module" in k.lower()), "?")
        by_module[module] += ev.duration_ns
        by_kernel[ev.name] += ev.duration_ns
    total = sum(by_module.values())
    bmu_ns = sum(ns for name, ns in by_module.items() if "_bmu_idx" in name)
    _line("bmu_share", kernel_time_ms=f"{total / 1e6:.3f}",
          bmu_ms=f"{bmu_ns / 1e6:.3f}",
          bmu_share=f"{bmu_ns / max(total, 1):.4f}")
    for name, ns in by_module.most_common(12):
        _line("bmu_share", module=name[:60], device_ms=f"{ns / 1e6:.3f}")
    for name, ns in by_kernel.most_common(8):
        _line("bmu_share", kernel=name[:60], device_ms=f"{ns / 1e6:.3f}")


_SKIP_OPS = {"parameter", "get-tuple-element", "tuple", "constant",
             "bitcast"}


def _loop_body_ops(hlo_text):
    """Opcode tally of the first while loop body in optimized HLO."""
    m = re.search(r"while\(.*?body=%?([\w.\-]+)", hlo_text)
    body = m.group(1)
    start = re.search(r"^%?" + re.escape(body) + r"\b.*\{\s*$", hlo_text,
                      re.M)
    ops = collections.Counter()
    for ln in hlo_text[start.end():].splitlines():
        if ln.strip() == "}":
            break
        op = re.search(r"=\s*(?:\([^=]*?\)|\S+)\s+([a-z][a-z0-9\-]*)\(", ln)
        if op and op.group(1) not in _SKIP_OPS:
            ops[op.group(1)] += 1
    return ops


def claim_rounds():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ark_tpu.ops import watershed as W

    rng = np.random.default_rng(0)
    b, h, w = 8, 1024, 1024
    levels = 256
    q = jnp.asarray(rng.integers(0, levels, (b, h, w), np.int32))
    mask = jnp.asarray(rng.random((b, h, w)) < 0.9)
    markers = np.zeros((b, h, w), np.int32)
    markers[:, ::64, ::64] = np.arange(1, 16 * 16 + 1).reshape(16, 16)
    markers = jnp.asarray(markers)
    lb = W._label_bits(levels)
    labm = jnp.int32((1 << lb) - 1)
    qs = q << lb
    claimable = mask & (markers == 0)
    pk0 = jnp.where(markers > 0, markers, W._LAB_SENTINEL)

    def minimax(rounds):
        @jax.jit
        def run(pk):
            return jax.lax.fori_loop(0, rounds, lambda i, p: W._minimax_round(
                p, qs, labm, claimable), pk)
        return run

    def level(rounds):
        @jax.jit
        def run(lab):
            return jax.lax.fori_loop(0, rounds, lambda i, l: W._claim_round(
                l, q, mask, jnp.int32(128)), lab)
        return run

    for name, make, init in (("minimax_round", minimax, pk0),
                             ("level_claim_round", level, markers)):
        ops = _loop_body_ops(make(64).lower(init).compile().as_text())
        t = {}
        for r in (16, 80):
            fn = make(r)
            t[r], _ = _best(lambda: np.asarray(fn(init)[0, 0, :1]), n=5)
        per_round = (t[80] - t[16]) / 64
        _line("claim_rounds", engine=name, shape=f"{b}x{h}x{w}",
              kernels_per_round=sum(ops.values()), ops=dict(ops),
              us_per_round=f"{per_round * 1e6:.1f}")


def stage_walls(work):
    """Templates 1 and 2 on a 4-FOV cohort kept in `work` across runs."""
    import chip_smoke

    if not os.path.isdir(os.path.join(work, "image_data")):
        _pixel_cohort(work, 4)
    channels = [f"chan{c}" for c in range(16)]
    base = tempfile.mkdtemp(dir=work)
    os.symlink(os.path.join(work, "image_data"),
               os.path.join(base, "image_data"))
    t0 = time.perf_counter()
    chip_smoke._run_segment(base, channels)
    seg = time.perf_counter() - t0
    t0 = time.perf_counter()
    chip_smoke._template("2_pixie_cluster_pixels").main(
        base, channels, seg_dir=os.path.join(base, "segmentation",
                                             "deepcell_output"))
    pix = time.perf_counter() - t0
    _line("stage_walls", xla_flags=os.environ.get("XLA_FLAGS", ""),
          fovs=4, segment_s=f"{seg:.3f}", pixel_s=f"{pix:.3f}")


def main():
    import argparse

    import ark_tpu  # noqa: F401  (XLA_FLAGS default before the backend)
    import jax

    p = argparse.ArgumentParser()
    p.add_argument("--only", default="bmu,claim_rounds,quantile_standalone,"
                   "training_scan,pixel_phase")
    p.add_argument("--work", default=None,
                   help="directory kept across runs (stage_walls)")
    args = p.parse_args()
    only = set(args.only.split(","))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("gpu_ab: no GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"device_kind={dev.device_kind} "
          f"JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS', '')}", flush=True)
    for name, fn in (("bmu", bmu), ("claim_rounds", claim_rounds),
                     ("quantile_standalone", quantile_standalone),
                     ("training_scan", training_scan)):
        if name in only:
            fn()
    if "pixel_phase" in only:
        with tempfile.TemporaryDirectory() as work:
            channels = _pixel_cohort(work, 4)
            bmu_share_of_pixel_phase(work, channels)
    if "stage_walls" in only:
        os.makedirs(args.work, exist_ok=True)
        stage_walls(args.work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
