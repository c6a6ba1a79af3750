"""Benchmark driver: prints ONE JSON line (the last line) with the headline
metric, after a first line naming the device.

Headline: Pixie SOM BMU-mapping throughput (Mpixels/s) — the reference's
single hottest kernel (pyFlowSOM C `map_data_to_nodes` over 1M-row chunks,
`cluster_helpers.py:118-163`), here `ops.som.bmu_xla`. The same line also
carries `mesmer_fovs_per_s` (1024² FOVs through the PanopticNet forward),
`permutations_per_s` (spatial-enrichment bootstrap) and `cohort_seconds`
(full 10x1024²x16 pipeline), measured by benchmarks/cohort_benchmark.py
in-process, plus `segmentation_e2e_fovs_per_s` (trained-checkpoint forward
+ device deep-watershed postprocess to int32 instance masks, dense planted
512² and 1024² cohorts) and `fiber_fovs_per_s`.

vs_baseline = speedup over a multithreaded-BLAS numpy implementation of the
same BMU search measured on this host's CPU.

Protocol: every timed window ends in a value readback; rates are best-of-3
after a warm-up call. The device run needs a GPU and exits non-zero
without one, or when any part fails. `--contract-only` is the CPU shape
check: it runs each measured function once at a tiny size and prints the
output shapes, no rate.
"""

import json
import subprocess
import sys
import time

import numpy as np


def _device_line() -> str:
    import jax

    dev = jax.devices()[0]
    card = "n/a"
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return (f"device platform={dev.platform} kind={dev.device_kind} "
            f"count={len(jax.devices())} card={card}")


def _bench_bmu(n, c, k, reps=50):
    """BMU throughput (Mpix/s): `reps` back-to-back calls of the BMU
    program on a device-resident block, ended by a readback."""
    import jax.numpy as jnp
    from ark_tpu.ops import som

    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.random((n, c)), jnp.float32)
    w = jnp.asarray(rng.random((k, c)), jnp.float32)
    np.asarray(som._bmu_idx(w, data)[:1])          # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            idx = som._bmu_idx(w, data)
        np.asarray(idx[:1])
        best = min(best, (time.perf_counter() - t0) / reps)
    return n / best / 1e6


def _bench_cpu_numpy(n, c, k, chunk=1_000_000):
    # float32 BLAS baseline (faster than pyFlowSOM's float64 single-thread C)
    rng = np.random.default_rng(0)
    data = rng.random((n, c)).astype(np.float32)
    w = rng.random((k, c)).astype(np.float32)
    w2 = (w * w).sum(1)

    def run():
        for i in range(0, n, chunk):
            x = data[i:i + chunk]
            d = w2[None, :] - 2.0 * (x @ w.T)
            d.argmin(axis=1)

    run()  # warm allocator / BLAS
    dt = float("inf")
    for _ in range(3):  # best-of-3: host scheduling noise swings this 50%+
        t0 = time.perf_counter()
        run()
        dt = min(dt, time.perf_counter() - t0)
    return n / dt / 1e6


def _bench_cohort():
    """Fold the end-to-end cohort benchmark's north-star numbers
    (BASELINE.json configs 2/4 and the end-to-end total) into the
    driver-captured line: Mesmer forward FOV/s, enrichment permutations/s,
    and the full 10x1024²x16 pipeline wall time."""
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.cohort_benchmark import main as cohort_main

    res = cohort_main(emit=False, verbose=False)
    stages = {s["stage"]: s for s in res["stages"]}
    # best-of-3 + spread: a single draw can't be compared across runs
    # without its spread
    trials = res["mesmer_forward_trials_s"]
    n = res["n_fovs"]
    return {
        "mesmer_fovs_per_s": round(n / min(trials), 1),
        "mesmer_fovs_per_s_spread": [round(n / max(trials), 1),
                                     round(n / min(trials), 1)],
        "permutations_per_s": round(
            stages["spatial_enrichment"]["per_second"], 1),
        "cohort_seconds": res["total_seconds"],
    }


def _bench_segmentation_e2e(n_fovs=8, size=512):
    """End-to-end instance segmentation throughput: trained-checkpoint
    forward + DEVICE deep-watershed postprocess + labels readback
    (`Mesmer.predict(postprocess='device')`, double-buffered batches).
    `mesmer_fovs_per_s` measures the forward alone; this is the number a
    user gets from FOV images to int32 instance masks. Dense planted
    cohort: n_cells=(250, 300) requested ellipses at crowding=0.35 merge
    to ~165 surviving instances per 512² FOV (synthetic_cells defaults
    would plant only 4-9); the reference's equivalent is a DeepCell REST
    round trip
    measured in minutes per 5-FOV zip (deepcell_service_utils.py:95-211)."""
    import os

    from ark_tpu.segmentation import mesmer, synthetic

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ark_tpu", "models", "checkpoints",
                        "mesmer_mini_synthetic.npz")
    rng = np.random.default_rng(0)
    fovs = synthetic.synthetic_cells(rng, n_fovs, hw=size,
                                     n_cells=(250, 300), crowding=0.35)[0]
    app = mesmer.Mesmer(weights_path=ckpt)

    mesmer.segment_fovs(fovs, app=app, postprocess="device")  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        mesmer.segment_fovs(fovs, app=app, postprocess="device")
        best = min(best, time.perf_counter() - t0)
    return {"segmentation_e2e_fovs_per_s": round(n_fovs / best, 1),
            "segmentation_e2e_fov_size": size}


def _bench_segmentation_e2e_1024(n_fovs=3, trials=3):
    """1024² segmentation e2e row with a spread field: best-of-N plus the
    [min, max] spread so a slow window is visible in the artifact."""
    import os

    from ark_tpu.segmentation import mesmer, synthetic

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ark_tpu", "models", "checkpoints",
                        "mesmer_mini_synthetic.npz")
    rng = np.random.default_rng(0)
    fovs = synthetic.synthetic_cells(rng, n_fovs, hw=1024,
                                     n_cells=(900, 1000), crowding=0.35)[0]
    app = mesmer.Mesmer(weights_path=ckpt)
    mesmer.segment_fovs(fovs, app=app, postprocess="device")  # warm
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        mesmer.segment_fovs(fovs, app=app, postprocess="device")
        times.append(time.perf_counter() - t0)
    rates = sorted(round(n_fovs / t, 2) for t in times)
    return {"segmentation_e2e_fovs_per_s_1024": rates[-1],
            "segmentation_e2e_1024_spread": [rates[0], rates[-1]]}


def _bench_fiber(size=1024):
    """Fiber segmentation e2e FOV/s at 1024²: the
    fused device program (blur→CLAHE→Frangi→EDT→Sobel) + the host
    otsu/watershed/label tail — `_fiber_steps(keep_intermediates=False)`,
    the production path of `run_fiber_segmentation`. Planted-ridge relief
    (random noise alone gives Frangi nothing to enhance). Stage-matched
    host-scipy comparison lives in benchmarks/r4_kernel_bench.py."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.r4_kernel_bench import _fiber_image
    from ark_tpu.segmentation.fiber_segmentation import _fiber_steps

    rng = np.random.default_rng(3)
    img = _fiber_image(rng, size)

    def e2e(x):
        return _fiber_steps(x, size, blur=2, contrast_scaling_divisor=128,
                            fiber_widths=tuple(range(1, 10, 2)),
                            ridge_cutoff=0.1, sobel_blur=1,
                            min_fiber_size=15, keep_intermediates=False)

    e2e(img)  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        e2e(img)
        best = min(best, time.perf_counter() - t0)
    return {"fiber_fovs_per_s": round(1 / best, 2)}


def main():
    import ark_tpu  # noqa: F401  (compile cache and XLA_FLAGS defaults
    import jax      # must be in place before the first backend exists)

    print(_device_line(), flush=True)
    if "--contract-only" in sys.argv:
        # CPU shape check (no rates): each measured function once, tiny
        import jax.numpy as jnp
        from ark_tpu.ops import som

        idx = som._bmu_idx(jnp.ones((100, 16), jnp.float32),
                           jnp.ones((4096, 16), jnp.float32))
        seg = _bench_segmentation_e2e(n_fovs=1, size=64)
        print(json.dumps({
            "metric": "som_bmu_map_throughput", "contract_only": True,
            "bmu_idx_shape": list(idx.shape),
            "segmentation_fields": sorted(seg)}))
        return 0
    if jax.devices()[0].platform != "gpu":
        print("[bench] needs a GPU", file=sys.stderr)
        return 1

    N, C, K = 4_194_304, 16, 100
    dev_mpix = _bench_bmu(N, C, K)
    cpu_mpix = _bench_cpu_numpy(1_048_576, C, K)
    extra = _bench_cohort()
    extra.update(_bench_segmentation_e2e())
    extra.update(_bench_segmentation_e2e_1024())
    extra.update(_bench_fiber())
    print(f"[bench] cpu numpy baseline: {cpu_mpix:.1f} Mpix/s "
          f"(N={N}, C={C}, K={K})", file=sys.stderr)
    print(json.dumps({
        "metric": "som_bmu_map_throughput",
        "value": round(dev_mpix, 1),
        "unit": "Mpixels/s",
        "vs_baseline": round(dev_mpix / cpu_mpix, 1),
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
