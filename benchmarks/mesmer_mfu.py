"""Mesmer forward MFU accounting.

Measures the bf16 PanopticNet forward at batch 16 x 512² and reports
achieved TFLOP/s from XLA's own cost analysis of the compiled executable
(FLOP count including the FPN/head convs) against the device's published
dense bf16 peak, looked up by `device_kind` in `PEAK_BF16_TFLOPS`. A device
that is not in the table is an error.

Protocol: reps inside one jitted lax.scan with a weight-derived carry
dependency (defeats loop hoisting), single readback, best-of-3 trials.

Usage: python benchmarks/mesmer_mfu.py [--batch 16] [--size 512] [--reps 20]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


# published dense bf16 peaks, TFLOP/s, keyed by jax `device_kind`
PEAK_BF16_TFLOPS = {
    # NVIDIA H100 SXM data sheet (dense, without sparsity), at 700 W
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_tflops(device_kind: str) -> float:
    if device_kind not in PEAK_BF16_TFLOPS:
        raise KeyError(f"no published bf16 peak for {device_kind!r}; add "
                       f"it to PEAK_BF16_TFLOPS with its source")
    return PEAK_BF16_TFLOPS[device_kind]


def main(batch=16, size=512, reps=20):
    import jax
    import jax.numpy as jnp

    from ark_tpu.models import unet

    kind = jax.devices()[0].device_kind
    peak = peak_tflops(kind)

    model, variables = unet.init_mesmer(input_shape=(1, size, size, 2))
    x = jnp.asarray(np.random.default_rng(0).random(
        (batch, size, size, 2)), jnp.float32)

    def fwd(v, xb):
        out = model.apply(v, xb, train=False)
        return out["whole_cell_inner_distance"], out["whole_cell_pixelwise"]

    # FLOPs from XLA's cost analysis of the single-forward executable
    lowered = jax.jit(fwd).lower(variables, x)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    flops = float(cost.get("flops", float("nan")))

    @jax.jit
    def loop(v, xb):
        def body(carry, _):
            # scale the first conv kernel by the carry: the smallest
            # operand that changes every rep's result
            v2 = v.copy()
            p = dict(v["params"])
            tp = dict(p["tensor_product"])
            tp["kernel"] = tp["kernel"] * (1.0 + carry)
            p["tensor_product"] = tp
            d, pix = fwd({"params": p, "batch_stats": v["batch_stats"]}, xb)
            s = jnp.sum(d.astype(jnp.float32))
            return (s % 7).astype(jnp.float32) * 1e-12, s
        _, out = jax.lax.scan(body, jnp.float32(0), jnp.arange(reps))
        return out

    np.asarray(loop(variables, x))  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(loop(variables, x))
        best = min(best, (time.perf_counter() - t0) / reps)

    tflops = flops / best / 1e12
    fovs_per_s = batch / best
    print(json.dumps({
        "benchmark": "mesmer_mfu", "device_kind": kind,
        "batch": batch, "size": size,
        "xla_flops_per_forward": flops,
        "seconds_per_forward": round(best, 5),
        "achieved_tflops": round(tflops, 1),
        "peak_bf16_tflops": peak,
        "mfu": round(tflops / peak, 3),
        "fovs_per_s": round(fovs_per_s, 1),
    }))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--reps", type=int, default=20)
    a = p.parse_args()
    main(a.batch, a.size, a.reps)
