"""Same-process A/B of Mesmer head/pyramid resize dtype at 1024²/b2.

The full-resolution head stages are the largest part of the Mesmer
forward at 1024². This script measures resizing in the model dtype (bf16,
the default) against upcasting every pyramid/head resize to f32
(`unet.RESIZE_IN_F32`), both in the published head order, in one process:
reps inside one scan, best-of-3. Not yet measured on the GPU.

Usage: python benchmarks/head_fold_ab.py [size] [batch]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def timed(fn, x, variables, reps=10):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(v, xb):
        def body(carry, _):
            p = dict(v["params"])
            tp = dict(p["tensor_product"])
            tp["kernel"] = tp["kernel"] * (1.0 + carry)
            p["tensor_product"] = tp
            out = fn({"params": p, "batch_stats": v["batch_stats"]}, xb)
            s = jnp.sum(out.astype(jnp.float32))
            return (s % 7).astype(jnp.float32) * 1e-12, s
        _, out = jax.lax.scan(body, jnp.float32(0), jnp.arange(reps))
        return out

    np.asarray(loop(variables, x))  # warm
    best = float("inf")
    for t in range(3):
        xb = jax.block_until_ready(x * (1.0001 + 1e-4 * t))
        t0 = time.perf_counter()
        np.asarray(loop(variables, xb))
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def main():
    import jax.numpy as jnp

    from ark_tpu.models import unet

    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    model, variables = unet.init_mesmer(input_shape=(1, size, size, 2))
    x = jnp.asarray(np.random.default_rng(0).random(
        (batch, size, size, 2)), jnp.float32)

    def run():
        def f(v, xb):
            out = model.apply(v, xb, train=False)
            return out["whole_cell_inner_distance"]
        return timed(f, x, variables)

    res = {}
    # both variants in ONE process (a second process may land on another
    # card or clock); timed() is best-of-3 per variant
    unet.RESIZE_IN_F32 = True
    res["f32resize_s"] = run()
    unet.RESIZE_IN_F32 = False
    res["modeldtype_resize_s"] = run()
    res = {k: round(v, 5) for k, v in res.items()}
    res["speedup"] = round(
        res["f32resize_s"] / res["modeldtype_resize_s"], 3)
    res["fov_per_s_best"] = round(batch / res["modeldtype_resize_s"], 1)
    print(json.dumps({f"{size}x{size}_b{batch}": res}))


if __name__ == "__main__":
    main()
