"""Same-process A/B: spatially TILED semantic heads at 1024²/b2.

Hypothesis: the full-res head intermediates at 1024² are 16× larger than
at 256², and XLA may spill (1024, 1024, 64..128)-channel bf16
intermediates to device memory between head stages. Tested here: computing each semantic head in
TxT spatial tiles (each tile ~512²-sized, the regime where XLA already
achieves 42% MFU) restores fusibility at the cost of ~2-3% halo
recompute. The tiled head is EXACT, not an approximation: per-stage halo
planning runs the 3x3 convs VALID on haloed slices with explicit zero
rows at global borders (= SAME), and the 2x/final bilinear resizes are
evaluated at the *global* half-pixel sample coordinates via per-tile
interpolation matrices, so every output element equals the untiled head's
(verified by --check on the CPU backend in f32, atol 1e-5; bf16 runs may
differ in bf16 rounding only).

Do not integrate tiling without this A/B winning on the card. On the GPU
it is not measured yet; the exactness harness is
tests/models/test_head_tile.py.


Usage:
  python benchmarks/head_tile_ab.py --check          # CPU exactness
  python benchmarks/head_tile_ab.py [size] [batch] [tiles]   # device A/B
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _resize_plan(t0, t1, h, th):
    """Source-row range + interpolation matrix for output rows [t0, t1) of
    a global bilinear resize h -> th (half-pixel convention, clamped —
    jax.image.resize 'bilinear' semantics)."""
    t = np.arange(t0, t1, dtype=np.float64)
    xs = (t + 0.5) * (h / th) - 0.5
    i0 = np.floor(xs).astype(int)
    w1 = xs - i0
    lo = int(np.clip(i0.min(), 0, h - 1))
    hi = int(np.clip(i0.max() + 1, 0, h - 1))
    a = np.zeros((t1 - t0, hi - lo + 1), np.float32)
    rows = np.arange(t1 - t0)
    a[rows, np.clip(i0, 0, h - 1) - lo] += (1.0 - w1)
    a[rows, np.clip(i0 + 1, 0, h - 1) - lo] += w1
    return lo, hi + 1, a


def _head_tile_plan(out_r, h_p3, out_hw):
    """Backward-plan one axis of one tile: from final output rows `out_r`
    to the needed P3 rows, recording per-round (pad_lo, pad_hi, A) where
    pad_* are the zero rows emulating SAME conv at global borders and A is
    that round's interpolation matrix restricted to the tile."""
    # forward shapes per round: h0 -> 2*h0 -> 4*h0 -> out_hw
    hs = [h_p3, 2 * h_p3, 4 * h_p3]
    ths = [2 * h_p3, 4 * h_p3, out_hw]
    need = out_r                      # rows needed of round-2 resize output
    plan = []                         # filled round 2 -> 0, then reversed
    for i in (2, 1, 0):
        src_lo, src_hi, a = _resize_plan(need[0], need[1], hs[i], ths[i])
        # conv (3x3 SAME) producing rows [src_lo, src_hi): needs input rows
        # [src_lo-1, src_hi+1); out-of-range rows are SAME's zero padding
        in_lo, in_hi = src_lo - 1, src_hi + 1
        pad_lo, pad_hi = max(0, -in_lo), max(0, in_hi - hs[i])
        plan.append((max(in_lo, 0), min(in_hi, hs[i]), pad_lo, pad_hi, a))
        need = (max(in_lo, 0), min(in_hi, hs[i]))
    return plan[::-1]                 # round 0 first; plan[0][:2] = p3 rows


def head_apply_tiled(params, batch_stats, p3, out_hw, tiles, dtype,
                     final_dtype):
    """Apply a SemanticHead's math in tiles x tiles spatial tiles,
    numerically equal to ark_tpu.models.unet.SemanticHead on the same
    variables (flax casting rules reproduced: inputs and params cast to
    `dtype` per op; dense_1 in final_dtype)."""
    import jax
    import jax.numpy as jnp

    b, h_p3, w_p3, _ = p3.shape
    H, W = out_hw

    def conv(x, kp):
        k = kp["kernel"].astype(dtype)
        bias = kp["bias"].astype(dtype)
        y = jax.lax.conv_general_dilated(
            x.astype(dtype), k, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y + bias

    out_tiles = []
    for ti in range(tiles):
        row_tiles = []
        r0, r1 = H * ti // tiles, H * (ti + 1) // tiles
        rplan = _head_tile_plan((r0, r1), h_p3, H)
        for tj in range(tiles):
            c0, c1 = W * tj // tiles, W * (tj + 1) // tiles
            cplan = _head_tile_plan((c0, c1), w_p3, W)
            (rl, rh, _, _, _), (cl, ch, _, _, _) = rplan[0], cplan[0]
            x = p3[:, rl:rh, cl:ch, :]
            for i in range(3):
                _, _, rpl, rph, ra = rplan[i]
                _, _, cpl, cph, ca = cplan[i]
                x = jnp.pad(x, ((0, 0), (rpl, rph), (cpl, cph), (0, 0)))
                x = conv(x, params[f"upsample_conv_{i}"])
                x = jax.nn.relu(x)
                # resize at the GLOBAL sample coordinates, model dtype
                x = jnp.einsum("th,bhwc->btwc", jnp.asarray(ra, dtype), x)
                x = jnp.einsum("vw,btwc->btvc", jnp.asarray(ca, dtype), x)
            d0 = params["dense_0"]
            x = (x.astype(dtype) @ d0["kernel"].astype(dtype)
                 + d0["bias"].astype(dtype))
            bn, st = params["bn_0"], batch_stats["bn_0"]
            inv = jax.lax.rsqrt(st["var"].astype(dtype) + jnp.asarray(1e-3, dtype))
            x = (x - st["mean"].astype(dtype)) * inv \
                * bn["scale"].astype(dtype) + bn["bias"].astype(dtype)
            x = jax.nn.relu(x)
            d1 = params["dense_1"]
            x = (x.astype(final_dtype) @ d1["kernel"].astype(final_dtype)
                 + d1["bias"].astype(final_dtype))
            row_tiles.append(x)
        out_tiles.append(jnp.concatenate(row_tiles, axis=2))
    return jnp.concatenate(out_tiles, axis=1)


def _forward_tiled(model, variables, x, tiles):
    """Full Mesmer forward with every semantic head tiled; output matches
    model.apply(variables, x, train=False) head-for-head."""
    import jax
    import jax.numpy as jnp

    out_hw = x.shape[1:3]
    p3 = model.apply(variables, x, train=False, return_p3=True)
    out = {}
    for comp in model.compartments:
        inner = head_apply_tiled(
            variables["params"][f"{comp}_inner"],
            variables["batch_stats"][f"{comp}_inner"], p3, out_hw, tiles,
            model.dtype, jnp.float32)
        pixelwise = head_apply_tiled(
            variables["params"][f"{comp}_pixelwise"],
            variables["batch_stats"][f"{comp}_pixelwise"], p3, out_hw,
            tiles, model.dtype, jnp.float32)
        act = {"relu": jax.nn.relu, "softplus": jax.nn.softplus,
               "linear": lambda y: y}[model.inner_activation]
        out[f"{comp}_inner_distance"] = act(inner)
        out[f"{comp}_pixelwise"] = jax.nn.softmax(pixelwise, axis=-1)
    return out


def check():
    """CPU exactness: tiled vs standard head outputs, f32 model."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ark_tpu.models import unet

    ok = True
    for size, tiles in ((128, 2), (256, 4)):
        model, variables = unet.init_mesmer_mini(
            input_shape=(1, size, size, 2), dtype=jnp.float32)
        x = jnp.asarray(np.random.default_rng(0).random(
            (2, size, size, 2)), jnp.float32)
        want = model.apply(variables, x, train=False)
        got = _forward_tiled(model, variables, x, tiles)
        for k in want:
            d = float(jnp.max(jnp.abs(got[k].astype(jnp.float32)
                                      - want[k].astype(jnp.float32))))
            status = "OK" if d < 1e-5 else "MISMATCH"
            ok &= d < 1e-5
            print(f"{size}^2 tiles={tiles} {k}: max|diff|={d:.2e} {status}")
    print("EXACTNESS", "PASS" if ok else "FAIL")
    return ok


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
    tiles = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    model, variables = unet.init_mesmer(input_shape=(1, size, size, 2))
    x = jnp.asarray(np.random.default_rng(0).random(
        (batch, size, size, 2)), jnp.float32)

    def f_std(v, xb):
        return model.apply(v, xb, train=False)["whole_cell_inner_distance"]

    def f_tiled(v, xb):
        p3 = model.apply(v, xb, train=False, return_p3=True)
        inner = head_apply_tiled(
            v["params"]["whole_cell_inner"],
            v["batch_stats"]["whole_cell_inner"], p3, (size, size), tiles,
            model.dtype, jnp.float32)
        return jnp.maximum(inner, 0)

    res = {"standard_s": timed(f_std, x, variables),
           "tiled_s": timed(f_tiled, x, variables)}
    res = {k: round(v, 5) for k, v in res.items()}
    res["speedup"] = round(res["standard_s"] / res["tiled_s"], 3)
    print(json.dumps({f"{size}x{size}_b{batch}_t{tiles}": res}))


if __name__ == "__main__":
    if "--check" in sys.argv:
        sys.exit(0 if check() else 1)
    main()
