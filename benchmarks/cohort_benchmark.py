"""End-to-end cohort benchmark: segment-quantify → pixel-cluster →
cell-cluster stats → spatial stats on a synthetic cohort (the end-to-end
cohort pipeline of BASELINE.json).

Protocol: all stages are warmed with same-shape calls first (compiles are
excluded — they are one-time), then timed with device-resident data. A
separate measurement reports the host-to-device transfer bandwidth so the
IO-inclusive number can be derived; in the templates host IO is overlapped
via ark_tpu.parallel.prefetch.

Usage: python benchmarks/cohort_benchmark.py [--fovs 10] [--size 1024]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))



def _sync(x):
    """Execution barrier: read back a VALUE derived from every output; a
    scalar sum keeps the transfer to 4 bytes (the extra device-side reduce
    reads each output once — ms-scale, and part of finishing a stage).
    """
    import jax
    import jax.numpy as jnp
    leaves = [l for l in jax.tree_util.tree_leaves(x) if hasattr(l, "dtype")]
    total = sum(jnp.sum(l.astype(jnp.float32)) for l in leaves)
    np.asarray(total)
    return x

def main(n_fovs=10, size=1024, channels=16, cells_per_fov=3000, seed=42,
         emit=True, verbose=True):
    """Run the cohort pipeline benchmark; returns the result dict.

    `emit` prints it as JSON (the CLI behavior); bench.py calls with
    emit=False, verbose=False to fold the numbers into its own single
    JSON line."""
    import jax
    import jax.numpy as jnp
    from ark_tpu.ops import image_filters, segment_reduce, som as som_ops
    from ark_tpu.ops import distances as dist_ops
    from ark_tpu.analysis import spatial_enrichment as se
    from ark_tpu.utils.profiling import StageTimer

    rng = np.random.default_rng(seed)
    timer = StageTimer(verbose=verbose)
    n_pix = n_fovs * size * size

    # ---- measure the host->device bandwidth with one FOV
    host_fov = rng.random((size, size, channels), dtype=np.float32)
    dev = _sync(jax.device_put(host_fov))
    t0 = time.perf_counter()
    dev = _sync(jax.device_put(host_fov))
    h2d_s = time.perf_counter() - t0
    h2d_gbps = host_fov.nbytes / h2d_s / 1e9

    # ---- synthesize the cohort on device (production path overlaps host
    # TIFF IO with compute via PrefetchLoader; see PERF.md note)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_fovs)
    make_img = jax.jit(lambda k: jax.random.uniform(
        k, (size, size, channels), jnp.float32))
    make_labels = jax.jit(lambda k: jax.random.randint(
        k, (size, size), 0, cells_per_fov, jnp.int32))
    imgs = [make_img(k) for k in keys]
    labels = [make_labels(k) for k in keys]

    img_stack = _sync(jnp.stack(imgs))   # (F, H, W, C) device-resident
    label_stack = _sync(jnp.stack(labels))

    # ---- stage -1: Mesmer segmentation forward (semantic heads for every
    # FOV; the host watershed postprocess is measured separately in PERF.md)
    from ark_tpu.models import unet
    model, variables = unet.init_mesmer(input_shape=(1, size, size, 2))
    mesmer_in = img_stack[..., :2]            # (F, H, W, 2) nuclear+membrane
    mes_batch = 2
    # pad the FOV axis up to a multiple of the scan batch (padded outputs
    # are computed then ignored; n_fovs=10 stays exact)
    n_pad = (-n_fovs) % mes_batch

    @jax.jit
    def mesmer_all(stack):
        def one(_, batch):
            out = model.apply(variables, batch, train=False)
            return None, (out["whole_cell_inner_distance"][..., 0],
                          out["whole_cell_pixelwise"][..., 0])
        if n_pad:
            stack = jnp.concatenate([stack, stack[:n_pad]], axis=0)
        batches = stack.reshape((n_fovs + n_pad) // mes_batch, mes_batch,
                                size, size, 2)
        _, outs = jax.lax.scan(one, None, batches)
        return outs

    _sync(mesmer_all(mesmer_in * 0.999))  # warm
    # 3 trials: the single number needs its spread alongside
    with timer.stage("mesmer_forward", items=n_fovs, unit="FOVs"):
        mes_out = _sync(mesmer_all(mesmer_in))
    mes_trials = [round(timer.records[-1].seconds, 4)]
    for _ in range(2):
        t0 = time.perf_counter()
        _sync(mesmer_all(mesmer_in))
        mes_trials.append(round(time.perf_counter() - t0, 4))

    # ---- stage 0: cohort channel percentiles (one device call, scan over
    # FOVs)
    from ark_tpu.ops import quantiles as quantile_ops

    @jax.jit
    def chan_pct_all(stack):
        def one(_, img):
            flat = img.reshape(-1, channels)
            return None, quantile_ops.nonzero_quantile_per_column(flat, 0.99)
        _, out = jax.lax.scan(one, None, stack)
        return jnp.mean(out, axis=0)

    _sync(chan_pct_all(img_stack * 0.999))  # warm
    with timer.stage("channel_percentiles", items=n_pix, unit="pixels"):
        norms = _sync(chan_pct_all(img_stack))

    # ---- stage 1: SOM training on a 10% cohort subsample
    n_sub = int(0.1 * n_pix)
    # device-resident subset, as produced by the on-device pixel subsampler
    # (som_train keeps jax.Array inputs on device — no host round trip)
    sub = jax.random.uniform(jax.random.PRNGKey(1), (n_sub, channels))
    weights = _sync(som_ops.som_train(sub * 0.99, seed=seed))  # warm
    with timer.stage("som_train", items=n_sub, unit="pixels"):
        weights = _sync(som_ops.som_train(sub, seed=seed))

    post_norms = jnp.asarray(rng.random(channels).astype(np.float32) + 0.5)
    wj = jnp.asarray(weights, jnp.float32)

    # ---- stage 2: pixel pipeline per FOV
    @jax.jit
    def pixel_fov(img):
        x = img / norms
        x = image_filters.gaussian_blur(x, sigma=2)
        mat = x.reshape(size * size, channels)
        rowsums = jnp.sum(mat, axis=1)
        valid = (rowsums > 0.05) & jnp.any(mat != 0, axis=1)
        nm = mat / jnp.where(rowsums == 0, 1.0, rowsums)[:, None]
        nm = nm / post_norms
        # the BMU fuses into this program (no separate dispatch)
        idx, _ = som_ops.bmu_xla(wj, nm)
        return jnp.where(valid, idx + 1, 0).astype(jnp.int32)

    @jax.jit
    def pixel_all(stack):
        def one(_, img):
            return None, pixel_fov(img)
        _, out = jax.lax.scan(one, None, stack)
        return out

    _sync(pixel_all(img_stack * 1.001))  # warm
    with timer.stage("pixel_pipeline", items=n_pix, unit="pixels"):
        clusters = _sync(pixel_all(img_stack))

    # ---- stage 3: marker quantification
    @jax.jit
    def quant_fov(img, lab):
        # morphology + channel sums in one fused scatter (the production
        # compute_marker_counts default path)
        feats, sums = segment_reduce.moment_and_channel_features(
            img, lab, cells_per_fov)
        return sums, feats["area"], feats["centroid-0"], feats["centroid-1"]

    @jax.jit
    def quant_all(istack, lstack):
        def one(_, pair):
            img, lab = pair
            return None, quant_fov(img, lab)
        _, out = jax.lax.scan(one, None, (istack, lstack))
        return out

    _sync(quant_all(img_stack * 1.001, label_stack))  # warm
    with timer.stage("marker_quantification", items=n_pix, unit="pixels"):
        quants_all = _sync(quant_all(img_stack, label_stack))
    quants = [tuple(q[i] for q in quants_all) for i in range(n_fovs)]

    # ---- stage 4: cell SOM over quantified features (cells x channels)
    cell_feats = np.concatenate([np.asarray(q[0])[1:] for q in quants])
    cw = som_ops.som_train(cell_feats * 0.99, seed=seed)  # warm compile bucket
    _sync(som_ops.som_map(cw, cell_feats * 0.99, return_dist=False))  # warm
    with timer.stage("cell_som", items=len(cell_feats), unit="cells"):
        cell_w = som_ops.som_train(cell_feats, seed=seed)
        cell_clusters, _ = som_ops.som_map(cell_w, cell_feats,
                                           return_dist=False)
        _sync(cell_clusters)

    # ---- stage 5: spatial stats (distances + enrichment permutations)
    n_markers, boots = 20, 100
    pos = jnp.asarray(
        (rng.random((n_markers, cells_per_fov)) < 0.2).astype(np.float32))

    @jax.jit
    def spatial_fov(cy, cx, pos):
        coords = jnp.stack([cy, cx], axis=1)
        d = dist_ops.pairwise_distances(coords, coords, zero_diagonal=True)
        dist_bin = ((d < 50) & (d > 0)).astype(jnp.float32)
        null = se._permutation_null(dist_bin, pos, cells_per_fov, 42, boots)
        obs = se._observed(dist_bin, pos)
        return obs, null.mean(0), null.std(0)

    @jax.jit
    def spatial_all(cys, cxs, pos):
        def one(_, pair):
            cy, cx = pair
            return None, spatial_fov(cy, cx, pos)
        _, out = jax.lax.scan(one, None, (cys, cxs))
        return out

    cys = jnp.stack([q[2] for q in quants])
    cxs = jnp.stack([q[3] for q in quants])
    _sync(spatial_all(cys + 0.001, cxs, pos))  # warm
    with timer.stage("spatial_enrichment", items=n_fovs * boots,
                     unit="permutations"):
        outs = _sync(spatial_all(cys, cxs, pos))

    total = timer.total_seconds
    result = {
        "benchmark": "cohort_pipeline",
        "n_fovs": n_fovs, "fov_size": size, "channels": channels,
        "total_seconds": round(total, 2),
        "mpix_per_s_end_to_end": round(n_pix / total / 1e6, 1),
        "host_to_device_GBps": round(h2d_gbps, 2),
        "mesmer_forward_trials_s": mes_trials,
        "stages": timer.report(),
    }
    if emit:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--fovs", type=int, default=10)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--channels", type=int, default=16)
    a = p.parse_args()
    main(a.fovs, a.size, a.channels)
