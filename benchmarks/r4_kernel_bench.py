"""Device throughput of UMAP embed, device exact t-SNE, k-means multi-restart, and the
fused fiber device pipeline — each against its installed host equivalent.

Host comparisons (what a CPU user of the reference stack pays):
- UMAP: umap-learn is not installed here (the reference's engine); the
  dominant stage (brute kNN over 50k rows) is compared against sklearn
  NearestNeighbors(algorithm='brute') as the closest installed oracle,
  and the full embed seconds are recorded standalone.
- t-SNE: sklearn.manifold.TSNE — both method='exact' (apples-to-apples
  with our exact device kernel) and the default 'barnes_hut' (what users
  actually run), at a matched iteration count.
- k-means: sklearn.cluster.KMeans(n_init, max_iter matched).
- fiber: a stage-matched host scipy/numpy pipeline (gaussian blur, numpy
  CLAHE in the tests' oracle formulation, scipy-hessian Frangi, scipy EDT,
  scipy sobel) feeding the SAME host otsu/watershed/label tail the
  production path uses.

Measurement protocol: every timed surface here returns host numpy, so the
value readback IS the barrier; input variants are materialized OUTSIDE the
timed window; best-of-3 trials after a warm call that pays the compile.

Usage: python benchmarks/r4_kernel_bench.py [--only umap,tsne,kmeans,fiber]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _best_of(fn, variants):
    best = float("inf")
    for v in variants:
        t0 = time.perf_counter()
        fn(v)
        best = min(best, time.perf_counter() - t0)
    return best


def _variants(arr, n=3):
    """Distinct inputs per trial, materialized before timing (the host
    multiply must stay outside the window)."""
    return [np.ascontiguousarray(arr * (1.0 + 1e-4 * (t + 1)))
            for t in range(n)]


def bench_umap(n=50_000, d=16, out=None):
    from ark_tpu.ops.umap import UMAP

    rng = np.random.default_rng(0)
    # clustered data so the kNN graph is non-degenerate
    centers = rng.normal(size=(20, d)).astype(np.float32) * 4
    data = (centers[rng.integers(0, 20, n)]
            + rng.normal(size=(n, d)).astype(np.float32))

    um = UMAP(n_neighbors=15, n_epochs=200)
    um.fit_transform(data)  # warm (compiles excluded)
    dt = _best_of(lambda x: um.fit_transform(x), _variants(data))
    out["umap_embed_seconds"] = round(dt, 2)
    out["umap_cells_per_s"] = round(n / dt, 1)

    # host comparison for the dominant stage: brute kNN (sklearn)
    from sklearn.neighbors import NearestNeighbors
    t0 = time.perf_counter()
    NearestNeighbors(n_neighbors=15, algorithm="brute").fit(
        data).kneighbors(data)
    out["umap_knn_host_sklearn_seconds"] = round(time.perf_counter() - t0, 2)

    # our kNN stage alone, honest readback
    import jax.numpy as jnp
    from ark_tpu.ops.umap import _knn
    dj = jnp.asarray(data)
    idx, dists = _knn(dj, 15)
    np.asarray(idx.sum() + dists.sum())  # warm + barrier
    dev_variants = [jnp.asarray(v) for v in _variants(data)]
    best = float("inf")
    for v in dev_variants:
        t0 = time.perf_counter()
        i2, d2 = _knn(v, 15)
        np.asarray(i2.sum() + d2.sum())
        best = min(best, time.perf_counter() - t0)
    out["umap_knn_device_seconds"] = round(best, 2)


def bench_tsne(n=5_000, d=16, n_iter=250, out=None):
    from ark_tpu.ops.tsne import tsne

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(10, d)).astype(np.float32) * 4
    data = (centers[rng.integers(0, 10, n)]
            + rng.normal(size=(n, d)).astype(np.float32))

    tsne(data, n_iter=n_iter)  # warm
    dt = _best_of(lambda x: tsne(x, n_iter=n_iter), _variants(data))
    out["tsne_device_seconds"] = round(dt, 2)
    out["tsne_n"] = n
    out["tsne_iters"] = n_iter

    from sklearn.manifold import TSNE as SkTSNE
    kw = {"max_iter": n_iter}
    try:
        SkTSNE(max_iter=n_iter)
    except TypeError:  # older sklearn spells it n_iter
        kw = {"n_iter": n_iter}
    t0 = time.perf_counter()
    SkTSNE(method="exact", init="pca", random_state=0,
           **kw).fit_transform(data)
    out["tsne_host_exact_seconds"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    SkTSNE(method="barnes_hut", init="pca", random_state=0,
           **kw).fit_transform(data)
    out["tsne_host_bh_seconds"] = round(time.perf_counter() - t0, 2)


def bench_kmeans(n=100_000, d=16, k=20, n_init=10, n_iter=50, out=None):
    from ark_tpu.ops.kmeans import kmeans

    rng = np.random.default_rng(2)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3
    data = (centers[rng.integers(0, k, n)]
            + rng.normal(size=(n, d)).astype(np.float32))

    kmeans(data, k, n_iter=n_iter, n_init=n_init)  # warm
    dt = _best_of(lambda x: kmeans(x, k, n_iter=n_iter, n_init=n_init),
                  _variants(data))
    out["kmeans_device_seconds"] = round(dt, 2)

    from sklearn.cluster import KMeans
    t0 = time.perf_counter()
    KMeans(n_clusters=k, n_init=n_init, max_iter=n_iter, random_state=0,
           algorithm="lloyd").fit(data)
    out["kmeans_host_sklearn_seconds"] = round(time.perf_counter() - t0, 2)
    out["kmeans_shape"] = f"{n}x{d} k={k} n_init={n_init}"


def _fiber_image(rng, size=1024, n_fibers=60):
    """Planted elongated ridges + noise (the bench relief; random noise
    alone gives frangi nothing to enhance)."""
    img = rng.normal(0.05, 0.02, size=(size, size)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n_fibers):
        x0, y0 = rng.uniform(0, size, 2)
        theta = rng.uniform(0, np.pi)
        length = rng.uniform(80, 300)
        nx, ny = -np.sin(theta), np.cos(theta)  # ridge normal
        tx, ty = np.cos(theta), np.sin(theta)
        t = (xx - x0) * tx + (yy - y0) * ty
        dist = np.abs((xx - x0) * nx + (yy - y0) * ny)
        prof = np.exp(-(dist ** 2) / (2 * 2.0 ** 2))
        prof *= ((t > 0) & (t < length))
        img += 0.6 * prof
    return np.clip(img, 0, 1)


def _host_fiber_equivalent(img, fiber_widths=(1, 3, 5, 7, 9),
                           ridge_cutoff=0.1, sobel_blur=1):
    """Stage-matched scipy/numpy pipeline (see module docstring)."""
    from scipy import ndimage as ndi

    blurred = ndi.gaussian_filter(img.astype(np.float64), 2)
    norm = blurred / max(blurred.max(), 1e-12)
    # same tile geometry the device program derives from
    # fov_len / contrast_scaling_divisor (=128)
    contrast = _clahe_numpy(norm, max(img.shape[0] // 128, 2))
    # frangi: scale-normalized hessian eigenvalues per sigma
    best = np.zeros_like(contrast)
    for sigma in fiber_widths:
        hrr = ndi.gaussian_filter(contrast, sigma, order=(2, 0)) * sigma ** 2
        hcc = ndi.gaussian_filter(contrast, sigma, order=(0, 2)) * sigma ** 2
        hrc = ndi.gaussian_filter(contrast, sigma, order=(1, 1)) * sigma ** 2
        tr, det_root = hrr + hcc, np.sqrt((hrr - hcc) ** 2 + 4 * hrc ** 2)
        e1, e2 = (tr - det_root) / 2, (tr + det_root) / 2
        swap = np.abs(e1) > np.abs(e2)
        l1 = np.where(swap, e2, e1)
        l2 = np.where(swap, e1, e2)
        rb2 = (l1 / np.where(l2 == 0, 1e-10, l2)) ** 2
        s2 = l1 ** 2 + l2 ** 2
        v = np.exp(-rb2 / (2 * 0.5 ** 2)) * (1 - np.exp(-s2 / (2 * 15. ** 2)))
        best = np.maximum(best, np.where(l2 < 0, v, 0.0))
    ridges = best * 10000
    fg = ridges > ridge_cutoff
    edt = ndi.distance_transform_edt(fg)
    dt = ndi.gaussian_filter(edt, 1)
    sb = ndi.gaussian_filter(dt, sobel_blur)
    elevation = np.hypot(ndi.sobel(sb, 0), ndi.sobel(sb, 1))
    return dt, elevation


def _clahe_numpy(img, kernel_size, clip_limit=0.01, nbins=256):
    """Vectorized host CLAHE (the tests' oracle formulation)."""
    img = np.asarray(img, np.float64)
    h, w = img.shape
    th = tw = int(kernel_size)
    n_tr, n_tc = -(-h // th), -(-w // tw)
    ph, pw = n_tr * th, n_tc * tw
    padded = np.pad(img, ((0, ph - h), (0, pw - w)), mode="symmetric")
    bins = np.clip((padded * (nbins - 1)).astype(np.int64), 0, nbins - 1)
    tile = (np.arange(ph)[:, None] // th) * n_tc + np.arange(pw)[None] // tw
    hists = np.bincount((tile * nbins + bins).ravel(),
                        minlength=n_tr * n_tc * nbins).reshape(
        n_tr, n_tc, nbins).astype(np.float64)
    clip = max(clip_limit * th * tw, 1.0)
    excess = np.maximum(hists - clip, 0).sum(axis=2, keepdims=True)
    hists = np.minimum(hists, clip) + excess / nbins
    cdf = np.cumsum(hists, axis=2)
    cdf /= cdf[:, :, -1:]
    yy = (np.arange(ph) + 0.5) / th - 0.5
    xx = (np.arange(pw) + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(yy).astype(int), 0, n_tr - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, n_tc - 1)
    y1, x1 = np.clip(y0 + 1, 0, n_tr - 1), np.clip(x0 + 1, 0, n_tc - 1)
    fy = np.clip(yy - y0, 0, 1)[:, None]
    fx = np.clip(xx - x0, 0, 1)[None, :]
    c00 = cdf[y0[:, None], x0[None, :], bins]
    c01 = cdf[y0[:, None], x1[None, :], bins]
    c10 = cdf[y1[:, None], x0[None, :], bins]
    c11 = cdf[y1[:, None], x1[None, :], bins]
    return (((1 - fy) * ((1 - fx) * c00 + fx * c01)
             + fy * ((1 - fx) * c10 + fx * c11)))[:h, :w]


def _host_fiber_tail(dt, elevation, min_fiber_size=15):
    from scipy import ndimage as ndi

    from ark_tpu.ops import classical, morphology, watershed as watershed_ops
    thresholds = classical.multi_otsu(dt, classes=3)
    threshed = np.zeros_like(dt)
    threshed[dt < thresholds[0]] = 1
    threshed[dt > thresholds[1]] = 2
    seg = np.maximum(
        watershed_ops.watershed(elevation.astype(np.float32),
                                threshed.astype(np.int32)) - 1, 0)
    labeled, _ = ndi.label(seg)
    return morphology.remove_small_objects(
        labeled, min_size=min_fiber_size) * seg


def bench_fiber(size=1024, out=None):
    from ark_tpu.segmentation.fiber_segmentation import _fiber_steps

    rng = np.random.default_rng(3)
    img = _fiber_image(rng, size)

    def e2e(x):
        return _fiber_steps(x, size, blur=2, contrast_scaling_divisor=128,
                            fiber_widths=tuple(range(1, 10, 2)),
                            ridge_cutoff=0.1, sobel_blur=1,
                            min_fiber_size=15, keep_intermediates=False)

    steps = e2e(img)  # warm
    n_fibers = int(steps["labeled_filtered"].max())
    dt = _best_of(e2e, _variants(img))
    out["fiber_e2e_seconds_per_fov"] = round(dt, 3)
    out["fiber_fovs_per_s"] = round(1 / dt, 2)
    out["fiber_objects_found"] = n_fibers

    # host equivalent, same stages + same tail
    def host_e2e(x):
        dtm, elev = _host_fiber_equivalent(x)
        return _host_fiber_tail(dtm, elev)

    host_lab = host_e2e(img)  # warm allocator; also sanity: finds objects
    out["fiber_host_objects_found"] = int(host_lab.max())
    hdt = _best_of(host_e2e, _variants(img))
    out["fiber_host_seconds_per_fov"] = round(hdt, 3)
    out["fiber_vs_host"] = round(hdt / dt, 2)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--only", default="umap,tsne,kmeans,fiber")
    args = p.parse_args()
    import jax
    out = {"backend": jax.default_backend()}
    todo = args.only.split(",")
    for name, fn in [("umap", bench_umap), ("tsne", bench_tsne),
                     ("kmeans", bench_kmeans), ("fiber", bench_fiber)]:
        if name in todo:
            t0 = time.perf_counter()
            fn(out=out)
            print(f"[{name}] done in {time.perf_counter() - t0:.1f}s",
                  file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
