"""Pairwise-distance kernels (reference: per-FOV `scipy.cdist`,
`spatial_analysis_utils.py:55`). One fused XLA matmul-based kernel; for very
large FOVs the matrix is computed in row blocks to bound memory."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def shape_bucket(n: int, floor: int = 128) -> int:
    """Next power-of-two shape bucket (≥ floor).

    Per-FOV device programs (cdist, enrichment P·D·Pᵀ) see a different
    cell count N per FOV; unpadded calls trace + compile a fresh
    executable per FOV — ~100 compiles per 100-FOV cohort. Zero-padding
    to a bucket keeps one executable per
    bucket; callers slice the real block back out (value-exact)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def squared_distances(a: jax.Array, b: jax.Array,
                      zero_diagonal: bool = False) -> jax.Array:
    """(N, M) squared euclidean distances between rows of a and b —
    traceable (callable inside jit); the ONE implementation of the
    close-pair numerics policy, shared by `pairwise_distances` and the
    t-SNE kernels (`ops/tsne.py`).

    D ≤ 4 (centroid/embedding space) computes |a−b|² DIRECTLY: the
    ||a||²−2ab+||b||² decomposition cancels catastrophically for close
    pairs at large coordinate magnitudes (f32 eps at ‖a‖² ~ 5e7 is ±4 in
    d², so two cells 1.5 px apart at the far corner of a 5000-px stage
    computed d = 0 and were dropped by downstream `dist > 0`
    self-exclusion masks — caught by the config-5 oracle), and a K=2
    contraction gains nothing from a matrix unit. The per-axis terms are
    unrolled (N, M) buffers rather than one (N, M, D) broadcast tensor:
    XLA fuses the adds, peak memory stays one (N, M) buffer. Larger D
    (feature space) keeps the decomposition (matmul at HIGHEST precision
    — a default-precision f32 matmul may run in bf16 or TF32, which would
    round the coordinates ~0.1-0.4% relative while the CPU suite validates
    true-f32 numerics),
    floored at 0.

    `zero_diagonal=True` forces d²_ii to exact 0 (float accumulation
    leaves small positive values that break `dist > 0` self-exclusion)."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    if a.shape[1] <= 4:
        d2 = None
        for k in range(a.shape[1]):
            diff = a[:, k][:, None] - b[:, k][None, :]
            term = diff * diff
            d2 = term if d2 is None else d2 + term
    else:
        a2 = jnp.sum(a * a, axis=1)[:, None]
        b2 = jnp.sum(b * b, axis=1)[None, :]
        d2 = a2 + b2 - 2.0 * jnp.dot(a, b.T,
                                     precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.maximum(d2, 0.0)
    if zero_diagonal:
        n, m = d2.shape
        eye = jnp.arange(n)[:, None] == jnp.arange(m)[None, :]
        d2 = jnp.where(eye, 0.0, d2)
    return d2


@functools.partial(jax.jit, static_argnames=("zero_diagonal",))
def pairwise_distances(a: jax.Array, b: jax.Array,
                       zero_diagonal: bool = False) -> jax.Array:
    """Euclidean distances between rows of a (N,D) and b (M,D); (N, M).

    See `squared_distances` for the D ≤ 4 direct-difference policy and the
    exact-zero-diagonal rationale."""
    return jnp.sqrt(squared_distances(a, b, zero_diagonal=zero_diagonal))


def cdist(a, b=None, block_rows: int = 8192) -> np.ndarray:
    """scipy.spatial.distance.cdist equivalent on device; returns numpy.

    Splits rows into blocks when N is large so the (N, M) output is the only
    full-size buffer.
    """
    a = np.asarray(a, np.float32)
    self_dist = b is None
    b = a if self_dist else np.asarray(b, np.float32)
    n = a.shape[0]
    # exact-zero self distances when b is None: downstream `dist > 0` masks
    # depend on it, and the matmul decomposition leaves small positive
    # diagonal values
    if n <= block_rows:
        return np.asarray(pairwise_distances(
            jnp.asarray(a), jnp.asarray(b), zero_diagonal=self_dist))
    out = np.empty((n, b.shape[0]), np.float32)
    bj = jnp.asarray(b)
    for i in range(0, n, block_rows):
        out[i:i + block_rows] = np.asarray(
            pairwise_distances(jnp.asarray(a[i:i + block_rows]), bj))
    if self_dist:
        np.fill_diagonal(out, 0.0)
    return out


@functools.partial(jax.jit, static_argnames=("k",))
def knn_mean_distance(dist_cols: jax.Array, k: int) -> jax.Array:
    """Mean of the k smallest positive entries per row of (N, M) distances
    (used by cell_neighborhood_stats; reference sorts full columns)."""
    masked = jnp.where(dist_cols > 0, dist_cols, jnp.inf)
    neg_topk, _ = jax.lax.top_k(-masked, k)
    return jnp.mean(-neg_topk, axis=1)


@jax.jit
def _neighbor_count_block(block: jax.Array, all_coords: jax.Array,
                          onehot: jax.Array, dist_lim: jax.Array,
                          row_offset: jax.Array) -> jax.Array:
    """(B, P) neighbor-phenotype counts for one row block: distances from
    `block` to every cell, thresholded, matmul'd against the one-hot
    phenotype matrix. Exclusion follows the reference's `dist == 0` rule
    (`compute_neighbor_counts` with self_neighbor=False) — the diagonal is
    forced to exact 0 by index so the matmul's small positive self-distances
    can't leak the cell back in."""
    d = pairwise_distances(block, all_coords)
    n_b = block.shape[0]
    self_mask = (jnp.arange(n_b)[:, None] + row_offset
                 == jnp.arange(all_coords.shape[0])[None, :])
    d = jnp.where(self_mask, 0.0, d)
    close = ((d < dist_lim) & (d > 0)).astype(jnp.float32)
    return jnp.dot(close, onehot, precision=jax.lax.Precision.HIGHEST)


def blocked_neighbor_counts(coords, onehot, dist_lim: float,
                            block_rows: int = 4096) -> np.ndarray:
    """Per-cell neighbor-phenotype counts WITHOUT the (N, N) distance
    matrix: peak device memory is one (block_rows, N) block.

    The reference materializes the full per-FOV distance matrix and then
    matmuls (`spatial_analysis_utils.py:277-338`) — at >50k cells that
    matrix alone is 10+ GB (BASELINE.json config 5); this streams row
    blocks through the same thresholded matmul and keeps only the (N, P)
    counts.

    Args: coords (N, 2/D) float centroids; onehot (N, P) phenotype matrix;
    dist_lim: neighborhood radius. Returns (N, P) float32 counts.
    """
    coords = np.asarray(coords, np.float32)
    onehot_j = jnp.asarray(onehot, jnp.float32)
    all_j = jnp.asarray(coords)
    n = coords.shape[0]
    out = np.empty((n, onehot_j.shape[1]), np.float32)
    lim = jnp.float32(dist_lim)
    for i in range(0, n, block_rows):
        blk = all_j[i:i + block_rows]
        out[i:i + blk.shape[0]] = np.asarray(_neighbor_count_block(
            blk, all_j, onehot_j, lim, jnp.int32(i)))
    return out


@jax.jit
def _silhouette_block(block: jax.Array, row_labels: jax.Array,
                      data: jax.Array, onehot: jax.Array,
                      counts: jax.Array, row_offset: jax.Array) -> jax.Array:
    """Per-point silhouette values for one row block: distance sums to
    every cluster via one (B, N)·(N, K) matmul, then the standard
    a/b/max(a, b) combination. Self-distances are forced to exact 0 by
    index (the D>4 matmul decomposition leaves small positive diagonals) so
    a_i is a true mean over the OTHER same-cluster points."""
    d = jnp.sqrt(squared_distances(block, data))
    n_b = block.shape[0]
    self_mask = (jnp.arange(n_b)[:, None] + row_offset
                 == jnp.arange(data.shape[0])[None, :])
    d = jnp.where(self_mask, 0.0, d)
    sums = jnp.dot(d, onehot, precision=jax.lax.Precision.HIGHEST)  # (B, K)
    own_count = counts[row_labels]                                  # (B,)
    own_sum = jnp.take_along_axis(sums, row_labels[:, None], 1)[:, 0]
    a = own_sum / jnp.maximum(own_count - 1.0, 1.0)
    own_oh = jax.nn.one_hot(row_labels, onehot.shape[1], dtype=bool)
    mean_other = sums / jnp.maximum(counts[None, :], 1.0)
    # empty clusters (count 0) must never win the min
    mean_other = jnp.where(counts[None, :] > 0, mean_other, jnp.inf)
    b = jnp.min(jnp.where(own_oh, jnp.inf, mean_other), axis=1)
    s = (b - a) / jnp.maximum(jnp.maximum(a, b), 1e-30)
    # sklearn convention: singleton clusters score 0
    return jnp.where(own_count > 1.0, s, 0.0)


def silhouette_score(data, labels, block_rows: int = 4096) -> float:
    """Mean euclidean silhouette coefficient on device, computed in row
    blocks — drop-in for `sklearn.metrics.silhouette_score(X, labels)`
    (the reference's topic-EDA metric, `spLDA/processing.py:194-304`)
    without materializing the (N, N) distance matrix: peak device memory
    is one (block_rows, N) block, the per-cluster reduction is a matmul.
    """
    data = np.asarray(data, np.float32)
    labels = np.asarray(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    n = data.shape[0]
    if not 2 <= len(uniq) <= n - 1:
        raise ValueError(
            f"Number of labels is {len(uniq)}. Valid values are 2 "
            f"to n_samples - 1 (inclusive)")
    k = len(uniq)
    onehot_j = jnp.asarray(np.eye(k, dtype=np.float32)[inv])
    counts_j = jnp.asarray(np.bincount(inv, minlength=k).astype(np.float32))
    data_j = jnp.asarray(data)
    labels_j = jnp.asarray(inv.astype(np.int32))
    total = 0.0
    for i in range(0, n, block_rows):
        blk = data_j[i:i + block_rows]
        s = _silhouette_block(blk, labels_j[i:i + block_rows], data_j,
                              onehot_j, counts_j, jnp.int32(i))
        total += float(jnp.sum(s))
    return total / n
