"""UMAP embedding in JAX (replaces the umap-learn/numba dependency,
SURVEY.md §2.3 [NATIVE-adjacent]).

Standard UMAP recipe, each stage a device computation:
  1. exact kNN via the blocked distance kernel + top_k,
  2. per-point bandwidth by binary search so Σ exp(−(d−ρ)/σ) = log2(k),
  3. fuzzy simplicial set symmetrization  w ∪ wᵀ = w + wᵀ − w∘wᵀ,
  4. PCA initialization,
  5. jitted SGD epochs of the UMAP cross-entropy: attractive updates along
     kNN edges, repulsive updates against per-edge random negatives —
     vectorized over all edges per epoch (no per-sample Python loop).

Distribution-level behavioral parity with umap-learn (same objective, same
default a/b curve for min_dist=0.1); embeddings differ by run as they do
between umap-learn versions/seeds.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# precomputed curve parameters for (spread=1.0, min_dist=0.1), the
# umap-learn defaults
_A, _B = 1.576943, 0.895061


@functools.partial(jax.jit, static_argnames=("k", "block_cols"))
def _knn_row_block(rows: jax.Array, row_idx: jax.Array, data: jax.Array,
                   n: int, k: int, block_cols: int):
    """Exact kNN of `rows` (B, C) against `data` (padded to a multiple of
    block_cols), via a lax.scan over column blocks with a running top-k
    merge — peak memory O(B·block_cols + B·k), never N².

    data rows at positions >= n are padding; they and the self-match are
    masked to +inf. Returns (idx (B, k) int32, sqdist (B, k))."""
    n_pad = data.shape[0]
    blocks = data.reshape(n_pad // block_cols, block_cols, -1)
    r2 = jnp.sum(rows * rows, axis=1)                              # (B,)

    def merge(carry, args):
        best_d, best_i = carry
        blk, offset = args                                  # (Bc, C), scalar
        col_idx = offset + jnp.arange(block_cols, dtype=jnp.int32)
        c2 = jnp.sum(blk * blk, axis=1)
        # HIGHEST: f32 neighbor ranks (a default-precision matmul may run
        # in bf16 or TF32)
        d = r2[:, None] - 2.0 * jnp.dot(
            rows, blk.T,
            precision=jax.lax.Precision.HIGHEST) + c2[None, :]
        invalid = (col_idx[None, :] >= n) | \
                  (col_idx[None, :] == row_idx[:, None])
        d = jnp.where(invalid, jnp.inf, d)
        dcat = jnp.concatenate([best_d, d], axis=1)
        icat = jnp.concatenate(
            [best_i, jnp.broadcast_to(col_idx, d.shape)], axis=1)
        neg_top, pos = jax.lax.top_k(-dcat, k)
        return (-neg_top, jnp.take_along_axis(icat, pos, axis=1)), None

    b = rows.shape[0]
    init = (jnp.full((b, k), jnp.inf),
            jnp.full((b, k), -1, jnp.int32))
    offsets = jnp.arange(0, n_pad, block_cols, dtype=jnp.int32)
    (best_d, best_i), _ = jax.lax.scan(merge, init, (blocks, offsets))
    return best_i, jnp.maximum(best_d, 0.0)


def _knn(data: jax.Array, k: int, block_rows: int = 4096,
         block_cols: int = 2048) -> Tuple[jax.Array, jax.Array]:
    """(indices (N,k), dists (N,k)) of each point's k nearest euclidean
    neighbors (self excluded), exact, blocked: O(N·k + block area) memory
    (a 200k-cell cohort table at f32 would need 160 GB for the full N×N
    matrix; blocked it needs ~32 MB). Outer row blocks loop on host (one
    compiled program reused); inner column blocks scan on device."""
    n, c = data.shape
    k = min(k, n - 1)
    block_cols = min(block_cols, max(256, 1 << (n - 1).bit_length()))
    n_pad = ((n + block_cols - 1) // block_cols) * block_cols
    data_padded = jnp.pad(data, ((0, n_pad - n), (0, 0)))
    block_rows = min(block_rows, n_pad)
    # separate row padding so every row block slices in-bounds and aligned
    n_pad_rows = ((n_pad + block_rows - 1) // block_rows) * block_rows
    data_rows = jnp.pad(data_padded, ((0, n_pad_rows - n_pad), (0, 0)))
    idx_out, d_out = [], []
    for r0 in range(0, n, block_rows):
        rows = jax.lax.dynamic_slice_in_dim(data_rows, r0, block_rows)
        row_idx = r0 + jnp.arange(block_rows, dtype=jnp.int32)
        bi, bd = _knn_row_block(rows, row_idx, data_padded, n, k, block_cols)
        idx_out.append(bi)
        d_out.append(bd)
    idx = jnp.concatenate(idx_out)[:n]
    d = jnp.concatenate(d_out)[:n]
    return idx, jnp.sqrt(d)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def _smooth_knn(dists: jax.Array, n_iter: int = 64):
    """Per-point (rho, sigma): rho = nearest distance; sigma solves
    Σ_j exp(−max(d_ij − ρ, 0)/σ) = log2(k) by bisection."""
    k = dists.shape[1]
    target = jnp.log2(float(k))
    rho = dists[:, 0]
    shifted = jnp.maximum(dists - rho[:, None], 0.0)

    def phi(sigma):
        return jnp.sum(jnp.exp(-shifted / sigma[:, None]), axis=1)

    lo = jnp.full(dists.shape[0], 1e-6)
    hi = jnp.full(dists.shape[0], 1e3)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) / 2.0
        val = phi(mid)
        too_big = val > target
        return jnp.where(too_big, lo, mid), jnp.where(too_big, mid, hi)

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    return rho, (lo + hi) / 2.0


@functools.lru_cache(maxsize=8)
def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Least-squares fit of the low-dim similarity curve 1/(1 + a d^{2b})
    to the target exp falloff, exactly as umap-learn's find_ab_params —
    this is what makes `min_dist` a real parameter instead of a hardwired
    (a, b) for min_dist=0.1."""
    if (spread, min_dist) == (1.0, 0.1):
        return _A, _B                      # precomputed default
    from scipy.optimize import curve_fit
    xv = np.linspace(0.0, spread * 3.0, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2.0 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(_A, _B), maxfev=10000)
    return float(a), float(b)


@functools.partial(jax.jit, static_argnames=("n_epochs", "negative_sample_rate"))
def _optimize(emb0: jax.Array, heads: jax.Array, tails: jax.Array,
              weights: jax.Array, key, n_epochs: int = 200,
              negative_sample_rate: int = 5,
              initial_lr: float = 1.0, a: float = _A,
              b: float = _B) -> jax.Array:
    """SGD over the UMAP cross-entropy, all edges per epoch.

    Update accumulation is two sorted `segment_sum`s per epoch instead of
    six scatter-adds: the edge endpoints are loop-invariant, so heads/tails
    are argsorted ONCE (XLA hoists it out of the scan) and every epoch's
    per-edge updates are permuted into sorted order and segment-summed with
    `indices_are_sorted=True` — the duplicate-index scatter-add becomes a
    contiguous segmented reduction. All
    `negative_sample_rate` negatives are drawn and accumulated in one
    phase (gradients at the epoch-start embedding, like the attractive
    phase) rather than five sequential scatter rounds; this is a different
    SGD sample schedule than umap-learn's per-edge async loop, gated by the
    embedding-quality goldens (tests/ops/test_umap_quality.py)."""
    n = emb0.shape[0]
    n_edges = heads.shape[0]

    # loop-invariant sorted-segment machinery (hoisted out of the scan)
    perm_h = jnp.argsort(heads)
    sorted_heads = jnp.take(heads, perm_h)
    perm_t = jnp.argsort(tails)
    sorted_tails = jnp.take(tails, perm_t)

    def seg_add(emb, update, perm, sorted_ids):
        contrib = jax.ops.segment_sum(
            jnp.take(update, perm, axis=0), sorted_ids,
            num_segments=n, indices_are_sorted=True)
        return emb + contrib

    def epoch(carry, t):
        emb, key = carry
        lr = initial_lr * (1.0 - t / n_epochs)
        he = jnp.take(emb, heads, axis=0)
        ta = jnp.take(emb, tails, axis=0)
        diff = he - ta
        d2 = jnp.sum(diff * diff, axis=1)
        # attractive gradient: dCE/dd2 for w_ij ~ 1/(1 + a d2^b);
        # clamp d2 away from 0 (d2^(b-1) diverges there) and zero the grad
        d2s = jnp.maximum(d2, 1e-8)
        grad_coef = jnp.where(
            d2 > 0.0,
            -2.0 * a * b * d2s ** (b - 1.0) / (1.0 + a * d2s ** b),
            0.0)
        attract = jnp.clip(grad_coef[:, None] * diff, -4.0, 4.0) \
            * weights[:, None]

        # repulsion: all negative samples for every edge in one phase
        key, sub = jax.random.split(key)
        negs = jax.random.randint(
            sub, (negative_sample_rate, n_edges), 0, n)
        # explicit last dim: -1 can't be inferred when the static
        # negative_sample_rate is 0 (size-0 reshape)
        ne = jnp.take(emb, negs.reshape(-1), axis=0).reshape(
            negative_sample_rate, n_edges, emb.shape[1])
        ndiff = he[None, :, :] - ne
        nd2 = jnp.sum(ndiff * ndiff, axis=2)
        ncoef = 2.0 * b / ((0.001 + nd2) * (1.0 + a * nd2 ** b))
        # clip per negative-sample contribution (as the sequential loop
        # did), then accumulate over the sample axis
        repel = jnp.sum(
            jnp.clip(ncoef[:, :, None] * ndiff, -4.0, 4.0)
            * weights[None, :, None], axis=0)

        emb = seg_add(emb, lr * (attract + repel), perm_h, sorted_heads)
        emb = seg_add(emb, -lr * attract, perm_t, sorted_tails)
        return (emb, key), None

    (emb, _), _ = jax.lax.scan(epoch, (emb0, key),
                               jnp.arange(n_epochs, dtype=jnp.float32))
    return emb


@functools.partial(jax.jit, static_argnames=("n_epochs", "negative_sample_rate"))
def _optimize_scatter(emb0: jax.Array, heads: jax.Array, tails: jax.Array,
                      weights: jax.Array, key, n_epochs: int = 200,
                      negative_sample_rate: int = 5,
                      initial_lr: float = 1.0, a: float = _A,
                      b: float = _B) -> jax.Array:
    """The pre-r4 epoch loop (6 duplicate-index scatter-adds per epoch,
    sequential negative-sample phases). Kept non-default as the
    zero-negatives test oracle for `_optimize`."""
    n = emb0.shape[0]
    n_edges = heads.shape[0]

    def epoch(carry, t):
        emb, key = carry
        lr = initial_lr * (1.0 - t / n_epochs)
        he = jnp.take(emb, heads, axis=0)
        ta = jnp.take(emb, tails, axis=0)
        diff = he - ta
        d2 = jnp.sum(diff * diff, axis=1)
        d2s = jnp.maximum(d2, 1e-8)
        grad_coef = jnp.where(
            d2 > 0.0,
            -2.0 * a * b * d2s ** (b - 1.0) / (1.0 + a * d2s ** b),
            0.0)
        attract = jnp.clip(grad_coef[:, None] * diff, -4.0, 4.0) \
            * weights[:, None]
        emb = emb.at[heads].add(lr * attract)
        emb = emb.at[tails].add(-lr * attract)

        def neg(carry, _):
            emb, key = carry
            key, sub = jax.random.split(key)
            negs = jax.random.randint(sub, (n_edges,), 0, n)
            he = jnp.take(emb, heads, axis=0)
            ne = jnp.take(emb, negs, axis=0)
            diff = he - ne
            d2 = jnp.sum(diff * diff, axis=1)
            coef = 2.0 * b / ((0.001 + d2) * (1.0 + a * d2 ** b))
            repel = jnp.clip(coef[:, None] * diff, -4.0, 4.0) \
                * weights[:, None]
            emb = emb.at[heads].add(lr * repel)
            return (emb, key), None

        (emb, key), _ = jax.lax.scan(neg, (emb, key), None,
                                     length=negative_sample_rate)
        return (emb, key), None

    (emb, _), _ = jax.lax.scan(epoch, (emb0, key),
                               jnp.arange(n_epochs, dtype=jnp.float32))
    return emb


def umap_epoch_sharded(emb, heads, tails, weights, key, mesh, lr: float,
                       negative_sample_rate: int = 5, a: float = _A,
                       b: float = _B, data_axis: str = "fov"):
    """One UMAP optimization epoch with the EDGE list sharded over the
    mesh: each shard computes attract + negative-sample repel deltas for
    its edges against the epoch-start embedding; the (N, d) deltas `psum`
    across devices and apply once. Batch-synchronous like the single-device
    `_optimize` epoch (since r4 both compute all phases against the
    epoch-start embedding) — the standard data-parallel relaxation (same
    fixed points, slightly different trajectory than per-edge async SGD).

    Edge count must be divisible by the mesh size — pad with
    (head=0, tail=0, weight=0) edges: zero weight zeroes both the attract
    and repel contributions. Negative samples differ per shard via
    `fold_in(key, axis_index)`. Returns the updated replicated embedding.
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = emb.shape[0]

    def shard(emb, he, ta, w, key):
        key = jax.random.fold_in(key, jax.lax.axis_index(data_axis))
        hpos = jnp.take(emb, he, axis=0)
        tpos = jnp.take(emb, ta, axis=0)
        diff = hpos - tpos
        d2 = jnp.sum(diff * diff, axis=1)
        d2s = jnp.maximum(d2, 1e-8)
        grad_coef = jnp.where(
            d2 > 0.0,
            -2.0 * a * b * d2s ** (b - 1.0) / (1.0 + a * d2s ** b), 0.0)
        attract = jnp.clip(grad_coef[:, None] * diff, -4.0, 4.0) * w[:, None]
        delta = jnp.zeros_like(emb).at[he].add(lr * attract)
        delta = delta.at[ta].add(-lr * attract)

        def neg(carry, _):
            delta, key = carry
            key, sub = jax.random.split(key)
            negs = jax.random.randint(sub, he.shape, 0, n)
            diff = hpos - jnp.take(emb, negs, axis=0)
            d2 = jnp.sum(diff * diff, axis=1)
            coef = 2.0 * b / ((0.001 + d2) * (1.0 + a * d2 ** b))
            repel = jnp.clip(coef[:, None] * diff, -4.0, 4.0) * w[:, None]
            return (delta.at[he].add(lr * repel), key), None

        (delta, _), _ = jax.lax.scan(neg, (delta, key), None,
                                     length=negative_sample_rate)
        return emb + jax.lax.psum(delta, data_axis)

    edge_sh = NamedSharding(mesh, P(data_axis))
    repl = NamedSharding(mesh, P())
    fn = shard_map(shard, mesh=mesh,
                   in_specs=(P(), P(data_axis), P(data_axis), P(data_axis),
                             P()),
                   out_specs=P())
    return fn(jax.device_put(jnp.asarray(emb, jnp.float32), repl),
              jax.device_put(jnp.asarray(heads, jnp.int32), edge_sh),
              jax.device_put(jnp.asarray(tails, jnp.int32), edge_sh),
              jax.device_put(jnp.asarray(weights, jnp.float32), edge_sh),
              jax.device_put(key, repl))


def _pca(data: jax.Array, n_components: int = 2) -> jax.Array:
    x = data - data.mean(0, keepdims=True)
    cov = (x.T @ x) / x.shape[0]
    vals, vecs = jnp.linalg.eigh(cov)
    return x @ vecs[:, ::-1][:, :n_components]


class UMAP:
    """umap-learn-compatible front: UMAP().fit_transform(X) -> (N, 2)."""

    def __init__(self, n_neighbors: int = 15, n_components: int = 2,
                 min_dist: float = 0.1, spread: float = 1.0,
                 n_epochs: int = 200, negative_sample_rate: int = 5,
                 random_state: int = 42):
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.min_dist = float(min_dist)
        self.spread = float(spread)
        self.n_epochs = n_epochs
        self.negative_sample_rate = negative_sample_rate
        self.random_state = random_state

    def fit_transform(self, data) -> np.ndarray:
        data = jnp.asarray(np.asarray(data), jnp.float32)
        n = data.shape[0]
        k = min(self.n_neighbors, n - 1)
        idx, dists = _knn(data, k)
        rho, sigma = _smooth_knn(dists)
        w = jnp.exp(-jnp.maximum(dists - rho[:, None], 0.0)
                    / sigma[:, None])                               # (N, k)
        heads = jnp.repeat(jnp.arange(n), k)
        tails = idx.reshape(-1)
        wflat = w.reshape(-1)
        # symmetrize without materializing N×N: the reverse weight w(j, i)
        # is nonzero only if i appears in j's kNN list, so look it up in the
        # (N, k) structure directly — O(N·k²) gathered compares
        w_rev = jnp.sum(
            jnp.take(w, tails, axis=0)
            * (jnp.take(idx, tails, axis=0) == heads[:, None]), axis=1)
        w_edges = wflat + w_rev - wflat * w_rev

        emb0 = _pca(data, self.n_components)
        emb0 = emb0 / (jnp.abs(emb0).max() + 1e-12) * 10.0
        a, b = find_ab_params(self.spread, self.min_dist)
        emb = _optimize(emb0, heads, tails, w_edges,
                        jax.random.PRNGKey(self.random_state),
                        n_epochs=self.n_epochs,
                        negative_sample_rate=self.negative_sample_rate,
                        a=a, b=b)
        return np.asarray(emb)


def pca_transform(data, n_components: int = 2) -> np.ndarray:
    """Device PCA projection (covariance eigendecomposition)."""
    return np.asarray(_pca(jnp.asarray(np.asarray(data), jnp.float32),
                           n_components))
