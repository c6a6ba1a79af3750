"""t-SNE on device: exact (dense) gradient, one jitted `lax.scan`.

The reference's visualization path delegates to single-thread sklearn
(`src/ark/analysis/dimensionality_reduction.py:85`); this is the device
replacement. Exact t-SNE is the right accelerator formulation at
cytometry scales: the (N, N) affinity and gradient matrices are dense
matmul/broadcast work (N = 10k → 400 MB f32 transients, comfortably in
device memory), whereas Barnes–Hut trees are pointer-chasing. Pipelines
subsample to ~1e4 cells for embedding plots, so O(N²) per iteration is
a non-issue on device.

Algorithm (van der Maaten & Hinton 2008, matching sklearn semantics):
  - per-point conditional affinities with a vectorized 64-step binary
    search of sigma to hit the target perplexity,
  - symmetrize + normalize, early exaggeration (×12) for the first quarter
    of the schedule,
  - Student-t low-dimensional kernel, gradient descent with momentum
    (0.5 → 0.8) and sklearn-style per-parameter gains,
  - learning_rate="auto" = max(N / early_exaggeration / 4, 50) = max(N/48,
    50), sklearn ≥1.1's default.

Deterministic per seed (PCA-free random init, jax.random).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _squared_dists(x: jax.Array) -> jax.Array:
    """(N, N) squared euclidean distances, exact-zero diagonal — the shared
    `ops/distances.squared_distances` kernel (one source of truth for the
    D ≤ 4 close-pair cancellation policy)."""
    from ark_tpu.ops.distances import squared_distances

    return squared_distances(x, x, zero_diagonal=True)


@functools.partial(jax.jit, static_argnames=("perplexity",))
def _conditional_affinities(d2: jax.Array, perplexity: float) -> jax.Array:
    """Row-stochastic P(j|i) at the target perplexity via a per-row
    64-step bisection on beta = 1/(2 sigma²)."""
    n = d2.shape[0]
    eye = jnp.eye(n, dtype=bool)
    target = jnp.log(perplexity)

    def entropy_and_p(beta):
        logits = -d2 * beta[:, None]
        logits = jnp.where(eye, -jnp.inf, logits)
        logp = jax.nn.log_softmax(logits, axis=1)
        p = jnp.exp(logp)
        h = -jnp.sum(jnp.where(p > 0, p * logp, 0.0), axis=1)
        return h, p

    def body(_, lohi):
        lo, hi = lohi
        mid = jnp.sqrt(lo * hi)             # geometric: beta spans decades
        h, _ = entropy_and_p(mid)
        too_smooth = h > target             # entropy too high -> raise beta
        lo = jnp.where(too_smooth, mid, lo)
        hi = jnp.where(too_smooth, hi, mid)
        return lo, hi

    lo = jnp.full((n,), 1e-12, jnp.float32)
    hi = jnp.full((n,), 1e12, jnp.float32)
    lo, hi = jax.lax.fori_loop(0, 64, body, (lo, hi))
    _, p = entropy_and_p(jnp.sqrt(lo * hi))
    return p


@functools.partial(jax.jit,
                   static_argnames=("n_iter", "n_exaggeration", "n_components"))
def _embed(p_sym: jax.Array, key, n_iter: int, n_exaggeration: int,
           learning_rate: float, n_components: int = 2) -> jax.Array:
    n = p_sym.shape[0]
    y0 = 1e-4 * jax.random.normal(key, (n, n_components), jnp.float32)
    eye = jnp.eye(n, dtype=bool)

    def grad(y, p):
        d2 = _squared_dists(y)
        w = 1.0 / (1.0 + d2)                       # student-t kernel
        w = jnp.where(eye, 0.0, w)
        q = w / jnp.maximum(jnp.sum(w), 1e-12)
        pq = (p - q) * w                           # (N, N)
        # 4 * sum_j pq_ij (y_i - y_j) = 4 * (rowsum(pq) * y_i - pq @ y)
        return 4.0 * (jnp.sum(pq, axis=1)[:, None] * y
                      - jnp.dot(pq, y,
                                precision=jax.lax.Precision.HIGHEST))

    def step(carry, it):
        y, vel, gains = carry
        p = jnp.where(it < n_exaggeration, p_sym * 12.0, p_sym)
        momentum = jnp.where(it < n_exaggeration, 0.5, 0.8)
        g = grad(y, p)
        same_dir = jnp.sign(g) == jnp.sign(vel)
        gains = jnp.clip(jnp.where(same_dir, gains * 0.8, gains + 0.2),
                         0.01, None)
        vel = momentum * vel - learning_rate * gains * g
        y = y + vel
        y = y - jnp.mean(y, axis=0, keepdims=True)
        return (y, vel, gains), None

    init = (y0, jnp.zeros_like(y0), jnp.ones_like(y0))
    (y, _, _), _ = jax.lax.scan(step, init, jnp.arange(n_iter))
    return y


def tsne(x, n_components: int = 2, perplexity: float = 30.0,
         n_iter: int = 1000, learning_rate="auto", seed: int = 42
         ) -> np.ndarray:
    """Embed (N, D) data to (N, n_components) via exact device t-SNE."""
    x = jnp.asarray(np.asarray(x, np.float32))
    n = x.shape[0]
    if n < 4:
        raise ValueError("t-SNE needs at least 4 points")
    perplexity = float(min(perplexity, (n - 1) / 3.0))
    if learning_rate == "auto":
        learning_rate = max(n / 12.0 / 4.0, 50.0)
    d2 = _squared_dists(x)
    p_cond = _conditional_affinities(d2, perplexity)
    p_sym = (p_cond + p_cond.T) / (2.0 * n)
    p_sym = jnp.maximum(p_sym, 1e-12)
    y = _embed(p_sym, jax.random.PRNGKey(seed), int(n_iter),
               max(int(n_iter) // 4, 1), float(learning_rate),
               int(n_components))
    return np.asarray(y)


class TSNE:
    """sklearn-compatible facade over `tsne` (drop-in for the reference's
    `sklearn.manifold.TSNE().fit_transform` call)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 n_iter: int = 1000, learning_rate="auto",
                 random_state: int = 42):
        self.n_components = n_components
        self.perplexity = perplexity
        self.n_iter = n_iter
        self.learning_rate = learning_rate
        self.random_state = random_state

    def fit_transform(self, x) -> np.ndarray:
        self.embedding_ = tsne(
            x, n_components=self.n_components, perplexity=self.perplexity,
            n_iter=self.n_iter, learning_rate=self.learning_rate,
            seed=self.random_state if self.random_state is not None else 42)
        return self.embedding_
