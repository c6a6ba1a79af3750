"""Spatial latent Dirichlet allocation in JAX.

Replaces the reference's external `spatial_lda` package (ADMM-regularized LDA
called from `templates/LDA_Training_and_Inference.ipynb` via
`spatial_lda.model.train/infer`; SURVEY.md §2.3 [NATIVE-adjacent]).

Design: batch variational EM (Blei et al.) as one jitted `lax.fori_loop` —
the E-step's doc-topic updates and the M-step's sufficient statistics are
dense matmuls over the (cells × features) count matrix — plus a spatial
regularization step each outer iteration: a proximal graph-Laplacian
smoothing of the cell-topic distributions over the FOV's MST adjacency
(difference matrices), with strength `difference_penalty`. This is a
gradient-flow form of the reference dependency's ADMM difference penalty
(convergence target differs in the same way batch-vs-ADMM solvers do;
topic recovery is validated distributionally in tests).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd


class LatentDirichletAllocation:
    """Fitted spatial-LDA model: components_ (topics × features) and
    topic_weights (cells × topics DataFrame, (fov, cell) MultiIndex)."""

    def __init__(self, components_: np.ndarray, topic_weights: pd.DataFrame,
                 feature_names, n_topics: int, alpha: float, eta: float):
        self.components_ = components_
        self.topic_weights = topic_weights
        self.feature_names = list(feature_names)
        self.n_topics = n_topics
        self.alpha = alpha
        self.eta = eta


@functools.partial(jax.jit, static_argnames=("n_topics", "n_iter", "e_steps"))
def _lda_em(X: jax.Array, L: jax.Array, key, n_topics: int,
            alpha: float, eta: float, penalty: float, n_iter: int = 50,
            e_steps: int = 20):
    """Batch variational EM with Laplacian smoothing.

    X: (N, V) counts; L: (N, N) graph Laplacian (zeros when no smoothing).
    Returns (lambda (K, V), gamma (N, K)).
    """
    n, v = X.shape
    k = n_topics
    digamma = jax.scipy.special.digamma

    lam = jax.random.gamma(key, 100.0, (k, v)) * 0.01
    gamma = jnp.ones((n, k))

    def e_step(lam, gamma):
        elog_beta = digamma(lam) - digamma(lam.sum(1, keepdims=True))
        exp_elog_beta = jnp.exp(elog_beta)                     # (K, V)

        def inner(_, gamma):
            elog_theta = digamma(gamma) - digamma(gamma.sum(1, keepdims=True))
            exp_elog_theta = jnp.exp(elog_theta)               # (N, K)
            phinorm = exp_elog_theta @ exp_elog_beta + 1e-100  # (N, V)
            return alpha + exp_elog_theta * (
                (X / phinorm) @ exp_elog_beta.T)
        gamma = jax.lax.fori_loop(0, e_steps, inner, gamma)
        elog_theta = digamma(gamma) - digamma(gamma.sum(1, keepdims=True))
        exp_elog_theta = jnp.exp(elog_theta)
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
        sstats = exp_elog_beta * (exp_elog_theta.T @ (X / phinorm))
        return gamma, sstats

    def outer(_, carry):
        lam, gamma = carry
        gamma, sstats = e_step(lam, gamma)
        lam = eta + sstats
        # spatial smoothing: proximal step on the difference penalty
        theta = gamma / gamma.sum(1, keepdims=True)
        theta = theta - penalty * (L @ theta)
        theta = jnp.maximum(theta, 1e-8)
        theta = theta / theta.sum(1, keepdims=True)
        gamma = theta * gamma.sum(1, keepdims=True)
        return lam, gamma

    lam, gamma = jax.lax.fori_loop(0, n_iter, outer, (lam, gamma))
    gamma, _ = e_step(lam, gamma)
    return lam, gamma


def em_step_sharded(X, lam, gamma, L, mesh, alpha: float, eta: float,
                    penalty: float, e_steps: int = 20,
                    data_axis: str = "fov"):
    """One EM outer iteration with CELLS sharded over the mesh (SURVEY.md
    §2.5: the E-step's (N, V)·(V, K) matmuls are embarrassingly row-
    parallel). Each shard runs the inner gamma fixed-point on its local
    cells; the M-step sufficient statistics `psum` across devices; the Laplacian
    smoothing `all_gather`s the (N, K) topic matrix (K is tiny) so local
    L rows can couple cells across shards.

    Args: X (N, V) counts, lam (K, V) replicated, gamma (N, K), L (N, N)
    Laplacian — N must be divisible by the mesh size (pad with zero-count
    cells; a zero row leaves gamma at alpha and contributes nothing to
    sstats or the smoothing). Returns (new lam replicated, new gamma
    sharded). Traced per call — drivers looping outer iterations should
    wrap their loop in one jit around this.
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    digamma = jax.scipy.special.digamma

    def step(X_l, gamma_l, L_l, lam):
        elog_beta = digamma(lam) - digamma(lam.sum(1, keepdims=True))
        exp_elog_beta = jnp.exp(elog_beta)                     # (K, V)

        def inner(_, g):
            elog_theta = digamma(g) - digamma(g.sum(1, keepdims=True))
            eet = jnp.exp(elog_theta)
            phinorm = eet @ exp_elog_beta + 1e-100
            return alpha + eet * ((X_l / phinorm) @ exp_elog_beta.T)

        gamma_l = jax.lax.fori_loop(0, e_steps, inner, gamma_l)
        elog_theta = digamma(gamma_l) - digamma(gamma_l.sum(1, keepdims=True))
        eet = jnp.exp(elog_theta)
        phinorm = eet @ exp_elog_beta + 1e-100
        sstats = exp_elog_beta * jax.lax.psum(
            eet.T @ (X_l / phinorm), data_axis)               # (K, V) repl.
        lam_new = eta + sstats

        gsum = gamma_l.sum(1, keepdims=True)
        theta_l = gamma_l / gsum
        theta_full = jax.lax.all_gather(theta_l, data_axis, tiled=True,
                                        axis=0)               # (N, K)
        theta_l = theta_l - penalty * (L_l @ theta_full)
        theta_l = jnp.maximum(theta_l, 1e-8)
        theta_l = theta_l / theta_l.sum(1, keepdims=True)
        return lam_new, theta_l * gsum

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(data_axis), P(data_axis),
                             P(data_axis, None), P()),
                   out_specs=(P(), P(data_axis)))
    sh = NamedSharding(mesh, P(data_axis))
    return fn(jax.device_put(jnp.asarray(X, jnp.float32), sh),
              jax.device_put(jnp.asarray(gamma, jnp.float32), sh),
              jax.device_put(jnp.asarray(L, jnp.float32),
                             NamedSharding(mesh, P(data_axis, None))),
              jax.device_put(jnp.asarray(lam, jnp.float32),
                             NamedSharding(mesh, P())))


def _build_laplacian(sample_features: pd.DataFrame,
                     difference_matrices: Optional[Dict]) -> np.ndarray:
    """Block-diagonal graph Laplacian DᵀD over all FOVs, aligned with the
    row order of sample_features; zeros if no difference matrices."""
    n = len(sample_features)
    L = np.zeros((n, n), np.float32)
    if difference_matrices is None:
        return L
    offset = 0
    for fov in sample_features.index.get_level_values(0).unique():
        n_fov = len(sample_features.loc[fov])
        D = difference_matrices.get(fov)
        if D is not None and D.shape[1] == n_fov:
            L[offset:offset + n_fov, offset:offset + n_fov] = D.T @ D
        offset += n_fov
    # normalize so `difference_penalty` has a scale-free meaning
    deg = np.abs(L).sum(1).max()
    if deg > 0:
        L /= deg
    return L


def train(sample_features: pd.DataFrame, difference_matrices: Optional[Dict] = None,
          difference_penalty: float = 0.25, n_topics: int = 5,
          n_parallel_processes: int = 1, n_iters: int = 50,
          admm_rho=None, primal_dual_mu=None, seed: int = 42,
          alpha: Optional[float] = None, eta: Optional[float] = None
          ) -> LatentDirichletAllocation:
    """Train a spatial-LDA model (API-parity with `spatial_lda.model.train`;
    `n_parallel_processes`/`admm_rho`/`primal_dual_mu` accepted and unused —
    the whole EM runs as one jitted device program)."""
    X = jnp.asarray(sample_features.values, jnp.float32)
    alpha = alpha if alpha is not None else 1.0 / n_topics
    eta = eta if eta is not None else 1.0 / n_topics
    L = jnp.asarray(_build_laplacian(sample_features, difference_matrices))
    lam, gamma = _lda_em(X, L, jax.random.PRNGKey(seed), n_topics,
                         float(alpha), float(eta), float(difference_penalty),
                         n_iter=int(n_iters))
    lam, gamma = np.asarray(lam), np.asarray(gamma)
    components = lam / lam.sum(1, keepdims=True)
    weights = gamma / gamma.sum(1, keepdims=True)
    topic_weights = pd.DataFrame(
        weights, index=sample_features.index,
        columns=[f"Topic-{i}" for i in range(n_topics)])
    return LatentDirichletAllocation(components, topic_weights,
                                     sample_features.columns, n_topics,
                                     alpha, eta)


def infer(model: LatentDirichletAllocation, sample_features: pd.DataFrame,
          difference_matrices: Optional[Dict] = None,
          difference_penalty: float = 0.25, n_parallel_processes: int = 1,
          n_iters: int = 30, seed: int = 42) -> pd.DataFrame:
    """Infer topic weights for new cells under fixed topics (E-step only,
    with the same spatial smoothing)."""
    X = jnp.asarray(sample_features.values, jnp.float32)
    n, v = X.shape
    k = model.n_topics
    lam = jnp.asarray(model.components_ * v, jnp.float32) + 1e-6
    L = jnp.asarray(_build_laplacian(sample_features, difference_matrices))
    digamma = jax.scipy.special.digamma

    @jax.jit
    def run(X, lam, L):
        elog_beta = digamma(lam) - digamma(lam.sum(1, keepdims=True))
        exp_elog_beta = jnp.exp(elog_beta)
        gamma = jnp.ones((n, k))

        def step(_, gamma):
            elog_theta = digamma(gamma) - digamma(gamma.sum(1, keepdims=True))
            exp_elog_theta = jnp.exp(elog_theta)
            phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
            gamma = model.alpha + exp_elog_theta * (
                (X / phinorm) @ exp_elog_beta.T)
            theta = gamma / gamma.sum(1, keepdims=True)
            theta = jnp.maximum(theta - difference_penalty * (L @ theta), 1e-8)
            theta = theta / theta.sum(1, keepdims=True)
            return theta * gamma.sum(1, keepdims=True)

        return jax.lax.fori_loop(0, n_iters, step, gamma)

    gamma = np.asarray(run(X, lam, L))
    weights = gamma / gamma.sum(1, keepdims=True)
    return pd.DataFrame(weights, index=sample_features.index,
                        columns=[f"Topic-{i}" for i in range(k)])
