"""k-means as jitted Lloyd iterations on device.

Replaces the reference's sklearn KMeans calls (neighborhood sweeps k=2..10,
`spatial_analysis_utils.py:341-454`; spLDA topic EDA). Deterministic given a
seed: k-means++ initialization with jax.random, then a fixed number of Lloyd
iterations with empty-cluster re-seeding to the farthest point."""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _plus_plus_init(key, data: jax.Array, k: int) -> jax.Array:
    """k-means++ seeding."""
    n = data.shape[0]
    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centers0 = jnp.zeros((k, data.shape[1]), data.dtype).at[0].set(data[first])

    x2 = jnp.sum(data * data, axis=1)

    def body(i, carry):
        centers, key = carry
        # matmul decomposition, same as assign(): the naive broadcast form
        # builds an (N, k, D) intermediate (~640 MB at 1M×10×16) per
        # seeding step — and n_init restarts vmap over this
        c2 = jnp.sum(centers * centers, axis=1)
        pair = x2[:, None] - 2.0 * jnp.dot(
            data, centers.T,
            precision=jax.lax.Precision.HIGHEST) + c2[None, :]
        d2 = jnp.min(jnp.maximum(pair, 0.0)
                     + jnp.where(jnp.arange(k)[None, :] < i, 0.0, jnp.inf),
                     axis=1)
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(jnp.sum(d2), 1e-12)
        nxt = jax.random.choice(sub, n, p=probs)
        return centers.at[i].set(data[nxt]), key

    centers, _ = jax.lax.fori_loop(1, k, body, (centers0, key))
    return centers


def _kmeans_fit_impl(data: jax.Array, k: int, seed,
                     n_iter: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    data = data.astype(jnp.float32)
    n = data.shape[0]
    key = jax.random.PRNGKey(seed)
    centers = _plus_plus_init(key, data, k)
    x2 = jnp.sum(data * data, axis=1)

    def assign(centers):
        c2 = jnp.sum(centers * centers, axis=1)
        # HIGHEST: f32 assignment parity (a default-precision matmul may
        # run in bf16 or TF32)
        d2 = x2[:, None] - 2.0 * jnp.dot(
            data, centers.T,
            precision=jax.lax.Precision.HIGHEST) + c2[None, :]
        return jnp.argmin(d2, axis=1), jnp.maximum(jnp.min(d2, axis=1), 0.0)

    def step(centers, _):
        labels, d2 = assign(centers)
        h = jax.nn.one_hot(labels, k, dtype=jnp.float32)    # (N, k)
        sums = h.T @ data                                   # (k, C)
        counts = jnp.sum(h, axis=0)
        new_centers = sums / jnp.maximum(counts, 1.0)[:, None]
        # empty clusters: re-seed to the current farthest point
        far = data[jnp.argmax(d2)]
        new_centers = jnp.where((counts > 0)[:, None], new_centers, far)
        return new_centers, None

    centers, _ = jax.lax.scan(step, centers, None, length=n_iter)
    labels, d2 = assign(centers)
    return centers, labels.astype(jnp.int32), jnp.sum(d2)


@functools.partial(jax.jit, static_argnames=("k", "n_iter"))
def kmeans_fit(data: jax.Array, k: int, seed: int = 42,
               n_iter: int = 50) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fit k-means; returns (centers (k,D), labels (N,), inertia scalar)."""
    return _kmeans_fit_impl(data, k, seed, n_iter)


@functools.partial(jax.jit, static_argnames=("k", "n_iter", "n_init"))
def kmeans_fit_multi(data: jax.Array, k: int, seed: int = 42,
                     n_iter: int = 50, n_init: int = 10
                     ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Best of `n_init` seeded k-means++ restarts (sklearn's n_init
    semantics, `spatial_analysis_utils.py:341-454` parity on hard data).
    The restarts run as ONE vmapped program — n_init Lloyd solves batched
    rather than looping — and the lowest-inertia fit wins."""
    seeds = seed + jnp.arange(n_init)
    centers, labels, inertias = jax.vmap(
        lambda s: _kmeans_fit_impl(data, k, s, n_iter))(seeds)
    best = jnp.argmin(inertias)
    return centers[best], labels[best], inertias[best]


def kmeans(data, k: int, seed: int = 42, n_iter: int = 50, n_init: int = 10):
    """Host-friendly wrapper: returns (labels np.int32, inertia float)."""
    data = jnp.asarray(np.asarray(data), jnp.float32)
    if n_init <= 1:
        _, labels, inertia = kmeans_fit(data, k, seed=seed, n_iter=n_iter)
    else:
        _, labels, inertia = kmeans_fit_multi(data, k, seed=seed,
                                              n_iter=n_iter, n_init=n_init)
    return np.asarray(labels), float(inertia)
