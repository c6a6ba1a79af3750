"""Quantile reductions with numpy-linear-interpolation semantics on device.

The reference's normalization contract is built on `np.quantile` /
`pandas.DataFrame.quantile` (linear interpolation) — channel 99th percentiles
of nonzero pixels (`pixel_cluster_utils.py:44-52`), 99.9% quantiles ignoring
zeros (`pixie_preprocessing.py:407`, `cluster_helpers.py:366`), and the 5%
pixel-intensity threshold (`pixel_cluster_utils.py:104`).

Every quantile here is computed without a sort: a 32-step bisection on the
order-preserving uint32 keys of the float bits, counting `key <= mid` per
step, finds the exact f32 order statistics bracketing q·(n−1), which are
then linearly interpolated like numpy. The results are bit-identical to
the sort-based `jnp.quantile`/`jnp.nanquantile` (pinned by the tests) and
faster than XLA's sort on the GPU (A/B in PERF.md). NaN is propagated like
`np.quantile` for the plain quantile and ignored by the zero-ignoring
variants, like pandas. (SURVEY.md §7 hard part a.)"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("q",))
def quantile(x: jax.Array, q: float) -> jax.Array:
    """np.quantile(x, q) with linear interpolation, on device."""
    flat = x.reshape(-1).astype(jnp.float32)
    out = _masked_quantile_flat(flat, jnp.ones_like(flat, bool), q)
    # np.quantile propagates NaN; the bit-key bisection would instead order
    # NaN as an extreme value
    return jnp.where(jnp.any(jnp.isnan(flat)), jnp.nan, out)


@functools.partial(jax.jit, static_argnames=("q",))
def nonzero_quantile(x: jax.Array, q: float) -> jax.Array:
    """Quantile of the positive entries of x (reference pattern
    `img[img > 0]` then np.quantile). NaN if no positive entries."""
    x = x.reshape(-1).astype(jnp.float32)
    return _masked_quantile_flat(x, x > 0, q)


def _float_keys(x: jax.Array) -> jax.Array:
    """IEEE754 f32 -> order-preserving uint32 key (negatives flipped)."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    return jnp.where(bits >> 31 == 1, ~bits, bits ^ jnp.uint32(0x80000000))


def _keys_to_float(keys: jax.Array) -> jax.Array:
    fbits = jnp.where(keys >> 31 == 1, keys ^ jnp.uint32(0x80000000), ~keys)
    return jax.lax.bitcast_convert_type(fbits, jnp.float32)


def masked_order_stats(x: jax.Array, valid: jax.Array,
                       ranks: jax.Array) -> jax.Array:
    """Exact order statistics of the VALID entries per column, without
    sorting. x: (N, C); valid: (N, C) bool; ranks: (C, M) int (may be
    traced/dynamic). Returns (C, M) f32 — the rank[c, m]-th smallest valid
    value of column c (garbage where a column has no valid entries)."""
    key = jnp.where(valid, _float_keys(x), jnp.uint32(0xFFFFFFFF))
    k = ranks.astype(jnp.uint32)
    # derive the loop carries from BOTH `ranks` and the data (not fresh
    # constants) so they inherit any shard_map manual-axis varying-ness —
    # the loop body's counts depend on `x`, and a carry init with weaker
    # varying-ness than the body output fails the fori_loop carry-type
    # check inside shard_map bodies (either operand alone can be an
    # unvarying constant, e.g. a `jnp.ones` mask built inside the shard)
    zero = (k * jnp.uint32(0)) + (key.ravel()[0] * jnp.uint32(0))
    lo = zero
    hi = zero + jnp.uint32(0xFFFFFFFE)

    def body(_, lh):
        lo, hi = lh
        mid = lo + (hi - lo) // 2
        # cnt[c, m] = #{n : key[n, c] <= mid[c, m]}
        cnt = jnp.sum((key[:, :, None] <= mid[None, :, :])
                      .astype(jnp.uint32), axis=0)
        take_hi = cnt > k
        hi = jnp.where(take_hi, mid, hi)
        lo = jnp.where(take_hi, lo, mid + 1)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, 32, body, (lo, hi))
    return _keys_to_float(lo)


def _masked_quantile_flat(flat: jax.Array, valid: jax.Array,
                          q: float) -> jax.Array:
    """Linear-interpolated quantile of the valid entries of a 1-D array via
    counting bisection; NaN when nothing is valid. The count is a plain
    full-array reduction per step."""
    key = jnp.where(valid, _float_keys(flat), jnp.uint32(0xFFFFFFFF))
    n_valid = jnp.sum(valid)
    pos = q * jnp.maximum(n_valid - 1, 0).astype(jnp.float32)
    i0 = jnp.floor(pos).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, jnp.maximum(n_valid - 1, 0)).astype(jnp.int32)
    frac = pos - i0.astype(jnp.float32)
    k = jnp.stack([i0, i1]).astype(jnp.uint32)           # (2,)
    lo = jnp.zeros((2,), jnp.uint32)
    hi = jnp.full((2,), 0xFFFFFFFE, jnp.uint32)

    def body(_, lh):
        lo, hi = lh
        mid = lo + (hi - lo) // 2
        cnt = jnp.sum((key[:, None] <= mid[None, :]).astype(jnp.uint32),
                      axis=0)
        take_hi = cnt > k
        hi = jnp.where(take_hi, mid, hi)
        lo = jnp.where(take_hi, lo, mid + 1)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, 32, body, (lo, hi))
    stats = _keys_to_float(lo)
    out = stats[0] * (1.0 - frac) + stats[1] * frac
    return jnp.where(n_valid > 0, out, jnp.nan)


@functools.partial(jax.jit, static_argnames=("q",))
def nonzero_quantile_per_column(x: jax.Array, q: float) -> jax.Array:
    """Per-column q-quantile ignoring zeros (pandas `.replace(0, np.nan)
    .quantile(q)` semantics, linear interpolation). x: (N, C) -> (C,); NaN
    for all-zero columns."""
    x = x.astype(jnp.float32)
    # NaN entries are ignored, matching pandas/nanquantile (NaN != 0 is
    # True, so a bare `x != 0` would count them as valid and the bit-key
    # ordering would place them past +inf)
    valid = (x != 0) & ~jnp.isnan(x)
    n_valid = jnp.sum(valid, axis=0)                       # (C,)
    pos = q * jnp.maximum(n_valid - 1, 0).astype(jnp.float32)
    i0 = jnp.floor(pos).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, jnp.maximum(n_valid - 1, 0)).astype(jnp.int32)
    frac = pos - i0.astype(jnp.float32)
    stats = masked_order_stats(x, valid, jnp.stack([i0, i1], axis=1))
    out = stats[:, 0] * (1.0 - frac) + stats[:, 1] * frac
    return jnp.where(n_valid > 0, out, jnp.nan)


@functools.partial(jax.jit, static_argnames=("q",))
def masked_quantile_per_column(x: jax.Array, valid: jax.Array,
                               q: float) -> jax.Array:
    """Per-column quantile over rows where `valid` is True, ignoring zeros
    and NaN. Used to compute per-FOV post-rownorm 99.9% values without
    compacting the dense (H*W, C) device matrix (invalid rows stay
    padded)."""
    x = x.astype(jnp.float32)
    ok = valid[:, None] & (x != 0) & ~jnp.isnan(x)
    n_valid = jnp.sum(ok, axis=0)
    pos = q * jnp.maximum(n_valid - 1, 0).astype(jnp.float32)
    i0 = jnp.floor(pos).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, jnp.maximum(n_valid - 1, 0)).astype(jnp.int32)
    frac = pos - i0.astype(jnp.float32)
    stats = masked_order_stats(x, ok, jnp.stack([i0, i1], axis=1))
    out = stats[:, 0] * (1.0 - frac) + stats[:, 1] * frac
    return jnp.where(n_valid > 0, out, jnp.nan)
