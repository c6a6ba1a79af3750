"""Exact Euclidean distance transform on device.

Replaces the host `scipy.ndimage.distance_transform_edt` round-trip in the
fiber pipeline (reference `src/ark/segmentation/fiber_segmentation.py:106`)
and synthetic training-data generation. Exact — not chamfer — via the
separable decomposition the Felzenszwalb–Huttenlocher algorithm is built on:

  pass 1:  g[i, j]  = min_{i': bg[i', j]} |i - i'|      (per-column 1-D EDT)
  pass 2:  dt²[i,j] = min_{j'} ( g[i, j']² + (j - j')² )

Pass 1 is O(H·W), fully vectorized: the nearest zero above is a cummax of
row indices masked to background pixels, the nearest below a reversed
cummin. Pass 2 is evaluated directly as a blocked min-plus reduction over
source columns — O(H·W²) element ops instead of the sequential O(H·W)
lower-envelope scan, because a data-dependent envelope stack doesn't map to
XLA, while a broadcast+min-reduce is plain vector work that keeps
everything in one fused program (1024² ≈ 1e9 int ops; 4096² ≈ 7e10).

All distance arithmetic is int32 — squared distances reach 2·4096² ≈ 33.5M,
past float32's 2²⁴ exact-integer range — so the result is bit-exact vs
scipy up to the final float sqrt. Pixels with no background anywhere return
+inf (scipy's answer there is an initialization artifact: distances to a
phantom zero at (-1, 0)).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# larger than any real distance in a 16k×16k image, and SENTINEL² plus any
# real squared offset stays well inside int32
_SENTINEL = np.int32(1 << 15)
_BLOCK = 256


def _column_pass(fg: jax.Array) -> jax.Array:
    """Per-column vertical distance to the nearest background pixel (int32,
    _SENTINEL where the column has no background)."""
    h = fg.shape[0]
    idx = jnp.arange(h, dtype=jnp.int32)[:, None]
    bg = ~fg
    neg = jnp.int32(-_SENTINEL)
    last_zero = jax.lax.cummax(jnp.where(bg, idx, neg), axis=0)
    nxt = jnp.int32(2 * _SENTINEL)
    next_zero = jax.lax.cummin(jnp.where(bg, idx, nxt), axis=0, reverse=True)
    down = jnp.minimum(idx - last_zero, jnp.int32(_SENTINEL))
    up = jnp.minimum(next_zero - idx, jnp.int32(_SENTINEL))
    return jnp.minimum(down, up)


@functools.partial(jax.jit, static_argnames=("block",))
def _edt2_int(fg: jax.Array, block: int = _BLOCK) -> jax.Array:
    """Squared EDT as int32; fg is a bool (H, W) foreground mask."""
    h, w = fg.shape
    g = _column_pass(fg)
    g2 = (g * g).astype(jnp.int32)                              # (H, W)
    # pad source columns to a block multiple with +sentinel² columns
    wp = -(-w // block) * block
    pad_val = jnp.int32(_SENTINEL * _SENTINEL)
    g2p = jnp.pad(g2, ((0, 0), (0, wp - w)), constant_values=pad_val)
    cols = jnp.arange(w, dtype=jnp.int32)                       # output j

    def step(run_min, s):
        gs = jax.lax.dynamic_slice_in_dim(g2p, s * block, block, axis=1)
        js = s * block + jnp.arange(block, dtype=jnp.int32)     # source j'
        d = cols[:, None] - js[None, :]
        cand = gs[:, None, :] + (d * d)[None, :, :]             # (H, W, B)
        return jnp.minimum(run_min, cand.min(axis=2)), None

    init = jnp.full((h, w), pad_val, jnp.int32)
    out, _ = jax.lax.scan(step, init,
                          jnp.arange(wp // block, dtype=jnp.int32))
    # squared vertical sentinel already caps at sentinel²; offsets from
    # padded columns can't win because pad_val ≥ any real candidate
    return out


def distance_transform_edt(image) -> jax.Array:
    """Exact Euclidean distance to the nearest zero/False pixel of a 2-D
    image (scipy.ndimage.distance_transform_edt semantics; float32).

    Pixels in an image with no background at all get +inf rather than
    scipy's phantom-corner artifact.
    """
    fg = jnp.asarray(image) != 0 if jnp.asarray(image).dtype != jnp.bool_ \
        else jnp.asarray(image)
    if fg.ndim != 2:
        raise ValueError(f"expected a 2-D image, got shape {fg.shape}")
    d2 = _edt2_int(fg)
    dist = jnp.sqrt(d2.astype(jnp.float32))
    return jnp.where(d2 >= _SENTINEL * _SENTINEL, jnp.inf, dist)
