"""Image filters as XLA ops: Gaussian blur (separable depthwise conv) etc.

Replaces the reference's `scipy.ndimage.gaussian_filter` calls in Pixie
preprocessing (`pixie_preprocessing.py:47-49`, sigma=blur_factor=2) and
channel smoothing (`pixel_cluster_utils.py:183-227`). Numerics match scipy's
default settings: truncate=4.0 kernel radius, 'reflect' boundary (numpy
'symmetric'), normalized order-0 kernel — so cohort norm values agree with the
reference to float32 precision. Runs as two 1-D depthwise convolutions on the
device (memory-bound; XLA fuses the pad)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d for order=0: normalized Gaussian taps.

    sigma <= 0 degenerates to the identity tap (scipy's gaussian_filter
    returns the input unchanged at sigma=0; callers like
    `classical.local_adaptive_threshold` hit this with block_size=1)."""
    if sigma <= 0:
        return np.ones(1, np.float32)
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("sigma", "truncate"))
def gaussian_blur(img: jax.Array, sigma: float = 2.0,
                  truncate: float = 4.0) -> jax.Array:
    """Per-channel Gaussian blur of an (H, W, C) or (H, W) image.

    Matches scipy.ndimage.gaussian_filter(img, sigma) (mode='reflect') to
    float32 rounding. Separable: rows then cols, via depthwise conv.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    k = jnp.asarray(gaussian_kernel1d(sigma, truncate))
    r = (k.shape[0] - 1) // 2

    x = img.astype(jnp.float32)
    # scipy 'reflect' = numpy pad 'symmetric' (edge pixel repeated)
    x = jnp.pad(x, ((r, r), (0, 0), (0, 0)), mode="symmetric")
    x = _conv1d_axis(x, k, axis=0)
    x = jnp.pad(x, ((0, 0), (r, r), (0, 0)), mode="symmetric")
    x = _conv1d_axis(x, k, axis=1)
    return x[..., 0] if squeeze else x


def _conv1d_axis(x: jax.Array, k: jax.Array, axis: int) -> jax.Array:
    """VALID 1-D depthwise convolution along `axis` of an (H, W, C) array."""
    h, w, c = x.shape
    # NHWC with batch=1; depthwise via feature_group_count=C
    lhs = x[None]
    if axis == 0:
        rhs = jnp.tile(k[:, None, None, None], (1, 1, 1, c))     # (KH,1,1,C)
        window = (k.shape[0], 1)
    else:
        rhs = jnp.tile(k[None, :, None, None], (1, 1, 1, c))     # (1,KW,1,C)
        window = (1, k.shape[0])
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c)
    return out[0]


@functools.partial(jax.jit, static_argnames=("sigma", "truncate"))
def gaussian_blur_batch(imgs: jax.Array, sigma: float = 2.0,
                        truncate: float = 4.0) -> jax.Array:
    """Blur a (B, H, W, C) FOV batch — vmapped single-image blur."""
    return jax.vmap(lambda im: gaussian_blur(im, sigma, truncate))(imgs)
