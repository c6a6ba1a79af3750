"""FOV-sharded cohort execution: run jitted per-FOV pipelines over a mesh.

This is the device replacement for the reference's multiprocessing
spawn-Pool FOV fan-out (`pixie_preprocessing.py:391-439` etc.): FOV batches
are stacked into (B, H, W, C) blocks, the leading axis is sharded over the
'fov' mesh axis, and one jitted program runs the whole batch; small cohort
statistics reduce across devices with psum."""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np
from ark_tpu.ops import image_filters, som as som_ops
from ark_tpu.parallel import mesh as mesh_utils

# jitted vmap per distinct fn OBJECT: callers that pass the same function
# repeatedly (module-level per-FOV fns) compile once per shape instead of
# retracing every call — a per-call jax.jit(...) wrapper would pay a trace
# and compile per batch
_vmapped_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _vmapped(fn: Callable):
    try:
        prog = _vmapped_cache.get(fn)
    except TypeError:                  # unhashable/unweakrefable callable
        return jax.jit(jax.vmap(fn))
    if prog is None:
        prog = jax.jit(jax.vmap(fn))
        _vmapped_cache[fn] = prog
    return prog


def map_over_fovs(fn: Callable, fov_batch: np.ndarray, mesh,
                  axis_name: str = mesh_utils.FOV_AXIS):
    """Apply a jitted per-FOV function over a (B, ...) batch sharded across
    the mesh; B is padded to a multiple of the mesh size (padding dropped).

    The jitted program is cached per `fn` object — pass the SAME function
    object across calls (module-level, not a fresh closure) to avoid
    recompiling every batch."""
    n = fov_batch.shape[0]
    n_dev = mesh.devices.size
    n_pad = mesh_utils.pad_to_multiple(n, n_dev)
    if n_pad != n:
        pad = np.zeros((n_pad - n,) + fov_batch.shape[1:], fov_batch.dtype)
        fov_batch = np.concatenate([fov_batch, pad])
    sharding = mesh_utils.fov_sharding(mesh, axis_name)
    batch = jax.device_put(jnp.asarray(fov_batch), sharding)
    out = _vmapped(fn)(batch)
    return jax.tree.map(lambda x: np.asarray(x)[:n], out)


def _pixel_per_fov(img, channel_norms, pixel_thresh, post_norms,
                   som_weights, blur_factor):
    x = img.astype(jnp.float32) / channel_norms
    x = image_filters.gaussian_blur(x, sigma=blur_factor)
    h, w, c = x.shape
    mat = x.reshape(h * w, c)
    rowsums = jnp.sum(mat, axis=1)
    valid = (rowsums > pixel_thresh) & jnp.any(mat != 0, axis=1)
    norm = mat / jnp.where(rowsums == 0, 1.0, rowsums)[:, None]
    norm = norm / post_norms
    idx, _ = som_ops.bmu_xla(som_weights, norm)
    clusters = jnp.where(valid, idx + 1, 0).astype(jnp.int32)
    return {"pixel_mat": norm, "valid": valid, "som_clusters": clusters}


@functools.partial(jax.jit, static_argnames=("blur_factor",))
def _pixel_cohort_program(batch, channel_norms, pixel_thresh, post_norms,
                          som_weights, blur_factor):
    return jax.vmap(functools.partial(
        _pixel_per_fov, channel_norms=channel_norms,
        pixel_thresh=pixel_thresh, post_norms=post_norms,
        som_weights=som_weights, blur_factor=blur_factor))(batch)


def run_pixel_cohort(fov_batches, channel_norms, pixel_thresh,
                     post_norms, som_weights, mesh=None,
                     blur_factor: int = 2) -> Dict[str, np.ndarray]:
    """Run the full pixel pipeline (preprocess + SOM assignment) over a
    cohort batch, FOV-sharded across the mesh.

    Args:
        fov_batches: (B, H, W, C) image block.
        channel_norms: (C,) pre-rownorm channel percentile norms.
        pixel_thresh: scalar total-signal threshold.
        post_norms: (C,) post-rownorm 99.9% channel norms.
        som_weights: (K, C) trained SOM weights.
        mesh: device mesh (default: all local devices).

    Returns dict with 'pixel_mat' (B, H·W, C), 'valid' (B, H·W) bool,
    'som_clusters' (B, H·W) int32 (0 = filtered out).

    Normalization params are traced ARGUMENTS of one module-level jitted
    program (not closure constants), so successive cohort batches of the
    same shape reuse a single compiled executable.
    """
    mesh = mesh or mesh_utils.get_mesh()
    fov_batches = np.asarray(fov_batches)
    n = fov_batches.shape[0]
    n_pad = mesh_utils.pad_to_multiple(n, mesh.devices.size)
    if n_pad != n:
        pad = np.zeros((n_pad - n,) + fov_batches.shape[1:],
                       fov_batches.dtype)
        fov_batches = np.concatenate([fov_batches, pad])
    sharding = mesh_utils.fov_sharding(mesh)
    batch = jax.device_put(jnp.asarray(fov_batches), sharding)
    out = _pixel_cohort_program(
        batch, jnp.asarray(channel_norms, jnp.float32),
        jnp.float32(pixel_thresh), jnp.asarray(post_norms, jnp.float32),
        jnp.asarray(som_weights, jnp.float32), blur_factor)
    return jax.tree.map(lambda x: np.asarray(x)[:n], out)


def run_fiber_cohort(fov_batches, fov_len=None, blur=2,
                     contrast_scaling_divisor=128,
                     fiber_widths=(1, 3, 5, 7, 9), ridge_cutoff=0.1,
                     sobel_blur=1, mesh=None) -> Dict[str, np.ndarray]:
    """Run the fused fiber device pipeline (blur → CLAHE → Frangi → EDT →
    Sobel elevation; `fiber_segmentation._fiber_device_program`) over a
    (B, H, W) FOV batch, sharded across the mesh — the device half of
    `run_fiber_segmentation`'s per-FOV loop (reference
    `fiber_segmentation.py:197-276`). Returns the host-tail inputs
    ('distance_transformed', 'elevation_map' (B, H, W), 'has_bg' (B,));
    callers run the host multi-Otsu/watershed/label tail per FOV.

    Per-shard work only (no collectives). Caveat: under vmap, CLAHE's
    per-image 1-D histogram scatter-add becomes a batched 2-D scatter. If
    batched fiber shows up hot on the device, flatten the scatter
    with per-image offset ids (`cc.py`'s offset-ids pattern) before
    scaling the batch."""
    from ark_tpu.ops import classical
    from ark_tpu.segmentation.fiber_segmentation import _fiber_device_program

    mesh = mesh or mesh_utils.get_mesh()
    fov_batches = np.asarray(fov_batches, np.float32)
    n, h, w = fov_batches.shape
    # segment_fibers derives fov_len from the ROW count (its channel_xr
    # shape is (fovs, rows, cols, channels) -> shape[1] = rows); matching
    # it keeps the CLAHE tile geometry identical on non-square FOVs
    fov_len = h if fov_len is None else fov_len
    n_pad = mesh_utils.pad_to_multiple(n, mesh.devices.size)
    if n_pad != n:
        pad = np.zeros((n_pad - n, h, w), np.float32)
        fov_batches = np.concatenate([fov_batches, pad])
    th, tw, n_tr, n_tc = classical._clahe_geometry(
        h, w, fov_len / contrast_scaling_divisor)
    batch = jax.device_put(jnp.asarray(fov_batches),
                           mesh_utils.fov_sharding(mesh))

    @functools.partial(
        jax.jit, static_argnames=("blur", "th", "tw", "n_tr", "n_tc",
                                  "fiber_widths", "sobel_blur"))
    def program(batch, ridge_cutoff, *, blur, th, tw, n_tr, n_tc,
                fiber_widths, sobel_blur):
        def one(img):
            out = _fiber_device_program(
                img, ridge_cutoff, blur=blur, th=th, tw=tw, n_tr=n_tr,
                n_tc=n_tc, fiber_widths=fiber_widths, sobel_blur=sobel_blur)
            return {k: out[k] for k in ("distance_transformed",
                                        "elevation_map", "has_bg")}
        return jax.vmap(one)(batch)

    out = program(batch, jnp.float32(ridge_cutoff), blur=blur, th=th,
                  tw=tw, n_tr=n_tr, n_tc=n_tc,
                  fiber_widths=tuple(fiber_widths), sobel_blur=sobel_blur)
    return jax.tree.map(lambda x: np.asarray(x)[:n], out)


def _percentile_per_fov(img, q):
    c = img.shape[-1]
    flat = img.reshape(-1, c).astype(jnp.float32)
    masked = jnp.where(flat > 0, flat, jnp.nan)
    return jnp.nanquantile(masked, q, axis=0)


@functools.partial(jax.jit, static_argnames=("q",))
def _percentile_program(batch, q):
    return jax.vmap(functools.partial(_percentile_per_fov, q=q))(batch)


def cohort_channel_percentiles(fov_batches: np.ndarray, q: float,
                               mesh=None) -> np.ndarray:
    """Mean over FOVs of per-FOV nonzero channel percentiles, computed
    sharded (the cohort normalization statistic of
    `pixel_cluster_utils.py:16-60`)."""
    mesh = mesh or mesh_utils.get_mesh()
    fov_batches = np.asarray(fov_batches)
    n = fov_batches.shape[0]
    n_pad = mesh_utils.pad_to_multiple(n, mesh.devices.size)
    if n_pad != n:
        pad = np.zeros((n_pad - n,) + fov_batches.shape[1:],
                       fov_batches.dtype)
        fov_batches = np.concatenate([fov_batches, pad])
    batch = jax.device_put(jnp.asarray(fov_batches),
                           mesh_utils.fov_sharding(mesh))
    per_fov_vals = np.asarray(_percentile_program(batch, q))[:n]
    return np.nanmean(per_fov_vals, axis=0)
