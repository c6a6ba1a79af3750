"""In-process Mesmer segmentation application.

Replaces the reference's DeepCell REST workflow (zip → upload → poll →
download; `deepcell_service_utils.py:95-343`) with local device inference: the
PanopticNet forward pass (ark_tpu.models.unet) runs on channel-stacked FOV
batches; the deep-watershed instance postprocess runs per FOV — local maxima
of the predicted inner-distance become markers (a device 3×3 maxpool), then
the native C++ watershed floods the interior mask.

Weights: random-initialized unless loaded from an `.npz` checkpoint via
`Mesmer(weights_path=...)` (this build has no network egress to fetch the
published Mesmer weights; the full pipeline is architecture/throughput-exact
and numerically well-formed either way).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ark_tpu.models import unet
from ark_tpu.ops import cc
from ark_tpu.ops import morphology
from ark_tpu.ops.quantiles import _float_keys, _keys_to_float
from ark_tpu.ops import watershed as watershed_ops

# Device deep-watershed parameters: 256 claim levels matches the relief
# resolution the instance tests need (the native kernel's 2^16 buckets are
# overkill for the [0, 1] inner-distance head). BFS rounds are cheap
# shifted-min passes while one phase-B exact resolution is a scatter/gather
# CC — 32 rounds per level keeps phase B at zero invocations on
# trained-model relief (level engine only; the default minimax engine
# budgets by geometry).
_DEVICE_WATERSHED_LEVELS = 256
_DEVICE_WATERSHED_BFS_ROUNDS = 32


@functools.partial(jax.jit, static_argnames=("idxs",))
def _order_stats_bisect(flat: jax.Array, idxs) -> jax.Array:
    """Exact order statistics `sort(flat, -1)[..., i]` for each rank i in
    `idxs`, WITHOUT sorting: 32-step bisection on the monotone uint32 key of
    the float bits, counting `key <= mid` per step, instead of a full
    per-slice sort of (H·W) pixels. Which is faster on the GPU is not
    measured. Exact to f32 bit patterns — the bisection
    converges to an element of the slice.

    The IEEE754↔monotone-uint32 key transforms are shared with
    `ops.quantiles` (the (N, C)-table masked variant of this kernel); only
    the batched unmasked bisection loop lives here. hi starts at the full
    0xFFFFFFFF because, with no invalid-row sentinel, that key is legal."""
    key = _float_keys(flat)
    k = jnp.asarray(idxs, jnp.uint32)
    prefix = flat.shape[:-1]
    m = len(idxs)
    lo = jnp.zeros(prefix + (m,), jnp.uint32)
    hi = jnp.full(prefix + (m,), 0xFFFFFFFF, jnp.uint32)

    def body(_, lh):
        lo, hi = lh
        mid = lo + (hi - lo) // 2
        cnt = jnp.sum((key[..., None, :] <= mid[..., :, None])
                      .astype(jnp.uint32), axis=-1)
        take_hi = cnt > k          # rank-k stat is <= mid
        hi = jnp.where(take_hi, mid, hi)
        lo = jnp.where(take_hi, lo, mid + 1)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, 32, body, (lo, hi))
    return _keys_to_float(lo)


def _percentile_normalize(batch: jax.Array) -> jax.Array:
    """Per-image, per-channel robust normalization to [0, 1] using the
    0.1/99.9 percentiles (Mesmer-style preprocessing). Matches
    jnp.percentile (linear interpolation) to f32 rounding, via sort-free
    order-statistic bisection (`_order_stats_bisect`)."""
    b, h, w, c = batch.shape
    n = h * w
    flat = jnp.moveaxis(batch, -1, 1).reshape(b, c, n)
    stats = {}
    for q in (0.1, 99.9):
        pos = q / 100.0 * (n - 1)
        i0 = int(np.floor(pos))
        stats[q] = (i0, pos - i0)
    idxs = (stats[0.1][0], min(stats[0.1][0] + 1, n - 1),
            stats[99.9][0], min(stats[99.9][0] + 1, n - 1))
    os_ = _order_stats_bisect(flat, idxs)             # (b, c, 4)
    lo = os_[..., 0] * (1 - stats[0.1][1]) + os_[..., 1] * stats[0.1][1]
    hi = os_[..., 2] * (1 - stats[99.9][1]) + os_[..., 3] * stats[99.9][1]
    return jnp.clip((batch - lo[:, None, None, :])
                    / jnp.maximum((hi - lo)[:, None, None, :], 1e-6),
                    0.0, 1.0)


@jax.jit
def _find_maxima(inner_distance: jax.Array, threshold: float = 0.1) -> jax.Array:
    """Local-maxima mask: pixels equal to their 3×3 max-pool and above
    threshold. (B, H, W) -> bool (B, H, W); runs on device."""
    x = inner_distance[..., None]
    pooled = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 1, 1, 1), "SAME")
    return ((x >= pooled) & (x > threshold))[..., 0]


def device_postprocess(res, interior_threshold, min_cell_size):
    """Deep-watershed postprocess of one `_segment_device` result on the
    device: marker labeling (batched Shiloach-Vishkin CC), minimax flood,
    small-object filter. Returns ({compartment: (B, H, W) labels}, done);
    `done` is False when an internal round budget ran out, and the caller
    then falls back to the host flood."""
    out = {}
    done = jnp.bool_(True)
    for comp in ("whole_cell", "nuclear"):
        # maxima plateaus are tiny: the scatter-free small-component
        # labeler; its flag trips the host fallback if a plateau ever
        # exceeds the propagation radius
        markers, _, m_done = cc.label_batched_small(res[comp]["maxima"])
        fgmask = res[comp]["foreground"] > interior_threshold
        q = watershed_ops._quantize(-res[comp]["inner"], fgmask,
                                    _DEVICE_WATERSHED_LEVELS)
        lab, w_done = watershed_ops.flood(
            q, markers, fgmask, _DEVICE_WATERSHED_LEVELS,
            _DEVICE_WATERSHED_BFS_ROUNDS)
        # 16k labels covers any real FOV's marker count; the in_range flag
        # trips the host fallback beyond it
        out[comp], a_ok = cc.area_filter_batched(
            lab, min_area=min_cell_size, n_max=2 ** 14 - 1)
        done &= m_done & w_done & a_ok
    return out, done


class Mesmer:
    """Whole-cell + nuclear segmentation from (nuclear, membrane) images."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 dtype=None, model=None, variables=None):
        """Sources of weights, in precedence order: an injected
        (model, variables) pair (e.g. from `train.train_on_synthetic` or a
        sharded trainer), an `.npz` checkpoint (converted published weights
        via `models/convert_deepcell.py`, `unet.save_params_npz` output, or
        the in-repo synthetic-trained `models/checkpoints/*.npz`), else
        random init (architecture/throughput demos only). Checkpoints carry
        their architecture config ('__config__'), so `weights_path` alone
        reconstructs the right PanopticNet variant.

        `dtype=None` means: the checkpoint config's dtype if it records one
        (the mini synthetic checkpoints train and validate in f32), else
        bfloat16 (the tensor-core fast path). An explicit dtype always wins
        — a checkpoint must not silently downgrade a requested bf16 forward
        to f32."""
        if model is not None:
            if weights_path is None and variables is None:
                raise ValueError(
                    "Mesmer(model=...) needs its weights: pass variables= "
                    "or weights_path= alongside the injected model")
            self.model = model
            self.variables = unet.load_params_npz(weights_path) \
                if weights_path is not None else variables
        elif weights_path is not None:
            self.variables, config = unet.load_params_npz(
                weights_path, return_config=True)
            config = dict(config or {})
            cfg_dtype = config.pop("dtype", None)
            if dtype is None:
                dtype = jnp.dtype(cfg_dtype).type if cfg_dtype is not None \
                    else jnp.bfloat16
            self.model = unet.PanopticNet(
                dtype=dtype, **{k: tuple(v) if isinstance(v, list) else v
                                for k, v in config.items()})
        else:
            self.model, self.variables = unet.init_mesmer(
                seed=seed, dtype=jnp.bfloat16 if dtype is None else dtype)
        self._forward = jax.jit(
            lambda v, x: self.model.apply(v, x, train=False))

        def _device_step(v, x, maxima_threshold):
            # normalize + forward + per-compartment maxima/foreground in ONE
            # jitted program: one dispatch per batch, and a single program
            # lets segment_fovs overlap the
            # whole device side of batch i+1 with batch i's host watershed
            xn = _percentile_normalize(x)
            out = self.model.apply(v, xn, train=False)
            res = {}
            for comp in ("whole_cell", "nuclear"):
                inner = out[f"{comp}_inner_distance"][..., 0]
                res[comp] = {
                    "inner": inner,
                    # flood everywhere the net says 'not background'
                    # (interior + border mass): thresholding the interior
                    # class alone starves instance edges (IoU 0.67 -> 0.88)
                    "foreground": 1.0 - out[f"{comp}_pixelwise"][..., 2],
                    "maxima": _find_maxima(inner, maxima_threshold),
                }
            return res

        self._segment_device = jax.jit(_device_step)

        def _device_step_post(v, x, maxima_threshold, interior_threshold,
                              min_cell_size):
            # forward + FULL deep-watershed postprocess in one device
            # program: no host compute and ONE readback per batch, vs the
            # host path's per-FOV priority-flood threads.
            return device_postprocess(_device_step(v, x, maxima_threshold),
                                      interior_threshold, min_cell_size)

        self._segment_device_post = jax.jit(_device_step_post)

    def predict_raw(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        """Run the network on a (B, H, W, 2) batch; returns semantic heads."""
        x = _percentile_normalize(jnp.asarray(batch, jnp.float32))
        out = self._forward(self.variables, x)
        return {k: np.asarray(v) for k, v in out.items()}

    def _postprocess_device_out(self, devres, interior_threshold: float,
                                min_cell_size: int) -> Dict[str, np.ndarray]:
        """Host deep-watershed postprocess of one `_segment_device` result;
        per-FOV floods run in a thread pool (the native C++ flood releases
        the GIL). The np.asarray reads are where the device result is
        awaited — callers may hand in a still-in-flight result."""
        import concurrent.futures

        import scipy.ndimage as ndi

        def postprocess_one(args):
            inner_b, foreground_b, maxima_b = args
            markers, _ = ndi.label(maxima_b)
            mask = foreground_b > interior_threshold
            lab = watershed_ops.watershed(-inner_b, markers, mask)
            return morphology.remove_small_objects(lab,
                                                   min_size=min_cell_size)

        labels = {}
        for comp in ("whole_cell", "nuclear"):
            inner = np.asarray(devres[comp]["inner"])
            foreground = np.asarray(devres[comp]["foreground"])
            maxima = np.asarray(devres[comp]["maxima"])
            work = [(inner[b], foreground[b], maxima[b])
                    for b in range(inner.shape[0])]
            with concurrent.futures.ThreadPoolExecutor() as pool:
                batch_labels = list(pool.map(postprocess_one, work))
            labels[comp] = np.stack(batch_labels).astype(np.int32)
        return labels

    def predict(self, batch: np.ndarray, maxima_threshold: float = 0.1,
                interior_threshold: float = 0.3, min_cell_size: int = 15,
                postprocess: str = "host") -> Dict[str, np.ndarray]:
        """Segment a (B, H, W, 2) batch.

        postprocess='host' (default): native C++ priority-flood per FOV in
        a thread pool. postprocess='device': the whole deep-watershed
        postprocess fuses into the forward program (`ops/watershed.py`
        level-synchronous flood) — labelings agree up to equidistant
        watershed-tie ownership (instance recovery is test-bound equal);
        preferable when host cores are scarce or batches are large. Falls
        back to the host flood in the (never-observed, budget-tested) case
        the device kernel's internal round budget reports non-convergence.
        NOTE: use the device path with TRAINED weights — a random-init
        model emits garbage relief with ~10k spurious maxima per FOV,
        a pathological tie-heavy regime where the level-synchronous
        flood's exact resolution grinds while the host flood degrades
        gracefully.

        Returns {'whole_cell': (B, H, W) int32 labels,
                 'nuclear': (B, H, W) int32 labels}.
        """
        if postprocess not in ("host", "device"):
            raise ValueError(f"postprocess must be 'host' or 'device', "
                             f"got {postprocess!r}")
        x = jnp.asarray(batch, jnp.float32)
        if postprocess == "device":
            return self._finish_device_post(self._dispatch_device_post(
                x, maxima_threshold, interior_threshold, min_cell_size))
        dev = self._segment_device(self.variables, x,
                                   jnp.float32(maxima_threshold))
        return self._postprocess_device_out(dev, interior_threshold,
                                            min_cell_size)

    def _dispatch_device_post(self, x, maxima_threshold,
                              interior_threshold, min_cell_size):
        """Dispatch (don't await) one fused forward+flood program; the
        returned pending tuple is finished by `_finish_device_post` —
        callers may dispatch the next batch in between (async-dispatch
        double-buffering, like the host path's `pending`)."""
        out, done = self._segment_device_post(
            self.variables, x, jnp.float32(maxima_threshold),
            jnp.float32(interior_threshold), jnp.int32(min_cell_size))
        return out, done, x, maxima_threshold, interior_threshold, \
            min_cell_size

    def _finish_device_post(self, pending):
        """Await a `_dispatch_device_post` result; falls back to the
        certified host flood in the (never-observed, budget-tested) case
        any internal round budget reported non-convergence."""
        out, done, x, maxima_threshold, interior_threshold, \
            min_cell_size = pending
        if bool(done):
            return {k: np.asarray(v).astype(np.int32)
                    for k, v in out.items()}
        dev = self._segment_device(self.variables, x,
                                   jnp.float32(maxima_threshold))
        return self._postprocess_device_out(dev, interior_threshold,
                                            min_cell_size)


def segment_fovs(fov_images: np.ndarray, weights_path: Optional[str] = None,
                 batch_size: int = 4, app: Optional["Mesmer"] = None,
                 **predict_kwargs) -> Dict[str, np.ndarray]:
    """Segment a stack of (N, H, W, 2) FOV images in device batches.

    Double-buffered: batch i+1's device program is dispatched BEFORE batch
    i's host watershed postprocess joins, so JAX's async dispatch overlaps
    device compute with the host flood —
    the segmentation stage costs ~max(device, host) per batch instead of
    their sum (the reference pays a network round trip per 5-FOV zip here,
    `deepcell_service_utils.py:95-211`).

    predict_kwargs additionally accepts postprocess='device': the flood
    runs on device fused with the forward (see `Mesmer.predict`), so there
    is no host stage to overlap and each batch is one program + one
    readback.

    Pass `app=` to reuse an existing Mesmer (keeps its jit caches warm
    across calls — a fresh instance per call retraces every program);
    `weights_path` is ignored when `app` is given."""
    if app is None:
        app = Mesmer(weights_path=weights_path)
    maxima_threshold = predict_kwargs.pop("maxima_threshold", 0.1)
    interior_threshold = predict_kwargs.pop("interior_threshold", 0.3)
    min_cell_size = predict_kwargs.pop("min_cell_size", 15)
    postprocess = predict_kwargs.pop("postprocess", "host")
    if predict_kwargs:
        raise TypeError(f"unknown predict kwargs: {sorted(predict_kwargs)}")

    if fov_images.shape[0] == 0:
        raise ValueError("segment_fovs needs at least one FOV image")
    if postprocess not in ("host", "device"):
        raise ValueError(
            f"postprocess must be 'host' or 'device', got {postprocess!r}")
    if postprocess == "device":
        # double-buffered like the host path: batch i+1's fused program is
        # dispatched before batch i's labels are read back, hiding the
        # dispatch+readback latency behind device compute
        whole, nuc = [], []
        pending = None
        for i in range(0, fov_images.shape[0], batch_size):
            nxt = app._dispatch_device_post(
                jnp.asarray(fov_images[i:i + batch_size], jnp.float32),
                maxima_threshold, interior_threshold, min_cell_size)
            if pending is not None:
                out = app._finish_device_post(pending)
                whole.append(out["whole_cell"])
                nuc.append(out["nuclear"])
            pending = nxt
        out = app._finish_device_post(pending)
        whole.append(out["whole_cell"])
        nuc.append(out["nuclear"])
        return {"whole_cell": np.concatenate(whole),
                "nuclear": np.concatenate(nuc)}
    whole, nuc = [], []
    pending = None
    for i in range(0, fov_images.shape[0], batch_size):
        dev = app._segment_device(
            app.variables,
            jnp.asarray(fov_images[i:i + batch_size], jnp.float32),
            jnp.float32(maxima_threshold))
        if pending is not None:
            out = app._postprocess_device_out(pending, interior_threshold,
                                              min_cell_size)
            whole.append(out["whole_cell"])
            nuc.append(out["nuclear"])
        pending = dev
    out = app._postprocess_device_out(pending, interior_threshold,
                                      min_cell_size)
    whole.append(out["whole_cell"])
    nuc.append(out["nuclear"])
    return {"whole_cell": np.concatenate(whole),
            "nuclear": np.concatenate(nuc)}
