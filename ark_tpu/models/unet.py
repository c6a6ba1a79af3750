"""Mesmer-style segmentation network: ResNet50 + FPN + semantic heads, in JAX.

Replaces the reference's remote DeepCell/Mesmer REST service
(`src/ark/utils/deepcell_service_utils.py:95-343` — zip upload → GPU predict →
poll → download) with an in-process JAX model so FOV batches run on the accelerator.

Architecture follows the published Mesmer configuration (deepcell-tf
PanopticNet topology, transcribed in tests/models/deepcell_layer_manifest.json):
input → Location2D coordinate-channel concat → channel-fixing dense
(TensorProduct to the backbone's 3 channels) → ResNet50 encoder → feature
pyramid over C3–C5 with retinanet-style P6/P7 extras → four semantic heads
fed from P3 — for each compartment (whole-cell, nuclear) an inner-distance
regression head (1 channel, ReLU) and a pixelwise classification head
(3 classes: interior / border / background, softmax). Input is a 2-channel
(nuclear, membrane) image batch in NHWC. Weights are random-initialized unless
loaded from an `.npz` (the zero-egress build cannot fetch published weights;
`load_params_npz` accepts a checkpoint converted by
`ark_tpu.models.convert_deepcell`, whose layer-name map targets the same
manifest).

All convs run in bfloat16 by default with float32 params/outputs; shapes
are static; the whole forward jits into one program. The layers are plain
`jax.lax` calls over an explicit variables pytree (no module library), with
the parameter layout and random init of the flax version this network was
first written in, so `.npz` checkpoints load unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# benchmarking/debug switch (benchmarks/head_fold_ab.py A/Bs it
# in-process): True upcasts every pyramid/head resize to float32. The
# default resizes in the model dtype: the result is rounded back to it
# anyway, and the 2× weights 0.25/0.75 are exact in bf16. Which is faster
# on the GPU is not measured.
RESIZE_IN_F32 = False

# keras/TF forward-semantics constants the converter contract depends on
# (pinned by tests/models/test_keras_semantics.py — a genuine
# MultiplexSegmentation.h5 converts AND computes correctly only if these
# match what the weights were trained under):
# - keras.applications resnet.py builds every backbone BatchNormalization
#   with epsilon=1.001e-5 (NOT keras' 1e-3 default, NOT flax's 1e-5)
# - deepcell-tf's semantic head uses a default-epsilon keras
#   BatchNormalization (1e-3)
BACKBONE_BN_EPSILON = 1.001e-5
HEAD_BN_EPSILON = 1e-3


def location2d_grid(h: int, w: int) -> jax.Array:
    """deepcell-tf `Location2D` coordinate channels (layers/location.py):
    row/col index grids each normalized to [0, 1] by their MAX INDEX
    (divide by h-1 / w-1, not h / w), stacked channel-last in (y, x)
    order — channel 0 varies down rows, channel 1 across columns.
    Returns (h, w, 2) float32."""
    ys = jnp.arange(h, dtype=jnp.float32) / max(h - 1, 1)
    xs = jnp.arange(w, dtype=jnp.float32) / max(w - 1, 1)
    return jnp.stack(jnp.meshgrid(ys, xs, indexing="ij"), axis=-1)


def _bilinear_resize(x: jax.Array, th: int, tw: int,
                     dtype=None) -> jax.Array:
    """Bilinear resize of NHWC `x` to (th, tw) via `jax.image.resize`, in
    the model dtype (f32 when RESIZE_IN_F32 — see note above)."""
    out_dtype = dtype if dtype is not None else x.dtype
    if RESIZE_IN_F32:
        x = x.astype(jnp.float32)
    b, h, w, c = x.shape
    if (h, w) != (th, tw):
        x = jax.image.resize(x, (b, th, tw, c), "bilinear")
    return x.astype(out_dtype)


_CONV_DIMS = jax.lax.ConvDimensionNumbers((0, 3, 1, 2), (3, 2, 0, 1),
                                          (0, 3, 1, 2))    # NHWC / HWIO
_lecun_normal = jax.nn.initializers.lecun_normal()
_zeros = jax.nn.initializers.zeros
_ones = jax.nn.initializers.ones


def _fold_in_path(key: jax.Array, path: Tuple) -> jax.Array:
    """Fold a module path (names, then a per-module counter) into `key`
    through the first 4 bytes of its SHA-1. This is flax's per-parameter
    key derivation, so `init_mesmer(seed)` draws the same weights as the
    flax version of this network did."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Scope:
    """One module's slice of the variables pytree ({'params', 'batch_stats'}).

    With a `key` (init) missing parameters are drawn and stored; without one
    every read must hit. In training mode BatchNorm uses batch statistics
    and writes its new running averages into `new_stats`."""

    def __init__(self, params, stats, key, path, train, new_stats):
        self.params, self.stats, self.key = params, stats, key
        self.path, self.train, self.new_stats = path, train, new_stats
        self._n_params = 0

    def child(self, name: str) -> "_Scope":
        init = self.key is not None
        return _Scope(
            self.params.setdefault(name, {}) if init else self.params[name],
            self.stats.setdefault(name, {}) if init
            else self.stats.get(name, {}),
            self.key, self.path + (name,), self.train,
            None if self.new_stats is None
            else self.new_stats.setdefault(name, {}))

    def param(self, name: str, init_fn, shape) -> jax.Array:
        if self.key is not None and name not in self.params:
            self._n_params += 1
            self.params[name] = init_fn(
                _fold_in_path(self.key, self.path + (self._n_params,)),
                shape, jnp.float32)
        return self.params[name]


def _conv(s: _Scope, name: str, x, features: int, kernel: Tuple[int, int],
          dtype, strides=(1, 1), padding="SAME", use_bias: bool = True):
    """2-D convolution, NHWC input, HWIO kernel, computed in `dtype`."""
    s = s.child(name)
    k = s.param("kernel", _lecun_normal, kernel + (x.shape[-1], features))
    b = s.param("bias", _zeros, (features,)) if use_bias else None
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), k.astype(dtype), strides, padding,
        lhs_dilation=(1, 1), rhs_dilation=(1, 1),
        dimension_numbers=_CONV_DIMS, feature_group_count=1)
    if b is not None:
        y = y + b.astype(dtype).reshape(1, 1, 1, -1)
    return y


def _dense(s: _Scope, name: str, x, features: int, dtype):
    """Channel-dense layer (keras TensorProduct / Dense) in `dtype`."""
    s = s.child(name)
    k = s.param("kernel", _lecun_normal, (x.shape[-1], features))
    b = s.param("bias", _zeros, (features,))
    x = x.astype(dtype)
    y = jax.lax.dot_general(x, k.astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    return y + b.astype(dtype).reshape((1,) * (y.ndim - 1) + (-1,))


def _batch_norm(s: _Scope, name: str, x, epsilon: float, dtype,
                scale_init=_ones, momentum: float = 0.9):
    """BatchNorm over NHW. Statistics and the affine map run in float32;
    the result is cast to `dtype`."""
    s = s.child(name)
    c = x.shape[-1]
    if s.key is not None and "mean" not in s.stats:
        s.stats["mean"] = jnp.zeros((c,), jnp.float32)
        s.stats["var"] = jnp.ones((c,), jnp.float32)
    axes = tuple(range(x.ndim - 1))
    if s.train:
        xf = x.astype(jnp.promote_types(dtype, jnp.float32))
        sq = jax.lax.square(xf)
        mean, mean2 = xf.mean(axes), sq.mean(axes)
        var = jnp.maximum(0.0, mean2 - jax.lax.square(mean))
        s.new_stats["mean"] = momentum * s.stats["mean"] \
            + (1 - momentum) * mean
        s.new_stats["var"] = momentum * s.stats["var"] + (1 - momentum) * var
    else:
        mean, var = s.stats["mean"], s.stats["var"]
    y = x - jnp.expand_dims(mean, axes)
    mul = jax.lax.rsqrt(jnp.expand_dims(var, axes) + epsilon)
    mul = mul * s.param("scale", scale_init, (c,)).reshape(1, 1, 1, c)
    y = y * mul
    y = y + s.param("bias", _zeros, (c,)).reshape(1, 1, 1, c)
    return y.astype(dtype)


def _max_pool_3x3_s2(x):
    """3×3/2 max pool with one row/col of -inf padding on each side."""
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1),
                                 ((0, 0), (1, 1), (1, 1), (0, 0)))


def _bottleneck(s: _Scope, x, features: int, strides, projection: bool,
                dtype):
    """ResNet50 bottleneck block (1×1, 3×3, 1×1 ×4, residual)."""
    def norm(name, y, **kw):
        return _batch_norm(s, name, y, BACKBONE_BN_EPSILON, dtype, **kw)

    residual = x
    y = _conv(s, "Conv_0", x, features, (1, 1), dtype, strides=strides,
              use_bias=False)
    y = jax.nn.relu(norm("BatchNorm_0", y))
    y = _conv(s, "Conv_1", y, features, (3, 3), dtype, use_bias=False)
    y = jax.nn.relu(norm("BatchNorm_1", y))
    y = _conv(s, "Conv_2", y, features * 4, (1, 1), dtype, use_bias=False)
    y = norm("BatchNorm_2", y, scale_init=_zeros)
    if projection or residual.shape[-1] != features * 4:
        residual = _conv(s, "Conv_3", residual, features * 4, (1, 1), dtype,
                         strides=strides, use_bias=False)
        residual = norm("BatchNorm_3", residual)
    return jax.nn.relu(y + residual)


def _resnet50(s: _Scope, x, stage_sizes: Sequence[int], base_width: int,
              dtype):
    """Standard ResNet50 stages; returns C2..C5 feature maps (strides
    4..32). `stage_sizes`/`base_width` shrink it for the mini
    configuration."""
    # keras ResNet50 stem: ZeroPadding2D(3) + 7x7/2 VALID conv — an
    # explicit (3, 3) pad, NOT 'SAME' (SAME on an even input pads (2, 3):
    # one row/col shifted vs the published weights)
    x = _conv(s, "Conv_0", x, base_width, (7, 7), dtype, strides=(2, 2),
              padding=[(3, 3), (3, 3)], use_bias=False)
    x = jax.nn.relu(_batch_norm(s, "BatchNorm_0", x, BACKBONE_BN_EPSILON,
                                dtype))
    # keras pool1: ZeroPadding2D(1) + 3x3/2 VALID maxpool. This pads with
    # -inf where keras pads with ZEROS — identical here because the input
    # is post-relu (>= 0, so real values always dominate a zero pad);
    # pinned by tests/models/test_keras_semantics.py
    x = _max_pool_3x3_s2(x)
    feats = []
    block = 0
    for i, n_blocks in enumerate(stage_sizes):
        features = base_width * (2 ** i)
        for j in range(n_blocks):
            strides = (2, 2) if (i > 0 and j == 0) else (1, 1)
            x = _bottleneck(s.child(f"BottleneckBlock_{block}"), x, features,
                            strides, projection=j == 0, dtype=dtype)
            block += 1
        feats.append(x)
    return feats  # [C2, C3, C4, C5]


def _fpn(s: _Scope, feats, channels: int, dtype):
    """deepcell-tf `fpn.__create_pyramid_features` topology over C3–C5:
    1×1 laterals (`C{l}_reduced`), bilinear top-down adds, 3×3 smoothing
    (`P{l}`), plus the retinanet-style extras P6 = stride-2 3×3 on C5 and
    P7 = stride-2 3×3 on relu(P6). P6/P7 exist in the published weights
    even though the semantic heads consume only P3 — they are created here
    too (XLA dead-code-eliminates their compute when unused) so a converted
    checkpoint maps 1:1 with no leftover layers."""
    levels = (3, 4, 5)                       # feats = [C3, C4, C5]
    laterals = [_conv(s, f"C{l}_reduced", f, channels, (1, 1), dtype)
                for l, f in zip(levels, feats)]
    tops = [laterals[-1]]
    for lat in laterals[-2::-1]:
        b, h, w, c = lat.shape
        tops.append(lat + _bilinear_resize(tops[-1], h, w, dtype=dtype))
    tops = tops[::-1]
    pyr = [_conv(s, f"P{l}", t, channels, (3, 3), dtype)
           for l, t in zip(levels, tops)]
    p6 = _conv(s, "P6", feats[-1], channels, (3, 3), dtype, strides=(2, 2))
    p7 = _conv(s, "P7", jax.nn.relu(p6), channels, (3, 3), dtype,
               strides=(2, 2))
    return pyr + [p6, p7]                    # [P3, P4, P5, P6, P7]


def _semantic_head(s: _Scope, p3, out_hw, n_classes: int,
                   upsample_filters: int, dense_features: int, dtype):
    """deepcell-tf `fpn.__create_semantic_head` topology: from the finest
    pyramid level (P3, stride 8), three rounds of 3×3 conv + relu + 2×
    bilinear upsample back to input resolution (`semantic_upsample`,
    conv_{i}_semantic_upsample_{id}), then a channel-dense (TensorProduct)
    to `dense_features` + BatchNorm + relu, then a channel-dense to
    n_classes. Leaf names are the converter's targets. Applying dense_0 +
    bn_0 below the final upsample would be an exact reordering (both are
    per-pixel affine maps and bilinear weights sum to 1); the published
    order is kept."""
    x = p3
    for i in range(3):
        x = jax.nn.relu(_conv(s, f"upsample_conv_{i}", x, upsample_filters,
                              (3, 3), dtype))
        b, h, w, c = x.shape
        # the last step is an UpsampleLike straight to the input size
        th, tw = (out_hw if i == 2 else (h * 2, w * 2))
        x = _bilinear_resize(x, th, tw, dtype=dtype)
    x = _dense(s, "dense_0", x, dense_features, dtype)
    x = jax.nn.relu(_batch_norm(s, "bn_0", x, HEAD_BN_EPSILON, dtype))
    return _dense(s, "dense_1", x, n_classes, jnp.float32)


_ACTIVATIONS = {"relu": jax.nn.relu, "softplus": jax.nn.softplus,
                "linear": lambda y: y}


@dataclasses.dataclass(frozen=True)
class PanopticNet:
    """Mesmer-configuration segmentation net.

    Output dict per compartment c in {'whole_cell', 'nuclear'}:
      `<c>_inner_distance`: (B, H, W, 1) ReLU regression of cell-center distance
      `<c>_pixelwise`: (B, H, W, 3) softmax over interior/border/background

    Defaults are the published Mesmer configuration (ResNet50 backbone,
    256-channel FPN). `stage_sizes`/`base_width`/`fpn_channels` define the
    mini configuration (`init_mesmer_mini`) used for fast synthetic training
    and tests — same code path, fewer/narrower blocks.

    Variables are the pytree {'params': ..., 'batch_stats': ...} with
    module paths as keys (`ResNet50Backbone_0/BottleneckBlock_3/Conv_1/
    kernel`, `FPN_0/P3/bias`, `whole_cell_inner/bn_0/mean`, ...): the
    layout of the `.npz` checkpoints and of `convert_deepcell`.
    """
    compartments: Sequence[str] = ("whole_cell", "nuclear")
    dtype: Any = jnp.bfloat16
    stage_sizes: Sequence[int] = (3, 4, 6, 3)
    base_width: int = 64
    fpn_channels: int = 256
    head_upsample_filters: int = 64
    head_dense_features: int = 128
    # deepcell PanopticNet(location=True): concatenate normalized (y, x)
    # coordinate channels, then a channel-dense maps to the backbone's
    # required 3 channels ('tensor_product' in the published weights)
    location: bool = True
    # published Mesmer uses relu on the inner-distance head; training from
    # scratch with MSE kills saturating heads on mostly-zero targets (relu:
    # all pre-activations go negative -> zero grad; softplus: driven to -inf
    # until exp underflows — both observed on synthetic training), so
    # trained-from-scratch configs use a linear head (MSE optimum is the
    # conditional mean, no saturation; the deep-watershed postprocess
    # thresholds at 0.1 so small negative background is harmless)
    inner_activation: str = "relu"

    def init(self, key: jax.Array, x: jax.Array, train: bool = False) -> Dict:
        """Draw a variables pytree for inputs shaped like `x`."""
        params, stats = {}, {}
        self._forward(_Scope(params, stats, key, (), False, None), x)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: Dict, x: jax.Array, train: bool = False,
              mutable=(), return_p3: bool = False):
        """Forward pass. `train=True` normalizes with batch statistics;
        with `mutable` set the call returns (outputs, {'batch_stats':
        updated running averages}).

        return_p3=True: stop after the FPN and return the P3 feature map
        (for head experiments, e.g. benchmarks/head_tile_ab.py)."""
        stats = variables.get("batch_stats", {})
        new_stats = {} if train else None
        out = self._forward(_Scope(variables["params"], stats, None, (),
                                   train, new_stats), x, return_p3)
        if mutable:
            return out, {"batch_stats": new_stats if train else stats}
        return out

    def _forward(self, s: _Scope, x, return_p3: bool = False):
        dtype = self.dtype
        out_hw = x.shape[1:3]
        x = x.astype(dtype)
        if self.location:
            b, h, w, _ = x.shape
            loc = jnp.broadcast_to(location2d_grid(h, w)[None], (b, h, w, 2))
            x = jnp.concatenate([x, loc.astype(dtype)], axis=-1)
        x = _dense(s, "tensor_product", x, 3, dtype)
        feats = _resnet50(s.child("ResNet50Backbone_0"), x,
                          tuple(self.stage_sizes), self.base_width, dtype)
        pyramid = _fpn(s.child("FPN_0"), feats[1:], self.fpn_channels, dtype)
        p3 = pyramid[0]
        if return_p3:
            return p3
        out = {}
        act = _ACTIVATIONS[self.inner_activation]
        for comp in self.compartments:
            inner = _semantic_head(
                s.child(f"{comp}_inner"), p3, out_hw, 1,
                self.head_upsample_filters, self.head_dense_features, dtype)
            pixelwise = _semantic_head(
                s.child(f"{comp}_pixelwise"), p3, out_hw, 3,
                self.head_upsample_filters, self.head_dense_features, dtype)
            out[f"{comp}_inner_distance"] = act(inner)
            out[f"{comp}_pixelwise"] = jax.nn.softmax(pixelwise, axis=-1)
        return out


# maxsize=2 bounds retained memory: a full Mesmer variables pytree is
# ~100 MB f32, and real sessions touch at most two configs (full + mini);
# 8 slots could pin close to a GB for the process lifetime
@functools.lru_cache(maxsize=2)
def _init_cached(seed, input_shape, dtype, config_items):
    model = PanopticNet(dtype=dtype, **dict(config_items))
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros(input_shape, jnp.float32))
    return model, variables


def init_mesmer(seed: int = 0, input_shape=(1, 256, 256, 2),
                dtype=jnp.bfloat16, **config):
    """Initialize a Mesmer PanopticNet; returns (model, variables).

    Init runs under jit — an eager init of the full ResNet50 evaluates
    ~160 convs op-by-op; jitted it is one compile.
    Results are memoized per (seed, shape, dtype, config): repeated inits
    (common in tests) return the same model and variables pytree — treat
    the variables as immutable (all jax ops copy; never mutate in place)."""
    config_items = tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in config.items()))
    return _init_cached(seed, tuple(input_shape), dtype, config_items)


def init_mesmer_mini(seed: int = 0, input_shape=(1, 64, 64, 2),
                     dtype=jnp.float32):
    """A small PanopticNet: 1-block stages, width 16, 64-channel FPN,
    narrow heads, linear inner-distance head (trained from scratch).
    Same code path as the full Mesmer configuration; used for
    synthetic-data training demos and the planted-instance e2e tests."""
    return init_mesmer(seed=seed, input_shape=input_shape, dtype=dtype,
                       stage_sizes=(1, 1, 1, 1), base_width=16,
                       fpn_channels=64, head_upsample_filters=32,
                       head_dense_features=64, inner_activation="linear")


def load_params_npz(path: str, return_config: bool = False):
    """Load a flattened param dict ('a/b/c' keys) from .npz into a pytree.

    Checkpoints written by `save_params_npz` embed the PanopticNet
    architecture config under '__config__'; pass return_config=True to get
    (variables, config_dict_or_None)."""
    import json

    flat = dict(np.load(path))
    config = None
    raw = flat.pop("__config__", None)
    if raw is not None:
        config = json.loads(str(raw.item() if raw.ndim == 0 else raw[0]))
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(val)
    return (tree, config) if return_config else tree


def save_params_npz(path: str, variables: Dict, config: Dict = None):
    """Save a variables pytree as a flattened compressed .npz; `config`
    (PanopticNet kwargs, e.g. {'stage_sizes': [1,1,1,1], 'base_width': 16})
    is embedded as JSON so loaders can rebuild the architecture."""
    import json

    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(node)

    rec(variables, "")
    if config is not None:
        flat["__config__"] = np.array(json.dumps(config))
    np.savez_compressed(path, **flat)
