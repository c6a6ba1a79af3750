"""Golden-activation tests pinning the keras/TF forward semantics the
deepcell-weight converter depends on (VERDICT r3 #1).

The reference's segmentation quality IS the published Mesmer model served
by deepcell.org (`src/ark/utils/deepcell_service_utils.py:214-343`);
`ark_tpu.models.convert_deepcell` maps that HDF5 onto
`ark_tpu.models.unet.PanopticNet`. A converted checkpoint only computes
correctly if every layer reproduces the TF/keras forward convention it was
trained under. Each convention is pinned here against a HAND-DERIVED
fixture (an independent numpy implementation of the TF rule, or frozen
literals worked out by hand) — never against the model code's own output:

  (a) stride-2 SAME conv: TF pads total = (out-1)*s + k - in split
      begin = total//2 (extra on the BOTTOM/RIGHT for even inputs)
  (b) keras ResNet50 stem: ZeroPadding2D(3) + 7x7/2 VALID conv (differs
      from SAME), ZeroPadding2D(1) + 3x3/2 VALID maxpool (zero pad ==
      the model's -inf pad only because the input is post-relu)
  (c) bilinear resize: TF2 half-pixel centers, in = (out+0.5)*in/out - 0.5
      with clamped gather (keras UpSampling2D(bilinear) / UpsampleLike both
      call tf.image.resize)
  (d) BatchNorm inference epsilons: keras.applications resnet uses
      1.001e-5; deepcell's semantic-head BN uses the keras default 1e-3
  (e) Location2D: (y, x) channel order, normalized by the MAX INDEX

plus one end-to-end golden (manifest-shaped seeded weights -> fixed 64^2
input -> frozen output stats) so converter+architecture semantics can
never drift silently.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ark_tpu.models import convert_deepcell as cd
from ark_tpu.models import unet

MANIFEST = os.path.join(os.path.dirname(__file__),
                        "deepcell_layer_manifest.json")


# ---------------------------------------------------------------- oracles

def _conv(x, kern, strides, padding):
    """The model's own conv layer on a given float32 kernel, no bias."""
    scope = unet._Scope({"conv": {"kernel": jnp.asarray(kern)}}, {}, None,
                        (), False, None)
    return unet._conv(scope, "conv", jnp.asarray(x), kern.shape[-1],
                      kern.shape[:2], jnp.float32, strides=strides,
                      padding=padding, use_bias=False)


def tf_same_pad(in_size: int, k: int, s: int):
    """TF's SAME padding rule (tensorflow nn_ops): total pad needed for
    out = ceil(in/s), split begin = total // 2 — the extra row/col goes at
    the END (bottom/right)."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2


def np_conv2d_valid(x, kern, s):
    """Plain-loop VALID cross-correlation oracle. x: (H, W, Cin),
    kern: (kh, kw, Cin, Cout)."""
    kh, kw, cin, cout = kern.shape
    h = (x.shape[0] - kh) // s + 1
    w = (x.shape[1] - kw) // s + 1
    out = np.zeros((h, w, cout), np.float64)
    for i in range(h):
        for j in range(w):
            patch = x[i * s:i * s + kh, j * s:j * s + kw, :]
            out[i, j] = np.tensordot(patch, kern, axes=([0, 1, 2],
                                                        [0, 1, 2]))
    return out


def tf_bilinear_resize_1d(v, out):
    """TF2 tf.image.resize(method='bilinear') along one axis (half-pixel
    centers, clamped gather; antialias is a no-op for upscale)."""
    v = np.asarray(v, np.float64)
    n = len(v)
    res = np.empty(out, np.float64)
    for o in range(out):
        c = (o + 0.5) * (n / out) - 0.5
        f = np.floor(c)
        frac = c - f
        lo = int(np.clip(f, 0, n - 1))
        hi = int(np.clip(f + 1, 0, n - 1))
        res[o] = v[lo] * (1 - frac) + v[hi] * frac
    return res


def tf_bilinear_resize_2d(img, th, tw):
    rows = np.stack([tf_bilinear_resize_1d(img[:, j], th)
                     for j in range(img.shape[1])], axis=1)
    return np.stack([tf_bilinear_resize_1d(rows[i], tw)
                     for i in range(th)], axis=0)


# ------------------------------------------------- (a) stride-2 SAME conv

@pytest.mark.parametrize("in_size", [5, 6, 7, 8])
def test_same_conv_stride2_matches_tf_padding(in_size):
    """padding='SAME' must place the asymmetric extra pad at the
    bottom/right exactly like TF (even inputs: (0, 1) for k=3, s=2). The
    FPN's P6/P7 stride-2 SAME convs ride on this."""
    rng = np.random.default_rng(1000 + in_size)
    x = rng.normal(size=(in_size, in_size, 2)).astype(np.float32)
    kern = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)

    lo, hi = tf_same_pad(in_size, 3, 2)
    xp = np.pad(x, ((lo, hi), (lo, hi), (0, 0)))
    expected = np_conv2d_valid(xp, kern, 2)

    got = _conv(x[None], kern, (2, 2), "SAME")[0]
    np.testing.assert_allclose(np.asarray(got), expected, rtol=2e-5,
                               atol=1e-5)


def test_same_pad_rule_is_bottom_right_heavy():
    # the hand rule itself: even input, odd kernel -> all pad at the end
    assert tf_same_pad(6, 3, 2) == (0, 1)
    assert tf_same_pad(224, 7, 2) == (2, 3)   # != ZeroPadding2D(3)!
    assert tf_same_pad(5, 3, 2) == (1, 1)


# ------------------------------------------------------- (b) keras stem

def test_stem_conv_is_zeropad3_valid_not_same():
    """keras ResNet50 conv1 = ZeroPadding2D(3) + 7x7/2 VALID. The model's
    stem uses explicit padding=[(3,3),(3,3)] — equal to the keras form and
    DIFFERENT from SAME on even inputs (SAME would pad (2, 3))."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 8, 3)).astype(np.float32)
    kern = rng.normal(size=(7, 7, 3, 4)).astype(np.float32)

    expected = np_conv2d_valid(np.pad(x, ((3, 3), (3, 3), (0, 0))), kern, 2)

    got = _conv(x[None], kern, (2, 2), [(3, 3), (3, 3)])[0]
    np.testing.assert_allclose(np.asarray(got), expected, rtol=2e-5,
                               atol=2e-5)

    got_same = _conv(x[None], kern, (2, 2), "SAME")[0]
    assert got.shape == got_same.shape  # both 'same'-sized outputs...
    assert not np.allclose(np.asarray(got), np.asarray(got_same))  # ...but
    # a different pixel alignment: regressing the stem to SAME would shift
    # every downstream activation of a converted checkpoint


def np_maxpool_zeropad(x, pad, k, s):
    xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)))  # keras pads ZEROS
    h = (xp.shape[0] - k) // s + 1
    w = (xp.shape[1] - k) // s + 1
    out = np.zeros((h, w, x.shape[2]), x.dtype)
    for i in range(h):
        for j in range(w):
            out[i, j] = xp[i * s:i * s + k, j * s:j * s + k, :].max((0, 1))
    return out


def test_stem_maxpool_zeropad_equivalence_post_relu():
    """keras pool1 = ZeroPadding2D(1) + 3x3/2 VALID maxpool (zero pad);
    the model's max pool pads -inf. Equal on post-relu input (reals >= 0 always
    dominate a zero pad) — and provably NOT equal on signed input, so the
    relu precondition in the stem is load-bearing."""
    rng = np.random.default_rng(11)
    x = np.abs(rng.normal(size=(9, 9, 2))).astype(np.float32)  # post-relu
    expected = np_maxpool_zeropad(x, 1, 3, 2)
    got = unet._max_pool_3x3_s2(jnp.asarray(x)[None])[0]
    np.testing.assert_array_equal(np.asarray(got), expected)

    signed = x - 2.0  # all-negative corners: zero pad would win in keras
    got_signed = unet._max_pool_3x3_s2(jnp.asarray(signed)[None])[0]
    assert not np.array_equal(np.asarray(got_signed),
                              np_maxpool_zeropad(signed, 1, 3, 2))


# --------------------------------------------- (c) bilinear resize (TF2)

def test_bilinear_2x_upsample_hand_literal():
    """2x upsample of the 1-D ramp [0, 1, 2] under TF2 half-pixel centers,
    worked by hand: out o maps to in (o+0.5)/2 - 0.5 = o/2 - 0.25, edges
    clamp. jax.image.resize must reproduce it exactly."""
    expected = np.array([0.0, 0.25, 0.75, 1.25, 1.75, 2.0])
    got = jax.image.resize(jnp.arange(3.0), (6,), "bilinear")
    np.testing.assert_allclose(np.asarray(got), expected, atol=1e-6)
    # cross-check the in-test oracle against the same hand literal
    np.testing.assert_allclose(tf_bilinear_resize_1d([0, 1, 2], 6),
                               expected, atol=0)


def test_bilinear_resize_matches_tf_oracle_2d():
    """General case incl. a NON-integer ratio (the head's final
    UpsampleLike resizes P3-derived maps straight to the input size)."""
    rng = np.random.default_rng(23)
    img = rng.normal(size=(5, 7)).astype(np.float32)
    for th, tw in [(10, 14), (7, 11), (5, 7)]:
        expected = tf_bilinear_resize_2d(img, th, tw)
        got = jax.image.resize(jnp.asarray(img), (th, tw), "bilinear")
        np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-5,
                                   atol=1e-6)


def test_model_resize_helper_uses_tf_convention():
    rng = np.random.default_rng(29)
    x = rng.normal(size=(1, 4, 6, 3)).astype(np.float32)
    got = unet._bilinear_resize(jnp.asarray(x), 8, 12)
    expected = np.stack([tf_bilinear_resize_2d(x[0, :, :, c], 8, 12)
                         for c in range(3)], axis=-1)
    np.testing.assert_allclose(np.asarray(got[0]), expected, rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------ (d) BatchNorm epsilons

def test_bn_epsilon_constants_are_keras_values():
    assert unet.BACKBONE_BN_EPSILON == 1.001e-5
    assert unet.HEAD_BN_EPSILON == 1e-3


def test_bn_inference_hand_math_discriminates_epsilon():
    """var=0 makes the output 1/sqrt(eps)-scaled, so the wrong epsilon
    (a common 1e-5 default vs keras' 1.001e-5) is a measurable 0.05% shift
    — the hand-math fixture must match the keras value and reject the
    1e-5 default at the discriminating tolerance."""
    x = np.array([[1.5, -0.25]], np.float32)
    gamma = np.array([2.0, 3.0], np.float32)
    beta = np.array([0.5, -1.0], np.float32)
    mean = np.array([0.25, 0.25], np.float32)
    var = np.zeros(2, np.float32)

    scope = unet._Scope({"bn": {"scale": gamma, "bias": beta}},
                        {"bn": {"mean": mean, "var": var}}, None, (), False,
                        None)
    got = unet._batch_norm(scope, "bn", jnp.asarray(x)[None, None],
                           unet.BACKBONE_BN_EPSILON, jnp.float32)[0, 0]
    expected = gamma * (x - mean) / np.sqrt(var + 1.001e-5) + beta
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-6)
    wrong = gamma * (x - mean) / np.sqrt(var + 1e-5) + beta
    assert not np.allclose(np.asarray(got), wrong, rtol=1e-6)


# ------------------------------------------------------- (e) Location2D

def test_location2d_grid_hand_values():
    """deepcell Location2D: channel 0 = row index / (h-1) (varies DOWN),
    channel 1 = col index / (w-1); asymmetric shape catches an order or
    normalization swap."""
    loc = np.asarray(unet.location2d_grid(3, 5))
    assert loc.shape == (3, 5, 2)
    np.testing.assert_allclose(loc[:, 0, 0], [0.0, 0.5, 1.0])   # y down
    np.testing.assert_allclose(loc[0, :, 0], np.zeros(5))       # y const
    np.testing.assert_allclose(loc[0, :, 1],
                               [0.0, 0.25, 0.5, 0.75, 1.0])     # x across
    np.testing.assert_allclose(loc[:, 4, 1], np.ones(3))
    assert loc.max() == 1.0 and loc.min() == 0.0


# -------------------------------------------------- end-to-end golden

def _golden_layers():
    """Manifest-shaped weights from a FROZEN seed (independent of the
    shared per-test rng fixture). Kernels are fan-in-scaled and BN stats
    kept near identity so activations stay O(1) through ~60 layers —
    unscaled N(0,1) weights measured 1e12 outputs and a fully saturated
    softmax, a golden that could not detect drift."""
    rng = np.random.default_rng(20240817)
    with open(MANIFEST) as f:
        manifest = json.load(f)["layers"]
    layers = {}
    for name, weights in sorted(manifest.items()):
        layers[name] = {}
        for w, shape in sorted(weights.items()):
            if w == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.normal(size=shape) / np.sqrt(fan_in)
            elif w == "gamma":
                arr = 1.0 + 0.1 * rng.normal(size=shape)
            elif w == "moving_variance":
                arr = 1.0 + 0.1 * np.abs(rng.normal(size=shape))
            else:  # bias / beta / moving_mean
                arr = 0.1 * rng.normal(size=shape)
            layers[name][w] = arr.astype(np.float32)
    return layers


# Frozen by running this module once (see docstring); a drift in ANY of
# padding/resize/BN-eps/Location2D/converter-mapping moves these numbers.
GOLDEN = {
    "whole_cell_inner_distance": {
        "mean": 0.0021603144705295563, "std": 0.012246135622262955,
        "samples": [0.0028510093688964844, 0.0, 0.0],
    },
    "whole_cell_pixelwise": {
        "mean": 0.3333333432674408, "std": 0.042415376752614975,
        "samples": [0.34042105078697205, 0.35757094621658325,
                    0.3563143312931061],
    },
    "nuclear_inner_distance": {
        "mean": 0.24508880078792572, "std": 0.07899712771177292,
        "samples": [0.14785471558570862, 0.2643473148345947,
                    0.36501753330230713],
    },
    "nuclear_pixelwise": {
        "mean": 0.3333333432674408, "std": 0.13909882307052612,
        "samples": [0.3010386824607849, 0.23812419176101685,
                    0.22199563682079315],
    },
}
_SAMPLE_AT = [(0, 0, 0, 0), (0, 13, 47, 0), (0, 32, 32, 0)]


def test_e2e_forward_golden_from_manifest_weights():
    """Manifest-shaped seeded weights -> convert -> full Mesmer forward on
    a fixed smooth 64^2 input -> frozen output stats. Guards the WHOLE
    semantic chain: if a genuine MultiplexSegmentation.h5 would convert
    cleanly but compute wrongly, this golden moves."""
    model, variables = unet.init_mesmer(seed=0, input_shape=(1, 64, 64, 2),
                                        dtype=np.float32)
    converted = cd.convert(_golden_layers(),
                           jax.device_get(jax.tree.map(np.asarray,
                                                       variables)))
    yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64),
                         indexing="ij")
    x = np.stack([np.sin(6 * xx) * yy, np.cos(4 * yy) + xx],
                 axis=-1)[None].astype(np.float32)
    out = jax.jit(lambda v, a: model.apply(v, a, train=False))(
        {"params": jax.tree.map(jnp.asarray, converted["params"]),
         "batch_stats": jax.tree.map(jnp.asarray,
                                     converted["batch_stats"])},
        jnp.asarray(x))
    for key, g in GOLDEN.items():
        arr = np.asarray(out[key], np.float32)
        assert np.isfinite(arr).all(), key
        np.testing.assert_allclose(arr.mean(), g["mean"], rtol=1e-3,
                                   err_msg=key)
        np.testing.assert_allclose(arr.std(), g["std"], rtol=1e-3,
                                   err_msg=key)
        got = [float(arr[i]) for i in _SAMPLE_AT]
        np.testing.assert_allclose(got, g["samples"], rtol=2e-3, atol=1e-6,
                                   err_msg=key)
