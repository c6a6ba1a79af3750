import numpy as np
import jax
import jax.numpy as jnp

from ark_tpu.models import unet


def test_init_mesmer_heads_and_params(tmp_path):
    model, variables = unet.init_mesmer(seed=0, dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 2), jnp.float32)
    out = model.apply(variables, x, train=False)
    assert set(out) == {"whole_cell_inner_distance", "whole_cell_pixelwise",
                        "nuclear_inner_distance", "nuclear_pixelwise"}
    assert out["whole_cell_inner_distance"].shape == (1, 64, 64, 1)
    assert out["whole_cell_pixelwise"].shape == (1, 64, 64, 3)
    # pixelwise heads are softmax distributions
    np.testing.assert_allclose(
        np.asarray(out["whole_cell_pixelwise"]).sum(-1), 1.0, atol=1e-4)
    n_params = sum(p.size for p in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n_params > 20_000_000   # full ResNet50+FPN PanopticNet


def test_model_dtype_resize_tracks_f32_resize():
    """The pyramid/head resizes run in the model dtype (A/B in
    benchmarks/head_fold_ab.py); on a bf16 model the outputs must
    stay within bf16 rounding of the old upcast-to-f32-resize behavior,
    and an f32 model must be bitwise unaffected by the switch."""
    mini = dict(stage_sizes=(1, 1, 1, 1), base_width=16, fpn_channels=64,
                head_upsample_filters=32, head_dense_features=64,
                inner_activation="linear")
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random((2, 48, 48, 2), np.float32))
    try:
        for dtype, tol in ((jnp.float32, 0.0), (jnp.bfloat16, 0.03)):
            model, variables = unet.init_mesmer(
                seed=3, input_shape=(2, 48, 48, 2), dtype=dtype, **mini)
            unet.RESIZE_IN_F32 = False
            fast = model.apply(variables, x, train=False)
            unet.RESIZE_IN_F32 = True
            ref = model.apply(variables, x, train=False)
            for k in fast:
                a, b = np.asarray(fast[k]), np.asarray(ref[k])
                span = max(float(np.abs(b).max()), 1.0)
                assert np.abs(a - b).max() <= tol * span, \
                    (dtype, k, np.abs(a - b).max())
    finally:
        unet.RESIZE_IN_F32 = False
    assert not unet.RESIZE_IN_F32


def test_params_npz_roundtrip(tmp_path):
    model, variables = unet.init_mesmer(seed=0, dtype=jnp.float32)
    path = str(tmp_path / "w.npz")
    unet.save_params_npz(path, variables)
    loaded = unet.load_params_npz(path)
    x = jnp.ones((1, 64, 64, 2), jnp.float32) * 0.5
    a = model.apply(variables, x, train=False)["whole_cell_inner_distance"]
    b = model.apply(loaded, x, train=False)["whole_cell_inner_distance"]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
