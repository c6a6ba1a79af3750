import numpy as np
import scipy.ndimage as ndi

from ark_tpu.ops import image_filters, quantiles


def test_gaussian_blur_matches_scipy(rng):
    img = rng.random((48, 40)).astype(np.float32)
    for sigma in [1.0, 2.0, 3.5]:
        ours = np.asarray(image_filters.gaussian_blur(img, sigma=sigma))
        ref = ndi.gaussian_filter(img, sigma=sigma)
        np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=2e-6)


def test_gaussian_blur_multichannel(rng):
    img = rng.random((32, 32, 4)).astype(np.float32)
    ours = np.asarray(image_filters.gaussian_blur(img, sigma=2.0))
    for c in range(4):
        ref = ndi.gaussian_filter(img[..., c], sigma=2.0)
        np.testing.assert_allclose(ours[..., c], ref, rtol=2e-5, atol=2e-6)


def test_gaussian_blur_batch(rng):
    imgs = rng.random((3, 16, 16, 2)).astype(np.float32)
    out = np.asarray(image_filters.gaussian_blur_batch(imgs, sigma=2.0))
    single = np.asarray(image_filters.gaussian_blur(imgs[1], sigma=2.0))
    np.testing.assert_allclose(out[1], single, rtol=1e-6)


def test_quantile_matches_numpy(rng):
    x = rng.random(10007).astype(np.float32)
    for q in [0.05, 0.5, 0.99, 0.999]:
        np.testing.assert_allclose(np.asarray(quantiles.quantile(x, q)),
                                   np.quantile(x, q), rtol=1e-5)


def test_nonzero_quantile(rng):
    x = rng.random(5000).astype(np.float32)
    x[rng.random(5000) < 0.3] = 0.0
    ref = np.quantile(x[x > 0], 0.99)
    np.testing.assert_allclose(np.asarray(quantiles.nonzero_quantile(x, 0.99)),
                               ref, rtol=1e-5)


def test_nonzero_quantile_per_column(rng):
    import pandas as pd
    x = rng.random((400, 5)).astype(np.float32)
    x[rng.random((400, 5)) < 0.2] = 0.0
    ref = pd.DataFrame(x).replace(0, np.nan).quantile(0.999).values
    ours = np.asarray(quantiles.nonzero_quantile_per_column(x, 0.999))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_masked_quantile_per_column(rng):
    x = rng.random((300, 4)).astype(np.float32)
    valid = rng.random(300) < 0.7
    ref = np.array([np.quantile(x[valid, c][x[valid, c] != 0], 0.999)
                    for c in range(4)])
    ours = np.asarray(quantiles.masked_quantile_per_column(x, valid, 0.999))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# Sort-free bisection quantiles (the only quantile path) must be
# bit-identical to XLA's sort-based quantile on every semantic variant.
# ---------------------------------------------------------------------------

def test_bisect_quantiles_bitwise_match_sort_paths(rng):
    import jax.numpy as jnp
    import pytest

    from ark_tpu.ops import quantiles as qs

    x = rng.random((4000, 5)).astype(np.float32)
    x[x < 0.3] = 0.0
    x[:, 4] = 0.0                      # all-zero column -> NaN
    valid = rng.random(4000) < 0.6
    for q in (0.05, 0.5, 0.99, 0.999):
        xs = jnp.asarray(x)
        a = np.asarray(jnp.nanquantile(jnp.where(xs == 0, jnp.nan, xs), q,
                                       axis=0))
        b = np.asarray(qs.nonzero_quantile_per_column(xs, q))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[:4], b[:4], rtol=0, atol=0)
        bad = (~jnp.asarray(valid)[:, None]) | (xs == 0)
        c = np.asarray(jnp.nanquantile(jnp.where(bad, jnp.nan, xs), q,
                                       axis=0))
        d = np.asarray(qs.masked_quantile_per_column(
            xs, jnp.asarray(valid), q))
        np.testing.assert_allclose(c[:4], d[:4], rtol=0, atol=0)
        # flat variants (incl. negative values for the key flip)
        y = rng.normal(size=3000).astype(np.float32)
        e = float(qs._masked_quantile_flat(jnp.asarray(y),
                                           jnp.ones(3000, bool), q))
        assert e == pytest.approx(float(np.quantile(y, q)), abs=2e-6)
        f = float(qs._masked_quantile_flat(jnp.asarray(y),
                                           jnp.asarray(y > 0), q))
        assert f == pytest.approx(float(np.quantile(y[y > 0], q)), abs=2e-6)


def test_bisect_quantile_degenerate_inputs(rng):
    import jax.numpy as jnp

    from ark_tpu.ops import quantiles as qs

    one = jnp.asarray(np.array([[3.5]], np.float32))
    out1 = np.asarray(qs.nonzero_quantile_per_column(one, 0.999))
    assert out1.tolist() == [3.5]
    allzero = jnp.zeros((10, 2), jnp.float32)
    out = np.asarray(qs.nonzero_quantile_per_column(allzero, 0.5))
    assert np.isnan(out).all()
