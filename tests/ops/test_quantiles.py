"""Oracle tests for ark_tpu.ops.quantiles.

The 32-pass counting bisection on order-preserving float bit-keys (the only
quantile path) is checked against NumPy's linear-interpolation quantile
semantics (the reference contract: `np.quantile` in
`pixel_cluster_utils.py:44-52,104` and pandas `.replace(0, nan).quantile` in
`pixie_preprocessing.py:407`), and bit for bit against XLA's sort-based
`jnp.nanquantile` on the same f32 inputs.
"""

import numpy as np
import pytest

from ark_tpu.ops import quantiles as q_ops


def _sort_nonzero_per_column(x, q):
    """XLA's sort-based quantile with the same zero/NaN-ignoring rule."""
    import jax.numpy as jnp
    x = jnp.asarray(x, jnp.float32)
    return np.asarray(jnp.nanquantile(jnp.where(x == 0, jnp.nan, x), q,
                                      axis=0))


def _sort_masked_per_column(x, valid, q):
    import jax.numpy as jnp
    x = jnp.asarray(x, jnp.float32)
    bad = (~jnp.asarray(valid)[:, None]) | (x == 0)
    return np.asarray(jnp.nanquantile(jnp.where(bad, jnp.nan, x), q,
                                      axis=0))


def _pandas_nonzero_quantile(x, q):
    import pandas as pd
    return pd.DataFrame(x).replace(0, np.nan).quantile(q).to_numpy()


@pytest.mark.parametrize("q", [0.0, 0.05, 0.5, 0.99, 0.999, 1.0])
def test_quantile_matches_numpy(rng, q):
    x = rng.normal(scale=10.0, size=(257, 13)).astype(np.float32)
    got = np.asarray(q_ops.quantile(x, q))
    want = np.quantile(x.astype(np.float64), q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [0.05, 0.5, 0.999])
def test_nonzero_quantile_matches_masked_numpy(rng, q):
    x = rng.normal(size=1000).astype(np.float32)
    x[rng.random(1000) < 0.4] = 0.0
    got = np.asarray(q_ops.nonzero_quantile(x, q))
    want = np.quantile(x[x > 0].astype(np.float64), q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nonzero_quantile_all_nonpositive_is_nan():
    x = np.zeros(64, np.float32)
    assert np.isnan(np.asarray(q_ops.nonzero_quantile(x, 0.999)))
    # negatives are excluded too (`img[img > 0]` reference semantics)
    x[:10] = -3.5
    assert np.isnan(np.asarray(q_ops.nonzero_quantile(x, 0.999)))


@pytest.mark.parametrize("q", [0.05, 0.5, 0.999])
def test_nonzero_per_column_matches_pandas(rng, q):
    x = rng.normal(scale=4.0, size=(400, 7)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    x[:, 3] = 0.0                           # all-zero column -> NaN
    got = np.asarray(q_ops.nonzero_quantile_per_column(x, q))
    want = _pandas_nonzero_quantile(x, q)
    assert np.isnan(got[3]) and np.isnan(want[3])
    keep = [c for c in range(7) if c != 3]
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-5)


def test_masked_per_column_matches_numpy(rng):
    x = rng.random((300, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = 0.0
    valid = rng.random(300) < 0.6
    got = np.asarray(q_ops.masked_quantile_per_column(x, valid, 0.999))
    for c in range(5):
        col = x[valid, c]
        col = col[col != 0].astype(np.float64)
        np.testing.assert_allclose(got[c], np.quantile(col, 0.999),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The bisection must agree with XLA's sort-based quantile bit-for-bit on the
# same f32 inputs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [0.0, 0.05, 0.5, 0.999, 1.0])
def test_bisect_matches_sort_path_exactly(rng, q):
    x = rng.normal(scale=100.0, size=(513, 9)).astype(np.float32)
    x[rng.random(x.shape) < 0.25] = 0.0
    bis = np.asarray(q_ops.nonzero_quantile_per_column(x, q))
    srt = _sort_nonzero_per_column(x, q)
    np.testing.assert_allclose(bis, srt, rtol=1e-6, atol=0)


def test_bisect_handles_negatives_and_extremes():
    # order-preserving bit-key transform must order negatives, zeros,
    # subnormals and large magnitudes correctly
    x = np.array([[-1e30, -1.5, -1e-40, 1e-40, 1.5, 1e30, 7.0, -7.0]],
                 np.float32).T
    valid = np.ones_like(x, bool)
    ranks = np.arange(8, dtype=np.int32)[None, :]
    got = np.asarray(q_ops.masked_order_stats(x.reshape(8, 1).T.reshape(8, 1),
                                              valid, ranks.reshape(1, 8)))
    # column 0 holds all 8 values; its order stats are the sorted values
    np.testing.assert_array_equal(got[0], np.sort(x[:, 0]))


def test_masked_order_stats_ignores_invalid_rows(rng):
    x = rng.normal(size=(100, 3)).astype(np.float32)
    valid = rng.random((100, 3)) < 0.5
    ranks = np.zeros((3, 2), np.int32)
    ranks[:, 1] = np.maximum(valid.sum(0) - 1, 0)
    got = np.asarray(q_ops.masked_order_stats(x, valid, ranks))
    for c in range(3):
        col = np.sort(x[valid[:, c], c])
        np.testing.assert_array_equal(got[c], [col[0], col[-1]])


def test_single_element_and_tied_inputs():
    one = np.array([[3.25]], np.float32)
    np.testing.assert_allclose(
        np.asarray(q_ops.nonzero_quantile_per_column(one, 0.999)), [3.25])
    ties = np.full((50, 2), 2.5, np.float32)
    got = np.asarray(q_ops.nonzero_quantile_per_column(ties, 0.37))
    np.testing.assert_array_equal(got, [2.5, 2.5])


def test_masked_bisect_matches_masked_sort(rng):
    x = rng.random((222, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.15] = 0.0
    valid = rng.random(222) < 0.7
    bis = np.asarray(q_ops.masked_quantile_per_column(x, valid, 0.999))
    srt = _sort_masked_per_column(x, valid, 0.999)
    np.testing.assert_allclose(bis, srt, rtol=1e-6, atol=0)


def test_bisect_nan_semantics_match_sort_paths(rng):
    """NaN handling must be backend-independent: plain quantile propagates
    NaN (np.quantile semantics); the nonzero/masked variants IGNORE NaN
    (pandas/nanquantile semantics). The bit-key bisection would otherwise
    order NaN as an extreme value."""
    x = rng.normal(size=200).astype(np.float32)
    x[7] = np.nan
    assert np.isnan(np.asarray(q_ops.quantile(x, 0.5)))

    m = rng.random((100, 3)).astype(np.float32)
    m[rng.random(m.shape) < 0.2] = 0.0
    m[5, 0] = np.nan
    m[9, 2] = np.nan
    bis = np.asarray(q_ops.nonzero_quantile_per_column(m, 0.9))
    srt = _sort_nonzero_per_column(m, 0.9)
    np.testing.assert_allclose(bis, srt, rtol=1e-6, atol=0)
    want = _pandas_nonzero_quantile(m, 0.9)
    np.testing.assert_allclose(bis, want, rtol=1e-5, atol=1e-5)

    valid = rng.random(100) < 0.7
    bis_m = np.asarray(q_ops.masked_quantile_per_column(m, valid, 0.9))
    srt_m = _sort_masked_per_column(m, valid, 0.9)
    np.testing.assert_allclose(bis_m, srt_m, rtol=1e-6, atol=0)
