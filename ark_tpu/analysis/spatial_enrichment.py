"""Pairwise spatial enrichment with vmapped device permutation tests.

The reference exposes the core utilities (`spatial_analysis_utils.py:119-274`:
positive-label selection + close-cell counting) that its pairwise-enrichment
notebook drives (README.md:97; the notebook itself is absent from the
snapshot). This module rebuilds that workflow for an accelerator: the
observed marker×marker close-interaction matrix and the full bootstrap null
distribution are computed as one batched matrix product —
`close_num[b] = P_b · D_bin · P_bᵀ` over B independently permuted positive-
label matrices — instead of a Python loop over permutations.

Outputs per FOV: observed close_num, the (B, M, M) null, z-scores, and
enrichment/depletion p-values with Benjamini–Hochberg adjustment.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ark_tpu import settings
from ark_tpu.analysis import spatial_analysis_utils
from ark_tpu.io.misc_utils import verify_in_list
from ark_tpu.ops.distances import shape_bucket as _bucket


def benjamini_hochberg(pvals: np.ndarray) -> np.ndarray:
    """BH-adjusted p-values (statsmodels.multipletests 'fdr_bh' equivalent)."""
    p = np.asarray(pvals, float).ravel()
    n = len(p)
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.minimum(ranked, 1.0)
    return out.reshape(np.asarray(pvals).shape)


@functools.partial(jax.jit, static_argnames=("bootstrap_num",))
def _permutation_null(dist_bin: jax.Array, pos_matrix: jax.Array,
                      n_real: jax.Array, seed: jax.Array,
                      bootstrap_num: int) -> jax.Array:
    """(B, M, M) null close-counts: each bootstrap permutes the cell axis of
    the positive-label matrix (preserving per-marker positive counts), then
    one batched P·D·Pᵀ einsum computes every marker pair at once.

    Inputs may be zero-padded past ``n_real`` (shape bucketing): a full
    ``jax.random.permutation`` over the bucket is stably partitioned so
    real columns fill the first ``n_real`` slots (in the exactly-uniform
    relative order the full permutation induces) and padding columns
    (all-zero in both operands) stay inert past them — the null over real
    cells is exactly the unpadded distribution. (An earlier argsort-of-f32-
    uniforms draw was *almost* uniform: ~2⁻²⁴ key collisions broke ties
    toward identity — r5 review finding.)"""
    m, n = pos_matrix.shape

    def one(key):
        perm_all = jax.random.permutation(key, n)
        order = jnp.argsort(perm_all >= n_real, stable=True)
        perm = jnp.take(perm_all, order)             # reals first, uniform
        p = jnp.take(pos_matrix, perm, axis=1)                   # (M, N)
        return p @ dist_bin @ p.T                                # 2 matmuls

    keys = jax.random.split(jax.random.PRNGKey(seed), bootstrap_num)
    return jax.lax.map(one, keys)                                # (B, M, M)


@jax.jit
def _observed(dist_bin: jax.Array, pos_matrix: jax.Array) -> jax.Array:
    return pos_matrix @ dist_bin @ pos_matrix.T


def calculate_enrichment(dist_mat, pos_matrix: np.ndarray, dist_lim: float,
                         bootstrap_num: int = 100, seed: int = 42):
    """Core enrichment computation for one FOV.

    Args:
        dist_mat: (N, N) distances (DataArray or ndarray).
        pos_matrix: (M, N) 0/1 indicator of marker/phenotype positivity.
        dist_lim: proximity threshold in pixels.
        bootstrap_num: number of label permutations for the null.
        seed: PRNG seed.

    Returns:
        dict with close_num (M, M), close_num_rand (B, M, M), z, muhat,
        sigmahat, p_pos, p_neg, p_adj.
    """
    vals = dist_mat.values if hasattr(dist_mat, "values") else np.asarray(dist_mat)
    m, n = pos_matrix.shape
    # Bucket ONLY the cell axis: N varies per FOV (the compile-churn axis),
    # while the marker/phenotype list is cohort-level, so M is constant
    # across a run and padding it would only inflate the dominant M·N²
    # einsum term (the r5 pow2-M bucket cost a measured ~1.3× on the
    # B=1000 null at M=20 — padded to 32 — for zero compile reuse).
    nb = _bucket(n)
    dist_host = np.zeros((nb, nb), np.float32)
    dist_host[:n, :n] = ((vals < dist_lim) & (vals > 0)).astype(np.float32)
    pos_host = np.zeros((m, nb), np.float32)
    pos_host[:, :n] = pos_matrix
    dist_bin = jnp.asarray(dist_host)
    pos = jnp.asarray(pos_host)

    close_num = np.asarray(_observed(dist_bin, pos))
    null = np.asarray(_permutation_null(
        dist_bin, pos, jnp.int32(n), seed, bootstrap_num))

    muhat = null.mean(axis=0)
    sigmahat = null.std(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(sigmahat > 0, (close_num - muhat) / sigmahat, 0.0)
    # permutation p-values with add-one smoothing
    p_pos = (np.sum(null >= close_num[None], axis=0) + 1) / (bootstrap_num + 1)
    p_neg = (np.sum(null <= close_num[None], axis=0) + 1) / (bootstrap_num + 1)
    p_two = np.minimum(np.minimum(p_pos, p_neg) * 2, 1.0)
    return {
        # int64: a dense 1024² FOV exceeds 65535 close pairs on the
        # diagonal at the default dist_lim (uint16 silently wrapped the
        # saved counts while z/muhat reflected the true values)
        "close_num": np.round(close_num).astype(np.int64),
        "close_num_rand": null,
        "muhat": muhat, "sigmahat": sigmahat, "z": z,
        "p_pos": p_pos, "p_neg": p_neg,
        "p_adj": benjamini_hochberg(p_two),
    }


def _build_pos_matrix(labels_list, dist_mat) -> np.ndarray:
    row_labels = np.asarray(dist_mat.coords["dim_0"])
    label_to_idx = {lab: i for i, lab in enumerate(row_labels)}
    pos = np.zeros((len(labels_list), len(row_labels)), np.float32)
    for j, labs in enumerate(labels_list):
        pos[j, [label_to_idx[v] for v in np.asarray(labs)]] = 1.0
    return pos


def calculate_cluster_spatial_enrichment(fov, all_data, dist_mat,
                                         included_cell_types: Optional[List] = None,
                                         dist_lim: float = 100,
                                         bootstrap_num: int = 100, seed: int = 42,
                                         fov_col=settings.FOV_ID,
                                         cell_label_col=settings.CELL_LABEL,
                                         cell_type_col=settings.CELL_TYPE):
    """Phenotype×phenotype spatial enrichment for one FOV.

    Returns (cluster_names, result dict from `calculate_enrichment`).
    """
    fov_data = all_data[all_data[fov_col] == fov]
    cluster_names = included_cell_types if included_cell_types is not None \
        else sorted(fov_data[cell_type_col].unique())
    present = set(fov_data[cell_type_col].unique())
    absent = [c for c in cluster_names if c not in present]
    if absent:
        # a cohort-wide phenotype list must work on FOVs missing some
        # types (comparable row ordering across FOVs is the whole point of
        # passing the list): warn and emit zero rows instead of dying
        import warnings
        warnings.warn(f"FOV {fov} has no cells of type(s) {absent}; their "
                      f"enrichment rows will be zero")
    labels_list = [
        spatial_analysis_utils.get_pos_cell_labels_cluster(
            pheno, fov_data, cell_label_col, cell_type_col).values
        for pheno in cluster_names]
    pos = _build_pos_matrix(labels_list, dist_mat)
    res = calculate_enrichment(dist_mat, pos, dist_lim,
                               bootstrap_num=bootstrap_num, seed=seed)
    return cluster_names, res


def calculate_channel_spatial_enrichment(fov, all_data, dist_mat, marker_titles,
                                         thresh_vec, dist_lim: float = 100,
                                         bootstrap_num: int = 100, seed: int = 42,
                                         fov_col=settings.FOV_ID,
                                         cell_label_col=settings.CELL_LABEL):
    """Marker×marker (threshold-positive) spatial enrichment for one FOV."""
    fov_data = all_data[all_data[fov_col] == fov]
    verify_in_list(marker_titles=list(marker_titles),
                   cell_table_columns=list(fov_data.columns))
    cell_labels = fov_data[cell_label_col]
    labels_list = [
        spatial_analysis_utils.get_pos_cell_labels_channel(
            thresh, fov_data[marker_titles], cell_labels, marker).values
        for marker, thresh in zip(marker_titles, thresh_vec)]
    pos = _build_pos_matrix(labels_list, dist_mat)
    res = calculate_enrichment(dist_mat, pos, dist_lim,
                               bootstrap_num=bootstrap_num, seed=seed)
    return list(marker_titles), res


def generate_enrichment_stats_table(names, result) -> pd.DataFrame:
    """Flatten an enrichment result into a tidy (pair, z, p) table."""
    rows = []
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            rows.append({"pheno1": a, "pheno2": b,
                         "close_num": int(result["close_num"][i, j]),
                         "z": float(result["z"][i, j]),
                         "muhat": float(result["muhat"][i, j]),
                         "sigmahat": float(result["sigmahat"][i, j]),
                         "p_pos": float(result["p_pos"][i, j]),
                         "p_neg": float(result["p_neg"][i, j]),
                         "p_adj": float(result["p_adj"][i, j])})
    return pd.DataFrame(rows)
