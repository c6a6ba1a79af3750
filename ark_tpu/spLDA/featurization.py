"""Neighborhood featurization for spatial-LDA.

Re-provides the `spatial_lda.featurization` surface the reference calls
(`spLDA/processing.py:115-135,177-188`): neighborhood_to_{cluster, marker,
avg_marker, count} reducers, `featurize_samples`, and
`make_merged_difference_matrices` (Delaunay adjacency reduced to an MST).

On device: each FOV's neighborhood statistic is one masked matmul —
indicator(dist ≤ r) · one-hot/marker matrix on device — instead of the
reference dependency's per-cell process pool."""

from __future__ import annotations

from typing import Callable, Dict

import jax.numpy as jnp
import numpy as np
import pandas as pd

from ark_tpu.ops import distances as dist_ops


def _neighbor_indicator(fov_df: pd.DataFrame, is_anchor_col: str,
                        radius: float, x_col="x", y_col="y"):
    """(anchors × cells) 0/1 indicator of distance ≤ radius (anchors incl.)."""
    coords = fov_df[[x_col, y_col]].values.astype(np.float32)
    anchors = fov_df[is_anchor_col].values.astype(bool)
    d = dist_ops.cdist(coords[anchors], coords)
    return (d <= radius).astype(np.float32), anchors


def neighborhood_to_cluster(fov_df, radius, is_anchor_col="is_index",
                            x_col="x", y_col="y", **kwargs) -> pd.DataFrame:
    """Counts of each cell cluster within `radius` of each anchor cell."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius,
                                       x_col, y_col)
    onehot = pd.get_dummies(fov_df["cluster"]).astype(np.float32)
    counts = np.asarray(jnp.asarray(ind) @ jnp.asarray(onehot.values))
    return pd.DataFrame(counts, columns=list(onehot.columns),
                        index=fov_df.index[anchors])


def neighborhood_to_marker(fov_df, radius, markers, is_anchor_col="is_index",
                           x_col="x", y_col="y", **kwargs) -> pd.DataFrame:
    """Counts of marker-positive (> 0.5) cells within `radius`."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius,
                                       x_col, y_col)
    pos = (fov_df[list(markers)].values > 0.5).astype(np.float32)
    counts = np.asarray(jnp.asarray(ind) @ jnp.asarray(pos))
    return pd.DataFrame(counts, columns=list(markers),
                        index=fov_df.index[anchors])


def neighborhood_to_avg_marker(fov_df, radius, markers,
                               is_anchor_col="is_index", x_col="x", y_col="y",
                               **kwargs) -> pd.DataFrame:
    """Average marker expression of cells within `radius`."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius,
                                       x_col, y_col)
    vals = fov_df[list(markers)].values.astype(np.float32)
    sums = np.asarray(jnp.asarray(ind) @ jnp.asarray(vals))
    n = ind.sum(axis=1, keepdims=True)
    return pd.DataFrame(sums / np.maximum(n, 1),
                        columns=list(markers), index=fov_df.index[anchors])


def neighborhood_to_count(fov_df, radius, is_anchor_col="is_index",
                          x_col="x", y_col="y", **kwargs) -> pd.DataFrame:
    """Total number of cells within `radius` of each anchor."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius,
                                       x_col, y_col)
    return pd.DataFrame({"count": ind.sum(axis=1)},
                        index=fov_df.index[anchors])


def featurize_samples(sample_dfs: Dict, neighborhood_feature_fn: Callable,
                      radius: float, is_anchor_col: str, x_col: str,
                      y_col: str, n_processes=None,
                      include_anchors: bool = True) -> pd.DataFrame:
    """Featurize every FOV; returns one frame with a (fov, cell) MultiIndex."""
    frames = []
    for fov, fov_df in sample_dfs.items():
        feats = neighborhood_feature_fn(fov_df, radius=radius,
                                        is_anchor_col=is_anchor_col,
                                        x_col=x_col, y_col=y_col)
        feats.index = pd.MultiIndex.from_product([[fov], feats.index])
        frames.append(feats)
    return pd.concat(frames).fillna(0)


def _mst_edges(coords: np.ndarray) -> np.ndarray:
    """(E, 2) edge list of the euclidean MST over Delaunay adjacency."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import Delaunay

    n = len(coords)
    if n < 2:
        return np.empty((0, 2), np.int64)
    if n == 2:
        return np.array([[0, 1]], np.int64)
    try:
        tri = Delaunay(coords)
        pairs = set()
        for simplex in tri.simplices:
            for i in range(3):
                a, b = int(simplex[i]), int(simplex[(i + 1) % 3])
                pairs.add((min(a, b), max(a, b)))
        pairs = np.array(sorted(pairs), np.int64)
    except Exception:
        # degenerate geometry: fall back to the complete graph
        ii, jj = np.triu_indices(n, k=1)
        pairs = np.stack([ii, jj], axis=1)
    weights = np.linalg.norm(coords[pairs[:, 0]] - coords[pairs[:, 1]],
                             axis=1)
    graph = coo_matrix((weights, (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    mst = minimum_spanning_tree(graph).tocoo()
    return np.stack([mst.row, mst.col], axis=1).astype(np.int64)


def make_merged_difference_matrices(sample_features: pd.DataFrame,
                                    sample_dfs: Dict, x_col="x", y_col="y",
                                    reduce_to_mst: bool = True) -> Dict:
    """Per-FOV difference matrices over the featurized cells: each row has
    +1/−1 at the endpoints of one spatial-adjacency (MST) edge."""
    out = {}
    for fov in sample_features.index.get_level_values(0).unique():
        cell_idx = sample_features.loc[fov].index
        fov_df = sample_dfs[fov].loc[cell_idx]
        coords = fov_df[[x_col, y_col]].values.astype(np.float64)
        edges = _mst_edges(coords)
        n = len(coords)
        diff = np.zeros((len(edges), n), np.float32)
        for e, (a, b) in enumerate(edges):
            diff[e, a] = 1.0
            diff[e, b] = -1.0
        out[fov] = diff
    return out
