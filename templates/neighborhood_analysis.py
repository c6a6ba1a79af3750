"""Pipeline template: neighborhood analysis (equivalent of
`templates/example_neighborhood_analysis_script.ipynb`): distance matrices →
neighbor counts → k-means neighborhoods → cluster summaries."""

import argparse
import os

import pandas as pd

from ark_tpu.analysis import neighborhood_analysis, spatial_analysis_utils


def main(base_dir, cell_table_path, distlim=50, cluster_num=6):
    dist_dir = os.path.join(base_dir, "spatial_analysis", "dist_mats")
    os.makedirs(dist_dir, exist_ok=True)
    all_data = pd.read_csv(cell_table_path)

    # 1. per-FOV distance matrices (device cdist)
    spatial_analysis_utils.calc_dist_matrix(all_data, dist_dir)

    # 2. neighbor counts/freqs (one-hot x binarized-distance matmuls)
    counts, freqs = neighborhood_analysis.create_neighborhood_matrix(
        all_data, dist_dir, distlim=distlim)
    counts.to_csv(os.path.join(base_dir, "neighborhood_counts.csv"),
                  index=False)
    freqs.to_csv(os.path.join(base_dir, "neighborhood_freqs.csv"),
                 index=False)

    # 3. k sweep (device k-means) + final clustering
    inertia = neighborhood_analysis.compute_cluster_metrics_inertia(counts)
    print("inertia sweep:", dict(zip(inertia.coords["cluster_num"],
                                     inertia.values)))
    all_data_clusters, counts_per_cluster, mean_expr = \
        neighborhood_analysis.generate_cluster_matrix_results(
            all_data, counts, cluster_num=cluster_num)
    all_data_clusters.to_csv(
        os.path.join(base_dir, "cell_table_neighborhoods.csv"), index=False)
    print("neighborhood analysis complete")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--cell_table_path", required=True)
    p.add_argument("--distlim", type=int, default=50)
    p.add_argument("--cluster_num", type=int, default=6)
    a = p.parse_args()
    main(a.base_dir, a.cell_table_path, a.distlim, a.cluster_num)
