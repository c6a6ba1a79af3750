"""Pipeline template: pairwise spatial enrichment (rebuilds the reference's
`example_pairwise_spatial_enrichment.ipynb` workflow around the vmapped
device permutation-test kernel)."""

import argparse
import os

import pandas as pd

from ark_tpu.analysis import spatial_analysis_utils, spatial_enrichment


def main(base_dir, cell_table_path, dist_lim=100, bootstrap_num=100):
    dist_dir = os.path.join(base_dir, "spatial_analysis", "dist_mats")
    all_data = pd.read_csv(cell_table_path)
    # per-FOV resume: only missing <fov>_dist_mat.xr files are computed
    spatial_analysis_utils.ensure_dist_matrices(all_data, dist_dir)

    tables = []
    for fov in all_data["fov"].unique():
        dm = spatial_analysis_utils.load_dist_matrix(dist_dir, fov)
        names, res = spatial_enrichment.calculate_cluster_spatial_enrichment(
            fov, all_data, dm, dist_lim=dist_lim,
            bootstrap_num=bootstrap_num)
        table = spatial_enrichment.generate_enrichment_stats_table(names, res)
        table.insert(0, "fov", fov)
        tables.append(table)
    out = pd.concat(tables)
    out.to_csv(os.path.join(base_dir, "spatial_enrichment_stats.csv"),
               index=False)
    print(f"enrichment stats saved for {out['fov'].nunique()} FOVs")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--cell_table_path", required=True)
    p.add_argument("--dist_lim", type=int, default=100)
    p.add_argument("--bootstrap_num", type=int, default=100)
    a = p.parse_args()
    main(a.base_dir, a.cell_table_path, a.dist_lim, a.bootstrap_num)
