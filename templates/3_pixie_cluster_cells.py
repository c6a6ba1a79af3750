"""Pipeline template 3: Pixie cell clustering (equivalent of
`templates/3_Pixie_Cluster_Cells.ipynb`): per-cell pixel-cluster counts →
cell SOM → consensus meta clusters → weighted channel expression.
`main` returns the per-cell table with its SOM and meta cluster labels."""

import argparse
import os

from ark_tpu.io import feather_utils as feather
from ark_tpu.io import io_utils
from ark_tpu.phenotyping import (cell_cluster_utils, cell_meta_clustering,
                                 cell_som_clustering, weighted_channel_comp)
import pandas as pd


def main(base_dir, channels, cell_table_path, fovs=None,
         pixel_cluster_col="pixel_meta_cluster_rename", max_k=20, seed=42):
    pixel_data_dir = os.path.join(base_dir, "pixel_mat_data")
    if fovs is None:
        fovs = io_utils.remove_file_extensions(
            io_utils.list_files(pixel_data_dir, substrs=".feather"))

    # the default column only exists after the interactive GUI remap of
    # template 2; in a headless chain fall back to the columns the
    # scripted flow actually produced instead of crashing with a KeyError
    sample = feather.read_dataframe(
        os.path.join(pixel_data_dir, fovs[0] + ".feather"))
    if pixel_cluster_col not in sample.columns:
        # c2pc accepts only the som or renamed-meta resolutions
        # (reference cell_cluster_utils contract)
        if "pixel_som_cluster" in sample.columns:
            print(f"'{pixel_cluster_col}' not found in the pixel data "
                  f"(interactive remap not applied); using "
                  f"'pixel_som_cluster'")
            pixel_cluster_col = "pixel_som_cluster"
        else:
            raise ValueError(
                f"pixel data has no cluster columns; run template 2 first "
                f"(columns: {list(sample.columns)})")

    # 1. cells × pixel-cluster counts (2-D bincount per FOV)
    cluster_counts, cluster_counts_norm = cell_cluster_utils.create_c2pc_data(
        fovs, pixel_data_dir, cell_table_path,
        pixel_cluster_col=pixel_cluster_col)
    count_cols = [c for c in cluster_counts_norm.columns
                  if c.startswith(pixel_cluster_col)]

    # 2. cell SOM + assignment
    cell_pysom = cell_som_clustering.train_cell_som(
        fovs, base_dir, cell_table_path, count_cols,
        cluster_counts_norm.copy(), seed=seed)
    cell_som_input_data = cell_som_clustering.cluster_cells(
        base_dir, cell_pysom, count_cols)
    cell_som_clustering.generate_som_avg_files(
        base_dir, cell_som_input_data, count_cols,
        "cell_som_cluster_count_avg.csv")

    # 3. consensus meta clustering
    cell_cc, cell_som_input_data = cell_meta_clustering.cell_consensus_cluster(
        base_dir, count_cols, cell_som_input_data,
        "cell_som_cluster_count_avg.csv", max_k=max_k, seed=seed)
    cell_meta_clustering.generate_meta_avg_files(
        base_dir, cell_cc, count_cols, cell_som_input_data,
        "cell_som_cluster_count_avg.csv", "cell_meta_cluster_count_avg.csv")

    # 4. weighted channel expression (cells×clusters · clusters×channels);
    # the avg table must be keyed by the SAME cluster resolution
    avg_name = ("pixel_channel_avg_som_cluster.csv"
                if pixel_cluster_col == "pixel_som_cluster"
                else "pixel_channel_avg_meta_cluster.csv")
    pixel_channel_avg = pd.read_csv(os.path.join(base_dir, avg_name))
    weighted = weighted_channel_comp.compute_p2c_weighted_channel_avg(
        pixel_channel_avg, channels, cluster_counts, fovs=fovs,
        pixel_cluster_col=pixel_cluster_col)
    feather.write_dataframe(weighted, os.path.join(
        base_dir, "weighted_cell_channel.feather"))
    weighted_channel_comp.generate_wc_avg_files(
        fovs, channels, base_dir, cell_cc, cell_som_input_data)

    # 5. [interactive] remap via MetaClusterGui, then:
    # cell_meta_clustering.apply_cell_meta_cluster_remapping(...)
    # cell_cluster_utils.add_consensus_labels_cell_table(
    #     base_dir, cell_table_path, cell_som_input_data)
    print("cell clustering complete")
    return cell_som_input_data


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--channels", nargs="+", required=True)
    p.add_argument("--cell_table_path", required=True)
    p.add_argument("--pixel_cluster_col",
                   default="pixel_meta_cluster_rename",
                   choices=["pixel_meta_cluster_rename",
                            "pixel_som_cluster"])
    a = p.parse_args()
    main(a.base_dir, a.channels, a.cell_table_path,
         pixel_cluster_col=a.pixel_cluster_col)
