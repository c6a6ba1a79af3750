"""Pipeline template 2: Pixie pixel clustering.

Equivalent of `templates/2_Pixie_Cluster_Pixels.ipynb`: preprocessing is
one fused jitted program per FOV; SOM training and BMU assignment run on
the device.

Usage:
    python templates/2_pixie_cluster_pixels.py --base_dir /data/cohort \
        --channels CD3 CD4 CD8 CD14 CD20 CD31 CD45 CD68 ECAD
"""

import argparse
import os

from ark_tpu.io import io_utils
from ark_tpu.phenotyping import (pixel_meta_clustering, pixel_som_clustering,
                                 pixie_fused, pixie_preprocessing)


def main(base_dir, channels, fovs=None, img_sub_folder=None,
         seg_dir=None, seg_suffix="_whole_cell.tiff", max_k=20,
         blur_factor=2, subset_proportion=0.1, seed=42, fused=True):
    tiff_dir = os.path.join(base_dir, "image_data")
    pixel_output_dir = "pixel_output_dir"
    os.makedirs(os.path.join(base_dir, pixel_output_dir), exist_ok=True)
    if fovs is None:
        fovs = io_utils.list_folders(tiff_dir)

    if fused:
        # single-sweep stage-boundary pipeline: identical artifacts to the
        # multi-pass steps below, one TIFF load + one full-feather write
        # per FOV (SURVEY.md §7; parity pinned in
        # tests/phenotyping/test_pixie_fused.py)
        pixie_fused.run_pixel_clustering(
            fovs, channels, base_dir, tiff_dir, seg_dir=seg_dir,
            img_sub_folder=img_sub_folder, seg_suffix=seg_suffix,
            pixel_output_dir=pixel_output_dir, blur_factor=blur_factor,
            subset_proportion=subset_proportion, seed=seed, max_k=max_k)
        print("pixel clustering complete")
        return

    # multi-pass path (reference-shaped steps; resumes interchangeably
    # with the fused driver's artifacts)
    # 1. preprocess: blur -> threshold -> rownorm -> subset
    pixie_preprocessing.create_pixel_matrix(
        fovs, channels, base_dir, tiff_dir, seg_dir,
        img_sub_folder=img_sub_folder, seg_suffix=seg_suffix,
        pixel_output_dir=pixel_output_dir, blur_factor=blur_factor,
        subset_proportion=subset_proportion, seed=seed)

    # 2. train SOM + assign clusters (device BMU search)
    pixel_pysom = pixel_som_clustering.train_pixel_som(
        fovs, channels, base_dir,
        norm_vals_name="channel_norm_post_rownorm.feather", seed=seed)
    pixel_som_clustering.cluster_pixels(fovs, base_dir, pixel_pysom)
    pixel_som_clustering.generate_som_avg_files(
        fovs, channels, base_dir, pixel_pysom, data_dir="pixel_mat_data")

    # 3. consensus (meta) clustering
    pixel_cc = pixel_meta_clustering.pixel_consensus_cluster(
        fovs, channels, base_dir, max_k=max_k, seed=seed)
    pixel_meta_clustering.generate_meta_avg_files(
        fovs, channels, base_dir, pixel_cc, data_dir="pixel_mat_data")

    # 4. [interactive] remap via the metacluster GUI, then apply:
    # from ark_tpu.utils.metacluster_remap_gui import (
    #     MetaClusterGui, metaclusterdata_from_files)
    # mcd = metaclusterdata_from_files(
    #     os.path.join(base_dir, "pixel_channel_avg_som_cluster.csv"))
    # mcd.output_mapping_filename = os.path.join(base_dir, "pixel_remap.csv")
    # MetaClusterGui(mcd)   # interact, then:
    # pixel_meta_clustering.apply_pixel_meta_cluster_remapping(
    #     fovs, channels, base_dir, "pixel_mat_data", "pixel_remap.csv")
    # pixel_meta_clustering.generate_remap_avg_files(
    #     fovs, channels, base_dir, "pixel_mat_data", "pixel_remap.csv",
    #     "pixel_channel_avg_som_cluster.csv",
    #     "pixel_channel_avg_meta_cluster.csv")
    # (the remap avg step adds the pixel_meta_cluster_rename column the
    #  cell-clustering template's default pixel_cluster_col needs)
    print("pixel clustering complete")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--channels", nargs="+", required=True)
    p.add_argument("--seg_dir", default=None)
    p.add_argument("--max_k", type=int, default=20)
    p.add_argument("--multipass", action="store_true",
                   help="run the reference-shaped multi-pass steps instead "
                        "of the fused single-sweep driver")
    a = p.parse_args()
    main(a.base_dir, a.channels, seg_dir=a.seg_dir, max_k=a.max_k,
         fused=not a.multipass)
