"""Pipeline template 1: segmentation + cell-table generation.

Equivalent of `templates/1_Segment_Image_Data.ipynb`: Mesmer runs
in-process on the accelerator instead of via the deepcell.org REST service; marker
quantification runs as device segment reductions. Run as a script or copy
cells into a notebook.

Usage:
    python templates/1_segment_image_data.py --base_dir /data/cohort \
        --nuc_channels CD45 --mem_channels CD14 CD45
"""

import argparse
import os

import pandas as pd

from ark_tpu.io import io_utils
from ark_tpu.segmentation import marker_quantification
from ark_tpu.utils import deepcell_service_utils


def main(base_dir, nuc_channels, mem_channels, img_sub_folder=None,
         fovs=None, nuclear_counts=False, fast_extraction=False,
         weights_path=None):
    tiff_dir = os.path.join(base_dir, "image_data")
    deepcell_input_dir = os.path.join(base_dir, "segmentation",
                                      "deepcell_input")
    deepcell_output_dir = os.path.join(base_dir, "segmentation",
                                       "deepcell_output")
    cell_table_dir = os.path.join(base_dir, "segmentation", "cell_table")
    for d in [deepcell_input_dir, deepcell_output_dir, cell_table_dir]:
        os.makedirs(d, exist_ok=True)

    if fovs is None:
        fovs = io_utils.list_folders(tiff_dir)

    # 1. build 2-channel (nuclear, membrane) inputs
    deepcell_service_utils.generate_deepcell_input(
        deepcell_input_dir, tiff_dir, nuc_channels, mem_channels, fovs,
        img_sub_folder=img_sub_folder)

    # 2. segment on device (whole-cell + nuclear masks); weights_path=None runs
    # the full Mesmer architecture (convert published weights via
    # models/convert_deepcell.py, or pass a trained checkpoint)
    deepcell_service_utils.create_deepcell_output(
        deepcell_input_dir, deepcell_output_dir, fovs=fovs,
        weights_path=weights_path)

    # 3. extract the cell table (size-normalized + arcsinh); per-FOV parts
    # checkpoint into cell_table/parts so a killed run resumes instead of
    # re-extracting the whole cohort
    cell_table_size_norm, cell_table_arcsinh = \
        marker_quantification.generate_cell_table(
            segmentation_dir=deepcell_output_dir, tiff_dir=tiff_dir,
            img_sub_folder=img_sub_folder, fovs=fovs,
            nuclear_counts=nuclear_counts, fast_extraction=fast_extraction,
            checkpoint_dir=os.path.join(cell_table_dir, "parts"))

    cell_table_size_norm.to_csv(
        os.path.join(cell_table_dir, "cell_table_size_normalized.csv"),
        index=False)
    cell_table_arcsinh.to_csv(
        os.path.join(cell_table_dir, "cell_table_arcsinh_transformed.csv"),
        index=False)
    print(f"cell table written for {len(fovs)} FOVs")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    p.add_argument("--nuc_channels", nargs="+", required=True)
    p.add_argument("--mem_channels", nargs="+", required=True)
    p.add_argument("--img_sub_folder", default=None)
    p.add_argument("--nuclear_counts", action="store_true")
    p.add_argument("--fast_extraction", action="store_true")
    a = p.parse_args()
    main(a.base_dir, a.nuc_channels, a.mem_channels, a.img_sub_folder,
         nuclear_counts=a.nuclear_counts, fast_extraction=a.fast_extraction)
