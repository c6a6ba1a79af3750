#!/usr/bin/env python
"""Generate the Jupyter notebook forms of the pipeline templates.

The reference is notebook-driven (17 `.ipynb` in `templates/`;
`README.md:71-110`). Each notebook here mirrors the corresponding
`templates/*.py` script (the CI-tested form) with the reference's narrative
style: a title, parameter-doc markdown, then one code cell per pipeline
stage. Regenerate after editing templates:

    python scripts/make_notebooks.py
"""

import json
import os

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "templates")

META = {
    "kernelspec": {"display_name": "Python 3", "language": "python",
                   "name": "python3"},
    "language_info": {"name": "python", "version": "3.12"},
}


def md(text):
    return {"cell_type": "markdown", "metadata": {},
            "source": text.splitlines(keepends=True)}


def code(text):
    return {"cell_type": "code", "execution_count": None, "metadata": {},
            "outputs": [], "source": text.strip("\n").splitlines(keepends=True)}


PATHS_MD = """### Path setup
* `base_dir`: the main folder containing your imaging data; analysis outputs land here too
* `cell_table_path`: cell table CSV from
  [segmentation](1_Segment_Image_Data.ipynb) /
  [Pixie](3_Pixie_Cluster_Cells.ipynb)
"""

NOTEBOOKS = {}

NOTEBOOKS["4_Post_Clustering.ipynb"] = [
    md("# 4. Post clustering\n\nTPU-native equivalent of the reference's "
       "`4_Post_Clustering.ipynb`: marker-threshold QC histograms, cohort "
       "cluster masks/plots, and a full Mantis Viewer project."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.phenotyping import post_cluster_utils\n"
         "from ark_tpu.utils import plot_utils"),
    md(PATHS_MD),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "seg_dir = os.path.join(base_dir, 'segmentation/deepcell_output')\n"
         "cell_table = pd.read_csv(cell_table_path)\n"
         "fovs = sorted(cell_table['fov'].unique())"),
    md("## Marker threshold QC\n* `marker`: channel whose per-population "
       "distribution to inspect\n* `populations`: cell populations to "
       "compare\n* `threshold`: optional vertical line to evaluate a "
       "positivity cutoff"),
    code("post_cluster_utils.plot_hist_thresholds(\n"
         "    cell_table, populations=['Cancer', 'Immune'], marker='Ecad',\n"
         "    threshold=0.002)"),
    md("## Cohort cluster masks + plots"),
    code("plot_utils.cohort_cluster_plot(\n"
         "    fovs=fovs, seg_dir=seg_dir,\n"
         "    save_dir=os.path.join(base_dir, 'post_clustering'),\n"
         "    cell_data=cell_table, cmap='tab20')"),
    md("## Mantis Viewer project"),
    code("post_cluster_utils.create_mantis_project(\n"
         "    cell_table=cell_table, fovs=fovs, seg_dir=seg_dir,\n"
         "    mask_dir=os.path.join(base_dir, 'post_clustering', 'masks'),\n"
         "    image_dir=os.path.join(base_dir, 'image_data'),\n"
         "    mantis_dir=os.path.join(base_dir, 'mantis'))"),
]

NOTEBOOKS["Calculate_Mixing_Scores.ipynb"] = [
    md("# Calculate mixing scores\n\nTPU-native equivalent of "
       "`Calculate_Mixing_Scores.ipynb`: cell-cell distance matrices, "
       "neighbor counts, target/reference cell ratios, and percent / "
       "homogeneous mixing scores."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.analysis import neighborhood_analysis, "
         "spatial_analysis_utils"),
    md(PATHS_MD + "* `target_cells` / `reference_cells`: the two "
       "populations whose mixing to score\n* `mixing_type`: 'percent' or "
       "'homogeneous'\n* `ratio_threshold`, `cell_count_thresh`: cold-image "
       "guards (NaN score below them)"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "target_cells = ['Cancer']\nreference_cells = ['Immune']\n"
         "distlim = 50\nmixing_type = 'percent'\n"
         "all_data = pd.read_csv(cell_table_path)"),
    md("## Distance matrices + neighbor counts"),
    code("dist_dir = os.path.join(base_dir, 'spatial_analysis', 'dist_mats')\n"
         "os.makedirs(dist_dir, exist_ok=True)\n"
         "spatial_analysis_utils.calc_dist_matrix(all_data, dist_dir)\n"
         "counts, _ = neighborhood_analysis.create_neighborhood_matrix(\n"
         "    all_data, dist_dir, distlim=distlim)"),
    md("## Cell ratios + mixing scores per FOV"),
    code("fovs = sorted(counts['fov'].unique())\n"
         "ratios = neighborhood_analysis.compute_cell_ratios(\n"
         "    counts, target_cells, reference_cells, fovs)\n"
         "scores = []\n"
         "for fov in fovs:\n"
         "    fov_counts = counts[counts['fov'] == fov]\n"
         "    score, total = neighborhood_analysis.compute_mixing_score(\n"
         "        fov_counts.copy(), target_cells, reference_cells, "
         "mixing_type)\n"
         "    scores.append({'fov': fov, 'mixing_score': score,\n"
         "                   'population_size': total})\n"
         "out = pd.DataFrame(scores).merge(ratios, on='fov')\n"
         "out.to_csv(os.path.join(base_dir, 'mixing_scores.csv'), "
         "index=False)\nout"),
]

NOTEBOOKS["Generalized_Masking.ipynb"] = [
    md("# Generalized masking\n\nTPU-native equivalent of "
       "`Generalized_Masking.ipynb`: composite-signal masks and cell-type "
       "masks from segmentations + phenotypes."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu import settings\n"
         "from ark_tpu.utils import masking_utils"),
    md(PATHS_MD + "* `img_dir`: single-channel TIFF tree\n"
       "* `seg_dir`: segmentations from "
       "[Mesmer segmentation](1_Segment_Image_Data.ipynb)\n"
       "* `mask_dir`: output directory for masks"),
    code("base_dir = '../data/example_dataset'\n"
         "img_dir = os.path.join(base_dir, 'image_data')\n"
         "seg_dir = os.path.join(base_dir, 'segmentation/deepcell_output')\n"
         "mask_dir = os.path.join(base_dir, 'mask_dir')\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')"),
    md("## Signal masking\n* `channels`: one or more channels (composited "
       "when several)\n* `sigma`: Gaussian blur\n* `min_object_area` / "
       "`max_hole_area`: object/hole size guards (pixels)"),
    code("channels = ['Au']\nmask_name = 'gold_mask'\n"
         "sigma = 10\nmin_object_area = 3500\nmax_hole_area = 1000\n\n"
         "masking_utils.generate_signal_masks(\n"
         "    img_dir, mask_dir, channels, mask_name,\n"
         "    intensity_thresh_perc='auto', sigma=sigma,\n"
         "    min_object_area=min_object_area, "
         "max_hole_area=max_hole_area)"),
    md("## Cell masking\n* `cell_types`: phenotypes to combine into one "
       "mask\n* `cluster_col`: cell-table phenotype column"),
    code("cell_types = ['Cancer']\ncluster_col = settings.CELL_TYPE\n"
         "mask_name = 'cancer_mask'\nsigma = 10\nmax_hole_area = 1000\n\n"
         "cell_table = pd.read_csv(cell_table_path)\n"
         "masking_utils.generate_cell_masks(\n"
         "    seg_dir, mask_dir, cell_table, cell_types, mask_name,\n"
         "    cluster_col, sigma=sigma, max_hole_area=max_hole_area)"),
]

NOTEBOOKS["Image_Stitching.ipynb"] = [
    md("# Image stitching\n\nTPU-native equivalent of "
       "`Image_Stitching.ipynb`: stitch RnCm-named tiled FOVs into one "
       "image per channel."),
    code("import os\n\nfrom ark_tpu.utils import data_utils"),
    md(PATHS_MD + "* tiled FOVs must follow the `<prefix>_R<n>C<m>` naming "
       "convention\n* `channels`: optional channel subset (None = all)"),
    code("base_dir = '../data/example_dataset'\n"
         "data_dir = os.path.join(base_dir, 'image_data')\n"
         "stitched_dir = os.path.join(base_dir, 'stitched_images')\n"
         "channels = None"),
    md("## Stitch"),
    code("data_utils.stitch_images_by_shape(\n"
         "    data_dir, stitched_dir, img_sub_folder=None, "
         "channels=channels)"),
]

NOTEBOOKS["LDA_Preprocessing.ipynb"] = [
    md("# Spatial-LDA: preprocessing\n\nTPU-native equivalent of "
       "`LDA_Preprocessing.ipynb`: format the cell table, featurize "
       "neighborhoods, and explore the topic count (elbow/silhouette/"
       "gap-stat EDA)."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.spLDA import processing as pros\n"
         "from ark_tpu.utils import spatial_lda_utils"),
    md(PATHS_MD + "* `clusters`: phenotypes to keep (None = all)\n"
       "* `radius`: neighborhood radius in pixels for featurization"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "clusters = None\nradius = 100\n"
         "cell_table = pd.read_csv(cell_table_path)\n"
         "if clusters is None:\n"
         "    clusters = sorted(cell_table['cell_meta_cluster'].unique())"),
    md("## Format + featurize"),
    code("cell_table_format = pros.format_cell_table(cell_table, "
         "clusters=clusters)\n"
         "features = pros.featurize_cell_table(\n"
         "    cell_table_format, featurization='cluster', radius=radius)"),
    md("## Topic-count EDA\n* `topics`: candidate topic counts\n"
       "* `num_boots`: gap-stat bootstrap count (>= 25)"),
    code("from ark_tpu.analysis import visualize\n\n"
         "eda = pros.compute_topic_eda(features['train_features'], "
         "'cluster',\n                             topics=list(range(3, 8)), "
         "num_boots=25)\n"
         "visualize.visualize_topic_eda(eda, metric='inertia')\n"
         "visualize.visualize_topic_eda(eda, metric='gap_stat')"),
    md("## Save the featurized tables for the training notebook"),
    code("out_dir = os.path.join(base_dir, 'spatial_analysis', "
         "'spatial_lda')\nos.makedirs(out_dir, exist_ok=True)\n"
         "spatial_lda_utils.save_spatial_lda_file(\n"
         "    features, out_dir, 'featurized_cell_table', format='pkl')\n"
         "spatial_lda_utils.save_spatial_lda_file(\n"
         "    cell_table_format, out_dir, 'formatted_cell_table', "
         "format='pkl')"),
]

NOTEBOOKS["LDA_Training_and_Inference.ipynb"] = [
    md("# Spatial-LDA: training and inference\n\nTPU-native equivalent of "
       "`LDA_Training_and_Inference.ipynb`: difference matrices, the JAX "
       "LDA optimizer (replacing the `spatial_lda` ADMM package), topic "
       "inference, and result plots."),
    code("import os\n\nfrom ark_tpu.spLDA import model as lda_model\n"
         "from ark_tpu.spLDA import processing as pros\n"
         "from ark_tpu.utils import spatial_lda_utils"),
    md(PATHS_MD + "* `n_topics`: chosen from the "
       "[preprocessing notebook](LDA_Preprocessing.ipynb) EDA\n"
       "* `difference_penalty`: spatial smoothness strength"),
    code("base_dir = '../data/example_dataset'\n"
         "lda_dir = os.path.join(base_dir, 'spatial_analysis', "
         "'spatial_lda')\nn_topics = 5\ndifference_penalty = 0.25\n"
         "features = spatial_lda_utils.read_spatial_lda_file(\n"
         "    lda_dir, 'featurized_cell_table', format='pkl')\n"
         "cell_table_format = spatial_lda_utils.read_spatial_lda_file(\n"
         "    lda_dir, 'formatted_cell_table', format='pkl')"),
    md("## Difference matrices (MST-reduced adjacency per FOV)"),
    code("diff_mats = pros.create_difference_matrices(cell_table_format, "
         "features)"),
    md("## Train + infer"),
    code("model = lda_model.train(\n"
         "    features['train_features'],\n"
         "    difference_matrices=diff_mats['train_diff_mat'],\n"
         "    n_topics=n_topics, "
         "difference_penalty=difference_penalty)\n"
         "inferred = lda_model.infer(\n"
         "    model, features['featurized_fovs'],\n"
         "    difference_matrices=diff_mats['inference_diff_mat'])"),
    md("## Save + visualize\n* topic heatmap over features; per-FOV cell "
       "scatters colored by dominant topic"),
    code("import matplotlib.pyplot as plt\n\n"
         "spatial_lda_utils.save_spatial_lda_file(model, lda_dir, "
         "'lda_model', format='pkl')\n"
         "inferred.to_csv(os.path.join(lda_dir, 'topic_weights.csv'))\n"
         "spatial_lda_utils.plot_topics_heatmap(\n"
         "    model.components_, features['train_features'].columns)\n"
         "fov_idx = list(cell_table_format.keys())[0]\n"
         "fig, ax = plt.subplots()\n"
         "spatial_lda_utils.plot_fovs_with_topics(ax, fov_idx, inferred,\n"
         "                                        cell_table_format)"),
]

NOTEBOOKS["OME-TIFF_Conversion.ipynb"] = [
    md("# OME-TIFF conversion\n\nTPU-native equivalent of "
       "`OME-TIFF_Conversion.ipynb`: bundle per-channel FOV trees into "
       "OME-TIFFs, or unpack OME-TIFFs back into channel trees."),
    code("import os\n\nfrom ark_tpu.io import io_utils, ome_utils"),
    md(PATHS_MD + "* `direction`: 'fov_to_ome' or 'ome_to_fov'"),
    code("base_dir = '../data/example_dataset'\n"
         "image_dir = os.path.join(base_dir, 'image_data')\n"
         "ome_dir = os.path.join(base_dir, 'ome_tiff')"),
    md("## FOV tree → OME-TIFF"),
    code("os.makedirs(ome_dir, exist_ok=True)\n"
         "for fov in io_utils.list_folders(image_dir):\n"
         "    ome_utils.fov_to_ome(os.path.join(image_dir, fov), ome_dir)"),
    md("## OME-TIFF → FOV tree"),
    code("for f in io_utils.list_files(ome_dir, substrs='.ome.tif'):\n"
         "    if f.endswith(('.ome.tif', '.ome.tiff')):\n"
         "        ome_utils.ome_to_fov(os.path.join(ome_dir, f), "
         "image_dir)"),
]

NOTEBOOKS["anndata_conversion.ipynb"] = [
    md("# AnnData conversion\n\nTPU-native equivalent of "
       "`anndata_conversion.ipynb`: convert the cohort cell table into "
       "per-FOV AnnData `.h5ad` stores (X=markers, obs=properties, "
       "obsm['spatial']=centroids) for third-party single-cell tooling."),
    code("import os\n\nfrom ark_tpu.utils import data_utils"),
    md(PATHS_MD + "* `markers`: 'auto' slices the marker block from the "
       "cell-table schema; or pass an explicit list"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "markers = 'auto'"),
    md("## Convert"),
    code("conv = data_utils.ConvertToAnnData(cell_table_path, "
         "markers=markers)\n"
         "paths = conv.convert_to_adata(os.path.join(base_dir, 'adata'))\n"
         "paths"),
    md("## Load back (lazy collection over all FOVs)"),
    code("adatas = data_utils.load_anndatas(os.path.join(base_dir, "
         "'adata'))\n{f: a.n_obs for f, a in adatas.items()}"),
]

NOTEBOOKS["cell_neighbors_analysis.ipynb"] = [
    md("# Cell neighbors analysis\n\nTPU-native equivalent of "
       "`cell_neighbors_analysis.ipynb`: neighborhood diversity (Shannon) "
       "and mean distance to the k nearest cells of each phenotype."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.analysis import (cell_neighborhood_stats,\n"
         "                              neighborhood_analysis,\n"
         "                              spatial_analysis_utils)"),
    md(PATHS_MD + "* `pixel_radius`: neighborhood radius\n"
       "* `k`: nearest-cell count for distance stats"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "pixel_radius = 50\nk = 5\n"
         "all_data = pd.read_csv(cell_table_path)\n"
         "dist_dir = os.path.join(base_dir, 'spatial_analysis', "
         "'dist_mats')\n"
         "neighbors_dir = os.path.join(base_dir, 'spatial_analysis',\n"
         "                             'neighborhood_mats')\n"
         "os.makedirs(neighbors_dir, exist_ok=True)\n"
         "if not os.path.exists(dist_dir):\n"
         "    os.makedirs(dist_dir, exist_ok=True)\n"
         "    spatial_analysis_utils.calc_dist_matrix(all_data, dist_dir)"),
    md("## Neighborhood diversity"),
    code("counts, freqs = "
         "neighborhood_analysis.create_neighborhood_matrix(\n"
         "    all_data, dist_dir, distlim=pixel_radius)\n"
         "freqs_path = os.path.join(\n"
         "    neighbors_dir,\n"
         "    f'neighborhood_freqs-cell_meta_cluster_radius"
         "{pixel_radius}.csv')\n"
         "freqs.to_csv(freqs_path, index=False)\n"
         "diversity = "
         "cell_neighborhood_stats.generate_neighborhood_diversity_analysis(\n"
         "    neighbors_dir, pixel_radius, ['cell_meta_cluster'])\n"
         "diversity.to_csv(os.path.join(base_dir, "
         "'neighborhood_diversity.csv'),\n                 index=False)"),
    md("## Mean distance to the k nearest cells of each phenotype"),
    code("distances = "
         "cell_neighborhood_stats.generate_cell_distance_analysis(\n"
         "    all_data, dist_dir,\n"
         "    os.path.join(base_dir, 'cell_distances.csv'), k=k)\n"
         "distances.head()"),
]

NOTEBOOKS["example_neighborhood_analysis_script.ipynb"] = [
    md("# Neighborhood analysis\n\nTPU-native equivalent of "
       "`example_neighborhood_analysis_script.ipynb`: distance matrices, "
       "neighbor counts/frequencies, k-means over neighborhoods with "
       "elbow/silhouette sweeps, and cluster pivots."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.analysis import neighborhood_analysis, "
         "spatial_analysis_utils\nfrom ark_tpu.analysis import visualize"),
    md(PATHS_MD + "* `distlim`: neighbor radius in pixels\n"
       "* `cluster_num`: final neighborhood k-means k"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "distlim = 50\ncluster_num = 6\n"
         "all_data = pd.read_csv(cell_table_path)"),
    md("## Distance matrices + neighbor matrix"),
    code("dist_dir = os.path.join(base_dir, 'spatial_analysis', "
         "'dist_mats')\nos.makedirs(dist_dir, exist_ok=True)\n"
         "spatial_analysis_utils.calc_dist_matrix(all_data, dist_dir)\n"
         "counts, freqs = "
         "neighborhood_analysis.create_neighborhood_matrix(\n"
         "    all_data, dist_dir, distlim=distlim)"),
    md("## Choose k: inertia + silhouette sweeps"),
    code("inertia = neighborhood_analysis.compute_cluster_metrics_inertia("
         "counts)\n"
         "silhouette = "
         "neighborhood_analysis.compute_cluster_metrics_silhouette("
         "counts)\n"
         "visualize.visualize_neighbor_cluster_metrics(inertia, "
         "metric_name='inertia')"),
    md("## Final clustering + pivots"),
    code("all_data_clustered, num_cluster_stats, num_marker_stats = \\\n"
         "    neighborhood_analysis.generate_cluster_matrix_results(\n"
         "        all_data, counts, cluster_num=cluster_num)\n"
         "all_data_clustered.to_csv(\n"
         "    os.path.join(base_dir, 'cell_table_neighborhoods.csv'), "
         "index=False)"),
]

NOTEBOOKS["example_visualization.ipynb"] = [
    md("# Visualization\n\nTPU-native equivalent of "
       "`example_visualization.ipynb`: population distributions, boxplots, "
       "and UMAP/PCA/tSNE scatters (JAX UMAP)."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.analysis import dimensionality_reduction, "
         "visualize"),
    md(PATHS_MD + "* `markers`: channels to embed\n* `patient_col` / "
       "`population_col`: grouping columns"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "markers = ['CD3', 'CD4', 'CD8', 'CD14']\n"
         "patient_col = 'PatientID'\npopulation_col = 'cell_meta_cluster'\n"
         "save_dir = os.path.join(base_dir, 'viz')\n"
         "os.makedirs(save_dir, exist_ok=True)\n"
         "cell_data = pd.read_csv(cell_table_path)"),
    md("## Population distributions + boxplot"),
    code("visualize.visualize_patient_population_distribution(\n"
         "    cell_data, patient_col, population_col, save_dir=save_dir)\n"
         "visualize.draw_boxplot(cell_data, markers[0], "
         "col_split=population_col,\n"
         "                       save_dir=save_dir, "
         "save_file='boxplot.png')"),
    md("## Dimensionality reduction (UMAP on device)"),
    code("dimensionality_reduction.visualize_dimensionality_reduction(\n"
         "    cell_data, markers, population_col, algorithm='UMAP',\n"
         "    save_dir=save_dir)"),
]

NOTEBOOKS["ez_segmenter.ipynb"] = [
    md("# ez segmenter\n\nTPU-native equivalent of `ez_segmenter.ipynb`: "
       "composite channels, segment non-cell objects (plaques, fibers, "
       "projections), merge with cell masks, renumber cohort-wide, and "
       "quantify over the merged masks."),
    code("import os\n\nfrom ark_tpu.io import io_utils\n"
         "from ark_tpu.segmentation import marker_quantification\n"
         "from ark_tpu.segmentation.ez_seg import (composites,\n"
         "    ez_object_segmentation, ez_seg_utils, merge_masks)"),
    md(PATHS_MD + "* `channel_to_segment`: channel (or composite) to "
       "object-segment\n* `composite_channels`: channels summed into a "
       "composite first (optional)"),
    code("base_dir = '../data/example_dataset'\n"
         "image_dir = os.path.join(base_dir, 'image_data')\n"
         "masks_dir = os.path.join(base_dir, 'ez_masks')\n"
         "merged_dir = os.path.join(base_dir, 'merged_masks')\n"
         "log_dir = os.path.join(base_dir, 'ez_logs')\n"
         "cell_mask_dir = os.path.join(base_dir, "
         "'segmentation/deepcell_output')\n"
         "for d in [masks_dir, merged_dir, log_dir]:\n"
         "    os.makedirs(d, exist_ok=True)\n"
         "fovs = io_utils.list_folders(image_dir)\n"
         "channel_to_segment = 'Amyloid'\nmask_name = 'plaques'"),
    md("## (Optional) composite builder"),
    code("composite_channels = []  # e.g. ['Abeta40', 'Abeta42']\n"
         "if composite_channels:\n"
         "    composites.composite_builder(\n"
         "        image_dir, None, fovs, composite_channels, [], 'signal',\n"
         "        'total', composite_directory=image_dir,\n"
         "        composite_name='composite', log_dir=log_dir)\n"
         "    channel_to_segment = 'composite'"),
    md("## Object masks\n* `object_shape_type`: 'blob' or 'projection'\n"
       "* `thresh`: 'auto' (local-adaptive), a percentile int, or None"),
    code("ez_object_segmentation.create_object_masks(\n"
         "    image_dir, None, fovs, mask_name, channel_to_segment,\n"
         "    masks_dir, log_dir, object_shape_type='blob', thresh='auto')"),
    md("## Merge with cell masks + cohort renumber"),
    code("merge_masks.merge_masks_seq(\n"
         "    fovs, [mask_name], masks_dir, cell_mask_dir, 'whole_cell',\n"
         "    overlap_percent_threshold=30, expansion_factor=10,\n"
         "    save_path=merged_dir, log_dir=log_dir)\n"
         "ez_seg_utils.renumber_masks(merged_dir)"),
    md("## Cell table over the merged masks"),
    code("cell_table_size_norm, cell_table_arcsinh = \\\n"
         "    marker_quantification.generate_cell_table(\n"
         "        segmentation_dir=merged_dir, tiff_dir=image_dir,\n"
         "        img_sub_folder=None, fovs=fovs,\n"
         "        mask_types=[mask_name + '_merged'])"),
]

NOTEBOOKS["generic_cell_clustering.ipynb"] = [
    md("# Generic cell clustering\n\nTPU-native equivalent of "
       "`generic_cell_clustering.ipynb`: cell SOM + consensus directly on "
       "arbitrary cell-table columns (marker expression) instead of "
       "pixel-cluster counts."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.phenotyping import (cell_meta_clustering,\n"
         "                                 cell_som_clustering)"),
    md(PATHS_MD + "* `cell_som_cluster_cols`: cell-table columns to "
       "cluster on\n* `max_k`: consensus metacluster count"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized.csv')\n"
         "cell_som_cluster_cols = ['CD3', 'CD4', 'CD8', 'CD14']\n"
         "max_k = 20\nseed = 42\n"
         "cell_table = pd.read_csv(cell_table_path)\n"
         "fovs = sorted(cell_table['fov'].unique())"),
    md("## Train + assign the cell SOM"),
    code("cell_pysom = cell_som_clustering.train_cell_som(\n"
         "    fovs, base_dir, cell_table_path, cell_som_cluster_cols,\n"
         "    cell_table.copy(), seed=seed, normalize=True)\n"
         "labeled = cell_som_clustering.cluster_cells(\n"
         "    base_dir, cell_pysom, cell_som_cluster_cols)\n"
         "cell_som_clustering.generate_som_avg_files(\n"
         "    base_dir, labeled, cell_som_cluster_cols,\n"
         "    'generic_cell_som_cluster_avg.csv')"),
    md("## Consensus metaclustering"),
    code("cell_cc, labeled = cell_meta_clustering.cell_consensus_cluster(\n"
         "    base_dir, cell_som_cluster_cols, labeled,\n"
         "    'generic_cell_som_cluster_avg.csv', max_k=max_k, seed=seed)\n"
         "cell_meta_clustering.generate_meta_avg_files(\n"
         "    base_dir, cell_cc, cell_som_cluster_cols, labeled,\n"
         "    'generic_cell_som_cluster_avg.csv',\n"
         "    'generic_cell_meta_cluster_avg.csv')\n"
         "labeled.to_csv(os.path.join(base_dir, "
         "'generic_cell_clusters.csv'),\n               index=False)"),
]

NOTEBOOKS["mask_generation.ipynb"] = [
    md("# Mask generation\n\nTPU-native equivalent of "
       "`mask_generation.ipynb`: signal masks from channel composites and "
       "binary cell-type masks from segmentations + phenotypes."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.utils import masking_utils"),
    md(PATHS_MD),
    code("base_dir = '../data/example_dataset'\n"
         "img_dir = os.path.join(base_dir, 'image_data')\n"
         "seg_dir = os.path.join(base_dir, 'segmentation/deepcell_output')\n"
         "mask_dir = os.path.join(base_dir, 'masks')\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "os.makedirs(mask_dir, exist_ok=True)\n"
         "cell_table = pd.read_csv(cell_table_path)"),
    md("## Signal masks"),
    code("masking_utils.generate_signal_masks(\n"
         "    img_dir, mask_dir, ['Au'], 'signal_mask')"),
    md("## Cell-type masks"),
    code("masking_utils.generate_cell_masks(\n"
         "    seg_dir, mask_dir, cell_table, ['Cancer'], 'cell_mask')"),
]

NOTEBOOKS["example_pairwise_spatial_enrichment.ipynb"] = [
    md("# Pairwise spatial enrichment\n\nPermutation-test spatial "
       "enrichment (the reference README's "
       "`example_pairwise_spatial_enrichment.ipynb`; the notebook is "
       "absent from the reference snapshot — rebuilt here over the "
       "vmapped device permutation engine)."),
    code("import os\n\nimport pandas as pd\n\n"
         "from ark_tpu.analysis import (spatial_analysis_utils,\n"
         "                              spatial_enrichment)"),
    md(PATHS_MD + "* `dist_lim`: proximity threshold (pixels)\n"
       "* `bootstrap_num`: permutations for the null"),
    code("base_dir = '../data/example_dataset'\n"
         "cell_table_path = os.path.join(\n"
         "    base_dir, 'segmentation/cell_table/"
         "cell_table_size_normalized_cell_labels.csv')\n"
         "dist_lim = 100\nbootstrap_num = 100\n"
         "all_data = pd.read_csv(cell_table_path)\n"
         "dist_dir = os.path.join(base_dir, 'spatial_analysis', "
         "'dist_mats')\nos.makedirs(dist_dir, exist_ok=True)\n"
         "spatial_analysis_utils.calc_dist_matrix(all_data, dist_dir)"),
    md("## Phenotype x phenotype enrichment per FOV"),
    code("stats = []\n"
         "for fov in sorted(all_data['fov'].unique()):\n"
         "    dist_mat = spatial_analysis_utils.load_dist_matrix("
         "dist_dir, fov)\n"
         "    names, res = "
         "spatial_enrichment.calculate_cluster_spatial_enrichment(\n"
         "        fov, all_data, dist_mat, dist_lim=dist_lim,\n"
         "        bootstrap_num=bootstrap_num)\n"
         "    table = spatial_enrichment.generate_enrichment_stats_table("
         "names, res)\n"
         "    table['fov'] = fov\n    stats.append(table)\n"
         "stats = pd.concat(stats)\n"
         "stats.to_csv(os.path.join(base_dir, "
         "'spatial_enrichment_stats.csv'),\n             index=False)\n"
         "stats.sort_values('z', ascending=False).head(10)"),
]


def main():
    for name, cells in NOTEBOOKS.items():
        nb = {"cells": cells, "metadata": META, "nbformat": 4,
              "nbformat_minor": 5}
        path = os.path.join(OUT_DIR, name)
        with open(path, "w") as f:
            json.dump(nb, f, indent=1)
            f.write("\n")
        print("wrote", name)


if __name__ == "__main__":
    main()
