"""Mesmer segmentation driver with the reference's DeepCell-service API.

Capability parity with reference `src/ark/utils/deepcell_service_utils.py`:
`generate_deepcell_input` (:347-408, identical 2-channel TIFF contract) and
`create_deepcell_output` (:95-211) — but the network round trip (zip upload →
remote GPU → redis poll → zip download) is replaced by in-process device
inference via `ark_tpu.segmentation.mesmer`. File contract preserved:
`<fov>_whole_cell.tiff` / `<fov>_nuclear.tiff` int32 masks in
`deepcell_output_dir`. The `host`/`job_type`/`timeout` arguments are accepted
for compatibility and ignored; `zip_size` becomes the device batch size."""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from ark_tpu.io import io_utils, load_utils
from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu.io.misc_utils import verify_in_list


def generate_deepcell_input(data_dir, tiff_dir, nuc_channels, mem_channels,
                            fovs, is_mibitiff=False, img_sub_folder="TIFs",
                            dtype="int16"):
    """Sum nuclear/membrane channels into channels-first 2-channel TIFFs."""
    if not nuc_channels and not mem_channels:
        raise ValueError("Either nuc_channels or mem_channels should be "
                         "non-empty.")
    channels = (nuc_channels or []) + (mem_channels or [])
    channels = [c for c in channels if c is not None]
    for fov in fovs:
        data_xr = load_utils.load_imgs_from_tree(
            tiff_dir, img_sub_folder=img_sub_folder, fovs=[fov],
            channels=channels)
        fov_name = list(data_xr.coords["fovs"])[0]
        in_dtype = data_xr.values.dtype
        is_int = np.issubdtype(in_dtype, np.integer)
        # accumulate wide: a multi-channel sum overflows the input dtype
        # (three ~30k-count uint16 membrane channels wrap to garbage); the
        # reference sums straight into the input dtype and also never
        # reads its `dtype` parameter
        acc = np.zeros((2, data_xr.shape[1], data_xr.shape[2]),
                       dtype=np.int64 if is_int else np.float64)
        if nuc_channels:
            acc[0] = np.sum(data_xr.sel(
                fovs=fov_name, channels=list(nuc_channels)).values,
                axis=-1, dtype=acc.dtype)
        if mem_channels:
            acc[1] = np.sum(data_xr.sel(
                fovs=fov_name, channels=list(mem_channels)).values,
                axis=-1, dtype=acc.dtype)
        out_dtype = np.dtype(dtype) if is_int else in_dtype
        # overflow check only makes sense for an integer target; a caller
        # requesting e.g. dtype='float32' on integer inputs gets a plain
        # astype (np.iinfo would raise TypeError on a float dtype)
        if (is_int and np.issubdtype(out_dtype, np.integer)
                and acc.max() > np.iinfo(out_dtype).max):
            promoted = np.promote_types(
                out_dtype, np.min_scalar_type(int(acc.max())))
            warnings.warn(
                f"summed channel counts exceed {out_dtype}; writing "
                f"{fov_name}.tiff as {promoted}")
            out_dtype = promoted
        save_image(os.path.join(data_dir, f"{fov_name}.tiff"),
                   acc.astype(out_dtype))


def zip_input_files(deepcell_input_dir, fov_group, batch_num):
    """Zip one batch of `<fov>.tiff` inputs into `fovs_batch_<n>.zip`
    (reference :17-40 contract; skip-if-exists). Kept for drop-in parity —
    the in-process path doesn't need zips, but external batch services
    and archival workflows do."""
    from zipfile import ZIP_DEFLATED, ZipFile

    zip_path = os.path.join(deepcell_input_dir, f"fovs_batch_{batch_num}.zip")
    if not os.path.exists(zip_path):
        with ZipFile(zip_path, "w", compression=ZIP_DEFLATED) as zf:
            for fov in fov_group:
                basename = fov + ".tiff"
                zf.write(os.path.join(deepcell_input_dir, basename), basename)
    return zip_path


def run_deepcell_direct(input_dir, output_dir, host=None, job_type="mesmer",
                        scale=1.0, timeout=300,
                        weights_path: Optional[str] = None):
    """In-process stand-in for the reference's REST loop (:214-343): read a
    `fovs_batch_<n>.zip` of 2-channel inputs, run the local Mesmer model, and
    write `deepcell_response_fovs_batch_<n>.zip` of `<fov>_feature_0.tif` /
    `<fov>_feature_1.tif` masks to `output_dir` (the exact artifact the
    remote service returns). `host`/`timeout` are accepted and ignored."""
    from zipfile import ZIP_DEFLATED, ZipFile

    from ark_tpu.io.image_utils import encode_tiff
    from ark_tpu.segmentation.mesmer import Mesmer

    batch_name = os.path.splitext(os.path.basename(input_dir))[0]
    app = Mesmer(weights_path=weights_path)
    out_zip = os.path.join(output_dir,
                           f"deepcell_response_{batch_name}.zip")
    with ZipFile(input_dir, "r") as zin:
        names = [n for n in zin.namelist() if n.endswith((".tiff", ".tif"))]
        imgs, fov_names = [], []
        for name in names:
            full = read_image_bytes(zin.read(name))
            if full.ndim == 3 and full.shape[0] == 2:
                full = np.moveaxis(full, 0, -1)
            imgs.append(full.astype(np.float32) * float(scale))
            fov_names.append(io_utils.remove_file_extensions([name])[0])
    preds = app.predict(np.stack(imgs))
    with ZipFile(out_zip, "w", compression=ZIP_DEFLATED) as zout:
        for i, fov in enumerate(fov_names):
            for feature, key in ((0, "whole_cell"), (1, "nuclear")):
                zout.writestr(f"{fov}_feature_{feature}.tif",
                              encode_tiff(preds[key][i].astype(np.int32)))
    return 0


def extract_deepcell_response(deepcell_output_dir, fov_group, batch_num,
                              wc_suffix, nuc_suffix):
    """Unzip `deepcell_response_fovs_batch_<n>.zip` masks, renaming
    `_feature_0`→wc_suffix and `_feature_1`→nuc_suffix and appending the
    extra `f` to `.tif` (reference :43-92 contract)."""
    import io as _io
    import warnings
    from zipfile import ZipFile

    batch_zip = os.path.join(
        deepcell_output_dir, f"deepcell_response_fovs_batch_{batch_num}.zip")
    with ZipFile(batch_zip, "r") as zf:
        names = zf.namelist()
        for name in names:
            if "_feature_0.tif" in name:
                renamed = name.replace("_feature_0", wc_suffix)
            else:
                renamed = name.replace("_feature_1", nuc_suffix)
            mask = read_image_bytes(zf.read(name)).squeeze()
            save_image(os.path.join(deepcell_output_dir, renamed + "f"),
                       mask.astype(np.int32))
    for fov in fov_group:
        if fov + "_feature_0.tif" not in names:
            warnings.warn(
                f"Deep Cell whole cell output file was not found for {fov}.")
        if fov + "_feature_1.tif" not in names:
            warnings.warn(
                f"Deep Cell nuclear output file was not found for {fov}.")


def read_image_bytes(data: bytes) -> np.ndarray:
    """Decode an in-memory TIFF (all pages) to an ndarray."""
    from ark_tpu.io.image_utils import decode_image

    return decode_image(data)


def create_deepcell_output(deepcell_input_dir, deepcell_output_dir, fovs=None,
                           wc_suffix="_whole_cell", nuc_suffix="_nuclear",
                           host=None, job_type="mesmer", scale=1.0,
                           timeout=300, zip_size=5,
                           weights_path: Optional[str] = None,
                           **predict_kwargs):
    """Segment every `<fov>.tiff` 2-channel input with the in-process Mesmer
    model; save `<fov><wc_suffix>.tiff` / `<fov><nuc_suffix>.tiff` int32
    masks. Previously produced masks are skipped (resume semantics)."""
    from ark_tpu.segmentation.mesmer import Mesmer

    try:
        scale = float(scale)
    except ValueError:
        raise ValueError("Scale argument must be a number")

    input_files = io_utils.list_files(deepcell_input_dir, substrs=[".tiff"])
    if fovs is None:
        fovs = input_files
    fovs = io_utils.remove_file_extensions(fovs)
    verify_in_list(fovs=fovs,
                   deepcell_input_files=io_utils.remove_file_extensions(
                       input_files))
    os.makedirs(deepcell_output_dir, exist_ok=True)

    todo = [fov for fov in fovs if not (
        os.path.exists(os.path.join(deepcell_output_dir,
                                    fov + wc_suffix + ".tiff"))
        and os.path.exists(os.path.join(deepcell_output_dir,
                                        fov + nuc_suffix + ".tiff")))]
    if not todo:
        print("All FOVs already segmented, skipping")
        return
    skipped = len(fovs) - len(todo)
    if skipped:
        print(f"Skipping {skipped} previously processed FOVs.")

    app = Mesmer(weights_path=weights_path)
    batch = max(int(zip_size), 1)
    groups = [todo[i:i + batch] for i in range(0, len(todo), batch)]
    print(f"Processing tiffs in {len(groups)} batches...")
    for fov_group in groups:
        imgs = []
        for fov in fov_group:
            img = read_image(os.path.join(deepcell_input_dir, fov + ".tiff"))
            if img.ndim == 3 and img.shape[0] == 2:   # channels-first input
                img = np.moveaxis(img, 0, -1)
            imgs.append(img.astype(np.float32) * scale)
        stack = np.stack(imgs)
        out = app.predict(stack, **predict_kwargs)
        for i, fov in enumerate(fov_group):
            save_image(os.path.join(deepcell_output_dir,
                                    fov + wc_suffix + ".tiff"),
                       out["whole_cell"][i].astype(np.int32))
            save_image(os.path.join(deepcell_output_dir,
                                    fov + nuc_suffix + ".tiff"),
                       out["nuclear"][i].astype(np.int32))
