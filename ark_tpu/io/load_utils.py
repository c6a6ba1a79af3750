"""Cohort image loading: TIFF channel trees -> (fov, row, col, channel) arrays.

Re-provides the `alpineer.load_utils` capability surface (SURVEY.md §1 L0:
load_imgs_from_tree / load_imgs_from_dir / load_tiled_img_data /
get_tiled_fov_names) with a device-friendly contract: loaders return a dense
float32/int numpy block plus coordinate labels (via ark_tpu DataArray), ready
for a single host→device transfer of whole FOV batches.

Expected tree layout (same as reference cohorts):
    data_dir/
      fov0/  <img_sub_folder>/ chan0.tiff chan1.tiff ...
      fov1/  <img_sub_folder>/ ...
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from ark_tpu.io import io_utils
from ark_tpu.io.image_utils import image_size, read_image
from ark_tpu.utils.labeled_array import DataArray


def _infer_dtype(arrs) -> np.dtype:
    return np.result_type(*[a.dtype for a in arrs])


def load_imgs_from_tree(data_dir: str, img_sub_folder: Optional[str] = None,
                        fovs: Optional[List[str]] = None,
                        channels: Optional[List[str]] = None,
                        dtype=None, max_image_size: Optional[int] = None) -> DataArray:
    """Load `data_dir/<fov>/<img_sub_folder>/<channel>.tiff` into a
    (fovs, rows, cols, channels) DataArray. Channels may be given with or
    without extensions; FOVs default to every subfolder, natural-sorted."""
    io_utils.validate_paths([data_dir])
    if fovs is None:
        fovs = io_utils.list_folders(data_dir)
    if isinstance(fovs, str):
        fovs = [fovs]
    if len(fovs) == 0:
        raise ValueError(f"No FOV folders found in {data_dir}")
    if img_sub_folder is None:
        img_sub_folder = ""

    # resolve channel file names from the first FOV
    first_dir = os.path.join(data_dir, fovs[0], img_sub_folder)
    io_utils.validate_paths([first_dir])
    all_files = io_utils.list_files(first_dir, substrs=[".tiff", ".tif"])
    if channels is None:
        channel_files = all_files
    else:
        with_ext, names = [], []
        for c in channels:
            if c.endswith((".tiff", ".tif")):
                with_ext.append(c)
            else:
                match = [f for f in all_files if os.path.splitext(f)[0] == c]
                if not match:
                    raise ValueError(f"channel {c} not found in {first_dir}")
                with_ext.append(match[0])
        channel_files = with_ext
    channel_names = io_utils.remove_file_extensions(channel_files)
    if len(channel_files) == 0:
        raise ValueError(f"No channel images found in {first_dir}")

    # header-only size scan: lets the output be preallocated and filled
    # FOV-by-FOV instead of keeping every block in a list alongside the
    # output — the list+copy pattern doubled peak host memory on multi-GB
    # cohorts
    max_h = max_w = 0
    for fov in fovs:
        path = os.path.join(data_dir, fov, img_sub_folder, channel_files[0])
        h, w = image_size(path)
        max_h, max_w = max(max_h, h), max(max_w, w)
    if max_image_size is not None:
        max_h = max_w = max_image_size

    # dtype probe over the first FOV's channels (promotes mixed dtypes);
    # the probe images are reused to fill row 0 below, so the first FOV is
    # only read once
    probe = [read_image(os.path.join(data_dir, fovs[0], img_sub_folder, cf))
             for cf in channel_files]
    native_dtype = _infer_dtype(probe)
    out_dtype = np.dtype(dtype) if dtype is not None else native_dtype
    if (dtype is not None and np.issubdtype(out_dtype, np.integer)
            and np.issubdtype(native_dtype, np.floating)):
        # alpineer contract: float image data is never silently truncated
        # into a requested integer dtype
        import warnings
        warnings.warn(
            f"supplied non-float dtype {out_dtype} would truncate float "
            f"image data; overwriting to {native_dtype}")
        out_dtype = native_dtype

    # pad ragged FOVs to the cohort max (keeps the device block dense/static)
    out = np.zeros((len(fovs), max_h, max_w, len(channel_files)),
                   dtype=out_dtype)
    for j, img in enumerate(probe):
        out[0, :img.shape[0], :img.shape[1], j] = img
    del probe
    for i, fov in enumerate(fovs[1:], start=1):
        fdir = os.path.join(data_dir, fov, img_sub_folder)
        for j, cf in enumerate(channel_files):
            img = read_image(os.path.join(fdir, cf))
            out[i, :img.shape[0], :img.shape[1], j] = img

    return DataArray(out, coords={"fovs": fovs, "rows": np.arange(max_h),
                                  "cols": np.arange(max_w), "channels": channel_names})


def load_imgs_from_dir(data_dir: str, files: Optional[List[str]] = None,
                       match_substring: Optional[str] = None,
                       trim_suffix: Optional[str] = None,
                       xr_dim_name: str = "compartments",
                       xr_channel_names: Optional[List[str]] = None,
                       dtype=None) -> DataArray:
    """Load loose image files `data_dir/*.tiff` into a
    (fovs, rows, cols, <xr_dim_name>) DataArray. Each file is one FOV; a
    multi-page/HxWxC file populates the last axis."""
    io_utils.validate_paths([data_dir])
    if files is None:
        files = io_utils.list_files(data_dir, substrs=match_substring or [".tiff", ".tif"])
    if len(files) == 0:
        raise ValueError(f"No image files found in {data_dir}")
    names = io_utils.remove_file_extensions(files)
    if trim_suffix:
        names = [re.sub(re.escape(trim_suffix) + "$", "", n) for n in names]

    blocks = []
    for f in files:
        img = read_image(os.path.join(data_dir, f))
        if img.ndim == 2:
            img = img[..., None]
        elif img.ndim == 3:
            if (xr_channel_names
                    and img.shape[0] == len(xr_channel_names)
                    and img.shape[-1] != len(xr_channel_names)):
                # channels-first multi-page TIFF (deepcell 2-channel inputs)
                img = np.moveaxis(img, 0, -1)
            elif (xr_channel_names is None
                  and img.shape[0] == min(img.shape)
                  and img.shape[0] != img.shape[-1]):
                # alpineer's channels-first auto-detection: without channel
                # names a multi-page TIFF would otherwise load with pages
                # as 'rows' and image width as the channel axis — silently
                # transposed data
                img = np.moveaxis(img, 0, -1)
        blocks.append(img)
    shapes = {b.shape for b in blocks}
    if len(shapes) > 1:
        raise ValueError(f"Mixed image shapes in {data_dir}: {shapes}")
    out = np.stack(blocks, axis=0)
    if dtype is not None:
        out = out.astype(dtype)
    nch = out.shape[-1]
    ch_names = xr_channel_names if xr_channel_names is not None else list(range(nch))
    return DataArray(out, coords={"fovs": names, "rows": np.arange(out.shape[1]),
                                  "cols": np.arange(out.shape[2]), xr_dim_name: ch_names})


def load_imgs_from_mibitiff(data_dir: str, mibitiff_files: Optional[List[str]] = None,
                            channels: Optional[List[str]] = None,
                            dtype=None) -> DataArray:
    """Load MIBItiff-style multi-channel single-file FOVs into a
    (fovs, rows, cols, channels) DataArray (re-provides
    `alpineer.load_utils.load_imgs_from_mibitiff`; SURVEY.md §1 L0).

    Each file is one FOV: a channels-first multi-page TIFF. Channel names are
    read from a `<file>.channels.txt` sidecar (written by
    `ark_tpu.io.ome_utils.fov_to_ome`) or OME-XML when present, else they are
    generated as channel_<i>.
    """
    from ark_tpu.io.ome_utils import _read_channel_names

    io_utils.validate_paths([data_dir])
    if mibitiff_files is None:
        mibitiff_files = [
            f for f in io_utils.list_files(data_dir, substrs=[".tiff", ".tif"])
            if f.endswith((".tiff", ".tif"))]
    blocks, names = [], []
    channel_names = None
    for f in mibitiff_files:
        path = os.path.join(data_dir, f)
        img = read_image(path)
        if img.ndim == 2:
            img = img[None]
        file_channels = _read_channel_names(path, img.shape[0])
        if channels is not None:
            keep = [file_channels.index(c) for c in channels]
            img = img[keep]
            file_channels = list(channels)
        if channel_names is None:
            channel_names = file_channels
        blocks.append(np.moveaxis(img, 0, -1))
        name = f
        for suffix in (".ome.tiff", ".ome.tif", ".tiff", ".tif"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
                break
        names.append(name)
    out = np.stack(blocks, axis=0)
    if dtype is not None:
        out = out.astype(dtype)
    return DataArray(out, coords={"fovs": names,
                                  "rows": np.arange(out.shape[1]),
                                  "cols": np.arange(out.shape[2]),
                                  "channels": channel_names})


def get_tiled_fov_names(fov_list: List[str], return_dims: bool = False):
    """From RnCm-style FOV names, compute the full expected tile grid
    (reference behavior: `alpineer.load_utils.get_tiled_fov_names`)."""
    prefixes, rows, cols = set(), 0, 0
    parsed = []
    for fov in fov_list:
        # fullmatch: an unanchored match silently drops suffixes after
        # RnCm ('R1C1_acquisition' -> 'R1C1'), and the tiled loader then
        # finds none of the real files and zero-fills every tile
        m = re.fullmatch(r"(?:(.*)_)?R(\d+)C(\d+)", fov)
        if not m:
            raise ValueError(f"FOV {fov} is not RnCm-tiled")
        prefix = m.group(1) or ""
        prefixes.add(prefix)
        parsed.append((prefix, int(m.group(2)), int(m.group(3))))
    expected = []
    dims = []
    for prefix in io_utils.natsorted(prefixes):
        rs = [r for p, r, c in parsed if p == prefix]
        cs = [c for p, r, c in parsed if p == prefix]
        rows, cols = max(rs), max(cs)
        names = [f"{prefix + '_' if prefix else ''}R{r}C{c}"
                 for r in range(1, rows + 1) for c in range(1, cols + 1)]
        expected.append(names)
        dims.append((prefix, rows, cols))
    flat = [n for group in expected for n in group]
    if return_dims:
        return flat, dims
    return flat


def load_tiled_img_data(data_dir: str, fovs: List[str], expected_fovs: List[str],
                        channel: str, single_dir: bool = False,
                        img_sub_folder: str = "") -> DataArray:
    """Load one channel for a tiled FOV grid, zero-filling missing tiles."""
    io_utils.validate_paths([data_dir])
    blocks, shape = {}, None
    for fov in fovs:
        if single_dir:
            path = os.path.join(data_dir, f"{fov}_{channel}.tiff")
        else:
            path = os.path.join(data_dir, fov, img_sub_folder, f"{channel}.tiff")
        img = read_image(path)
        blocks[fov] = img
        shape = img.shape
    if shape is None:
        raise ValueError("no tiles loaded")
    out = np.zeros((len(expected_fovs),) + shape + (1,), dtype=np.float32)
    for i, fov in enumerate(expected_fovs):
        if fov in blocks:
            out[i, ..., 0] = blocks[fov]
    return DataArray(out, coords={"fovs": expected_fovs, "rows": np.arange(shape[0]),
                                  "cols": np.arange(shape[1]), "channels": [channel]})
