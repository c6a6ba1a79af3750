"""OME-TIFF ↔ per-channel FOV conversion (re-provides the
`alpineer.load_utils.{fov_to_ome, ome_to_fov}` surface used by
`templates/OME-TIFF_Conversion.ipynb`; SURVEY.md §1 L0).

Writes multi-page TIFFs with a minimal OME-XML header carrying channel names;
reads them (or any channels-first multi-page TIFF) back into a channel tree.
"""

from __future__ import annotations

import os
import re
import xml.sax.saxutils
from typing import List, Optional

import numpy as np

from ark_tpu.io import io_utils
from ark_tpu.io.image_utils import read_image, save_image, tiff_description


def _ome_xml(channel_names: List[str], shape, dtype) -> str:
    chans = "".join(
        f'<Channel ID="Channel:0:{i}" Name='
        f'{xml.sax.saxutils.quoteattr(str(c))} SamplesPerPixel="1"/>'
        for i, c in enumerate(channel_names))
    h, w = shape
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        f'<Image ID="Image:0"><Pixels ID="Pixels:0" DimensionOrder="XYCZT" '
        f'Type="{np.dtype(dtype).name}" SizeX="{w}" SizeY="{h}" '
        f'SizeC="{len(channel_names)}" SizeZ="1" SizeT="1">'
        f"{chans}</Pixels></Image></OME>")


def fov_to_ome(fov_dir: str, ome_save_dir: str,
               img_sub_folder: Optional[str] = None,
               fov_name: Optional[str] = None) -> str:
    """Bundle one FOV's channel TIFF tree into a single `<fov>.ome.tiff`."""
    io_utils.validate_paths([fov_dir])
    sub = img_sub_folder or ""
    chan_dir = os.path.join(fov_dir, sub)
    files = io_utils.list_files(chan_dir, substrs=[".tiff", ".tif"])
    channels = io_utils.remove_file_extensions(files)
    stack = np.stack([read_image(os.path.join(chan_dir, f)) for f in files])
    fov_name = fov_name or os.path.basename(os.path.normpath(fov_dir))
    os.makedirs(ome_save_dir, exist_ok=True)
    out_path = os.path.join(ome_save_dir, f"{fov_name}.ome.tiff")
    save_image(out_path, stack, description=_ome_xml(
        channels, stack.shape[1:], stack.dtype))
    # sidecar with channel names (robust to TIFF-tag roundtrip limitations)
    with open(out_path + ".channels.txt", "w") as f:
        f.write("\n".join(channels))
    return out_path


def _read_channel_names(ome_path: str, n_channels: int) -> List[str]:
    sidecar = ome_path + ".channels.txt"
    if os.path.exists(sidecar):
        return open(sidecar).read().splitlines()
    try:
        desc = tiff_description(ome_path)
        names = re.findall(r'Name="([^"]+)"', desc)
        if len(names) == n_channels:
            return names
        reason = (f"found {len(names)} Name attributes in the OME-XML "
                  f"description for {n_channels} channels")
    except Exception as e:  # metadata recovery must never block the load
        reason = f"{type(e).__name__}: {e}"
    import warnings
    warnings.warn(
        f"could not recover channel names from {ome_path} ({reason}); "
        f"falling back to generic channel_N names")
    return [f"channel_{i}" for i in range(n_channels)]


def ome_to_fov(ome_path: str, data_dir: str,
               img_sub_folder: Optional[str] = None) -> str:
    """Unbundle an OME-TIFF back into a `<fov>/<chan>.tiff` tree."""
    io_utils.validate_paths([ome_path])
    stack = read_image(ome_path)
    if stack.ndim == 2:
        stack = stack[None]
    fov_name = os.path.basename(ome_path)
    for suffix in (".ome.tiff", ".ome.tif", ".tiff", ".tif"):
        if fov_name.endswith(suffix):
            fov_name = fov_name[: -len(suffix)]
            break
    channels = _read_channel_names(ome_path, stack.shape[0])
    out_dir = os.path.join(data_dir, fov_name, img_sub_folder or "")
    os.makedirs(out_dir, exist_ok=True)
    for chan, img in zip(channels, stack):
        save_image(os.path.join(out_dir, f"{chan}.tiff"), img)
    return os.path.join(data_dir, fov_name)
