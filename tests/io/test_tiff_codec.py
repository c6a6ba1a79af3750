"""The numpy/zlib TIFF codec in `ark_tpu.io.image_utils`: round trips of
every layout the pipeline writes, bit-exact reads of files written by
Pillow (raw, deflate, deflate with horizontal differencing), and a clear
refusal of the TIFF layouts it does not decode (LZW here)."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from ark_tpu.io import image_utils

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.float32, np.float64, np.int64, bool]


def _sample(dtype, shape, rng):
    if dtype is bool:
        return rng.random(shape) > 0.5
    if np.issubdtype(dtype, np.floating):
        return (rng.normal(size=shape) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=dtype,
                        endpoint=True)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_save_read_roundtrip(tmp_path, rng, dtype, compress):
    want = _sample(dtype, (17, 23), rng)
    path = str(tmp_path / "img.tiff")
    image_utils.save_image(path, want, compression_level=6 if compress
                           else None)
    got = image_utils.read_image(path)
    # the documented widenings: float64 -> float32, int64 -> int32,
    # bool -> uint8
    cast = {np.float64: np.float32, np.int64: np.int32,
            bool: np.uint8}.get(dtype, dtype)
    assert got.dtype == np.dtype(cast)
    np.testing.assert_array_equal(got, np.asarray(want).astype(cast))
    assert image_utils.image_size(path) == (17, 23)


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.int32])
def test_stack_is_one_page_per_plane(tmp_path, rng, dtype):
    """(2, H, W) deepcell inputs and OME stacks are multi-page files."""
    want = _sample(dtype, (3, 9, 11), rng)
    path = str(tmp_path / "stack.tif")
    image_utils.save_image(path, want, description="<OME/>")
    np.testing.assert_array_equal(image_utils.read_image(path), want)
    assert image_utils.tiff_description(path) == "<OME/>"
    with Image.open(path) as im:           # an independent reader agrees
        assert im.n_frames == 3
        im.seek(2)
        np.testing.assert_array_equal(np.asarray(im), want[2])


def test_rgb_page(rng):
    want = rng.integers(0, 255, (5, 7, 3), dtype=np.uint8)
    got = image_utils.decode_tiff(image_utils.encode_tiff(want))
    np.testing.assert_array_equal(got, want)
    with Image.open(io.BytesIO(image_utils.encode_tiff(want))) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), want)


# TIFF horizontal differencing (predictor 2) is defined for integers only
@pytest.mark.parametrize("dtype,compression,predictor", [
    (dt, comp, pred)
    for dt in (np.uint8, np.uint16, np.int32, np.float32)
    for comp, pred in ((None, None), ("tiff_adobe_deflate", None),
                       ("tiff_adobe_deflate", 2))
    if not (pred and dt == np.float32)])
def test_reads_pillow_files_exactly(tmp_path, rng, dtype, compression,
                                    predictor):
    want = _sample(dtype, (31, 40), rng)
    path = str(tmp_path / "pil.tiff")
    kw = {}
    if compression:
        kw["compression"] = compression
    if predictor:
        kw["tiffinfo"] = {317: predictor}
    Image.fromarray(want).save(path, format="TIFF", **kw)
    got = image_utils.read_image(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32,
                                   np.float32])
def test_lzw_tiff_is_refused(tmp_path, rng, dtype):
    """TIFF has one decoder: a layout it lacks is an error naming the
    layout, never a second reader."""
    path = str(tmp_path / "lzw.tiff")
    Image.fromarray(_sample(dtype, (31, 40), rng)).save(
        path, format="TIFF", compression="tiff_lzw")
    with pytest.raises(image_utils.UnsupportedTiff, match="compression 5"):
        image_utils.read_image(path)
    assert image_utils.image_size(path) == (31, 40)


def test_unsupported_layouts_fall_back_or_raise(tmp_path):
    with pytest.raises(image_utils.UnsupportedTiff):
        image_utils.decode_tiff(b"PK\x03\x04 not a tiff")
    with pytest.raises(TypeError):
        image_utils.encode_tiff(np.zeros((2, 2), np.complex64))
    path = str(tmp_path / "x.png")
    image_utils.save_image(path, np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert os.path.exists(path)
    np.testing.assert_array_equal(image_utils.read_image(path),
                                  np.arange(12, dtype=np.uint8).reshape(3, 4))
