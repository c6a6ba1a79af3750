"""Image save/load (reference uses `alpineer.image_utils.save_image` and
tifffile; SURVEY.md §1 L0).

TIFF is read and written here with numpy and zlib alone: classic TIFF in
either byte order, one image per page, strips stored raw or
deflate-compressed (with or without horizontal differencing), 8/16/32/64-bit
unsigned, signed and float samples. A multi-page file reads as a (pages, H,
W) stack. A TIFF this codec does not cover (BigTIFF, LZW, JPEG, tiles,
bilevel) raises `UnsupportedTiff`; every other format goes to Pillow,
imported only then."""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# tag numbers
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_DESCRIPTION, _STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP = 270, 273, 277, 278
_STRIP_BYTES, _PLANAR, _PREDICTOR, _SAMPLE_FORMAT = 279, 284, 317, 339
_SUBFILE_TYPE = 254

# TIFF field type -> (struct code, size)
_FIELD_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4),
                5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
                9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}
_SAMPLE_KIND = {1: "u", 2: "i", 3: "f"}
_KIND_FORMAT = {"u": 1, "b": 1, "i": 2, "f": 3}
_DEFLATE = (8, 32946)


class UnsupportedTiff(ValueError):
    """The file is a TIFF layout this codec does not decode."""


def _tiff_pages(buf: bytes) -> Tuple[List[Dict[int, tuple]], str]:
    """Parse every IFD of a TIFF byte string: ([{tag: values}], byteorder)."""
    order = {b"II": "<", b"MM": ">"}.get(buf[:2])
    if order is None:
        raise UnsupportedTiff("not a TIFF file")
    magic, offset = struct.unpack(order + "HI", buf[2:8])
    if magic != 42:
        raise UnsupportedTiff(f"TIFF magic {magic} (BigTIFF is 43)")
    pages = []
    while offset:
        n = struct.unpack_from(order + "H", buf, offset)[0]
        tags = {}
        for i in range(n):
            pos = offset + 2 + i * 12
            tag, ftype, count = struct.unpack_from(order + "HHI", buf, pos)
            if ftype not in _FIELD_TYPES:
                continue
            code, size = _FIELD_TYPES[ftype]
            nbytes = size * count
            data_pos = pos + 8
            if nbytes > 4:
                data_pos = struct.unpack_from(order + "I", buf, data_pos)[0]
            raw = buf[data_pos:data_pos + nbytes]
            if ftype == 2:
                tags[tag] = (raw.split(b"\0", 1)[0].decode("utf-8",
                                                           "replace"),)
            else:
                tags[tag] = struct.unpack(
                    order + code[0] * (count * len(code)), raw)
        pages.append(tags)
        offset = struct.unpack_from(order + "I", buf, offset + 2 + n * 12)[0]
    return pages, order


def _decode_page(buf: bytes, tags: Dict[int, tuple], order: str) -> np.ndarray:
    if _STRIP_OFFSETS not in tags:
        raise UnsupportedTiff("tiled TIFF")
    width, length = tags[_WIDTH][0], tags[_LENGTH][0]
    spp = tags.get(_SAMPLES, (1,))[0]
    bits = set(tags.get(_BITS, (1,)))
    kinds = set(tags.get(_SAMPLE_FORMAT, (1,)))
    compression = tags.get(_COMPRESSION, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    if len(bits) != 1 or len(kinds) != 1:
        raise UnsupportedTiff("mixed sample types")
    bits, kind = bits.pop(), kinds.pop()
    if bits not in (8, 16, 32, 64) or kind not in _SAMPLE_KIND:
        raise UnsupportedTiff(f"{bits}-bit samples of format {kind}")
    if compression not in (1,) + _DEFLATE or predictor not in (1, 2):
        raise UnsupportedTiff(f"compression {compression}, "
                              f"predictor {predictor}")
    if predictor == 2 and kind == 3:
        raise UnsupportedTiff("differenced float samples")
    dtype = np.dtype(f"{order}{_SAMPLE_KIND[kind]}{bits // 8}")
    strips = [buf[o:o + n] for o, n in zip(tags[_STRIP_OFFSETS],
                                           tags[_STRIP_BYTES])]
    if compression in _DEFLATE:
        strips = [zlib.decompress(s) for s in strips]
    planar = tags.get(_PLANAR, (1,))[0]
    shape = (spp, length, width) if planar == 2 else (length, width, spp)
    # a bytearray, so the decoded image is writable like imageio's was
    data = np.frombuffer(bytearray().join(strips), dtype,
                         count=int(np.prod(shape))).reshape(shape)
    if predictor == 2:
        data = np.cumsum(data, axis=-1 if planar == 2 else 1, dtype=dtype)
    if planar == 2:
        data = np.moveaxis(data, 0, -1)
    data = data.astype(dtype.newbyteorder("="), copy=False)
    return data[..., 0] if spp == 1 else data


def decode_tiff(buf: bytes) -> np.ndarray:
    """Decode TIFF bytes: (H, W) or (H, W, S) for one page, a (pages, ...)
    stack for several. Reduced-resolution pages are skipped."""
    pages, order = _tiff_pages(buf)
    pages = [p for p in pages if not p.get(_SUBFILE_TYPE, (0,))[0] & 1]
    arrays = [_decode_page(buf, p, order) for p in pages]
    return arrays[0] if len(arrays) == 1 else np.stack(arrays)


def tiff_description(fname: str) -> str:
    """The first page's ImageDescription ('' when absent)."""
    with open(fname, "rb") as f:
        pages, _ = _tiff_pages(f.read())
    return pages[0].get(_DESCRIPTION, ("",))[0] if pages else ""


def encode_tiff(data: np.ndarray, description: Optional[str] = None,
                compress: bool = False) -> bytes:
    """Encode a little-endian classic TIFF. (H, W) is one page; (H, W, 3|4)
    uint8 is one RGB(A) page; any other 3-D array is one page per entry of
    axis 0. `compress` stores strips with deflate."""
    data = np.asarray(data)
    kind = data.dtype.kind
    if kind not in _KIND_FORMAT or data.dtype.itemsize not in (1, 2, 4, 8):
        raise TypeError(f"cannot write {data.dtype} samples to TIFF")
    data = data.astype(data.dtype.newbyteorder("<"), copy=False)
    if kind == "b":
        data = data.astype(np.uint8)
    rgb = data.ndim == 3 and data.shape[-1] in (3, 4) \
        and data.dtype == np.uint8
    if data.ndim == 2 or rgb:
        pages = [data]
    elif data.ndim == 3:
        pages = list(data)
    else:
        raise ValueError(f"cannot write a {data.ndim}-D array to TIFF")
    spp = data.shape[-1] if rgb else 1
    out = io.BytesIO()
    out.write(b"II*\0" + struct.pack("<I", 0))
    next_ptr = 4
    for i, page in enumerate(pages):
        raw = np.ascontiguousarray(page).tobytes()
        if compress:
            raw = zlib.compress(raw, 6)
        strip_at = out.tell()
        out.write(raw)
        extra = io.BytesIO()       # out-of-line values, after the IFD
        entries = []

        def add(tag, ftype, values):
            code, size = _FIELD_TYPES[ftype]
            payload = values if ftype == 2 else struct.pack(
                "<" + code * len(values), *values)
            count = len(payload) if ftype == 2 else len(values)
            entries.append((tag, ftype, count, payload))

        bits = page.dtype.itemsize * 8
        add(_WIDTH, 4, (page.shape[1],))
        add(_LENGTH, 4, (page.shape[0],))
        add(_BITS, 3, (bits,) * spp)
        add(_COMPRESSION, 3, (8 if compress else 1,))
        add(_PHOTOMETRIC, 3, (2 if rgb else 1,))
        if description is not None and i == 0:
            add(_DESCRIPTION, 2, description.encode("utf-8") + b"\0")
        add(_STRIP_OFFSETS, 4, (strip_at,))
        add(_SAMPLES, 3, (spp,))
        add(_ROWS_PER_STRIP, 4, (page.shape[0],))
        add(_STRIP_BYTES, 4, (len(raw),))
        add(_PLANAR, 3, (1,))
        add(_SAMPLE_FORMAT, 3, (_KIND_FORMAT[kind],) * spp)
        if out.tell() % 2:
            out.write(b"\0")
        ifd_at = out.tell()
        extra_at = ifd_at + 2 + 12 * len(entries) + 4
        body = [struct.pack("<H", len(entries))]
        for tag, ftype, count, payload in entries:
            if len(payload) <= 4:
                value = payload.ljust(4, b"\0")
            else:
                value = struct.pack("<I", extra_at + extra.tell())
                extra.write(payload)
                if extra.tell() % 2:
                    extra.write(b"\0")
            body.append(struct.pack("<HHI", tag, ftype, count) + value)
        out.write(b"".join(body) + struct.pack("<I", 0))
        out.write(extra.getvalue())
        end = out.tell()
        out.seek(next_ptr)
        out.write(struct.pack("<I", ifd_at))
        out.seek(end)
        next_ptr = extra_at - 4
    return out.getvalue()


def _is_tiff(fname: str) -> bool:
    return fname.lower().endswith((".tif", ".tiff"))


def _is_tiff_bytes(buf: bytes) -> bool:
    return buf[:2] in (b"II", b"MM")


def save_image(fname: str, data: np.ndarray, compression_level=None,
               description: Optional[str] = None):
    """Save a 2-D (or HxWxC, or stacked) image array to `fname` (TIFF, or
    any Pillow format by extension).

    float64 is saved float32, int64 int32 and bool uint8. A
    `compression_level` above 0 deflate-compresses TIFF strips."""
    data = np.asarray(data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    if _is_tiff(fname):
        blob = encode_tiff(data, description=description,
                           compress=bool(compression_level))
        with open(fname, "wb") as f:
            f.write(blob)
        return
    from PIL import Image

    Image.fromarray(data).save(fname)


def decode_image(buf: bytes) -> np.ndarray:
    """Decode image bytes (all pages): TIFF with `decode_tiff`, any other
    format through Pillow."""
    if _is_tiff_bytes(buf):
        return decode_tiff(buf)
    from PIL import Image, ImageSequence

    with Image.open(io.BytesIO(buf)) as img:
        frames = [np.asarray(f) for f in ImageSequence.Iterator(img)]
    return frames[0] if len(frames) == 1 else np.stack(frames)


def read_image(fname: str) -> np.ndarray:
    """Read an image file into a numpy array (dtype preserved for TIFF)."""
    with open(fname, "rb") as f:
        return decode_image(f.read())


def image_size(fname: str) -> Tuple[int, int]:
    """(height, width) of an image's first page, from its header."""
    if _is_tiff(fname):
        with open(fname, "rb") as f:
            pages, _ = _tiff_pages(f.read())
        return pages[0][_LENGTH][0], pages[0][_WIDTH][0]
    from PIL import Image

    with Image.open(fname) as im:
        w, h = im.size
    return h, w
