"""Tiny uint16 grayscale TIFF writer/reader.

The reference writes images through a vendored copy of ``tifffile.py``
(ref: run_simulation_02.py:1864, C15 in SURVEY.md).  We only ever need
single-page uncompressed 16-bit grayscale, which is ~60 lines of TIFF, so
this module is self-contained instead of vendoring a 6 kLoC dependency.
"""
from __future__ import annotations

import struct

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339

_TYPE_SHORT = 3
_TYPE_LONG = 4


def write_tiff16(path: str, image: np.ndarray) -> None:
    """Write a 2-D uint16 array as a little-endian single-strip TIFF."""
    img = np.ascontiguousarray(np.asarray(image, dtype=np.uint16))
    if img.ndim != 2:
        raise ValueError("write_tiff16 expects a 2-D array")
    h, w = img.shape
    data = img.tobytes()

    # layout: 8-byte header | pixel data | IFD
    data_offset = 8
    ifd_offset = data_offset + len(data)

    tags = [
        (_IMAGE_WIDTH, _TYPE_LONG, 1, w),
        (_IMAGE_LENGTH, _TYPE_LONG, 1, h),
        (_BITS_PER_SAMPLE, _TYPE_SHORT, 1, 16),
        (_COMPRESSION, _TYPE_SHORT, 1, 1),        # none
        (_PHOTOMETRIC, _TYPE_SHORT, 1, 1),        # BlackIsZero
        (_STRIP_OFFSETS, _TYPE_LONG, 1, data_offset),
        (_SAMPLES_PER_PIXEL, _TYPE_SHORT, 1, 1),
        (_ROWS_PER_STRIP, _TYPE_LONG, 1, h),
        (_STRIP_BYTE_COUNTS, _TYPE_LONG, 1, len(data)),
        (_SAMPLE_FORMAT, _TYPE_SHORT, 1, 1),      # unsigned int
    ]

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        f.write(data)
        f.write(struct.pack("<H", len(tags)))
        for tag, ttype, count, value in tags:
            f.write(struct.pack("<HHII", tag, ttype, count, value))
        f.write(struct.pack("<I", 0))  # no next IFD


def read_tiff16(path: str) -> np.ndarray:
    """Read a TIFF written by :func:`write_tiff16` (or equivalent layout)."""
    with open(path, "rb") as f:
        raw = f.read()
    byte_order, magic, ifd_offset = struct.unpack_from("<2sHI", raw, 0)
    if byte_order != b"II" or magic != 42:
        raise ValueError(f"{path}: not a little-endian TIFF")
    (ntags,) = struct.unpack_from("<H", raw, ifd_offset)
    tags = {}
    for i in range(ntags):
        tag, ttype, count, value = struct.unpack_from(
            "<HHII", raw, ifd_offset + 2 + 12 * i)
        if ttype == _TYPE_SHORT and count == 1:
            value &= 0xFFFF
        tags[tag] = value
    w, h = tags[_IMAGE_WIDTH], tags[_IMAGE_LENGTH]
    off, nbytes = tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS]
    if tags.get(_BITS_PER_SAMPLE, 16) != 16 or tags.get(_COMPRESSION, 1) != 1:
        raise ValueError(f"{path}: unsupported TIFF variant")
    return np.frombuffer(raw[off:off + nbytes], dtype=np.uint16).reshape(h, w).copy()
