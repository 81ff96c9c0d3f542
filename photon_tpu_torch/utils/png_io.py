"""Minimal pure-Python PNG reader and writer (numpy and zlib only).

Own copy of ``photon_tpu/utils/png_io.py``'s reader, which covers what
the reference's image-driven BOS source needs
(``run_simulation_02.py:1620-1628`` reads a grayscale dot-pattern PNG
with matplotlib and keeps channel 0): 8/16-bit grayscale, RGB(A) and
gray+alpha, non-interlaced, all five scanline filters.  Returns channel
0 as float32 scaled to [0, 1] like matplotlib's PNG path.  The writer
(grayscale, 8 or 16 bits, no filter) authors such targets.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """Read a PNG file into a (H, W) float32 array in [0, 1] (channel 0)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")

    pos = 8
    width = height = bitdepth = colortype = None
    idat = []
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            (width, height, bitdepth, colortype,
             _comp, _filt, interlace) = struct.unpack(">IIBBBBB", chunk)
            if interlace:
                raise NotImplementedError("interlaced PNG not supported")
            if colortype == 3:
                raise NotImplementedError("palette PNG not supported")
            if bitdepth not in (8, 16):
                raise NotImplementedError(f"bit depth {bitdepth}")
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: missing IHDR")

    raw = zlib.decompress(b"".join(idat))
    nchan = _CHANNELS[colortype]
    bpp = nchan * (bitdepth // 8)          # bytes per pixel
    stride = width * bpp
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    off = 0
    for row in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1:off + 1 + stride],
                             dtype=np.uint8).copy()
        off += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:                    # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:                    # Up
            line = (line + prev) & 0xFF
        elif ftype == 3:                    # Average
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:                    # Paeth
            for i in range(stride):
                a = int(line[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else c)
                line[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {ftype}")
        out[row] = line
        prev = line

    if bitdepth == 16:
        px = out.reshape(height, width, bpp)
        hi = px[..., 0::2].astype(np.uint16) << 8
        lo = px[..., 1::2].astype(np.uint16)
        img = (hi | lo).astype(np.float32) / 65535.0
    else:
        img = out.reshape(height, width, nchan).astype(np.float32) / 255.0
    return np.ascontiguousarray(img[..., 0])


def write_png(path: str, image: np.ndarray, bitdepth: int = 8) -> None:
    """Write a (H, W) array of integer levels as a grayscale PNG
    (``bitdepth`` 8 or 16, filter 0 on every row)."""
    if bitdepth not in (8, 16):
        raise ValueError(f"bit depth {bitdepth}")
    img = np.asarray(image)
    if img.ndim != 2:
        raise ValueError(f"expected a (H, W) array, got {img.shape}")
    height, width = img.shape
    dtype = ">u2" if bitdepth == 16 else np.uint8
    rows = np.clip(img, 0, 2 ** bitdepth - 1).astype(dtype)
    raw = b"".join(b"\x00" + row.tobytes() for row in rows)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data)))

    ihdr = struct.pack(">IIBBBBB", width, height, bitdepth, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
