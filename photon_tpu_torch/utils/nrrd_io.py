"""Minimal NRRD reader/writer.

The reference uses the teem C library (``loadNRRD`` in
``cuda_codes/trace_rays_through_density_gradients.h:1663-1817``) to read
density volumes, and pynrrd (``python_codes/nrrd_functions.py``,
``synthetic_fields.py:157-190``) to write them.  Neither is available here,
so this is a small self-contained implementation of the subset of NRRD
actually exercised: 3-D float32 raw/gzip volumes with ``spacings`` and
``space origin`` headers.

Own copy of the JAX package's pure-Python reader/writer (numpy only), so
that volumes written by either package load in the other.
"""
from __future__ import annotations

import gzip
import io
import zlib
from typing import Dict, Tuple

import numpy as np

_NRRD_TYPES = {
    "float": np.float32, "f4": np.float32, "float32": np.float32,
    "double": np.float64, "f8": np.float64, "float64": np.float64,
    "short": np.int16, "int16": np.int16,
    "ushort": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uchar": np.uint8, "uint8": np.uint8,
}

_INV_TYPES = {np.dtype(np.float32): "float", np.dtype(np.float64): "double",
              np.dtype(np.int16): "short", np.dtype(np.uint16): "ushort",
              np.dtype(np.int32): "int", np.dtype(np.uint8): "uchar"}


def _parse_vector(s: str) -> np.ndarray:
    s = s.strip().lstrip("(").rstrip(")")
    parts = [p for p in s.replace(",", " ").split() if p]
    return np.array([float(p) for p in parts])


def read_nrrd(path: str) -> Tuple[np.ndarray, Dict]:
    """Read an NRRD file.

    Returns ``(data, header)`` where ``data`` has shape ``(sizes[0],
    sizes[1], sizes[2])`` with axis 0 the *fastest-varying* axis on disk —
    the same axis convention as pynrrd and as teem's ``nrrd->axis[0]``
    (ref: trace_rays_through_density_gradients.h:1688-1690, where axis[0]
    is called x).  ``header`` holds 'sizes', 'spacings', 'space origin',
    'type' and any other key/value fields found.
    """
    with open(path, "rb") as f:
        raw = f.read()

    # header is text up to the first blank line
    end = raw.find(b"\n\n")
    if end < 0:
        raise ValueError(f"{path}: no NRRD header terminator found")
    header_text = raw[: end].decode("ascii", errors="replace")
    payload = raw[end + 2:]

    lines = header_text.splitlines()
    if not lines or not lines[0].startswith("NRRD"):
        raise ValueError(f"{path}: not an NRRD file")

    header: Dict = {}
    for line in lines[1:]:
        if line.startswith("#") or not line.strip():
            continue
        if ":" not in line:
            continue
        key, _, value = line.partition(":")
        header[key.strip().lower()] = value.lstrip("= ").strip()

    sizes = [int(v) for v in header["sizes"].split()]
    dtype = _NRRD_TYPES[header["type"].strip()]
    encoding = header.get("encoding", "raw").strip()
    endian = header.get("endian", "little").strip()

    if encoding == "raw":
        buf = payload
    elif encoding in ("gzip", "gz"):
        buf = gzip.decompress(payload)
    elif encoding in ("zlib",):
        buf = zlib.decompress(payload)
    elif encoding in ("ascii", "text", "txt"):
        data = np.loadtxt(io.StringIO(payload.decode())).astype(dtype)
        buf = data.tobytes()
    else:
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding!r}")

    count = int(np.prod(sizes))
    data = np.frombuffer(buf, dtype=dtype, count=count)
    if endian == "big":
        data = data.byteswap()
    # NRRD stores axis 0 fastest; numpy C-order stores the last axis fastest,
    # so read as reversed shape then transpose (pynrrd does the same).
    data = data.reshape(tuple(reversed(sizes))).transpose(
        tuple(reversed(range(len(sizes)))))

    out = {"sizes": np.array(sizes), "type": header["type"].strip()}
    if "spacings" in header:
        out["spacings"] = _parse_vector(header["spacings"])
    if "space origin" in header:
        out["space origin"] = _parse_vector(header["space origin"])
    if "space" in header:
        out["space"] = header["space"]
    return np.ascontiguousarray(data.astype(np.float32)
                                if dtype != np.float32 else data), out


def write_nrrd(path: str, data: np.ndarray, spacings, space_origin,
               space: str = "3D-right-handed") -> None:
    """Write a raw-encoded NRRD volume.

    Matches the header layout produced by the reference's ``save_nrrd``
    (ref: synthetic_fields.py:157-190): float32, raw encoding, ``spacings``
    and ``space origin`` fields, axis 0 fastest on disk.
    """
    data = np.asarray(data)
    dtype = np.dtype(data.dtype)
    if dtype not in _INV_TYPES:
        data = data.astype(np.float32)
        dtype = np.dtype(np.float32)
    sizes = data.shape
    spacings = np.asarray(spacings, dtype=float).ravel()
    space_origin = np.asarray(space_origin, dtype=float).ravel()

    header = [
        "NRRD0004",
        "# generated by photon_tpu_torch",
        f"type: {_INV_TYPES[dtype]}",
        f"dimension: {data.ndim}",
        f"space: {space}",
        "sizes: " + " ".join(str(s) for s in sizes),
        "spacings: " + " ".join(f"{s:.9g}" for s in spacings),
        "endian: little",
        "encoding: raw",
        "space origin: (" + ",".join(f"{s:.9g}" for s in space_origin) + ")",
        "",
        "",
    ]
    # axis 0 fastest on disk: transpose so numpy's C order writes it last
    on_disk = data.transpose(tuple(reversed(range(data.ndim))))
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(np.ascontiguousarray(on_disk).tobytes())
