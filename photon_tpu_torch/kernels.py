"""Building and loading the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header (only the ``csrc/*.cuh`` headers beside it), so ``nvcc`` builds it in
seconds.  A source is compiled into its
own shared library under ``photon_tpu_torch/build/`` the first time one of
its kernels is launched (never at import: machines without ``nvcc`` import
and run the package on the CPU), and loaded with ``ctypes``.  The library's
name carries a hash of its source, the headers and the flags, so an edited
source rebuilds.
A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# per-source additions.  The fan forward (fan_stats.cu) is built without FMA
# contraction, so that every product and sum rounds as in the plain version
# (which cannot contract) and the image agrees with the plain render to the
# order of the sums: contracted, the thick lens's discriminant
# beta^2 - 4 gamma, formed from coordinates of 1e5..1e8 um in f32, moved the
# ray centroids by ~0.03 px.  The fan backward (fan_stats_bwd.cu) is built
# with contraction: it traces each ray with the forward's own path, whose
# rounding fan_common.cuh pins with intrinsics, and pins the cotangents that
# cancel in the same way; the rest of its sweep contracts.  The volume
# preparation (volume_prep.cu) is built without contraction for the same
# reason: its gradient precompute is then bit-equal to the plain version's
# float64 stencil, and its prefilter rounds as the plain version's float32
# recurrence.
EXTRA_NVCC_FLAGS: Dict[str, List[str]] = {"fan_stats": ["-fmad=false"],
                                          "volume_prep": ["-fmad=false"]}

_vp, _i, _ll, _f, _d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float, ctypes.c_double)

# source name -> {C function: argtypes}; every function returns an int
# (cudaGetLastError() after its launch)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "march_dense": {
        "photon_march_dense": [_vp] * 8 + [_ll, _i, _i, _i, _vp, _i, _i, _i,
                                           _vp],
        "photon_march_dense_grad": [_vp] * 5 + [_ll, _i, _i, _i, _vp, _i, _i,
                                                _vp],
        "photon_march_stagewise": [_vp] * 10 + [_ll, _i, _i, _i, _vp, _i, _i,
                                                _i, _vp],
    },
    "march_bwd": {
        "photon_march_bwd_stage": [_vp] * 7 + [_ll, _i, _i, _i, _vp, _i, _i,
                                               _vp],
        "photon_march_bwd_remarch": [_vp] * 7 + [_ll, _i, _i, _i, _vp, _i, _i,
                                                 _i, _vp],
        "photon_march_stagewise_bwd": [_vp] * 7 + [_ll, _i, _i, _i, _vp, _i,
                                                   _i, _i, _vp],
    },
    "slab_sample": {
        "photon_slab_sample": [_vp] * 6 + [_ll, _i, _i, _i, _vp],
        "photon_slab_sample_bwd": [_vp] * 9 + [_ll, _i, _i, _i, _vp],
    },
    "fan_stats": {
        "photon_fan_const_floats": [],
        "photon_fan_stats": [_vp] * 13 + [_ll, _i, _vp, _i, _i, _i, _vp],
    },
    "fan_stats_bwd": {
        "photon_fan_bwd_const_floats": [],
        "photon_fan_stats_bwd": [_vp] * 14 + [_ll, _i, _vp, _i, _i, _i, _vp],
    },
    "splat": {
        "photon_splat": [_vp] * 6 + [_ll, _i, _i, _i, _f, _f, _vp],
        "photon_splat_bwd": [_vp] * 7 + [_ll, _i, _i, _i, _f, _f, _vp],
    },
    "volume_prep": {
        "photon_gradient_field": [_vp, _vp, _ll, _ll, _ll, _d, _d, _d, _ll,
                                  _vp],
        "photon_gradient_field_transpose": [_vp, _vp, _ll, _ll, _ll, _d, _d,
                                            _d, _d, _ll, _vp],
        "photon_bspline_prefilter": [_vp, _vp] + [_ll] * 4 + [_vp] * 3,
        "photon_bspline_prefilter_bwd": [_vp, _vp] + [_ll] * 4 + [_vp] * 3,
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0      # wall time spent in nvcc by this process


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of photon_tpu_torch are "
        "built from csrc/ at first launch and need the CUDA toolkit")


def _source(name: str) -> Path:
    if name not in SIGNATURES:
        raise KeyError(f"unknown kernel source {name!r}")
    return CSRC_DIR / f"{name}.cu"


def nvcc_flags(name: str) -> List[str]:
    return NVCC_FLAGS + EXTRA_NVCC_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    h = hashlib.sha1(_source(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> List[Path]:
    """Compile the named sources that have no current library, one ``nvcc``
    each, all started together.  Raises if any build fails."""
    global build_seconds
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return []
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp), str(_source(name))]
        procs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            if tmp.exists():
                tmp.unlink()
        else:
            os.replace(tmp, out)
    build_seconds += time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return [out for _, out in todo]


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be, with the
    argument types of its functions set."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a kernel's launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {code})")


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_kernel_input(name: str, t, device=None, dtype=None) -> None:
    """What every wrapper demands of a tensor it hands to a kernel."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
