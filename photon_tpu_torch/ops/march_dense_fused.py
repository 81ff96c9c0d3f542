"""The dense chief-ray march as one CUDA kernel, and its wrapper.

Kernel: ``csrc/march_dense.cu`` (``photon_march_dense``).  It replaces the
TPU kernel ``photon_tpu/ops/march_dense_fused.py::_fused_kernel_impl`` (the
forward head without the stage-state output, trilinear scheme).  The TPU
kernel contracts dense interpolation weights against packed slab pairs on
the matrix unit; on a GPU one thread owns one ray, keeps its state in
registers through all slabs, and gathers eight 16-byte voxels per
integrator stage from the (D, H, W, 4) field, which an H100 serves from L2.
Bound on the card: f32 operations and dependent-load latency (48 bytes a
ray and one pass over the field are all the bytes it must move); the
design answers with one thread a ray and neighbouring rays on neighbouring
voxels.  No slab packing, no block table, no padding rows, no bf16 passes.

Not in this slice: tricubic (scheme 2) and the stage-state residual of the
``_traj`` head, which the backward kernels need (ROADMAP.md).

Plain version: ``march_dense.march_chief_dense`` (re-exported here as
``march_chief_plain``).  ``march_chief_fused.launches`` counts kernel
launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import kernels
from photon_tpu_torch.ops.march_dense import (check_march_options,
                                              march_chief_dense,
                                              march_geometry,
                                              resolve_substeps)
from photon_tpu_torch.volume import DensityVolume

march_chief_plain = march_chief_dense


def march_chief_fused(vol: DensityVolume, xs, ys, zs, dcx, dcy, dcz, *,
                      algorithm: int = 2, interpolation_scheme: int = 1,
                      substeps: Optional[int] = None):
    """March (P,) chief rays through the volume.

    Same contract as :func:`march_dense.march_chief_dense`: (P,) float32
    chief states in, ``(x, y, z, dirx, diry, dirz)`` after traversal out;
    rays that miss the volume pass through unchanged.  Tensors on a CUDA
    device go to the kernel; tensors on the CPU go to the plain version.
    Forward only: an input that requires grad raises.
    """
    check_march_options(algorithm, interpolation_scheme)
    dev = vol.field.device
    rays = (xs, ys, zs, dcx, dcy, dcz)
    names = ("xs", "ys", "zs", "dcx", "dcy", "dcz")
    kernels.check_kernel_input("vol.field", vol.field, dev, torch.float32)
    for name, t in zip(names, rays):
        kernels.check_kernel_input(name, t, dev, torch.float32)
        if t.shape != xs.shape or t.dim() != 1:
            raise ValueError(f"{name}: expected shape {tuple(xs.shape)}, "
                             f"got {tuple(t.shape)}")
    if dev.type == "cpu":
        return march_chief_dense(vol, *rays, algorithm=algorithm,
                                 interpolation_scheme=interpolation_scheme,
                                 substeps=substeps)

    P = xs.shape[0]
    out = torch.empty((6, P), dtype=torch.float32, device=dev)
    if P == 0:
        return tuple(out.unbind(0))
    w, h, d = (int(s) for s in vol.sizes)
    geom = np.asarray(march_geometry(vol), dtype=np.float32)
    lib = kernels.load("march_dense")
    with torch.cuda.device(dev):
        code = lib.photon_march_dense(
            *(t.data_ptr() for t in rays), vol.field.data_ptr(),
            out.data_ptr(), P, w, h, d, geom.ctypes.data, int(algorithm),
            resolve_substeps(algorithm, substeps),
            kernels.current_stream(dev))
    kernels.check_launch(code, "photon_march_dense")
    march_chief_fused.launches += 1
    return tuple(out.unbind(0))


march_chief_fused.launches = 0
