"""The port's device rule.

``device=None`` means the card.  An entry point called without a device on
a machine where ``torch.cuda.is_available()`` is false raises; it never
falls back to the CPU on its own.  Tests pass ``device="cpu"``, which sends
every kernel wrapper to its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "photon_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_f32(a, device: torch.device) -> torch.Tensor:
    """numpy / tensor / sequence -> contiguous float32 tensor on ``device``.

    Every float64 numpy array is cast here, explicitly, before it meets a
    tensor (the JAX package runs with x64 off, so its arrays are f32)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    # np.array copies: the tensor never aliases (possibly read-only) input
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)
