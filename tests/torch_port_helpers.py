"""Shared helpers of the tests/test_torch_*.py parity tests.

State crosses from the JAX package to the port as numpy arrays and plain
dicts (``photon_tpu_torch.compat.from_reference``); the unpacking on the
JAX side happens here.
"""
import dataclasses
import json

import numpy as np

from photon_tpu_torch.compat import from_reference


def port_volume(jax_vol, device="cpu"):
    state = {k: (np.asarray(v) if hasattr(v, "shape") else float(v))
             for k, v in jax_vol._asdict().items()}
    return from_reference(volume=state, device=device)["volume"]


def port_source(jax_source):
    return from_reference(source=dataclasses.asdict(jax_source),
                          device="cpu")["source"]


def port_config(jax_cfg):
    return from_reference(config=json.loads(jax_cfg.to_json()),
                          device="cpu")["config"]


def rel_l1(a, b):
    """L1 distance of two images relative to the reference's sum."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())
