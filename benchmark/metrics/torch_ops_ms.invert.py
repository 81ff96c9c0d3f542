"""Device ms a step in operations that are not the port's own kernels
(every ``__global__`` of ``photon_tpu_torch/csrc``): PyTorch's kernels of
``volume_from_rho``, its transpose and Adam, and the copies and fills,
taken by name from the traced window."""
from benchmark.core.device import port_kernel_names
from benchmark.core.spec import ROOT


def read(reading):
    if not reading.units:
        return None
    own = port_kernel_names(ROOT / "photon_tpu_torch" / "csrc")
    us = sum(ev.self_device_time_total for ev in reading.key_events
             if not any(k in ev.key for k in own))
    return us / 1e3 / reading.units if us > 0 else None
