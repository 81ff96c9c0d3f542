"""Device ms a step of the operations launched inside the program's
``invert.backward`` span (``torch.autograd.grad``) that are not the port's
own kernels (every ``__global__`` of ``photon_tpu_torch/csrc``, as
``torch_ops_ms.invert`` tells them apart): the stencil's transpose, the
layout copies and the adds that accumulate them.  Left out where the
window's ``invert.step`` spans are not as many as its steps."""
from benchmark.core import spans
from benchmark.core.device import port_kernel_names
from benchmark.core.spec import ROOT


def read(reading):
    sr = spans.of(reading)
    n = spans.steps(sr, reading)
    if not n:
        return None
    own = port_kernel_names(ROOT / "photon_tpu_torch" / "csrc")
    s = sr.device_s("invert.backward",
                    keep=lambda name: not any(k in name for k in own))
    return 1e3 * s / n if s > 0 else None
