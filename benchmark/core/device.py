"""What a run checks of its process, and the names of the port's own
kernels."""
from __future__ import annotations

import re
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "photon_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: ``photon_tpu_torch`` passes."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def port_kernel_names(csrc: Path):
    """The names of the port's own kernels: every ``__global__`` function
    of its CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)")
    names = set()
    for f in sorted(Path(csrc).glob("*.cu")):
        names.update(pat.findall(f.read_text()))
    return sorted(names)
