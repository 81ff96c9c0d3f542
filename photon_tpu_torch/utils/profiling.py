"""Phase timers with rays/s accounting.

The reference's observability is wall-clock printfs around the kernel
loop (ref: parallel_ray_tracing.cu:3498-3684, batch_run_simulation.py:53).
Here: lightweight host-clock phase timers that synchronise the CUDA device
at each phase end, so a phase's time includes the device work it enqueued.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


@dataclass
class PhaseTimer:
    """Accumulating phase timer with optional ray throughput.

    ``device``: when it is a CUDA device, ``torch.cuda.synchronize`` runs
    before a phase's clock is read.
    """

    device: Optional[torch.device] = None
    phases: Dict[str, float] = field(default_factory=dict)
    rays: Dict[str, int] = field(default_factory=dict)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, num_rays: Optional[int] = None):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if num_rays:
                self.rays[name] = self.rays.get(name, 0) + int(num_rays)

    def report(self) -> str:
        lines = []
        for name, dt in self.phases.items():
            extra = ""
            if name in self.rays and dt > 0:
                extra = f"  {self.rays[name] / dt / 1e6:.2f}M rays/s"
            lines.append(f"{name}: {dt:.3f}s{extra}")
        return "\n".join(lines)
