"""Spans, phase timers with rays/s accounting, and ray-survival statistics.

The reference's observability is wall-clock printfs around the kernel
loop (ref: parallel_ray_tracing.cu:3498-3684, batch_run_simulation.py:53).
Here: named spans of the program's work (:func:`span`), which a
``torch.profiler`` session records on the clock of its device records and
which cost one boolean test otherwise; lightweight host-clock phase timers
that synchronise the CUDA device at each phase end, so a phase's time
includes the device work it enqueued; an optional ``torch.profiler`` trace
context for per-kernel analysis; and a count of the rays that survive a
trace (the reference's NaN-culled rays, counted instead of printf'd).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the work inside it as the span
    ``name`` (dotted by layer: ``invert.backward``, ``render.chunk``).

    With a ``torch.profiler`` session active it is a
    ``torch.profiler.record_function`` range, on the same clock as the
    session's kernels and copies, nested in the ranges that enclose it.
    Without one it is a shared no-op context: one boolean test, no range,
    no device synchronisation, nothing allocated."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@dataclass
class PhaseTimer:
    """Accumulating phase timer with optional ray throughput.

    ``device``: when it is a CUDA device, ``torch.cuda.synchronize`` runs
    before a phase's clock is read.  A phase is also the span
    ``pipeline.<name>``, its ``:suffix`` dropped (``render:frame_0001`` is
    ``pipeline.render``).
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
            with span("pipeline." + name.partition(":")[0]):
                try:
                    yield
                finally:
                    self._sync()
        finally:
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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace context: the host's operations and, where a
    CUDA device is present, its kernels and copies; on exit the trace is
    written into ``log_dir`` as ``<worker>.<time>.pt.trace.json`` (view it
    with Perfetto, chrome://tracing or TensorBoard's profiler plugin).
    The program's spans (:func:`span`) show in it beside the kernels they
    launched.  Yields the profiler (``key_averages()`` for sums by
    kernel)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def ray_statistics(rays) -> Dict[str, float]:
    """Survival accounting for a traced RayBundle: the reference poisons
    culled rays with NaN, so a ray survives where its position is finite.
    Counted on the bundle's device; returns Python floats."""
    n = int(rays.pos.shape[0])
    surviving = int(torch.isfinite(rays.pos).all(dim=-1).sum())
    return {
        "total_rays": float(n),
        "surviving": float(surviving),
        "survival_fraction": surviving / n if n else 0.0,
    }
