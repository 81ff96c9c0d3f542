"""The traced window: a ``torch.profiler`` session over some requests, and
what the per-layer metrics read from it.

Copied from ``chip_smoke.py`` (``device_events``, ``held_to_counters``, the
spin kernels that open a session); the rest is the harness's own.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPIN_LAUNCHES = 16     # kernels that open each traced session
SPIN = "spin_kernel"


WINDOW = "bench.window"


def _annotation(ev, spans) -> bool:
    """A ``record_function`` range, which the trace also shows on the
    device; it is no operation of the device."""
    name = getattr(ev, "key", None) or ev.name
    return (bool(getattr(ev, "is_user_annotation", False))
            or name in spans or name == WINDOW)


def _on_device(ev) -> bool:
    return "CUDA" in str(getattr(ev, "device_type", "")).upper()


def device_events(prof, spans=()):
    """The device side of a torch.profiler trace (its key_averages()),
    without the spin kernels and the harness's own ranges."""
    return [ev for ev in prof.key_averages()
            if _on_device(ev) and SPIN not in ev.key
            and not _annotation(ev, spans)]


def held_to_counters(events, launches: Dict[str, int]):
    """Each kernel's device time in one trace, held to the launch counter of
    the same run: ``{tag: (ms in all, launches)}``, or None where the trace
    holds another number of launches of that kernel than its counter, or no
    time for a kernel that launched (a profiler can drop records).
    ``events``: the trace's device events (``key``, ``count``,
    ``self_device_time_total`` in us); ``launches``: {a part of a kernel's
    name that no other kernel's name holds: launches counted}."""
    out = {}
    for tag, n in launches.items():
        hit = [ev for ev in events if tag in ev.key]
        traced_n = sum(ev.count for ev in hit)
        us = sum(ev.self_device_time_total for ev in hit)
        out[tag] = ((us / 1e3, traced_n) if traced_n == n and (n == 0 or us > 0)
                    else None)
    return out


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], start: float, end: float):
    """The idle stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Reading:
    """What one traced window gives the per-layer metrics."""
    key_events: list                  # device key_averages, spins left out
    busy_s: float
    window_s: float
    requests: int
    units: float                      # steps or images completed
    counters: Dict[str, int]          # launches counted in the window
    shapes: Dict[str, dict]           # a kernel's shape a launch, by kernel
    phases: Dict[str, float]          # program_span seconds, summed
    breakdown: dict = field(default_factory=dict)

    def held(self, tag: str, counter: str) -> Optional[Tuple[float, int]]:
        """(device ms in all, launches) of a kernel, held to its counter."""
        n = self.counters.get(counter)
        if not n:
            return None
        return held_to_counters(self.key_events, {tag: n})[tag]


def _device_intervals(prof, spans):
    out = []
    for ev in prof.events():
        if not _on_device(ev) or SPIN in ev.name or _annotation(ev, spans):
            continue
        tr = ev.time_range
        if tr.end > tr.start:
            out.append((tr.start / 1e6, tr.end / 1e6, ev.name))
    return out


def _host_spans(prof, names):
    out = []
    for ev in prof.events():
        if ev.name in names and not _on_device(ev):
            tr = ev.time_range
            out.append((tr.start / 1e6, tr.end / 1e6, ev.name))
    return out


def breakdown(prof, key_events, span_names, window):
    """The ten device operations that took most time, and the ten longest
    idle gaps of the window, each labelled by the innermost harness span
    the host was in when it began and the device operation it followed."""
    ops = sorted(((ev.key, ev.self_device_time_total / 1e6)
                  for ev in key_events), key=lambda kv: -kv[1])[:10]
    dev = _device_intervals(prof, span_names)
    if not dev or window is None:
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": []}
    w0, w1 = window
    spans = sorted(_host_spans(prof, set(span_names)))
    by_end = sorted((e, n) for s, e, n in dev)
    ends = [e for e, _ in by_end]
    found = []
    for a, b in gaps([(s, e) for s, e, _ in dev if e > w0 and s < w1],
                     w0, w1):
        k = bisect.bisect_right(ends, a)
        after = by_end[k - 1][1][:60] if k else "the window's start"
        inner = "harness"
        for s, e, n in spans:
            if s > a:
                break
            if a < e:
                inner = n
        found.append((f"{inner} after {after}", b - a))
    found.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in found[:10]]}


@contextlib.contextmanager
def session(torch, dev, span_names):
    """A profiler session opened with the spin kernels; yields a dict that
    receives ``prof`` and, after the ``with``, ``window`` (the profiler's
    clock at the two ends of the ``bench.window`` span, in s) and
    ``busy_s``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    box = {}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a session can lose its first device records: spend them on
        # spin kernels that no reading counts
        if dev.type == "cuda":
            for _ in range(SPIN_LAUNCHES):
                torch.cuda._sleep(100)
            torch.cuda.synchronize(dev)
        with record_function(WINDOW):
            yield box
    box["prof"] = prof
    win = _host_spans(prof, {WINDOW})
    box["window"] = (win[0][0], win[0][1]) if win else None
    dev_iv = [(s, e) for s, e, _ in _device_intervals(prof, span_names)]
    if box["window"] is not None:
        w0, w1 = box["window"]
        dev_iv = [(max(s, w0), min(e, w1)) for s, e in dev_iv
                  if e > w0 and s < w1]
    box["busy_s"] = union_seconds(dev_iv)
