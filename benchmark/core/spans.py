"""The program's own spans in a traced window, and what the card did inside
them.

The program marks its work with ``torch.profiler`` ranges named by layer
(``pipeline.``, ``invert.``, ``volume.``, ``render.``: the spans of
``photon_tpu_torch.utils.profiling.span``), so they lie on the clock of the
device records.  From the window's profiler this module reads:

* the spans, as host intervals;
* each device operation's span: the innermost span whose host interval
  holds the runtime call that launched it (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ..., found by correlation id), whatever thread made
  that call: autograd launches a backward's kernels from a thread of its
  own while the caller waits inside ``invert.backward``;
* each idle gap of the window, put down to the innermost span the host was
  in when the gap began (the rule ``trace.breakdown`` applies to the
  harness's spans);
* the program's chunk counter, ``render_image_fast.chunks``, over the
  window.

:func:`attach` wraps ``trace.session`` so that the reading of each traced
session is kept here; the traced window imports every file of ``counts/``
before it opens its session, and ``counts/render_chunk.py`` attaches it
then.  A program without the spans or the counter reads as empty, and the
metrics that read it are left out.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import sys
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from benchmark.core import trace as T

PREFIXES = ("pipeline.", "invert.", "volume.", "render.")


def innermost(spans: Sequence[Tuple[float, float, str]],
              times: Sequence[float]) -> List[Optional[str]]:
    """For each of ``times``, the name of the innermost of ``spans``
    ((start, end, name)) that holds it, the latest to start of those that
    hold it, or None where none does.  The spans may come from any
    thread."""
    spans = sorted(spans, key=lambda sp: sp[0])
    out: List[Optional[str]] = [None] * len(times)
    stack: list = []
    i = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            stack.append(spans[i])
            i += 1
        # every span above the top was closed when it was popped, so the
        # top is the latest to start of the spans still open
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def _merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals,
    with the covered length before each."""
    out, before, total = [], [], 0.0
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                total += e - out[-1][1]
                out[-1][1] = e
        else:
            out.append([s, e])
            before.append(total)
            total += e - s
    return out, before


def _covered(merged, before, starts, s, e) -> float:
    """The length of [s, e] that a :func:`_merged` union covers;
    ``starts``: its intervals' starts."""
    def upto(t):
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0.0
        a, b = merged[k - 1]
        return before[k - 1] + min(t, b) - a
    return max(0.0, upto(e) - upto(s))


@dataclass
class SpanReading:
    """What the program's spans show of one traced window (seconds on the
    profiler's clock)."""
    spans: list          # (start, end, name) of the program's spans
    ops: list            # (start, end, name, span or None): device ops in
    #                      the window, clipped to it, with their span
    gaps: list           # (start, end, span or None): the window's idle gaps
    chunks: Optional[int] = None    # render_image_fast.chunks; None where
    #                                 the program has no such counter
    trace_device_s: Optional[float] = None   # the trace's own device
    #                                          records in the window

    def count(self, name: str) -> int:
        return sum(1 for _, _, n in self.spans if n == name)

    def host_s(self, name: str) -> float:
        return sum(e - s for s, e, n in self.spans if n == name)

    def device_s(self, span: Optional[str],
                 keep: Callable[[str], bool] = lambda name: True) -> float:
        """Device seconds of the operations launched inside ``span`` (and
        inside no span within it); None: those launched inside none."""
        return sum(e - s for s, e, name, sp in self.ops
                   if sp == span and keep(name))

    def device_total_s(self) -> float:
        return sum(e - s for s, e, _, _ in self.ops)

    def idle_inside(self, name: str) -> Tuple[float, float]:
        """(seconds in which the card ran nothing, seconds) summed over the
        host intervals of the spans ``name``."""
        merged, before = _merged([(s, e) for s, e, _, _ in self.ops])
        starts = [a for a, _ in merged]
        idle = total = 0.0
        for s, e, n in self.spans:
            if n != name:
                continue
            total += e - s
            idle += (e - s) - _covered(merged, before, starts, s, e)
        return idle, total

    def idle_from(self, prefix: str) -> float:
        """Seconds of the window's idle gaps that began inside a span whose
        name starts with ``prefix``."""
        return sum(b - a for a, b, sp in self.gaps
                   if sp is not None and sp.startswith(prefix))

    def by_span_ms(self) -> dict:
        out: dict = {}
        for s, e, _, sp in self.ops:
            out[sp or "(none)"] = out.get(sp or "(none)", 0.0) + 1e3 * (e - s)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _on_device(ev) -> bool:
    return "CUDA" in str(ev.device_type()).upper()


def from_events(events, trace_start_ns: int, window, skip=()) -> SpanReading:
    """A :class:`SpanReading` from a profiler session's kineto events
    (``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``correlation_id()``, ``linked_correlation_id()``,
    ``is_user_annotation()``).  ``window``: (start, end) s on the
    profiler's clock; ``skip``: the harness's own range names.

    A device operation's launch is the runtime call of the same
    correlation id, else the host operation it is linked to; an operation
    with neither has no span."""
    spans, raw = [], []
    runtime, host_ops = {}, {}
    for ev in events:
        name = ev.name()
        s = (ev.start_ns() - trace_start_ns) / 1e9
        e = s + ev.duration_ns() / 1e9
        if _on_device(ev):
            if (ev.is_user_annotation() or T.SPIN in name
                    or name == T.WINDOW or name in skip):
                continue
            raw.append((s, e, name, ev.correlation_id(),
                        ev.linked_correlation_id()))
        elif name.startswith(PREFIXES):
            spans.append((s, e, name))
        elif name.startswith("cu"):
            runtime.setdefault(ev.correlation_id(), s)
        else:
            host_ops.setdefault(ev.correlation_id(), s)
    w0, w1 = window if window is not None else (float("-inf"),
                                                float("inf"))
    raw = [(max(s, w0), min(e, w1), name, c, lc) for s, e, name, c, lc in raw
           if e > w0 and s < w1]
    launch = [runtime[c] if c in runtime
              else host_ops.get(lc) if lc > 0 else None
              for _, _, _, c, lc in raw]
    known = [k for k, t in enumerate(launch) if t is not None]
    names = innermost(spans, [launch[k] for k in known])
    span_of: List[Optional[str]] = [None] * len(raw)
    for k, n in zip(known, names):
        span_of[k] = n
    ops = [(s, e, name, sp) for (s, e, name, _, _), sp in zip(raw, span_of)]
    gaps = []
    if window is not None:
        found = T.gaps([(s, e) for s, e, _, _ in ops], w0, w1)
        gaps = [(a, b, n) for (a, b), n in
                zip(found, innermost(spans, [a for a, _ in found]))]
    spans.sort()
    return SpanReading(spans=spans, ops=ops, gaps=gaps)


def _chunk_counter():
    """``render_image_fast``, which carries the program's chunk counter, or
    None where the program has no such counter."""
    from photon_tpu_torch.models.render_fast import render_image_fast
    return render_image_fast if hasattr(render_image_fast, "chunks") else None


def read(prof, window, skip=(), chunks=None) -> SpanReading:
    """The reading of a finished ``torch.profiler`` session, and the
    trace's own device records in the window for the check that every
    device operation was counted once."""
    res = prof.profiler.kineto_results
    sr = from_events(res.events(), res.trace_start_ns(), window, skip)
    sr.chunks = chunks
    w0, w1 = window if window is not None else (float("-inf"),
                                                float("inf"))
    sr.trace_device_s = sum(min(e, w1) - max(s, w0) for s, e, _ in
                            T._device_intervals(prof, skip)
                            if e > w0 and s < w1)
    return sr


def summary(sr: SpanReading) -> dict:
    """Device ms by span, and the check of the sum against the trace."""
    total = sr.device_total_s()
    ref = sr.trace_device_s
    return {"device_ms_by_span": {k: round(v, 3) for k, v in
                                  list(sr.by_span_ms().items())[:16]},
            "attributed_ms": round(1e3 * (total - sr.device_s(None)), 3),
            "unattributed_ms": round(1e3 * sr.device_s(None), 3),
            "trace_device_ms": None if ref is None else round(1e3 * ref, 3),
            "spans": len(sr.spans), "chunks": sr.chunks}


_last: Optional[SpanReading] = None


def attach() -> None:
    """Wrap ``trace.session`` (once) so that each traced session resets the
    program's chunk counter when it opens and keeps its reading here when it
    closes.  What the session yields and computes is left as it was; a
    session whose spans cannot be read keeps nothing, and says why on
    standard error."""
    if getattr(T.session, "keeps_spans", False):
        return
    opened = T.session

    @contextlib.contextmanager
    def session(torch, dev, span_names):
        global _last
        _last = None
        counter = _chunk_counter()
        if counter is not None:
            counter.chunks = 0
        with opened(torch, dev, span_names) as box:
            yield box
        try:
            _last = read(box["prof"], box["window"], tuple(span_names),
                         None if counter is None else int(counter.chunks))
            print("spans: " + json.dumps(summary(_last)), file=sys.stderr)
        except Exception as exc:      # the metrics that read it go out
            print(f"spans: the program's spans were not read: {exc!r}",
                  file=sys.stderr)

    session.keeps_spans = True
    T.session = session


def of(reading) -> Optional[SpanReading]:
    """The spans of the window ``reading`` holds: its ``spans`` where it
    has them, else the reading of the last traced session (then kept on
    it)."""
    sr = getattr(reading, "spans", None)
    if sr is None:
        sr = _last
        reading.spans = sr
    return sr


def steps(sr: Optional[SpanReading], reading) -> int:
    """The window's inversion steps where its ``invert.step`` spans are as
    many, else 0."""
    if sr is None or not reading.units:
        return 0
    n = sr.count("invert.step")
    return n if n == int(reading.units) else 0


def chunks_held(sr: Optional[SpanReading]) -> bool:
    """Whether the window's ``render.chunk`` spans are as many as the
    program counted chunks, and there were some."""
    return (sr is not None and sr.chunks is not None and sr.chunks > 0
            and sr.count("render.chunk") == sr.chunks)
