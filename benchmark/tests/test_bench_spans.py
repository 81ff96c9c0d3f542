"""``core/spans.py`` on synthetic profiler events, the seven readers of the
program's spans on synthetic readings, and a traced run of the harness on
the CPU that reads the program's spans through the session it wraps."""
import time

import pytest
import torch

from benchmark import run
from benchmark.core import spans as SP
from benchmark.core import spec as S
from benchmark.core import trace as T
from benchmark.core.device import port_kernel_names
from benchmark.tests.test_bench_faults import CASES

SPEC = S.load_spec()
US = 1000          # ns in a us


class Ev:
    """A kineto event as ``torch.profiler`` gives it, times in us."""

    def __init__(self, name, start, dur, device=False, corr=0, linked=0,
                 thread=1, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._corr, self._linked = device, corr, linked
        self._thread, self._annotation = thread, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def start_ns(self):
        return 5_000_000 + self._start * US

    def duration_ns(self):
        return self._dur * US

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation


def kernel(name, start, dur, corr, linked=0):
    return Ev(name, start, dur, device=True, corr=corr, linked=linked)


def launch(start, corr, thread=1, name="cudaLaunchKernel"):
    return Ev(name, start, 2, corr=corr, thread=thread)


def solve_events():
    """One step: the field's rebuild, a backward whose kernels autograd's
    own thread launches while the caller waits, Adam; a kernel launched
    outside every span, one whose launch the trace lost, and the ranges
    and spin kernels that are no operation."""
    return [
        Ev("invert.step", 0, 100), Ev("invert.volume_from_rho", 5, 15),
        Ev("invert.backward", 30, 40), Ev("invert.adam", 75, 15),
        Ev("aten::add", 85, 3, corr=77),
        launch(10, 1), kernel("elementwise_kernel", 12, 28, 1),
        launch(50, 2, thread=2), kernel("CatArrayBatchedCopy", 52, 8, 2),
        launch(61, 3, thread=2), kernel("march_bwd_stage_kernel", 62, 6, 3),
        launch(80, 4), kernel("vectorized_elementwise_kernel", 82, 4, 4),
        kernel("vectorized_elementwise_kernel", 87, 2, 5, linked=77),
        launch(95, 6, name="cudaMemcpyAsync"),
        kernel("Memcpy DtoH (Device -> Pageable)", 96, 10, 6),
        launch(150, 7), kernel("elementwise_kernel", 151, 9, 7),
        kernel("elementwise_kernel", 170, 5, 8),
        # ranges on the device, which the trace also shows: no operation
        Ev("invert.step", 1, 99, device=True, annotation=True),
        Ev("solve", 0, 200, device=True),
        Ev(T.SPIN, 0, 1, device=True, corr=99),
    ]


@pytest.fixture
def solve():
    return SP.from_events(solve_events(), 5_000_000, (0.0, 200e-6),
                          skip=("solve",))


def test_each_operation_goes_to_the_innermost_span_of_its_launch(solve):
    got = [(name, sp) for _, _, name, sp in solve.ops]
    assert got == [
        ("elementwise_kernel", "invert.volume_from_rho"),
        # launched from another thread while the caller waits inside
        ("CatArrayBatchedCopy", "invert.backward"),
        ("march_bwd_stage_kernel", "invert.backward"),
        ("vectorized_elementwise_kernel", "invert.adam"),
        # no runtime call: the host operation it is linked to
        ("vectorized_elementwise_kernel", "invert.adam"),
        # inside the step and inside none of its parts
        ("Memcpy DtoH (Device -> Pageable)", "invert.step"),
        ("elementwise_kernel", None),          # launched outside every span
        ("elementwise_kernel", None)]          # its launch is not traced


def test_attributed_and_unattributed_make_the_whole(solve):
    total = solve.device_total_s()
    assert total == pytest.approx((28 + 8 + 6 + 4 + 2 + 10 + 9 + 5) * 1e-6)
    named = sum(solve.device_s(n) for n in {sp for *_, sp in solve.ops
                                            if sp is not None})
    assert named + solve.device_s(None) == pytest.approx(total)
    assert solve.device_s(None) == pytest.approx(14e-6)
    own = port_kernel_names(S.ROOT / "photon_tpu_torch" / "csrc")
    assert "march_bwd_stage_kernel" in own
    torch_only = solve.device_s(
        "invert.backward", keep=lambda n: not any(k in n for k in own))
    assert torch_only == pytest.approx(8e-6)


def test_idle_gaps_go_to_the_span_the_host_was_in(solve):
    gaps = [(round(a * 1e6), round(b * 1e6), sp) for a, b, sp in solve.gaps]
    assert gaps == [(0, 12, "invert.step"), (40, 52, "invert.backward"),
                    (60, 62, "invert.backward"), (68, 82, "invert.backward"),
                    (86, 87, "invert.adam"), (89, 96, "invert.adam"),
                    (106, 151, None), (160, 170, None), (175, 200, None)]
    assert solve.idle_from("invert.") == pytest.approx(48e-6)
    # the step's host time in which the card ran nothing
    idle, total = solve.idle_inside("invert.step")
    assert total == pytest.approx(100e-6)
    assert idle == pytest.approx((12 + 12 + 2 + 14 + 1 + 7) * 1e-6)


def test_the_window_clips_what_it_reads():
    sr = SP.from_events(solve_events(), 5_000_000, (20e-6, 90e-6),
                        skip=("solve",))
    assert [round((e - s) * 1e6) for s, e, _, _ in sr.ops] == [20, 8, 6, 4,
                                                               2]


def test_innermost_of_spans_that_overlap_without_nesting():
    spans = [(0, 10, "a"), (2, 4, "b"), (3, 12, "c"), (11, 20, "d")]
    assert SP.innermost(spans, [1, 3.5, 5, 11, 13, 25, 2]) == [
        "a", "c", "c", "d", "d", None, "b"]


def reading(sr, units=0, requests=1):
    r = T.Reading(key_events=[], busy_s=0.0, window_s=1.0,
                  requests=requests, units=units, counters={}, shapes={},
                  phases={})
    r.spans = sr
    return r


def metric(name, r):
    return S.module("metrics", name).read(r)


def test_inversion_readers(solve):
    r = reading(solve, units=1)
    assert metric("volume_from_rho_ms.invert", r) == pytest.approx(28e-3)
    assert metric("backward_torch_ms.invert", r) == pytest.approx(8e-3)
    assert metric("adam_ms.invert", r) == pytest.approx(6e-3)
    # a window whose steps the spans do not match leaves them out
    for name in ("volume_from_rho_ms.invert", "backward_torch_ms.invert",
                 "adam_ms.invert"):
        assert metric(name, reading(solve, units=2)) is None
        assert metric(name, reading(None, units=1)) is None


def test_solve_tail_reader():
    spans = [(0.0, 1.0, "invert.step"), (1.0, 1.25, "invert.result_volume"),
             (1.25, 1.5, "invert.rho_to_host")]
    sr = SP.SpanReading(spans=spans, ops=[], gaps=[])
    assert metric("solve_tail_ms.invert", reading(sr)) == pytest.approx(500)
    cut = SP.SpanReading(spans=spans[:2], ops=[], gaps=[])
    assert metric("solve_tail_ms.invert", reading(cut)) is None
    none = SP.SpanReading(spans=spans[:1], ops=[], gaps=[])
    assert metric("solve_tail_ms.invert", reading(none)) is None


def render_reading(chunks=2, builds=1):
    spans = ([(0.0, 0.1, "volume.build"), (0.05, 0.1, "volume.data_min")]
             * builds
             + [(0.1, 1.0, "render.image"), (0.1, 0.2, "render.setup"),
                (0.2, 0.5, "render.chunk"), (0.5, 0.9, "render.chunk")])
    ops = [(0.0, 0.05, "gradient_kernel", "volume.gradient"),
           (0.3, 0.6, "fan_stats_kernel", "render.chunk")]
    gaps = [(0.05, 0.3, "volume.data_min"), (0.6, 1.0, "render.chunk")]
    return SP.SpanReading(spans=spans, ops=ops, gaps=gaps, chunks=chunks)


def test_render_readers():
    sr = render_reading()
    assert metric("chunk_host_us.piv", reading(sr)) == pytest.approx(3.5e5)
    assert metric("render_idle_pct.images", reading(sr)) == pytest.approx(
        100 * 0.6 / 0.9)
    assert metric("volume_idle_ms.images", reading(sr)) == pytest.approx(250)
    # spans against their counters: left out where they differ, and where
    # the program has no counter (the parent's)
    for bad in (render_reading(chunks=3), render_reading(chunks=None)):
        assert metric("chunk_host_us.piv", reading(bad)) is None
        assert metric("render_idle_pct.images", reading(bad)) is None
    assert metric("volume_idle_ms.images",
                  reading(render_reading(builds=2))) is None
    # nothing ran on the card: no idle share to read
    quiet = SP.SpanReading(spans=sr.spans, ops=[], gaps=[], chunks=2)
    assert metric("render_idle_pct.images", reading(quiet)) is None
    assert metric("volume_idle_ms.images", reading(quiet)) is None


def test_a_traced_window_reads_the_programs_spans_on_the_cpu():
    res = run.run_cell(SPEC, "piv_pairs", 2 ** 31 + 9, 0.5, True,
                       torch.device("cpu"), time.perf_counter(),
                       docs=CASES["piv_pairs"]())
    assert getattr(T.session, "keeps_spans", False)
    sr = SP._last
    assert sr.chunks and sr.count("render.chunk") == sr.chunks
    assert sr.count("pipeline.render") == 2 * res["attempted"]
    assert res["metrics"]["chunk_host_us.piv"]["value"] > 0
    # no device here: what needs the card is left out, not read as idle
    assert sr.ops == [] and "render_idle_pct.images" not in res["metrics"]
    assert res["correct"]
