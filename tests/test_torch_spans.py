"""The program's spans (``utils.profiling.span``): without a profiler one
boolean test and nothing else; under ``torch.profiler`` (here on the CPU)
ranges where the work happens: ``invert_bos``'s steps, the render's chunks
held to ``render_image_fast.chunks``, ``PhaseTimer``'s phases."""
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photon_tpu_torch.config import default_config
from photon_tpu_torch.inverse import invert_bos
from photon_tpu_torch.models.render_fast import render_image_fast
from photon_tpu_torch.pipeline import run_piv
from photon_tpu_torch.utils.profiling import PhaseTimer, span
from tests.torch_port_helpers import small_bos_scene

PREFIXES = ("pipeline.", "invert.", "volume.", "render.")


def _spans(prof):
    """The program's spans of a finished session: (start us, end us, name),
    by start."""
    return sorted((ev.time_range.start, ev.time_range.end, ev.name)
                  for ev in prof.events() if ev.name.startswith(PREFIXES))


def _inside(spans, outer, name):
    """The spans ``name`` that lie inside the span ``outer``."""
    s0, e0, _ = outer
    return [sp for sp in spans if sp[2] == name and s0 <= sp[0]
            and sp[1] <= e0]


def _count(spans, name):
    return sum(1 for sp in spans if sp[2] == name)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


class _Counting:
    """Stands in for ``record_function`` and ``synchronize``: counts its
    calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *a, **kw):
        self.calls.append(a)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_without_a_profiler_enters_nothing(monkeypatch):
    rf, sync = _Counting(), _Counting()
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", rf)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    # one shared context: nothing is made for a span
    assert span("invert.step") is span("render.chunk")
    for _ in range(1000):
        with span("render.chunk"):
            pass
    assert rf.calls == [] and sync.calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("render.chunk"):
            pass
    assert rf.calls == [("render.chunk",)] and sync.calls == []


def test_span_under_a_profiler_is_a_range_nested_where_it_opens():
    def work():
        with span("render.image"):
            with span("render.chunk"):
                torch.ones(4).sum()
            with span("render.chunk"):
                torch.ones(4).sum()

    _, spans = _traced(work)
    assert [n for _, _, n in spans] == ["render.image", "render.chunk",
                                        "render.chunk"]
    assert len(_inside(spans, spans[0], "render.chunk")) == 2


@pytest.fixture(scope="module")
def scene():
    return small_bos_scene()


def test_invert_bos_spans_one_step_a_step(scene):
    cfg, setup, source, r1, r2, rho, vol = scene
    target = render_image_fast(cfg, setup, source, r1, r2, vol=vol,
                               device="cpu")
    seen = []
    res, spans = _traced(lambda: invert_bos(
        cfg, setup, source, r1, r2, target, vol, rho0=0.9 * rho, steps=3,
        learning_rate=1e-3, callback=lambda t, loss, r: seen.append(t),
        device="cpu"))
    steps = [sp for sp in spans if sp[2] == "invert.step"]
    assert len(steps) == 3 == len(res.losses) and seen == [1, 2, 3]
    for step in steps:
        for name in ("invert.volume_from_rho", "invert.render",
                     "invert.backward", "invert.adam", "invert.loss_read",
                     "invert.callback"):
            assert len(_inside(spans, step, name)) == 1, name
        render = _inside(spans, step, "invert.render")[0]
        assert len(_inside(spans, render, "render.image")) == 1
    # the solve's tail, after the last step: the result volume (with the
    # volume build's own spans) and rho's copy to the host
    for name in ("invert.result_volume", "invert.rho_to_host"):
        (tail,) = [sp for sp in spans if sp[2] == name]
        assert tail[0] >= steps[-1][1]
    (rv,) = [sp for sp in spans if sp[2] == "invert.result_volume"]
    (build,) = _inside(spans, rv, "volume.build")
    assert len(_inside(spans, build, "volume.gradient")) == 1
    assert len(_inside(spans, build, "volume.data_min")) == 1


@pytest.mark.parametrize("per_chunk", [None, 7])
def test_render_chunk_spans_match_the_chunk_counter(scene, per_chunk):
    cfg, setup, source, r1, r2, _, vol = scene
    n = int(np.asarray(source.x).shape[0])
    render_image_fast.chunks = 0
    img, spans = _traced(lambda: render_image_fast(
        cfg, setup, source, r1, r2, vol=vol, particles_per_chunk=per_chunk,
        device="cpu"))
    want = 1 if per_chunk is None else -(-n // per_chunk)
    assert render_image_fast.chunks == want == _count(spans, "render.chunk")
    (image,) = [sp for sp in spans if sp[2] == "render.image"]
    for name in ("render.setup", "render.chief_march"):
        assert len(_inside(spans, image, name)) == 1
    assert len(_inside(spans, image, "render.chunk")) == want
    # the counter counts with tracing off too, and the image is the same
    render_image_fast.chunks = 0
    again = render_image_fast(cfg, setup, source, r1, r2, vol=vol,
                              particles_per_chunk=per_chunk, device="cpu")
    assert render_image_fast.chunks == want
    torch.testing.assert_close(again, img, rtol=0, atol=0)


def _piv_config(sensor=64, particles=60, rays=8, per_chunk=20):
    cfg = default_config("piv")
    cfg.camera_design.x_pixel_number = sensor
    cfg.camera_design.y_pixel_number = sensor
    pf = cfg.particle_field
    pf.particle_number = particles
    pf.lightray_number_per_particle = rays
    pf.lightray_process_number = per_chunk * rays
    pf.mie_scattering_angle_number = 16
    pf.particle_diameter_number = 5
    m = cfg.lens_design.focal_length / (cfg.lens_design.object_distance
                                        - cfg.lens_design.focal_length)
    half = 0.7 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    pf.X_Min, pf.X_Max, pf.Y_Min, pf.Y_Max = -half, half, -half, half
    return cfg


def test_run_piv_phases_are_pipeline_spans():
    cfg = _piv_config()
    plain = run_piv(copy.deepcopy(cfg), rng=np.random.default_rng(3),
                    device="cpu")
    res, spans = _traced(lambda: run_piv(
        copy.deepcopy(cfg), rng=np.random.default_rng(3), device="cpu"))
    # the timer's phases are as they were, with the render's suffix
    assert list(res.timer.phases) == list(plain.timer.phases)
    frames = [k for k in res.timer.phases if k.startswith("render:")]
    assert frames == ["render:particle_image_frame_0001",
                      "render:particle_image_frame_0002"]
    assert "mie" in res.timer.phases and res.timer.report()
    names = {n for _, _, n in spans if n.startswith("pipeline.")}
    assert names == {"pipeline." + k.partition(":")[0]
                     for k in res.timer.phases}
    renders = [sp for sp in spans if sp[2] == "pipeline.render"]
    assert len(renders) == len(frames)
    for r in renders:
        assert len(_inside(spans, r, "render.image")) == 1
        assert len(_inside(spans, r, "render.chunk")) == 3
    for k in res.raw_images:
        torch.testing.assert_close(torch.as_tensor(res.raw_images[k]),
                                   torch.as_tensor(plain.raw_images[k]),
                                   rtol=0, atol=0)


def test_phase_timer_keeps_its_seconds_and_rays():
    timer = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("render:frame_0001", num_rays=10):
            pass
        with timer.phase("render:frame_0002", num_rays=5):
            pass
    assert list(timer.phases) == ["render:frame_0001", "render:frame_0002"]
    assert timer.rays == {"render:frame_0001": 10, "render:frame_0002": 5}
    assert [n for _, _, n in _spans(prof)] == ["pipeline.render"] * 2
    with pytest.raises(ValueError):
        with timer.phase("postprocess"):
            raise ValueError("the phase's error passes through")
    assert "postprocess" in timer.phases
