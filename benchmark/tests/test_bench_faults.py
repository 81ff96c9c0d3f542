"""A run whose timed path is broken underneath comes out not correct: the
harness driven end to end on the CPU at a small size (its look for a card
skipped), once for each fault that a cell can have.  Sound runs of the
same sizes come out correct."""
import contextlib
import dataclasses
import time

import pytest
import torch

from benchmark import run
from benchmark.core import spec as S
from benchmark.tests import tiny

SPEC = S.load_spec()
CPU = torch.device("cpu")


def half_render(render):
    """The render of the first half of the particles, doubled: half of the
    batch left out, the mean taken over the rest."""
    def fn(cfg, setup, source, *a, **kw):
        n = source.num_particles // 2
        sub = dataclasses.replace(
            source, x=source.x[:n], y=source.y[:n], z=source.z[:n],
            radiance=source.radiance[:n],
            diameter_index=source.diameter_index[:n])
        return 2.0 * render(cfg, setup, sub, *a, **kw)
    return fn


@contextlib.contextmanager
def patched(module, name, wrap):
    import importlib
    mod = importlib.import_module(module)
    old = getattr(mod, name)
    setattr(mod, name, wrap(old))
    try:
        yield
    finally:
        setattr(mod, name, old)


def unchanged_state(invert_bos):
    """Every step returns rho unchanged."""
    def fn(*a, **kw):
        kw["learning_rate"] = 0.0
        return invert_bos(*a, **kw)
    return fn


def half_batch_invert(invert_bos):
    def fn(*a, **kw):
        with patched("photon_tpu_torch.inverse", "render_image_fast",
                     half_render):
            return invert_bos(*a, **kw)
    return fn


def half_batch_piv(run_piv):
    def fn(*a, **kw):
        with patched("photon_tpu_torch.pipeline", "render_image_fast",
                     half_render):
            return run_piv(*a, **kw)
    return fn


def altered_render(render):
    def fn(*a, **kw):
        img = render(*a, **kw)
        return img * 1.01
    return fn


def altered_piv(run_piv):
    def fn(*a, **kw):
        res = run_piv(*a, **kw)
        for k in res.raw_images:
            res.raw_images[k] = res.raw_images[k] * 1.01
        return res
    return fn


CASES = {
    "bos512_invert": (lambda: (tiny.bos(), tiny.traffic(
        "invert_solves", steps=5, warm_steps=1))),
    "bos512_render": (lambda: (tiny.bos(), tiny.traffic(
        "snapshot_renders", warm_requests=1, check_among=4))),
    "piv_pairs": (lambda: (tiny.piv(), tiny.traffic(
        "piv_cases", warm_cases=0, check_among=3))),
}
FAULTS = [("bos512_invert", None), ("bos512_invert", unchanged_state),
          ("bos512_invert", half_batch_invert),
          ("bos512_render", None), ("bos512_render", half_render),
          ("bos512_render", altered_render),
          ("piv_pairs", None), ("piv_pairs", half_batch_piv),
          ("piv_pairs", altered_piv)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__ if f else 'sound'}"
                              for w, f in FAULTS])
def test_fault_comes_out_not_correct(workload, fault):
    res = run.run_cell(SPEC, workload, 2 ** 31 + 5, 1.0, False, CPU,
                       time.perf_counter(), fault=fault,
                       docs=CASES[workload]())
    assert res["correct"] is (fault is None), res["checks"]
