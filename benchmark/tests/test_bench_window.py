"""The window's end-to-end metrics take all the work and all the time of
the window, and a tail of every request."""
import time

from benchmark.core import spec as S
from benchmark.core import window as W
from benchmark.endtoend.image_p95_ms import p95


class Sleeper:
    """Requests of a fixed length, one of them stalled."""

    def __init__(self, dt, stall_at=None, stall=0.0):
        self.dt, self.stall_at, self.stall, self.k = dt, stall_at, stall, 0

    def request(self, deadline):
        time.sleep(self.stall if self.k == self.stall_at else self.dt)
        self.k += 1
        return 1, None


def e2e(name, rec):
    return S.module("endtoend", name).value(rec)


def test_a_stall_moves_the_rate_and_the_tail():
    calm = W.run(Sleeper(0.01), 0.5)
    stalled = W.run(Sleeper(0.01, stall_at=3, stall=0.2), 0.5)
    assert e2e("images_per_s", stalled) < 0.8 * e2e("images_per_s", calm)
    # one stall in ten requests lies above the 95th percentile's rank
    a = W.run(Sleeper(0.01, stall_at=1, stall=0.2), 1.0, max_requests=10)
    assert e2e("image_p95_ms", a) > 2 * e2e("image_p95_ms", calm)


def test_rate_over_the_whole_window():
    rec = W.run(Sleeper(0.02), 0.3)
    assert rec.window_s >= 0.3
    assert abs(e2e("images_per_s", rec) - rec.units / rec.window_s) < 1e-12
    assert len(rec.latencies_s) == rec.requests


def test_a_driver_that_closes_the_window_counts_what_it_finished():
    class Steps:
        def request(self, deadline):
            time.sleep(0.05)
            return 7, time.perf_counter()

    rec = W.run(Steps(), 10.0)
    assert rec.units == 7 and rec.requests == 1 and rec.window_s < 1.0
    assert e2e("invert_step_ms", rec) == 1e3 * rec.window_s / 7


def test_order_statistics():
    assert p95([1.0] * 19 + [100.0]) < 100.0
    assert p95(list(range(1, 101))) == 95.05
