"""The measured window: requests of one closed-loop client until the
window's seconds have passed, and what the end-to-end metrics read."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Record:
    """One window.  ``units`` are what the cell's rate counts (inversion
    steps, images) completed inside the window; ``latencies_s`` each
    request's time from its start to the synchronised end of its work."""
    setup_s: float = 0.0
    window_s: float = 0.0
    units: float = 0.0
    requests: int = 0
    latencies_s: List[float] = field(default_factory=list)


def run(driver, seconds: float, max_requests: Optional[int] = None,
        record: Optional[Record] = None) -> Record:
    """Serve requests one after another from now until ``seconds`` have
    passed; the window closes at the end of the request in flight then, or
    where the driver closes it inside a request (a request that would
    outlast the window by far counts the units it finished).  The rate is
    taken over all the time of the window and the tail over all of its
    requests."""
    rec = record or Record()
    t0 = time.perf_counter()
    deadline = t0 + float(seconds)
    while True:
        r0 = time.perf_counter()
        units, closed_at = driver.request(deadline)
        r1 = time.perf_counter()
        rec.units += units
        rec.requests += 1
        if closed_at is not None:
            rec.window_s = closed_at - t0
            break
        rec.latencies_s.append(r1 - r0)
        if r1 >= deadline or (max_requests and rec.requests >= max_requests):
            rec.window_s = r1 - t0
            break
    return rec
