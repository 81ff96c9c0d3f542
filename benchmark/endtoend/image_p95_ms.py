"""The 95th percentile of every request of the window, each timed from its
start to the synchronised end of its image."""
import statistics


def p95(values) -> float:
    """The 95th percentile of every value, interpolated between ranks
    (``statistics.quantiles(..., n=20, method="inclusive")``); a single
    value is its own percentile."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


def value(rec):
    return 1e3 * p95(rec.latencies_s) if rec.latencies_s else None
