"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (the cell's driver: inputs made from the seed, the program's
kernels built or loaded from ``photon_tpu_torch/build/``, every shape of the
cell warmed) runs from process start to the first timed request and is
``setup_s``.  Then one closed-loop client serves requests for ``--seconds``
seconds.  With ``--trace 0`` the line holds the cell's end-to-end metrics;
with ``--trace 1`` the window (at most the traffic's ``trace_requests``
requests) runs under ``torch.profiler`` and the line holds the per-layer
metrics, ``busy_s``, ``window_s`` and a ``breakdown``.  After the window the
program's state is freed and the plain reference (``benchmark/reference``)
recomputes a sample of what the window produced; ``correct`` says whether
each number compared is within its limit (the traffic file's ``limits``).
The numbers compared end the line under ``checks`` and end standard error.

Exits 2 without a CUDA device (or with fewer than the cell asks for) and 3
if ``jax``, ``jaxlib``, ``flax`` or ``photon_tpu`` was loaded; neither
prints a result.
"""
from __future__ import annotations

import os
import time

_T0 = time.perf_counter()

# one process with few threads: the host's thread pools (OpenMP, BLAS)
# would otherwise spin beside the thread that launches the kernels
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark.core import spec as S  # noqa: E402
from benchmark.core import trace as T  # noqa: E402
from benchmark.core import window as W  # noqa: E402
from benchmark.core.device import forbidden_modules  # noqa: E402


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counters():
    """The program's launch counters that ``counts/`` names:
    {counter name: the function that carries ``.launches``}."""
    out = {}
    for f in sorted((S.BENCH / "counts").glob("*.py")):
        cm = S.module("counts", f.stem)
        if hasattr(cm, "COUNTER"):
            mod, attr = cm.COUNTER
            out[attr] = getattr(importlib.import_module(mod), attr)
    return out


def traced_window(torch, driver, dmod, seconds, max_requests, dev):
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    if hasattr(driver, "reset_phases"):
        driver.reset_phases()
    with T.session(torch, dev, dmod.SPANS) as box:
        rec = W.run(driver, seconds, max_requests=max_requests)
        _sync(torch, dev)
    prof = box["prof"]
    key_events = T.device_events(prof, dmod.SPANS)
    reading = T.Reading(
        key_events=key_events, busy_s=box["busy_s"],
        window_s=(box["window"][1] - box["window"][0]) if box["window"]
        else rec.window_s,
        requests=rec.requests, units=rec.units,
        counters={k: int(fn.launches) for k, fn in counters.items()},
        shapes=driver.shapes(), phases=driver.phases())
    reading.breakdown = T.breakdown(prof, key_events, dmod.SPANS,
                                    box["window"])
    return rec, reading


def run_cell(spec, workload, seed, seconds, trace, dev, t0, fault=None,
             docs=None):
    """Set-up, the window, the comparison: the result as a dict (without
    the device facts).  ``docs``: (config, traffic) documents in place of
    the files (the harness's tests); ``fault``: wraps the program's entry
    point (the harness's tests)."""
    import torch
    cell = S.cell(spec, workload)
    config, traffic = docs or (S.config_doc(spec, cell["config"]),
                               S.traffic_doc(cell["traffic"]))
    dmod = S.module("drivers", traffic["driver"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    driver = dmod.Driver(config, traffic, seed, dev, fault)
    _sync(torch, dev)
    setup_s = time.perf_counter() - t0
    out = {"metrics": {}}
    units = S.units(spec)
    if trace:
        rec, reading = traced_window(torch, driver, dmod, seconds,
                                     int(traffic["trace_requests"]), dev)
        for m in S.per_layer(spec, workload):
            v = S.module("metrics", m["name"]).read(reading)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": units[m["name"]]}
        out["busy_s"] = reading.busy_s
        out["window_s"] = reading.window_s
        out["breakdown"] = reading.breakdown
    else:
        rec = W.run(driver, seconds)
        rec.setup_s = setup_s
        for m in S.end_to_end(spec, workload):
            v = S.module("endtoend", m["name"]).value(rec)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": units[m["name"]]}
    out["attempted"] = rec.requests
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                if dev.type == "cuda" else 0)
    # the program's state goes before the reference runs
    outputs = driver.outputs()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = driver.reference(outputs)
    numbers = driver.compare(outputs, ref)
    lat = sorted(rec.latencies_s) or [0.0]
    print(f"benchmark: setup {setup_s:.3f} s, window {rec.window_s:.3f} s, "
          f"{rec.requests} requests (latency min {lat[0]:.4f} median "
          f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s), reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limits = traffic["limits"]
    out["checks"] = {k: {"value": float(numbers[k]), "limit": limits[k]}
                     for k in sorted(limits)}
    out["correct"] = all(numbers[k] <= limits[k] for k in limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = S.load_spec()
    cell = S.cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), dev, _T0)
    bad = forbidden_modules()
    if bad:
        print("benchmark: modules that must not load were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": int(cell["chips"]),
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": 0, "metrics": res["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
