"""Readings from which the limits of ``correct`` are set: for each seed, the
numbers that the program's window gives against the plain reference (the
lower reading), and those that the control gives: the reference in the
program's place with its field and its image stored in bfloat16 (the upper
reading).  The benchmark's own runs never run this.

    python3 -m benchmark.control --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

Each seed builds the cell's set-up, serves a window of ``--seconds`` (long
enough to finish a request of the cell's longest kind), then runs the
reference twice: in float32 and as the control.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from benchmark.core import spec as S
from benchmark.core import window as W
from benchmark.reference.render import bf16


def readings(spec, workload, seed, seconds, dev, docs=None, fault=None):
    """{"program": numbers, "control": numbers} for one seed."""
    import torch
    cell = S.cell(spec, workload)
    config, traffic = docs or (S.config_doc(spec, cell["config"]),
                               S.traffic_doc(cell["traffic"]))
    dmod = S.module("drivers", traffic["driver"])
    driver = dmod.Driver(config, traffic, seed, dev, fault)
    W.run(driver, seconds)
    out = driver.outputs()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(out)
    program = driver.compare(out, ref)
    low = driver.reference(out, lowp=bf16)
    control = driver.compare(low, ref)
    return {"program": program, "control": control,
            "limits": traffic["limits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    spec = S.load_spec()
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(spec, args.workload, seed, args.seconds, dev)
        r.update(workload=args.workload, seed=seed,
                 seconds=time.perf_counter() - t0,
                 card=torch.cuda.get_device_name(dev))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
