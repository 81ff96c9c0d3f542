#!/usr/bin/env python3
"""Where K11 and K12's tiles spend their time on the card.

    python3 tools/prefilter_tile_probe.py [--shapes 64,64,64,4 512,512,512,4]

Builds ``tools/prefilter_tile_probe.cu`` (the tile kernels' body and
launcher of ``photon_tpu_torch/csrc/volume_prep.cu`` compiled in, the body
given global-timer stamps at each block's phases) with the library's nvcc
flags and prints, for each shape:

* the blocks an SM the CUDA runtime grants the tile kernels at the shape's shared
  memory, with their registers and local bytes;
* for each axis of K11 and K12, the launch's span and each block's median
  and 90th-percentile time copying in, running its lines' passes and
  copying out, and the most blocks in flight on one SM;
* the wrappers' CUDA-event time (median of 5), the tiles and the
  one-thread-a-line kernel in turns (tiles, one thread, one thread, tiles).

Needs nvcc and a card: run it on the machine with the card.  Prints the
card's name and power limit first.
"""
import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from photon_tpu_torch import kernels, native  # noqa: E402


def build(out_dir):
    so = Path(out_dir) / "prefilter_tile_probe.so"
    flags = [f for f in kernels.nvcc_flags("volume_prep")]
    subprocess.run([kernels.nvcc_path(), *flags, "-o", str(so),
                    str(ROOT / "tools" / "prefilter_tile_probe.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_axis.argtypes = [i, vp, vp, ll, ll, ll, ll, vp, vp, i, vp]
    lib.probe_occupancy.argtypes = [i, vp]
    return lib


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def probe_shape(lib, shape, dev):
    f = torch.randn(shape, device=dev)
    out = torch.empty_like(f)
    plans = native.prefilter_plan(*shape)
    records = native._plan_records(plans)
    poles = native._poles(*shape[:3])
    occ = (ctypes.c_int * 6)()
    for p in plans:
        lib.probe_occupancy(p.smem_bytes, occ)
        print(f"{shape} {p.smem_bytes} B a tile: K11 {occ[0]} blocks an SM "
              f"({occ[1]} registers, {occ[2]} B local), K12 {occ[3]} "
              f"({occ[4]}, {occ[5]} B)")
    for backward in (0, 1):
        for axis, p in enumerate(plans):
            stamps = torch.zeros(5 * p.tiles, dtype=torch.int64, device=dev)
            for _ in range(3):            # the last of three launches
                code = lib.probe_axis(backward, f.data_ptr(),
                                      out.data_ptr(), *shape,
                                      ctypes.addressof(poles),
                                      ctypes.addressof(records), axis,
                                      stamps.data_ptr())
                torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"probe_axis returned {code}")
            t0, t1, t2, t3, sm = stamps.view(p.tiles, 5).cpu().numpy().T
            phases = [(t1 - t0) / 1e3, (t2 - t1) / 1e3, (t3 - t2) / 1e3]
            in_flight = max(
                max(int(((t0[sm == s] <= x) & (t3[sm == s] > x)).sum())
                    for x in t0[sm == s])
                for s in np.unique(sm)[:8])
            print(f"{shape} K1{1 + backward} axis {axis}: {p.tiles} tiles of "
                  f"{p.rows} x {p.cols} lines, span "
                  f"{(t3.max() - t0.min()) / 1e3:.1f} us; a block's copy in, "
                  f"passes, copy out: median "
                  + ", ".join(f"{np.median(x):.2f}" for x in phases)
                  + " us, 90th percentile "
                  + ", ".join(f"{np.percentile(x, 90):.2f}" for x in phases)
                  + f" us; at most {in_flight} blocks in flight on an SM")
    one_line = tuple(p._replace(tiled=False) for p in plans)
    for fn in ("photon_bspline_prefilter", "photon_bspline_prefilter_bwd"):
        turns = []
        for tiled in (True, False, False, True):
            turns.append(event_ms(lambda: native._launch_prefilter(
                fn, f, None if tiled else one_line)))
        print(f"{shape} {fn}: tiles {turns[0]:.4f}, {turns[3]:.4f} ms; one "
              f"thread a line {turns[1]:.4f}, {turns[2]:.4f} ms (CUDA events, "
              f"median of 5, in turns)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["64,64,64,4", "512,512,512,4"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for s in args.shapes:
            probe_shape(lib, tuple(int(x) for x in s.split(",")), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
