#!/usr/bin/env python3
"""Compare the compiled kernels of two ``csrc/`` trees, kernel by kernel.

    python3 tools/kernel_sass_diff.py --base OTHER/photon_tpu_torch/csrc \\
        [--sources march_dense march_bwd]

Compiles each named source of this checkout's ``photon_tpu_torch/csrc`` and
of ``--base`` to a cubin with the library's own nvcc flags (``kernels.py``)
under ``-Xptxas=-v``, disassembles both with ``cuobjdump -sass``, and prints
for every kernel of the base whether this checkout's SASS is the same
instruction for instruction and whether ptxas's register and spill lines
are, with both trees' lines.
Same SASS from the same launch means the same output bits (float atomics
aside, whose order changes from run to run anyway).  Kernels are matched by
their demangled names with the anonymous namespace taken out (its mangled
name differs between files).  Needs nvcc and the toolkit's cuobjdump and
cu++filt: run it on the machine with the card.  Exit code 1 if a kernel of
the base differs or is missing.
"""
import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from photon_tpu_torch import kernels  # noqa: E402

_ANON = re.compile(r"_GLOBAL__N__\w+?_(?=\d+[a-z_])|\(anonymous namespace\)::")


def compile_cubin(src: Path, name: str, out_dir: str):
    flags = [f for f in kernels.nvcc_flags(name)
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(out_dir, name + ".cubin")
    res = subprocess.run([kernels.nvcc_path(), *flags, "-cubin",
                          "-Xptxas=-v", "-o", cubin, str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr[-2000:]}")
    return cubin, res.stdout + res.stderr


def demangle(names):
    filt = os.path.join(os.path.dirname(kernels.nvcc_path()), "cu++filt")
    res = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True)
    return dict(zip(names, res.stdout.splitlines()))


def kernels_of(cubin, ptxas_log):
    """{plain kernel name: (SASS lines, ptxas lines)}"""
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : ", text)[1:]
    mangled = [p.split("\n", 1)[0].strip() for p in parts]
    plain = demangle(mangled)
    report = {}
    current = None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        elif current and re.search(r"spill stores|Used \d+ registers", line):
            report.setdefault(current, []).append(" ".join(line.split()))
    out = {}
    for name, part in zip(mangled, parts):
        ins = [" ".join(i.split()) for i in
               re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", part)]
        ins = [_ANON.sub("", i) for i in ins]
        out[_ANON.sub("", plain[name])] = (ins, report.get(name, []))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True,
                    help="the other checkout's photon_tpu_torch/csrc")
    ap.add_argument("--sources", nargs="+",
                    default=["march_dense", "march_bwd"])
    args = ap.parse_args(argv)
    base = Path(args.base)
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources:
            got = {}
            for tag, src in (("base", base / f"{name}.cu"),
                             ("this", kernels.CSRC_DIR / f"{name}.cu")):
                d = os.path.join(tmp, tag)
                os.makedirs(d, exist_ok=True)
                got[tag] = kernels_of(*compile_cubin(src, name, d))
            for kern, (ins, rep) in sorted(got["base"].items()):
                mine = got["this"].get(kern)
                if mine is None:
                    print(f"{name}: {kern}: MISSING in this checkout")
                    differ += 1
                    continue
                same, same_rep = mine[0] == ins, mine[1] == rep
                differ += not (same and same_rep)
                print(f"{name}: {kern}: {len(ins)} SASS instructions, "
                      f"{'the same' if same else 'DIFFERENT'}; ptxas lines "
                      f"{'the same' if same_rep else 'DIFFERENT'}")
                for a, b in zip(rep, mine[1]):
                    print(f"    ptxas, base: {a}\n    ptxas, this: {b}")
            for kern in sorted(set(got["this"]) - set(got["base"])):
                print(f"{name}: {kern}: new in this checkout, "
                      f"{len(got['this'][kern][0])} SASS instructions; "
                      + "; ".join(got["this"][kern][1]))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
