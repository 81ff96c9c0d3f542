"""Nothing the benchmark runs loads ``jax`` or ``photon_tpu``: compared by
the whole top-level name, so that ``photon_tpu_torch`` passes."""
import subprocess
import sys

from benchmark.core.device import forbidden_modules
from benchmark.core.spec import ROOT


def test_top_level_names_compared_whole():
    assert forbidden_modules(["photon_tpu_torch", "photon_tpu_torch.ops",
                              "jaxtyping", "benchmark"]) == []
    assert forbidden_modules(["photon_tpu.ops", "jax"]) == ["jax",
                                                           "photon_tpu.ops"]
    assert forbidden_modules(["flax.linen", "jaxlib"]) == ["flax.linen",
                                                          "jaxlib"]


def test_harness_traffic_and_reference_load_no_jax():
    code = (
        "import sys, torch\n"
        "from benchmark.core import spec as S\n"
        "import benchmark.run, benchmark.control\n"
        "import benchmark.reference.inverse, benchmark.reference.mie\n"
        "import benchmark.reference.postprocess\n"
        "for k in ('drivers', 'metrics', 'endtoend', 'counts'):\n"
        "    for f in sorted((S.BENCH / k).glob('*.py')):\n"
        "        if f.stem != '__init__': S.module(k, f.stem)\n"
        "import benchmark.drivers.common as c\n"
        "from benchmark.tests import tiny\n"
        "c.bos_inputs(tiny.bos(), 3)\n"
        "from benchmark.core.device import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.reference.render, benchmark.reference.inverse\n"
            "import benchmark.reference.mie, benchmark.reference.scenes\n"
            "import benchmark.reference.postprocess\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('photon_tpu_torch', 'jax',\n"
            "                                    'photon_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
