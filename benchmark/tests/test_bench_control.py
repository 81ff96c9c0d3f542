"""The control, the reference with its field and its image stored in
bfloat16 in the program's place, comes out not correct; the program's own
window at the same size comes out within every limit."""
import pytest
import torch

from benchmark.control import readings
from benchmark.core import spec as S
from benchmark.tests.test_bench_faults import CASES

SPEC = S.load_spec()


@pytest.mark.parametrize("workload", sorted(CASES))
def test_control_fails_a_limit(workload):
    r = readings(SPEC, workload, 2 ** 31 + 9, 1.0, torch.device("cpu"),
                 docs=CASES[workload]())
    lim = r["limits"]
    assert all(r["program"][k] <= lim[k] for k in lim), r
    assert any(r["control"][k] > lim[k] for k in lim), r


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    from benchmark import run
    import time
    res = run.run_cell(SPEC, "bos512_render", 17, 1.0, False, card,
                       time.perf_counter(), docs=CASES["bos512_render"]())
    assert res["correct"], res["checks"]
