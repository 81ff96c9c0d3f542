"""Traffic repeats for a seed and changes with it."""
import numpy as np
import torch

from benchmark.drivers import common
from benchmark.tests import tiny


def test_bos_inputs_repeat_and_change_with_the_seed():
    doc = tiny.bos()
    a, b = common.bos_inputs(doc, 2 ** 31 + 7), common.bos_inputs(doc,
                                                                    2 ** 31 + 7)
    c = common.bos_inputs(doc, 2 ** 31 + 8)
    assert np.array_equal(a.ref_source.x, b.ref_source.x)
    assert torch.equal(a.r1, b.r1)
    assert not np.array_equal(a.ref_source.x, c.ref_source.x)
    assert not torch.equal(a.r1, c.r1)
    # the same sizes for every seed
    assert a.ref_source.x.shape == c.ref_source.x.shape


def test_seeds_of_cases_differ_and_repeat():
    s = [common.sub_seed(2 ** 33 + 1, 4, k) for k in range(5)]
    assert len(set(s)) == 5
    assert s == [common.sub_seed(2 ** 33 + 1, 4, k) for k in range(5)]
    assert common.sub_seed(2 ** 33 + 2, 4, 0) != s[0]


def test_snapshots_repeat_and_change_with_the_seed():
    from benchmark.drivers.render_sequence import Driver
    docs = tiny.bos(), tiny.traffic("snapshot_renders", warm_requests=0)
    dev = torch.device("cpu")
    a = Driver(*docs, 11, dev)
    b = Driver(*docs, 11, dev)
    c = Driver(*docs, 12, dev)
    assert all(torch.equal(x, y) for x, y in zip(a.snaps, b.snaps))
    assert not torch.equal(a.snaps[0], c.snaps[0])
    assert a.wanted == b.wanted
