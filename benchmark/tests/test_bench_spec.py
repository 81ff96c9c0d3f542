"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from benchmark.core import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = S.load_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p


def test_names_and_units():
    names = []
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for c in SPEC["configs"]:
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    assert len(names) == len(set(names))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(m):
    for w in m["workloads"]:
        assert m["moves"] in {e["name"] for e in S.end_to_end(SPEC, w)}
    assert m in S.per_layer(SPEC, m["workloads"][0])
    assert S.module("metrics", m["name"]).read


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cfg = S.config_doc(SPEC, w["config"])
    assert cfg["reduced"] == next(c["reduced"] for c in SPEC["configs"]
                                  if c["name"] == w["config"])
    traffic = S.traffic_doc(w["traffic"])
    drv = S.module("drivers", traffic["driver"])
    assert drv.Driver and drv.SPANS
    e2e = S.end_to_end(SPEC, w["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert S.per_layer(SPEC, w["name"])
    for m in e2e:
        assert S.module("endtoend", m["name"]).value
    assert set(traffic["limits"]) >= set()
