"""BENCHMARK.json against the files of vilbench/: every cell finds its
configuration, traffic, generator and check limits, every metric its
reader, and every name and unit keeps to the allowed characters."""
import json
import os
import re

import pytest

from vilbench import harness
from vilbench.tests.tiny import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vilbench"]
    assert BENCH["command"] == ["python3", "vilbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.load_cell(ROOT, cell)
    assert spec["cell"]["chips"] == 1
    gen = os.path.join(ROOT, "vilbench", "traffic", spec["traffic"]["generator"] + ".py")
    assert os.path.exists(gen)
    ref = os.path.join(ROOT, "vilbench", "reference", spec["config"]["reference"] + ".py")
    assert os.path.exists(ref)
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for kind, entries in (("end_to_end", spec["end_to_end"]),
                          ("layer_metrics", spec["per_layer"])):
        for m in entries:
            assert callable(harness.reader(ROOT, kind, m["name"]))


def test_configs_resolve():
    for c in BENCH["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("vilbench/") and os.path.exists(path)
        assert json.load(open(path))["name"] == c["name"]
        assert c["reduced"] == json.load(open(path))["reduced"]
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        for w in m["workloads"]:  # each listed cell reports the metric it moves
            e = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert w in e.get("workloads", CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200


def test_layers_named_alike():
    """A kernel's share of its roofline is `<kernel>_roofline...` in %, of
    the layer "kernels"."""
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%" and m["layer"] == "kernels"
