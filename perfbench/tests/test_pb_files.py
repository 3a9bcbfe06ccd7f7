"""BENCHMARK.json and the files it names: each parses, names and units
keep to their characters, each cell finds its files, and each per-layer
metric has a reader and moves an end-to-end metric that every cell it
lists reports."""
from __future__ import annotations

import json
import re

import pytest

from perfbench.tests.helpers import ROOT
from perfbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(p == "perfbench" or p.startswith("perfbench/")
               for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in e.get("reduced", []):
            assert NAME.match(k)
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_parse(workload):
    cell = common.cell(workload, BENCH)
    assert cell["traffic"]["driver"] in ("sweep", "serve")
    assert (ROOT / "perfbench" / "drivers"
            / f"{cell['traffic']['driver']}.py").exists()
    port = cell["config"]["port"]
    assert (ROOT / "perfbench" / "reference"
            / f"{port['family']}.py").exists()
    assert common.port_config(cell["config"]).name == port["name"]
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    entry = cell["entry"]
    assert entry["chips"] == 1 and NAME.match(entry["config"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_reader_and_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (ROOT / "perfbench" / "metrics" / f"{metric}.py").exists()
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for w in m["workloads"]:
        assert w in WORKLOADS
        assert "workloads" not in moved or w in moved["workloads"]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in WORKLOADS:
        e2e = [m for m in BENCH["end_to_end"]
               if "workloads" not in m or w in m["workloads"]]
        assert len(e2e) >= 2
        assert any(w in m.get("workloads", WORKLOADS)
                   for m in BENCH["per_layer"])


def test_configuration_files():
    for c in BENCH["configs"]:
        cfg = common.load_json(ROOT / c["file"])
        assert "port" in cfg
        assert c["file"].startswith("perfbench/")
        for k in c["reduced"]:       # a cut of depth, never of a width
            assert not k.endswith(("_size", "_dim", "_rank", "_channels",
                                   "expand", "_per_tok"))
