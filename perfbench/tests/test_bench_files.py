"""The benchmark's files: ``BENCHMARK.json`` against the contract's
shapes, every configuration and workload file, and a reader for every
metric."""

import json
import re

import pytest

from perfbench.harness import check
from perfbench.harness.cell import load
from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_moves_name_a_metric_every_listed_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        reporting = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", reporting)) <= set(reporting) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    from perfbench.run import metric_names

    e2e = metric_names(cell, trace=False)
    assert "setup_s" in e2e and len(e2e) >= 2 and metric_names(cell, trace=True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = load(cell)
    assert c.workload["config"] == entry["config"] and c.workload["traffic"] == entry["traffic"]
    assert entry["chips"] == c.workload["chips"] == 1
    assert list(c.limits) == check.names(c.tasks())
    archs = [t["arch"] for t in c.config["tasks"]]
    assert [t["arch"] for t in c.workload["tasks"]] == archs
    for t in c.tasks():
        assert t["cfg"].name == t["arch"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["source"] == entry["source"] and data["name"] == config
    assert set(entry["reduced"]) == set(data["reduced"])
    # No width is ever changed, and a nested group holds widths (rope_scaling's
    # mscale_all_dim), so groups stay as published and reduced names none.
    for key in entry["reduced"]:
        assert not isinstance(data.get(key), dict), key
        assert not re.search(r"_dim$|_rank$|_size$|head|expert|latent|state|proj", key), key


@pytest.mark.parametrize("kind,folder", [("end_to_end", "end_to_end"), ("per_layer", "metrics")])
def test_a_reader_for_every_metric(kind, folder):
    from perfbench.run import readers

    mods = readers(folder)
    assert {m["name"] for m in BENCH[kind]} == set(mods)
    for m in BENCH[kind]:
        assert mods[m["name"]].UNIT == m["unit"] and callable(mods[m["name"]].read)


def test_one_layer_name_a_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0].replace("_roofline", ""), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
