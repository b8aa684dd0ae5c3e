"""BENCHMARK.json against the benchmark's contract, and the loaders
finding each piece by name."""

import json
import os
import re

import pytest

from fitbench import spec

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert BENCH["command"][1].startswith("benchmarks/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(CELLS)
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    for key in ("burnin", "mcmc", "thin"):
        assert c.traffic[key] >= 1
    assert c.traffic["mcmc"] % c.traffic["thin"] == 0
    assert {"data", "model", "run", "backend", "fit", "answer",
            "limits", "source", "reduced"} <= set(c.config)
    assert {m["name"] for m in c.end_to_end} == {"fit_s", "peak_mem_GiB",
                                                 "setup_s"}
    assert len(c.per_layer) == len(BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(spec.metric_reader(metric).read)


def test_config_files_match_their_entries():
    for entry in BENCH["configs"]:
        conf = spec.load_json(os.path.join(spec.ROOT, entry["file"]))
        assert conf["name"] == entry["name"]
        assert conf["source"] == entry["source"]
        assert conf["reduced"] == entry["reduced"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
