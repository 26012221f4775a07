"""The harness finds each cell's configuration, mix, entry, reference and
metric readers by the names `BENCHMARK.json` gives, and the file keeps to
the shapes its contract fixes."""
from __future__ import annotations

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.find_cell(workload)
    w = {x["name"]: x for x in BENCH["workloads"]}[workload]
    assert (cell.config_name, cell.traffic_name, cell.chips) == (
        w["config"], w["traffic"], w["chips"])
    assert cell.config["name"] == w["config"]
    assert int(cell.traffic["batch"]) > 0
    assert callable(spec.entry_module(cell.config["entry"]).build)
    assert callable(spec.reference_module(cell.config["reference"]).compare)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.find_cell("no-such.cell")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    + BENCH["end_to_end"]])
def test_metric_reader_found_by_name(metric):
    assert callable(spec.metric_reader(metric).read)


def test_benchmark_file_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]]
    assert len(names) == len(set(names))


def test_a_metric_split_by_cells_reads_with_its_base_reader():
    from portbench.metrics import recall
    assert spec.metric_reader("recall.some-config") is recall
    with pytest.raises(ModuleNotFoundError):
        spec.metric_reader("no_such_metric")
    split = [m for m in BENCH["end_to_end"] if m["name"].startswith(
        "recall.")]
    cells = [w for m in split for w in m["workloads"]]
    assert len(cells) == len(set(cells)) == len(BENCH["workloads"])
