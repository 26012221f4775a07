"""Find the cell, its configuration, its traffic mix and its metrics by name.

`BENCHMARK.json` lives at the root of the checkout, one level above this
folder. A configuration is `configs/<name>.json` (the path its `file` entry
gives), a mix `traffic/<name>.json`, an entry point `entries/<name>.py`, a
reference `reference/<name>.py` and a metric `metrics/<module>.py`, where
the module is the metric's name with `.` and `-` read as `_` (or, for a
metric split by cells, the part of the name before the first dot).
"""
from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple      # the metric entries this cell reports, trace 0
    per_layer: tuple       # the metric entries this cell reports, trace 1


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench: Optional[dict] = None,
              root: str = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    `BENCHMARK.json`) with its configuration and mix read from their files.
    Raises KeyError for a name the benchmark does not hold."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _listed(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _listed(m, name)))


def module_name(metric_name: str) -> str:
    return metric_name.replace(".", "_").replace("-", "_")


def metric_reader(metric_name: str):
    """The reader module of a metric: it has ``read(ctx)``, which returns a
    number or None where it finds nothing to read. A metric split by the
    cells it is read in (``recall.<config>``, ``queries_per_s.churn``: each
    part with its own bound or its own end-to-end metric to move) that has
    no module of its own reads with the module of the part of its name
    before the first dot."""
    own = f"portbench.metrics.{module_name(metric_name)}"
    try:
        return importlib.import_module(own)
    except ModuleNotFoundError as e:
        if e.name != own or "." not in metric_name:
            raise
    return importlib.import_module(
        f"portbench.metrics.{module_name(metric_name.split('.')[0])}")


def entry_module(name: str):
    """The entry point module named by a configuration's ``entry``."""
    return importlib.import_module(f"portbench.entries.{module_name(name)}")


def reference_module(name: str):
    """The plain reference named by a configuration's ``reference``."""
    return importlib.import_module(f"portbench.reference.{module_name(name)}")
