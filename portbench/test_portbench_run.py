"""Whole runs on the CPU at a tiny size: the result line, the control and
the planted faults that have to come out as not correct, the command's
refusal without a card, and the modules a run loads."""
from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench import harness, spec
from portbench.conftest import CELLS, ROOT
from portbench.control import ControlSut

SEED = 2**31 + 12345


def _run(cell, trace=False, make_sut=None, seconds=0.2):
    out, err = io.StringIO(), io.StringIO()
    res = harness.run(cell.name, SEED, seconds, trace, device="cpu",
                      cell=cell, make_sut=make_sut, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cpu_run_prints_a_well_formed_last_line(name, trace, tiny_cell,
                                                own_modules_only):
    cell = tiny_cell(name)
    res, out, err = _run(cell, trace)
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(res))
    assert set(last) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] % cell.traffic["batch"] == 0
    want = {m["name"]: m["unit"]
            for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(last["metrics"]) <= set(want)
    for name_, m in last["metrics"].items():
        assert m["unit"] == want[name_] and np.isfinite(m["value"])
    if not trace:      # the host clock's metrics are there on any device
        assert set(last["metrics"]) == set(want)
    else:              # a CPU run has no device trace to read
        assert any(k.startswith("pages_per_query") for k in last["metrics"])
        assert not any(k.endswith("_roofline") for k in last["metrics"])
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # the numbers compared close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert all(line.startswith("check ") and line.endswith(" ok")
               for line in tail)
    assert "portbench setup:" in out and "build_s=" in out


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny_cell, own_modules_only):
    res, _, err = _run(tiny_cell(name), make_sut=ControlSut)
    assert res["correct"] is False
    assert "check score_gap" in err and "FAILED" in err
    assert res["checks"]["score_gap"]["value"] > 1e-5


class _Fault:
    """The configuration's entry with its answers broken where they are
    produced."""

    def __init__(self, kind, entry, x, config, seed, device, k):
        self.kind = kind
        self.inner = spec.entry_module(entry).build(x, config, seed, device,
                                                    k)
        self.meta = self.inner.meta

    def insert(self, ids, rows):
        if self.kind != "writes_dropped":   # the state left unchanged
            self.inner.insert(ids, rows)

    def delete(self, ids):
        if self.kind != "writes_dropped":
            self.inner.delete(ids)

    def snapshot(self):
        self.inner.snapshot()

    def search(self, q):
        if self.kind == "half_batch":       # half the batch left out
            h = len(q) // 2
            ids, scores, pages = self.inner.search(q[:h])
            return (np.concatenate([ids, ids]),
                    np.concatenate([scores, scores]), pages)
        ids, scores, pages = self.inner.search(q)
        if self.kind == "writes_dropped":
            return ids, scores, pages
        ids = np.array(ids)
        ids[0, 0] = (ids[0, 0] + 1) % self.meta["n"]     # an answer altered
        return ids, scores, pages

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["half_batch", "answer_altered"])
def test_planted_fault_is_not_correct(name, kind, tiny_cell,
                                      own_modules_only):
    cell = tiny_cell(name)
    entry = cell.traffic.get("entry", cell.config["entry"])
    res, _, _ = _run(cell, make_sut=lambda *a: _Fault(kind, entry, *a))
    assert res["correct"] is False
    assert res["checks"]["score_gap"]["value"] > 1e-5


@pytest.mark.parametrize("name", [n for n in CELLS if "churn" in n])
def test_dropped_writes_are_not_correct(name, tiny_cell, own_modules_only):
    """A step that leaves the catalog unchanged returns rows the writes
    deleted: no answer at that step."""
    cell = tiny_cell(name)
    entry = cell.traffic["entry"]
    res, _, _ = _run(cell, make_sut=lambda *a: _Fault(
        "writes_dropped", entry, *a))
    assert res["correct"] is False
    assert res["checks"]["invalid"]["value"] > 0
    res, _, _ = _run(cell)
    assert res["correct"] is True


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    return env


def test_command_refuses_without_a_card(no_card):
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


_LOADED = """
import io, json, sys
import torch
torch.set_num_threads(1)
from portbench import harness
from portbench.conftest import tiny
for name in sys.argv[1:]:
    harness.run(name, 7, 0.1, True, device="cpu", cell=tiny(name),
                out=io.StringIO(), err=io.StringIO())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", _LOADED, *CELLS], cwd=ROOT,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "portbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch_like.x", "reprox", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"repro_torch_like", "reprox", "jaxtyping_like"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.planted", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib.planted", types.ModuleType("x"))
    assert {"repro", "jaxlib"} <= set(harness.forbidden_modules())
