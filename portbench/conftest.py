"""Fixtures of the benchmark's CPU tests: one thread, a card decided inside
a fixture only, and the cells cut to a size a test run holds."""
from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (os.path.join(ROOT, "src"), ROOT):
    if _path not in sys.path:
        sys.path.insert(0, _path)

CELLS = ("mf1m-d128.topk10", "yahoo-d300.topk10", "mf1m-d128.churn")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run the "
                    "cell at its full size")


def tiny(name: str, n: int = 3000):
    """Cell ``name`` of the checkout's `BENCHMARK.json` at ``n`` rows, with
    a window of a few batches and a small check: the whole run, the
    reference's check and the result line, on the CPU in about a second."""
    from portbench import spec
    cell = spec.find_cell(name)
    traffic = dict(cell.traffic, warmup_batches=1, pool_queries_per_s=200,
                   check_batches=2, trace_batches=2)
    if "writes" in traffic:    # a tenth of the rows new, a twentieth gone
        traffic["writes"] = dict(traffic["writes"], prefill_rows=n // 10,
                                 pre_delete_base=n // 20)
    return dataclasses.replace(cell, config=dict(cell.config, n=n),
                               traffic=traffic)


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture
def own_modules_only(monkeypatch):
    """A run's check for modules of JAX and the JAX package looks at what
    the run loads in this test: the other test files of a worker process
    may have loaded `jax` and `repro` before it (a clean process is
    `test_a_run_loads_no_module_of_jax_or_the_jax_package`'s)."""
    from portbench import harness
    before = {m.split(".")[0] for m in sys.modules}
    found = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: sorted(set(found()) - before))
