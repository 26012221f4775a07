"""One run of one cell: set-up, the measured window, the reference's check
and the result line.

`run` does everything but look for the card, which `run.py` does first; a
test calls `run` on the CPU at a small size, and may pass ``make_sut`` to
put something else (a control, a planted fault) in the program's place.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from . import corpus as _corpus
from . import spec as _spec
from . import devtrace as _trace
from . import traffic as _traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start_wall() -> Optional[float]:
    """The wall-clock time this process started (Linux `/proc`, 10 ms
    ticks); None where `/proc` cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None
    return time.time() - age


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: `repro_torch` is not `repro`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Context:
    """What the metric readers read."""
    cell: _spec.Cell
    seed: int
    k: int
    setup: dict
    window: _traffic.Window
    pages: list                  # per batch: (pages summed, largest or None)
    meta: Optional[dict]
    trace: Optional[_trace.Summary] = None
    stretch: tuple = (0, 0)      # the traced batches [start, end)
    readings: dict = field(default_factory=dict)
    writes: Optional[_traffic.Writes] = None
    first_step: int = 0          # the step of the window's first batch
    snapshot_s: list = field(default_factory=list)  # traced runs' steps


def _pages(p):
    """(sum, largest query's) of one batch's pages: a per-query tensor or
    array, or a total (largest then unknown)."""
    if p is None:
        return 0, None
    if isinstance(p, (int, np.integer)):
        return int(p), None
    a = np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
    return int(a.sum()), int(a.max())


def checks(readings: dict, config: dict, window: _traffic.Window) -> dict:
    """Each number compared, with its limit and whether it holds. The
    guarantee's limit is the configuration's p less three standard errors
    of a share over the checked queries."""
    lim = config["limits"]
    p = float(config["guarantee_p"])
    n = max(1, readings["queries"])
    share_floor = p - 3.0 * math.sqrt(p * (1.0 - p) / n)
    out = {
        "failed_batches": (window.failed_batches, 0, "<="),
        "invalid": (readings["invalid"], 0, "<="),
        "score_gap": (readings["score_gap"], lim["score_gap"], "<="),
        "guarantee_share": (readings["guarantee_share"], share_floor, ">="),
    }
    return {name: {"value": v, "limit": l,
                   "ok": bool(v <= l if op == "<=" else v >= l), "rule": op}
            for name, (v, l, op) in out.items()}


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", bench: Optional[dict] = None,
        cell: Optional[_spec.Cell] = None,
        make_sut: Optional[Callable] = None,
        out=sys.stdout, err=sys.stderr) -> dict:
    """Run cell ``workload`` once; print the set-up split, the checks and
    the result line; return the result. ``make_sut(x, config, seed, device,
    k)`` replaces the configuration's entry point."""
    t_proc = process_start_wall()
    t_first_line = time.time()
    device = torch.device(device)
    cell = _spec.find_cell(workload, bench) if cell is None else cell
    cfg, mix = cell.config, cell.traffic
    k, b = int(mix["k"]), int(mix["batch"])
    entry = _spec.entry_module(mix.get("entry", cfg["entry"]))
    reference = _spec.reference_module(cfg["reference"])

    def say(msg):
        print(msg, file=err, flush=True)

    cuda = device.type == "cuda"
    clock = time.perf_counter
    setup = {"process_start_s": (t_first_line - t_proc) if t_proc else 0.0}
    t = clock()
    entry.prepare(device)
    setup["kernel_library_s"] = clock() - t
    t = clock()
    x = _corpus.corpus(cfg, seed)
    setup["corpus_s"] = clock() - t
    t = clock()
    batches = _traffic.make_batches(cfg, mix, seed, seconds)
    setup["queries_s"] = clock() - t
    writes = None
    if "writes" in mix:
        t = clock()
        writes = _traffic.make_writes(cfg, mix, seed,
                                      sum(_traffic.steps(mix, seconds)))
        setup["writes_drawn_s"] = clock() - t
    t = clock()
    build = make_sut or entry.build
    sut = build(x, cfg, int(cfg["build_seed"]), device, k)
    setup["build_s"] = clock() - t
    snapshot_s = []
    step_no = [0]
    if writes is not None:
        t = clock()
        sut.insert(*writes.prefill_items())
        sut.delete(writes.pre_deleted)
        setup["prefill_s"] = clock() - t

    def step(q):
        """One step: its writes, then the search of batch ``q``."""
        i = step_no[0]
        step_no[0] += 1
        if writes is not None and i < writes.n_steps:
            sut.insert(*writes.step_inserts(i))
            sut.delete(writes.deletes[i])
        if trace and writes is not None:
            t0 = clock()
            sut.snapshot()
            snapshot_s.append(clock() - t0)
        return sut.search(q)

    t = clock()
    for q in batches.warmup:
        step(q)
    if trace:
        _trace.warm_profiler(lambda: sut.search(batches.warmup[-1]), device)
    if cuda:
        torch.cuda.synchronize(device)
    setup["warmup_s"] = clock() - t
    t_start = t_proc if t_proc else t_first_line - setup["process_start_s"]
    setup["setup_s"] = time.time() - t_start
    split = " ".join(f"{key}={v:.4f}" for key, v in setup.items())
    print(f"portbench setup: {split}", file=out, flush=True)
    say(f"portbench setup: {split}")

    # ---- the window
    snapshot_s.clear()
    first_step = step_no[0]
    search = step
    stretch = None
    if trace:
        stretch = _trace.Stretch(float(mix["trace_after_frac"]) * seconds,
                                 int(mix["trace_batches"]), device)

        def search(q, _inner=step):
            with torch.profiler.record_function(_trace.ANNOTATION + "batch"):
                return _inner(q)
    win = _traffic.closed_loop(search, batches.pool, seconds, on_batch=stretch)
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = stretch.finish(win.n_batches) if stretch else None
    pages = [_pages(p) for p in win.pages]
    meta = getattr(sut, "meta", None)
    sut.close()
    del sut
    lat = np.asarray(win.latencies_s) * 1e3
    if len(lat):
        say(f"portbench window: {win.n_batches} batches in {win.seconds:.4f} s"
            f", pool {win.pool_size} batches (sent again: {win.wrapped}); "
            f"latency median {np.median(lat):.4f} ms, max {lat.max():.4f} ms,"
            f" {int((lat > 3 * np.median(lat)).sum())} above 3x the median; "
            f"queries/s by quarter "
            f"{' '.join(f'{r:.1f}' for r in _traffic.rate_by_part(win, 4))}; "
            f"pages a query {sum(p[0] for p in pages) / (len(lat) * b):.2f}")
    if win.error:
        say(f"portbench window: a batch failed: {win.error}")
    if writes is not None:
        say(f"portbench writes: {min(step_no[0], writes.n_steps)} steps "
            f"written of {step_no[0]}"
            + ("" if step_no[0] <= writes.n_steps else
               "; the schedule ran out, later steps only searched"))

    # ---- the reference's check, after the program's state is freed
    t = clock()
    sample = _traffic.check_sample(win, int(mix["check_batches"]), seed)
    if len(sample):
        q = np.concatenate([batches.pool[win.pool_index[i]] for i in sample])
        ids = np.concatenate([np.asarray(win.ids[i]) for i in sample])
        sc = np.concatenate([np.asarray(win.scores[i]) for i in sample])
        steps = np.repeat(first_step + sample, b)
        readings = reference.compare(x, q, ids, sc, c=float(cfg["guarantee_c"]),
                                     device=device, writes=writes,
                                     steps=steps)
    else:
        readings = {"invalid": 0, "score_gap": 1e9, "recall": 0.0,
                    "guarantee_share": 0.0, "queries": 0}
    say(f"portbench reference: {readings['queries']} queries checked in "
        f"{clock() - t:.4f} s")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: modules of JAX or the JAX package are "
                         f"loaded: {', '.join(found)}")

    ctx = Context(cell=cell, seed=seed, k=k, setup=setup, window=win,
                  pages=pages, meta=meta, trace=summary,
                  stretch=(stretch.start_i or 0, stretch.end_i or 0)
                  if stretch else (0, 0), readings=readings, writes=writes,
                  first_step=first_step, snapshot_s=snapshot_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    chk = checks(readings, cfg, win)
    attempted = (win.n_batches + win.failed_batches) * b
    result = {
        "correct": all(c["ok"] for c in chk.values()),
        "attempted": attempted,
        "failed": win.failed_batches * b,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                        for name, c in chk.items()}
    for name, c in chk.items():
        say(f"check {name} {c['value']!r} {c['rule']} {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(result), file=out, flush=True)
    return result
