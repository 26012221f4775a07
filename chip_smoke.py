#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ProMIPS on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result
line):
  1. setup: versions, the card's name and power limit, TF32 off, and the
     build of every kernel from src/repro_torch/kernels/csrc/, with each
     kernel's registers and spills from ptxas (a spill fails the run);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes on the n=1M index (B=64, k=10): block_mips on a sparse
     pow2 tile with padding slots, on the dense tile of all 125,000 slots,
     on a round-2 tile with a carried top-k, on a tile with carried hits at
     c_half where the Condition-A stop fires, and on the round-1 tile at the
     streaming over-fetch's k = 2,058 and at k = 16,394, each bit for bit
     equal to the plain version and printed with its density (selected
     pairs / (NS x B)) and union pages; sketch_scores at NB=125,000;
     mips_score on a 131,072-row delta with 1% of rows invalid; each with
     its time, the plain version's, the library call's and the bound;
  3. the main path (`ProMIPS.search`, two-phase fused search with the sketch
     prefilter) at n=100,000 with the LARGE_N recipe, held against the same
     search on the plain versions (sketch estimates within tolerance, each
     prefilter cut flip with its distance to the cut), against an exact
     top-k and against the Theorem-2 floor;
  4. the same at n=1,000,000, plus the time per batch, the launches of each
     kernel, the peak memory, and a torch.profiler trace of one batch
     (device time per kernel, the device's idle share);
  4b. on the same n=1M index, the promips backend in every mode at full
     budget (fused, batched, scan, progressive): scan = batched = fused in
     ids and every counter, or each difference a tie or a flip with its
     margin; the steps each query walked (mean, p50, p99, max and the
     query that sets it) in every timed batch of the scan and progressive
     modes, and one scan batch profiled; the scan_blocks kernel against
     its plain walk on the same inputs, bit for bit in all five outputs (and within check_walk's
     account: scores within tolerance on equal rows, differing rows exact
     ties, a differing walk explained by a flip and, in scan mode, each
     output the top-k of its own walk), at full budget and at budgets 256
     and 4,096, each walk's lengths and its bound over the union of the
     blocks it read; the full-budget progressive walk on the modes run's
     own inputs against the jump walk (`jump_walk`, the plain function
     one merged step a pass, itself held to the step loop at the two
     budgets) and against the modes run's walk and ids; ops.mips_topk over
     the corpus; the
     facade with the four baselines on the n=100k rows; the paper's host
     search in a forked child process pinned to one core, away from the
     thread that drives the card;
  5. the streaming index (`MutableProMIPS`: insert / delete / update ->
     snapshot -> base search with the over-fetched k + the delta scored by
     mips_score -> merge; compaction), in two cells:
     compact-100k: a stream over the n=100k index with 11,112 inserts,
       200 deletes and 200 updates, compacted synchronously and searched,
       then a background compaction with 1,000 inserts and searches landing
       while it runs, after which the inserted rows are found;
     stream-1M: a stream over the n=1M index with 111,112 inserts (state A,
       a 10% delta) and then 2,000 base deletes or updates and 1,112 delta
       deletes (state B, k_base = 2,058); each state held like the main
       path (plain path, exact top-k over the live rows, Theorem-2 floor),
       timed, and state B profiled.
     Every search of phases 3-5 also runs quick_probe_select (the
     frontend's whole Quick-Probe in one launch); each choice of group that
     differs between the kernel and the plain path, and each round-1 block
     that the radius's last-ulp difference moves across its sphere test, is
     reported with its margin. Fused searches on the card run the in-graph
     driver (`core/search_graph.py`: the tile plan on the device, the
     stages replayed as CUDA graphs); phases 3-5 hold it bit for bit (ids,
     scores, every stats field) against the host driver
     (`search_fused.search_batch_fused`, its plan in numpy) on the same
     input, through a search that captures the graphs and one that replays
     them; phases 4 and 5 time the two drivers in turns (host, graph,
     graph, host, after one graph pass that captures), each median with
     its range, and profile one batch under each (device busy, idle share,
     Memcpy time);
  6. the serve path (`serve.DecodeEngine`) at the full width of
     tinyllama-1.1b (22 layers, d_model 2048, 32 heads, 4 KV heads, vocab
     32,000 padded to 32,256), random f32 weights from a seeded generator,
     4 batch slots, max_len 512, 16 requests with prompts of 24 and 40
     tokens and 16 new tokens each: exact and ProMIPS logits, each on the
     kernels (decode_attention in every layer of every step; the vocab
     search's quick_probe_select and mips_score) and on the plain versions,
     tokens held kernel against plain (each difference explained by a logit
     margin below LOGIT_TOL), the c-approximation of every searched row
     against the exact top-1 over the live vocab (the Theorem-2 floor), the
     hot-query cache (hits, tokens equal to a cache-off run), deletes and an
     update of vocab rows; step times, tokens/s, pages, launches per step,
     peak memory. The engine replays its decode step as a CUDA graph: on
     the kernel path each mode's traffic runs four times on one engine,
     eager, graph, graph, eager (the eager runs point the engine at the
     functions behind its graphs), with equal tokens and launches in all
     four, at most one capture of each decode variant, and one fixed
     step's logits or hidden state equal bit for bit between the replay
     and the eager step; again after the deletes and the update (which
     captures the hidden-state graph once more, over the engine's copy of
     the embed table). A torch.profiler trace of one decode step on the
     graph and on the eager functions; a fenced span trace (`obs.trace`)
     of a promips run, the `search`, `rescore` and `segments_merge` span
     totals of each step against its wall time; and an open-loop Zipfian
     `serve.loadgen` run of about 10 s at half the graph engine's
     throughput (p50/p99 latency and queue wait, completed requests/s,
     shed and expired shares, tier occupancy).
Phase 2 also holds binary_probe_lb and quick_probe_select (each at the
vocab index's shape and at the n=1M index's; quick_probe_select one CUDA
kernel a call, its representative rows and Test-A flags equal to the plain
version's, its radius within 1e-6 relative, timed beside the chain of torch
ops around binary_probe_lb that it replaced) and decode_attention (at the
serve shape, where it must be one CUDA kernel a call, and at the JAX
package's decode shapes: decode_32k, S=32,768, at B=8 and at B=128 with
seeded uniform lengths, and long_500k, B=1, S=524,288) against their plain
versions and against a second call (equal bit for bit), with the same four
times and each time's share of the HBM rate, and mips_score at the serve
search's tile (R=32,000, B=4, d=2,048). Two bit-for-bit checks fail the run
if they do not hold: mips_score's small-batch path against its tile path at
the serve tile (1% of the rows invalid, exactly -1e30), and sketch_scores
against the ordered LUT sum `ref.sketch_scores_lut_ref` at n=1M, at both of
the kernel's query-group sizes there (8 for the batch of 64, 4 for its
first 4 queries). The B sweep of mips_score (B = 1..64 at the serve tile
and at the stream delta's shape, the small path, the tile path and
torch.matmul + masked_fill_ in turns) prints one line per shape; its
crossover sets the kernel's B_SMALL.
Phases 7-9 (sharded-1M, sharded-stream-100k, durable-stream-1M) are
described at their functions. Then:
  10. the autotuner (`tune.search.tune_point`) at the LARGE_N point on the
      card, writing its entry into a temporary copy of
      results/tune/tuning.json: every candidate with a status and none in
      error, the key naming the card and torch, the JAX entry unchanged as
      text, the cache-driven search equal bit for bit to the explicit tuned
      one, the tuned search equal to the hand-picked one in ids and scores,
      the cache off equal to the explicit hand-picked search; each
      candidate's ratio and verdict, the two medians in turns, the stage
      cutouts against `launch.roofline`'s bound; then `python -m
      repro_torch.tune` in a subprocess;
  11. the paper's four dataset proxies (netflix, yahoo and p53 at full size,
      sift at 200,000 rows) through `api.build(backend="promips")` with the
      quickstart's guarantee and the main path's knobs: kernels against the
      plain path (ids equal, scores within REL / ABS, flips reported), the
      progressive mode, recall, overall ratio and the Theorem-2 share
      against an exact top-k, pages, medians, launches and peak memory;
      then examples/quickstart_torch.py in a subprocess;
  12. training (no kernel: the JAX training attention is jnp under a
      custom_vjp, and so is the port's): (a) three `make_train_step` steps
      of each of the four dense configs, reduced, on the card and on the
      CPU from one set of parameters (TF32 off), losses, grad norms and
      every leaf of params, mu, nu (and the int8 residuals) held within
      `train.parity`'s tolerance; (b) `launch.train.main` at tinyllama-1.1b's
      full width, 8 steps of 8 x 256 tokens with checkpoints at steps 4 and
      8 under build/: the loss falls, both steps complete, a rerun from
      step_4 reproduces steps 4-7; step time, tokens/s, peak memory, each
      checkpoint's bytes and seconds, two identical steps compared leaf by
      leaf, and one step's device time by op under torch.profiler.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the LARGE_N recipe (benchmarks/paper_figures.py), shipped search knobs
RECIPE = dict(d=128, rank=16, decay=0.5, norm_tail=0.6)
BUILD = dict(m=16, c=0.9, p=0.6, k_p=8, k_sp=8, norm_strata=8, seed=0)
SEARCH = dict(k=10, prefilter=True, prefilter_eps=0.1, dense_frac=0.8)
N_QUERIES = 64
JAX_CPU_RECORD_100K = dict(pages_mean=1386.14, pages_frac=0.111, recall=0.9984)

# the device the smoke run drives (a CPU rehearsal of the serve phase with
# the kernels' plain versions may set it to "cpu"; the run itself needs the
# card)
DEVICE = "cuda"
# the bounds' constants (H100 SXM, NVIDIA data sheet) and counts live in
# src/repro_torch/launch/roofline.py
# kernel vs plain version: |difference| <= REL * ||q|| * ||row|| + ABS
REL, ABS = 1e-5, 1e-6


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------- timing

class Timer:
    """Per-call CUDA-event timing with the L2 cache flushed before each call
    (the main path finds its inputs cold).

    ``hold=True`` (device time) first parks the card in a spin kernel long
    enough for the host to enqueue the whole call, so the events bracket the
    call's device work only; ``hold=False`` leaves the card waiting on the
    host, so the time includes the wrapper's host-side cost."""

    HOLD_CYCLES = 10_000_000  # ~5 ms at the H100's clock, above any enqueue

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, warm=2, iters=10, hold=True):
        torch = self.torch
        for _ in range(warm):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            if hold:
                torch.cuda._sleep(self.HOLD_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


# ---------------------------------------------------------------- phase 1

def phase_setup():
    import torch
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path, build_log = build.build()
    build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")
    # ptxas's report of each kernel: registers, stack frame and spills; a
    # kernel that spills fails the run
    kernel, frame, spilled = "?", "", []
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            frame = line.strip()
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", frame):
                spilled.append(kernel)
        elif "registers" in line:
            log(f"[build] {kernel[:100]}: {line.split(':', 1)[1].strip()}; "
                f"{frame}")
    require(not spilled, f"kernels that spill registers: {spilled}")
    return smi.splitlines()[0]


# ---------------------------------------------------------------- data

def build_size(n, seed_queries=1):
    import torch
    from repro_torch.core.promips import ProMIPS
    from repro_torch.data.synthetic import mf_factors
    t0 = time.perf_counter()
    x = mf_factors(n, RECIPE["d"], RECIPE["rank"], decay=RECIPE["decay"],
                   norm_tail=RECIPE["norm_tail"], seed=0)
    q = mf_factors(N_QUERIES, RECIPE["d"], RECIPE["rank"],
                   decay=RECIPE["decay"], seed=seed_queries)
    pm = ProMIPS.build(x, device="cuda", **BUILD)
    log(f"[build n={n}] host index build {time.perf_counter() - t0:.1f} s: "
        f"NB={pm.meta.n_blocks} G={pm.meta.n_groups} S={pm.meta.n_subparts} "
        f"page_rows={pm.meta.page_rows} sketch M={pm.meta.sk_subspaces} "
        f"K={pm.meta.sk_codewords}")
    return pm, torch.from_numpy(x).cuda(), torch.from_numpy(q).cuda()


# ---------------------------------------------------------------- phase 2

def _row_tol(x_rows, qv):
    return REL * x_rows.double().norm(dim=-1) * qv.double().norm() + ABS


def check_block_mips(args, k, page_rows, got, want):
    """Hold a kernel round against the plain round. Equal except where a
    flip is explained: a cnt difference needs a valid row of that slot whose
    exact score lies within tolerance of c_half (that query's later
    accounting is then not compared); a top-k row difference needs the two
    rows' exact scores within tolerance. Returns (max |score diff|, flips)."""
    import torch
    x, valid, q, slots, sel, init_s, init_r, c_half = args
    g = [t.cpu() for t in got]
    w = [t.cpu() for t in want]
    slots_c, c_half_c = slots.cpu().long(), c_half.cpu().double()
    flipped = set()
    worst = 0.0
    for b, j in (g[2] != w[2]).nonzero().tolist():
        rows = slots_c[j] * page_rows + torch.arange(page_rows)
        xr = x[rows.cuda()]
        s64 = (xr.double() @ q[b].double()).cpu()
        near = ((s64 - c_half_c[b]).abs() / _row_tol(xr, q[b]).cpu())
        near = near[valid[rows.cuda()].cpu()]
        require(near.numel() and float(near.min()) <= 1.0,
                f"block_mips cnt[{b},{j}] {int(g[2][b, j])} != {int(w[2][b, j])} "
                "with no row near c_half")
        worst = max(worst, float(near.min()))
        flipped.add(b)
    keep = torch.tensor([b not in flipped for b in range(q.shape[0])])
    require(torch.equal(g[3][keep], w[3][keep]), "block_mips pages differ")
    require(torch.equal(g[4][keep], w[4][keep]), "block_mips cand differ")
    kq = keep.nonzero().flatten()
    gs, ws, gr, wr = g[0][kq], w[0][kq], g[1][kq], w[1][kq]
    same = gr == wr
    inf = torch.isinf(gs) | torch.isinf(ws)
    require(bool((gs[same & inf] == ws[same & inf]).all()),
            "block_mips: an infinite top_s differs on the same row")
    fin = same & ~inf
    x_norm = x.norm(dim=1).double().cpu()
    tol = (REL * x_norm[gr.clamp(min=0).long()]
           * q.double().norm(dim=1).cpu()[kq][:, None] + ABS)
    err = (gs.double() - ws.double()).abs()
    require(bool((err[fin] <= tol[fin]).all()),
            f"block_mips top_s beyond tolerance by "
            f"{float((err - tol)[fin].max()) if fin.any() else 0.0}")
    max_err = float(err[fin].max()) if bool(fin.any()) else 0.0
    tie_flips = 0
    for i, j in (~same).nonzero().tolist():   # a row difference is a tie
        b, rg, rw = int(kq[i]), int(gr[i, j]), int(wr[i, j])
        require(rg >= 0 and rw >= 0, f"block_mips top_r[{b},{j}] {rg} vs {rw}")
        e = (x[[rg, rw]].double() @ q[b].double()).cpu()
        t = float(_row_tol(x[rg], q[b]))
        require(abs(float(e[0] - e[1])) <= t,
                f"block_mips top_r[{b},{j}] {rg} vs {rw}: exact scores "
                f"{float(e[0])} vs {float(e[1])} are not a tie")
        tie_flips += 1
    return max_err, dict(cnt_flip_queries=len(flipped), tie_flips=tie_flips,
                         worst_cnt_margin=worst)


def _bound(rec):
    """(ms, "bytes" or "operations") of a `launch.roofline` record."""
    return (1e3 * rec["roofline_s"],
            "operations" if rec["bound"] == "compute" else "bytes")


def block_mips_bound_ms(args, k, page_rows):
    """Least time for one round (`roofline.block_mips`): the pages any query
    selects, every selected (query, page) pair scored once."""
    from repro_torch.launch import roofline
    x, valid, q, slots, sel, init_s, init_r, c_half = args
    b, d = q.shape
    return _bound(roofline.block_mips(b, d, k, page_rows, slots.shape[0],
                                      int(sel.any(dim=0).sum()),
                                      int(sel.sum())))


def mips_score_bound_ms(x, q):
    """`roofline.mips_score`: rows read once, scores written once, against
    2 R B d fp32 operations."""
    from repro_torch.launch import roofline
    return _bound(roofline.mips_score(x.shape[0], q.shape[0], x.shape[1]))


def sketch_bound_ms(q, codebooks, codes):
    from repro_torch.launch import roofline
    b, d = q.shape
    m, kcw, sub_d = codebooks.shape
    return _bound(roofline.sketch_scores(b, d, codes.shape[0], m, kcw, sub_d))


def binary_probe_bound_ms(b, g, m):
    """`roofline.binary_probe_lb`: codes, query codes and projections read
    once, bounds written once, one multiply-add per bit."""
    from repro_torch.launch import roofline
    return _bound(roofline.binary_probe_lb(b, g, m))


def decode_attention_bound_ms(q, k, cache_len):
    """`roofline.decode_attention` over the cache rows each sequence needs
    (cache_len of them, all S when it is 0)."""
    from repro_torch.launch import roofline
    b, kh, g, dh = q.shape
    s = k.shape[1]
    n = cache_len.clamp(max=s)
    rows = int(n.masked_fill(n <= 0, s).sum())
    return _bound(roofline.decode_attention(b, kh, g, dh, rows))


def check_binary_probe(timer, label, codes, q_proj):
    """binary_probe_lb against its plain version (|d| <= 1e-6 |lb| + 1e-7),
    timed. Returns the kernel line's record."""
    import torch
    from repro_torch.core.quick_probe import pack_codes
    from repro_torch.kernels import ops
    q_code = pack_codes(q_proj)
    args = (codes, q_code, q_proj)
    got = ops.binary_probe_lb(*args, use_kernels=True)
    want = ops.binary_probe_lb(*args, use_kernels=False)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = 1e-6 * want.abs() + 1e-7
    require(bool((diff <= tol).all()),
            f"binary_probe_lb {label}: |d| beyond 1e-6|lb|+1e-7 by "
            f"{float((diff - tol).max())}")
    b, m = q_proj.shape
    g = codes.shape[0]
    shifts = torch.arange(m, device=codes.device)
    bits = (((codes[None, :] ^ q_code[:, None])[..., None] >> shifts) & 1).float()
    qabs = q_proj.abs()[..., None]
    rec = dict(
        name="binary_probe_lb", route="cuda",
        source="src/repro_torch/kernels/csrc/binary_probe.cu",
        replaces="src/repro/kernels/binary_probe.py:30",
        max_abs_err=float(diff.max()),
        ms=timer.ms(lambda: ops.binary_probe_lb(*args, use_kernels=True)),
        call_ms=timer.ms(lambda: ops.binary_probe_lb(*args, use_kernels=True),
                         hold=False),
        plain_ms=timer.ms(lambda: ops.binary_probe_lb(*args, use_kernels=False)),
        library_ms=timer.ms(lambda: torch.matmul(bits, qabs)))
    rec["bound_ms"], rec["bound_by"] = binary_probe_bound_ms(b, g, m)
    log(f"[kernel binary_probe_lb: {label}] B={b} G={g} m={m}: "
        f"max|d|={rec['max_abs_err']:.3g} (tol 1e-6|lb|+1e-7)  device "
        f"{rec['ms']:.4f} ms (call with host {rec['call_ms']:.4f} ms)  plain "
        f"{rec['plain_ms']:.4f} ms  torch.matmul of the unpacked bits "
        f"{rec['library_ms']:.4f} ms  bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']})")
    return rec


def quick_probe_bound_ms(b, g, m):
    """`roofline.quick_probe_select`: the group table and the batch read
    once, three outputs a query; a multiply-add per bit and about ten
    operations of Test A per (query, group)."""
    from repro_torch.launch import roofline
    return _bound(roofline.quick_probe_select(b, g, m))


def probe_chain(table, q_proj, q_l1, c, x_p):
    """The frontend's Quick-Probe as it was before quick_probe_select: the
    binary_probe_lb kernel, then Test A, the choice and the radius as
    separate torch ops, timed beside the fused kernel that replaced it."""
    import torch
    from repro_torch.core.quick_probe import pack_codes
    from repro_torch.kernels import ops
    q_code = pack_codes(q_proj)
    lb = ops.binary_probe_lb(table.code, q_code, q_proj, use_kernels=True)
    valid = table.count > 0
    denom = c * (table.min_l1[None, :] + q_l1[:, None]) ** 2
    val = lb * lb / torch.clamp(denom, min=1e-30)
    passes = (val >= x_p) & valid[None, :]
    any_pass = passes.any(dim=1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=q_proj.device)
    first_pass = torch.argmin(torch.where(passes, lb, inf), dim=1)
    best_val = torch.argmax(torch.where(valid[None, :], val, -inf), dim=1)
    chosen = torch.where(any_pass, first_pass, best_val)
    rep = table.rep_proj[chosen]
    radius = torch.sqrt(((rep - q_proj) ** 2).sum(dim=-1))
    return table.rep_row[chosen], radius, any_pass


def cuda_kernels_of(fn, n_calls=3, sessions=3):
    """The CUDA kernels (and copies) of ``n_calls`` calls of ``fn``, as
    torch.profiler sees them, and the sessions it took. The calls sit
    between sentinel kernels (short spins, three before and one after);
    this tracer can drop the first records of a session, which the leading
    sentinels absorb. A session whose trace does not end with the trailing
    sentinel, or holds fewer records than calls, lost records and is taken
    again, up to ``sessions`` times."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        kernels = [n for n in names if "spin_kernel" not in n]
        if names and "spin_kernel" in names[-1] and len(kernels) >= n_calls:
            return kernels, session
    raise SmokeFailure(f"torch.profiler lost records in {sessions} sessions "
                       f"in a row (last trace: {names})")


def host_enqueue_us(fn, n_calls=20):
    """Host time of one call of ``fn`` issued to an idle card (a sync
    before each call, none after it): what the host spends to enqueue it,
    plus any wait the call itself imposes (a pageable copy)."""
    import torch
    fn()
    total = 0.0
    for _ in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / n_calls * 1e6


def check_quick_probe(timer, label, table, q_proj, q_l1, c, x_p):
    """quick_probe_select against its plain version (rep_row and Test A
    equal, the radius within 1e-6 relative + 1e-7) and against itself (a
    second call equal bit for bit), one CUDA kernel a call, timed beside
    the torch chain it replaced. Returns the kernel line's record."""
    import torch
    from repro_torch.kernels import ops
    args = (table.code, table.min_l1, table.count, table.rep_proj,
            table.rep_row, q_proj, q_l1, c, x_p)
    got = ops.quick_probe_select(*args, use_kernels=True)
    again = ops.quick_probe_select(*args, use_kernels=True)
    want = ops.quick_probe_select(*args, use_kernels=False)
    chain = probe_chain(table, q_proj, q_l1, c, x_p)
    torch.cuda.synchronize()
    require(all(torch.equal(a, w) for a, w in zip(got, again)),
            f"quick_probe_select {label}: two calls on the same input differ")
    require(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
            f"quick_probe_select {label}: the chosen rows or Test-A flags "
            f"differ from the plain version's in "
            f"{int(((got[0] != want[0]) | (got[2] != want[2])).sum())} queries")
    require(torch.equal(got[0], chain[0]) and torch.equal(got[2], chain[2]),
            f"quick_probe_select {label}: the choice differs from the "
            "binary_probe_lb chain's, whose bounds are the same bits")
    diff = (got[1] - want[1]).abs()
    tol = 1e-6 * want[1].abs() + 1e-7
    require(bool((diff <= tol).all()),
            f"quick_probe_select {label}: radius beyond 1e-6 relative by "
            f"{float((diff - tol).max())}")
    fused = lambda: ops.quick_probe_select(*args, use_kernels=True)  # noqa: E731
    kernels, sessions = cuda_kernels_of(fused)
    require(len(kernels) == 3 and all("quick_probe_kernel" in k
                                      for k in kernels),
            f"quick_probe_select {label}: not one CUDA kernel a call in 3 "
            f"calls ({sessions} profiler sessions): {kernels}")
    chain_fn = lambda: probe_chain(table, q_proj, q_l1, c, x_p)  # noqa: E731
    chain_kernels = cuda_kernels_of(chain_fn, n_calls=1)[0]
    b, m = q_proj.shape
    g = table.code.shape[0]
    rec = dict(
        name="quick_probe_select", route="cuda",
        source="src/repro_torch/kernels/csrc/binary_probe.cu",
        replaces="src/repro/kernels/binary_probe.py:30",
        max_abs_err=float(diff.max()),
        ms=timer.ms(fused), call_ms=timer.ms(fused, hold=False),
        plain_ms=timer.ms(lambda: ops.quick_probe_select(*args,
                                                         use_kernels=False)),
        chain_ms=timer.ms(chain_fn), chain_call_ms=timer.ms(chain_fn, hold=False),
        host_us=host_enqueue_us(fused), chain_host_us=host_enqueue_us(chain_fn),
        library_ms=None)
    rec["bound_ms"], rec["bound_by"] = quick_probe_bound_ms(b, g, m)
    log(f"[kernel quick_probe_select: {label}] B={b} G={g} m={m}: rep_row and "
        f"Test A equal to the plain version's ({int(got[2].sum())} of {b} "
        f"pass), radius max|d|={rec['max_abs_err']:.3g} (tol 1e-6|r|+1e-7), "
        f"two calls equal bit for bit, one CUDA kernel a call "
        f"({kernels[0][:40]}; {sessions} profiler sessions)  device "
        f"{rec['ms']:.4f} ms (call with host {rec['call_ms']:.4f} ms; host "
        f"enqueue {rec['host_us']:.1f} us)  "
        f"plain {rec['plain_ms']:.4f} ms  the binary_probe_lb chain it "
        f"replaced: {len(chain_kernels)} CUDA kernels and copies, device "
        f"{rec['chain_ms']:.4f} ms (call with host {rec['chain_call_ms']:.4f} "
        f"ms; host enqueue {rec['chain_host_us']:.1f} us)  bound "
        f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def vocab_probe_table(gen):
    """A Quick-Probe table of the vocab index's shape (all 256 sign codes of
    m = 8, B = 4), seeded, with x_p in the widest gap of the tested values
    near their median, so some groups pass and none sits within an ulp of
    the cut. Returns (table, q_proj, q_l1, c, x_p)."""
    import torch
    from repro_torch.core.quick_probe import GroupTable, pack_codes
    from repro_torch.kernels import ref
    g, m, b, c = 256, 8, 4, 0.9
    table = GroupTable(
        code=torch.arange(g, dtype=torch.int64, device=DEVICE),
        min_l1=torch.rand(g, generator=gen, device=DEVICE) * 40 + 20,
        rep_proj=torch.randn((g, m), generator=gen, device=DEVICE),
        rep_row=torch.randperm(32_000, generator=gen, device=DEVICE)[:g].int(),
        count=torch.randint(1, 400, (g,), generator=gen, device=DEVICE).int())
    q_proj = torch.randn((b, m), generator=gen, device=DEVICE) * 8
    q_l1 = q_proj.abs().sum(dim=1) * 16
    lb = ref.binary_probe_lb_ref(table.code, pack_codes(q_proj), q_proj)
    val = (lb.double() ** 2 / (c * (table.min_l1.double()[None, :]
                                    + q_l1.double()[:, None]) ** 2)).flatten()
    val = torch.sort(val).values
    lo, hi = int(0.4 * val.numel()), int(0.6 * val.numel())
    i = lo + int(torch.argmax(val[lo + 1:hi] - val[lo:hi - 1]))
    return table, q_proj, q_l1, c, float(val[i] + val[i + 1]) / 2


def check_decode_attention(timer, label, b, s, lens, seed, kh=4, g=8, dh=64,
                           count_launches=False):
    """decode_attention against its plain version on seeded normal inputs
    (|d| <= 1e-5 max|v| + 1e-6) and against itself (a second call equal bit
    for bit), timed, with scaled_dot_product_attention (length mask, the G
    query rows of a KV head as its query-length axis) as the library
    yardstick. ``count_launches`` also holds the call
    to one CUDA kernel under torch.profiler. Returns the kernel line's
    record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    q = torch.randn((b, kh, g, dh), generator=gen, device=DEVICE)
    k = torch.randn((b, s, kh, dh), generator=gen, device=DEVICE)
    v = torch.randn((b, s, kh, dh), generator=gen, device=DEVICE)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    args = (q, k, v, cache_len)
    got = ops.decode_attention(*args, use_kernels=True)
    again = ops.decode_attention(*args, use_kernels=True)
    want = ops.decode_attention(*args, use_kernels=False)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = 1e-5 * v.abs().amax(dim=(1, 2, 3))[:, None, None, None] + 1e-6
    require(bool((diff <= tol).all()),
            f"decode_attention {label}: |d| beyond 1e-5 max|v|+1e-6 by "
            f"{float((diff - tol).max())}")
    require(torch.equal(got, again), f"decode_attention {label}: two calls on "
            f"the same input differ in {int((got != again).sum())} entries")
    launches = ""
    if count_launches:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ops.decode_attention(*args, use_kernels=True)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        require(len(kernels) == 1, f"decode_attention {label}: {len(kernels)} "
                f"CUDA kernels in one call: {kernels}")
        launches = f"; one CUDA kernel a call ({kernels[0][:40]})"
    # G as the query-length axis: each KV head's G query rows attend to its
    # own K and V, so the library call needs no GQA expansion of the cache
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(s, device=DEVICE)[None, :]
            < cache_len[:, None].long())[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q, ks, vs, attn_mask=mask)

    lib_err = float((sdpa() - want).abs().max())
    library_ms = timer.ms(sdpa)
    rec = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66",
        max_abs_err=float(diff.max()),
        ms=timer.ms(lambda: ops.decode_attention(*args, use_kernels=True)),
        call_ms=timer.ms(lambda: ops.decode_attention(*args, use_kernels=True),
                         hold=False),
        plain_ms=timer.ms(lambda: ops.decode_attention(*args, use_kernels=False)),
        library_ms=library_ms)
    rec["bound_ms"], rec["bound_by"] = decode_attention_bound_ms(q, k, cache_len)
    log(f"[kernel decode_attention: {label}] B={b} S={s} KH={kh} G={g} dh={dh} "
        f"cache_len={lens if len(lens) <= 8 else '...'}: max|d|="
        f"{rec['max_abs_err']:.3g} (tol 1e-5 max|v|+1e-6), two calls equal bit "
        f"for bit{launches}  device {rec['ms']:.4f} ms "
        f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of the HBM rate; call with "
        f"host {rec['call_ms']:.4f} ms)  plain {rec['plain_ms']:.4f} ms  "
        f"scaled_dot_product_attention {library_ms:.4f} ms (max|d| to plain "
        f"{lib_err:.3g})  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def check_sketch_bitwise(q, codebooks, codes, est):
    """sketch_scores bit for bit against the ordered LUT sum in torch:
    ``est``, what the wrapper returned for the batch (query groups of 8),
    and the kernel on the batch's first 4 queries (a group of 4)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch_scores as sk
    for label, qb, got in (("the batch", q, est),
                           ("4 queries", q[:4], None)):
        want = ref.sketch_scores_lut_ref(qb, codebooks, codes)
        if got is None:
            got = sk.sketch_scores(qb, codebooks, codes)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"sketch_scores on {label} is not "
                f"bit-identical to the ordered LUT sum: "
                f"{int((got != want).sum())} entries differ, max |d| "
                f"{float((got - want).abs().max()):.3g}")
    log("[kernel sketch_scores] bit-identical to the ordered LUT sum "
        "(ref.sketch_scores_lut_ref) with query groups of 8 and of 4")


def sweep_mips_score(timer, shapes):
    """The B sweep of mips_score: at each (label, x) of ``shapes`` and each
    B, the small-batch path (for B <= B_SMALL), the tile path and
    torch.matmul + masked_fill_, in turns; one line per shape. The wrapper
    takes the small path for B <= B_SMALL."""
    import torch
    from repro_torch.kernels import mips_score as ms
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(15)
    b_small = ms.b_small()
    for label, x in shapes:
        r, d = x.shape
        valid = torch.ones(r, dtype=torch.bool, device=DEVICE)
        cells = []
        for b in (1, 2, 4, 8, 16, 32, 64):
            qb = torch.randn((b, d), generator=gen, device=DEVICE)
            t_s = (timer.ms(lambda: ms._launch(x, qb, valid, ms.SMALL))
                   if b <= b_small else None)
            t_l = timer.ms(lambda: torch.matmul(x, qb.T).masked_fill_(
                ~valid[:, None], -1e30))
            t_t = timer.ms(lambda: ms._launch(x, qb, valid, ms.TILE))
            small = "-" if t_s is None else f"{t_s:.4f}"
            cells.append(f"B={b}: small {small} tile {t_t:.4f} "
                         f"matmul {t_l:.4f}")
        log(f"[mips_score B sweep: {label}] R={r} d={d} (ms; B_SMALL="
            f"{b_small}): " + " | ".join(cells))


def phase_kernels_serve(pm, q, timer):
    """The serve path's kernels against their plain versions:
    binary_probe_lb and quick_probe_select at the vocab index's shape
    (every one of the 256 sign codes of m = 8, B = 4) and at the n=1M
    index's (its group table, the batch's projections); decode_attention at
    the serve shape and at the JAX package's decode shapes (decode_32k at
    B 8 and B 128, long_500k);
    mips_score at the serve search's union tile. Returns the records of the
    kernel line (the serve shapes; quick_probe_select's at n=1M)."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import mf_factors
    from repro_torch.kernels import mips_score as ms_wrapper
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    vocab_codes = torch.arange(256, dtype=torch.int64, device=DEVICE)
    bp_rec = check_binary_probe(timer, "vocab index shape", vocab_codes,
                                torch.randn((4, 8), generator=gen, device=DEVICE))
    check_binary_probe(timer, "n=1M index", pm.arrays.g_code, q @ pm.arrays.a)
    from repro_torch.core import search_device as sd
    check_quick_probe(timer, "vocab index shape", *vocab_probe_table(gen))
    qp_rec = check_quick_probe(timer, "n=1M index", sd._group_table(pm.arrays),
                               q @ pm.arrays.a, q.abs().sum(dim=1), pm.meta.c,
                               pm.meta.x_p)
    da_rec = check_decode_attention(timer, "serve shape", 4, 512,
                                    [1, 37, 300, 512], seed=12,
                                    count_launches=True)
    # the JAX package's decode shapes (`src/repro/configs/base.py`)
    lens = [32768, 1, 20000, 4097, 64, 31000, 12345, 27000]
    check_decode_attention(timer, "decode_32k shape, B 8", 8, 32768, lens,
                           seed=13)
    lens = np.random.RandomState(16).randint(1, 32769, 128).tolist()
    check_decode_attention(timer, "decode_32k shape, B 128", 128, 32768, lens,
                           seed=17)
    check_decode_attention(timer, "long_500k shape", 1, 524288, [524288],
                           seed=18)
    torch.cuda.empty_cache()
    # mips_score at the serve search's tile: every vocab row at full budget
    xt = torch.from_numpy(mf_factors(32_000, 2048, 64, decay=0.5,
                                     seed=14)).to(DEVICE)
    qt = torch.randn((4, 2048), generator=gen, device=DEVICE)
    vt = torch.ones(32_000, dtype=torch.bool, device=DEVICE)
    got = ops.mips_score(xt, qt, vt, use_kernels=True)
    want = ops.mips_score(xt, qt, vt, use_kernels=False)
    torch.cuda.synchronize()
    tol = REL * xt.norm(dim=1)[:, None] * qt.norm(dim=1)[None, :] + ABS
    require(bool(((got - want).abs() <= tol).all()),
            "mips_score at the serve tile exceeds |d| <= 1e-5*|q||x|+1e-6")
    # the small-batch path bit for bit against the tile path's columns, with
    # 1% of the rows invalid: the batch padded past B_SMALL takes the tile
    # path; the wrapper's own choice at B = 4 is the small path
    v1 = torch.rand(32_000, generator=gen, device=DEVICE) > 0.01
    pad = torch.randn((ms_wrapper.b_small() + 1 - 4, 2048), generator=gen,
                      device=DEVICE)
    small = ms_wrapper._launch(xt, qt, v1, ms_wrapper.SMALL)
    chosen = ops.mips_score(xt, qt, v1, use_kernels=True)
    tile = ops.mips_score(xt, torch.cat([qt, pad]), v1, use_kernels=True)[:, :4]
    torch.cuda.synchronize()
    require(torch.equal(small, chosen), "mips_score at the serve tile does "
            "not take its small-batch path")
    require(torch.equal(small, tile), "mips_score small path != tile path at "
            f"the serve tile: {int((small != tile).sum())} scores differ")
    require(bool((small[~v1] == -1e30).all()),
            "mips_score: an invalid row is not exactly -1e30")
    t_k = timer.ms(lambda: ops.mips_score(xt, qt, vt, use_kernels=True))
    t_c = timer.ms(lambda: ops.mips_score(xt, qt, vt, use_kernels=True),
                   hold=False)
    t_p = timer.ms(lambda: ops.mips_score(xt, qt, vt, use_kernels=False))
    t_l = timer.ms(lambda: torch.matmul(xt, qt.T).masked_fill_(~vt[:, None], -1e30))
    bound, by = mips_score_bound_ms(xt, qt)
    log(f"[kernel mips_score: serve tile] R=32000 B=4 d=2048: max|d|="
        f"{float((got - want).abs().max()):.3g}; small path = tile path bit "
        f"for bit ({int((~v1).sum())} invalid rows exactly -1e30)  device "
        f"{t_k:.4f} ms (call with host {t_c:.4f} ms)  plain {t_p:.4f} ms  "
        f"torch.matmul+masked_fill {t_l:.4f} ms  bound {bound:.4f} ms ({by})")
    xd = torch.from_numpy(mf_factors(131_072, RECIPE["d"], RECIPE["rank"],
                                     decay=RECIPE["decay"],
                                     norm_tail=RECIPE["norm_tail"],
                                     seed=3)).to(DEVICE)
    sweep_mips_score(timer, [("serve tile", xt), ("stream delta", xd)])
    return [bp_rec, qp_rec, da_rec]


def block_mips_cases(pm, q):
    """The seven block_mips rounds of phase 2 on the n=1M index, as (label,
    args, dense, k): the main path's round-1 tile, a sparse pow2 tile with
    padding slots, the dense tile of the same pairs, round 2 with a carried
    top-k, round 1 where the Condition-A stop fires, and round 1 at the
    stream's k = 2,058 and at k = 16,394."""
    import numpy as np
    import torch
    from repro_torch.core import search_device as sd
    from repro_torch.core.search_fused import _plan_tile
    from repro_torch.kernels import ops
    arrays = pm.arrays
    k, pr, nb = SEARCH["k"], pm.meta.page_rows, pm.meta.n_blocks
    valid = arrays.ids >= 0
    *_, c_half, mask0 = sd.select_frontend(arrays, pm.meta, q)
    mask_r1 = sd.prefilter_round1(arrays, q, mask0, k, pr,
                                  SEARCH["prefilter_eps"], True)[0]
    mask_np = mask_r1.cpu().numpy()
    union = np.nonzero(mask_np.any(axis=0))[0]
    n_sub = min(3000, len(union) // 3)       # 3000 union blocks -> 4096 slots
    n_sub -= n_sub > 1 and (n_sub & (n_sub - 1)) == 0   # never a power of 2
    sub = np.zeros(nb, bool)
    sub[union[:n_sub]] = True

    def empty_top(kk):
        return (torch.full((q.shape[0], kk), float("-inf"), device=q.device),
                torch.full((q.shape[0], kk), -1, dtype=torch.int32,
                           device=q.device))

    empty = empty_top(k)
    main_plan = _plan_tile(mask_np, nb, nb, SEARCH["dense_frac"])

    def as_args(plan, init, c=c_half):
        slots, sel = plan[0], plan[1]
        return (arrays.x, valid, q, torch.from_numpy(slots).cuda(),
                torch.from_numpy(np.ascontiguousarray(sel)).cuda(), init[0],
                init[1], c)

    dense_args = as_args((np.arange(nb, dtype=np.int32), mask_np), empty)
    cases = [("main path round 1", as_args(main_plan, empty), main_plan[3], k),
             ("sparse pow2 tile", as_args(_plan_tile(mask_np & sub[None], nb, nb,
                                                     SEARCH["dense_frac"]), empty),
              False, k),
             ("dense tile", dense_args, True, k)]
    top1 = ops.block_mips(*dense_args, k=k, page_rows=pr, use_kernels=False)
    round2 = (mask0 & ~mask_r1).cpu().numpy()     # blocks the prefilter cut
    plan2 = _plan_tile(round2, nb, nb, SEARCH["dense_frac"])
    cases.append(("round 2, carried top-k", as_args(plan2, top1[:2]), None, k))
    # The Condition-A stop: carry the top-k of the blocks the prefilter cut
    # into the round-1 tile, with c_half at each query's 5th carried score,
    # so 5 hits are carried and the scan stops at the 5th hit in the tile.
    top2 = ops.block_mips(*as_args(plan2, empty), k=k, page_rows=pr,
                          dense=bool(plan2[3]), use_kernels=False)
    c_stop = top2[0][:, 4].contiguous()
    require(bool(torch.isfinite(c_stop).all()),
            "the stop case needs 5 carried scores per query")
    cases.append(("round 1 after a carried top-k, Condition-A stop",
                  as_args(main_plan, top2[:2], c_stop), main_plan[3], k))
    # the streaming over-fetch: k_base = 10 + next_pow2(2,000 tombstones),
    # and a k whose sort crosses the merge's cluster in device memory
    for kk in (2_058, 16_394):
        cases.append((f"main path round 1 at k={kk}",
                      as_args(main_plan, empty_top(kk)), main_plan[3], kk))
    return cases


def phase_kernels(pm, q, timer):
    """Each kernel against its plain version at the n=1M main path's shapes.
    Returns the records of the kernel line (launches filled in later)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    arrays, meta = pm.arrays, pm.meta
    pr, nb = meta.page_rows, meta.n_blocks

    # -- sketch_scores
    sk = (q, arrays.sk_mu, arrays.sk_codebooks, arrays.sk_codes)
    est_k = ops.sketch_scores(*sk, use_kernels=True)
    est_p = ops.sketch_scores(*sk, use_kernels=False)
    torch.cuda.synchronize()
    tol = REL * q.norm(dim=1)[:, None] * arrays.sk_mu.norm(dim=1)[None, :] + ABS
    diff = (est_k - est_p).abs()
    require(bool((diff <= tol).all()),
            f"sketch_scores exceeds |d| <= 1e-5*|q||mu|+1e-6: max excess "
            f"{float((diff - tol).max())}")
    sk_rec = dict(
        name="sketch_scores", route="cuda",
        source="src/repro_torch/kernels/csrc/sketch_scores.cu",
        replaces="src/repro/kernels/block_mips.py:140",
        max_abs_err=float(diff.max()),
        ms=timer.ms(lambda: ops.sketch_scores(*sk, use_kernels=True)),
        call_ms=timer.ms(lambda: ops.sketch_scores(*sk, use_kernels=True),
                         hold=False),
        plain_ms=timer.ms(lambda: ops.sketch_scores(*sk, use_kernels=False)),
        library_ms=timer.ms(lambda: torch.matmul(q, arrays.sk_mu.T)))
    sk_rec["bound_ms"], sk_rec["bound_by"] = sketch_bound_ms(
        q, arrays.sk_codebooks, arrays.sk_codes)
    log(f"[kernel sketch_scores] B={q.shape[0]} NB={nb} M={meta.sk_subspaces} "
        f"K={meta.sk_codewords}: max|d|={sk_rec['max_abs_err']:.3g} "
        f"(tol 1e-5*|q||mu|+1e-6)  device {sk_rec['ms']:.4f} ms (call with "
        f"host {sk_rec['call_ms']:.4f} ms)  plain "
        f"{sk_rec['plain_ms']:.4f} ms  torch.matmul {sk_rec['library_ms']:.4f} ms"
        f"  bound {sk_rec['bound_ms']:.4f} ms ({sk_rec['bound_by']})")
    check_sketch_bitwise(q, arrays.sk_codebooks, arrays.sk_codes, est_k)

    # -- mips_score on a delta of the stream-1M cell's shape
    from repro_torch.data.synthetic import mf_factors
    r_delta = 131_072
    xd = torch.from_numpy(mf_factors(r_delta, RECIPE["d"], RECIPE["rank"],
                                     decay=RECIPE["decay"],
                                     norm_tail=RECIPE["norm_tail"],
                                     seed=3)).cuda()
    vd = torch.from_numpy(np.random.RandomState(7).rand(r_delta) > 0.01).cuda()
    ms_k = ops.mips_score(xd, q, vd, use_kernels=True)
    ms_p = ops.mips_score(xd, q, vd, use_kernels=False)
    torch.cuda.synchronize()
    tol = REL * xd.norm(dim=1)[:, None] * q.norm(dim=1)[None, :] + ABS
    diff = (ms_k - ms_p).abs()
    require(bool((diff <= tol).all()),
            f"mips_score exceeds |d| <= 1e-5*|q||x|+1e-6: max excess "
            f"{float((diff - tol).max())}")
    require(bool((ms_k[~vd] == -1e30).all()),
            "mips_score: an invalid row is not exactly -1e30")
    ms_rec = dict(
        name="mips_score", route="cuda",
        source="src/repro_torch/kernels/csrc/mips_score.cu",
        replaces="src/repro/kernels/mips_topk.py:45",
        max_abs_err=float(diff.max()),
        ms=timer.ms(lambda: ops.mips_score(xd, q, vd, use_kernels=True)),
        call_ms=timer.ms(lambda: ops.mips_score(xd, q, vd, use_kernels=True),
                         hold=False),
        plain_ms=timer.ms(lambda: ops.mips_score(xd, q, vd, use_kernels=False)),
        library_ms=timer.ms(lambda: torch.matmul(xd, q.T).masked_fill_(
            ~vd[:, None], -1e30)))
    ms_rec["bound_ms"], ms_rec["bound_by"] = mips_score_bound_ms(xd, q)
    log(f"[kernel mips_score] R={r_delta} B={q.shape[0]} d={RECIPE['d']} "
        f"invalid rows={int((~vd).sum())}: max|d|={ms_rec['max_abs_err']:.3g} "
        f"(tol 1e-5*|q||x|+1e-6), invalid rows exactly -1e30  device "
        f"{ms_rec['ms']:.4f} ms (call with host {ms_rec['call_ms']:.4f} ms)  "
        f"plain {ms_rec['plain_ms']:.4f} ms  torch.matmul+masked_fill "
        f"{ms_rec['library_ms']:.4f} ms  bound {ms_rec['bound_ms']:.4f} ms "
        f"({ms_rec['bound_by']})")
    del xd, vd, ms_k, ms_p, diff, tol

    cases = block_mips_cases(pm, q)
    bm_rec = None
    for label, args, dense, k in cases:
        slots = args[3]
        got = ops.block_mips(*args, k=k, page_rows=pr, use_kernels=True)
        want = ops.block_mips(*args, k=k, page_rows=pr, dense=bool(dense),
                              use_kernels=False)
        torch.cuda.synchronize()
        err, flips = check_block_mips(args, k, pr, got, want)
        # the kernel's in-order fmaf chains give the plain version's bits
        # at every one of these rounds: hold it to that
        for name, g, w in zip(("top_s", "top_r", "cnt", "pages", "cand"),
                              got, want):
            require(torch.equal(g.view(torch.int32) if g.is_floating_point()
                                else g,
                                w.view(torch.int32) if w.is_floating_point()
                                else w),
                    f"block_mips {label}: {name} not bit for bit the plain "
                    f"version's (max|d score| {err}, {flips})")
        n0 = int((args[5] >= args[7][:, None]).sum())
        stopped = int((got[3] < args[4].sum(dim=1)).sum())
        if "stop" in label:
            require(stopped > 0, f"block_mips {label}: the stop fired for no "
                    "query (pages == selected slots for every query)")
        rec = dict(
            name="block_mips", route="cuda",
            source="src/repro_torch/kernels/csrc/block_mips.cu",
            replaces="src/repro/kernels/block_mips.py:181",
            max_abs_err=err,
            ms=timer.ms(lambda: ops.block_mips(*args, k=k, page_rows=pr,
                                               use_kernels=True)),
            call_ms=timer.ms(lambda: ops.block_mips(*args, k=k, page_rows=pr,
                                                    use_kernels=True), hold=False),
            plain_ms=timer.ms(lambda: ops.block_mips(
                *args, k=k, page_rows=pr, dense=bool(dense), use_kernels=False)),
            library_ms=None)
        rec["bound_ms"], rec["bound_by"] = block_mips_bound_ms(args, k, pr)
        pairs, union = int(args[4].sum()), int(args[4].any(dim=0).sum())
        log(f"[kernel block_mips: {label}] NS={slots.shape[0]} "
            f"selected pairs={pairs} density "
            f"{pairs / args[4].numel():.4f} union pages={union} carried hits={n0} "
            f"stopped queries={stopped} "
            f"pages={float(got[3].float().mean()):.1f}/query: max|d score|={err:.3g} "
            f"(tol 1e-5*|q||x|+1e-6) flips={flips}  device {rec['ms']:.4f} ms "
            f"(call with host {rec['call_ms']:.4f} ms)  plain "
            f"{rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        if bm_rec is None:
            bm_rec = rec                       # the main path's own tile
    return [bm_rec, sk_rec, ms_rec]


# ---------------------------------------------------------------- phases 3-4

def exact_topk(x, q, k):
    """Exact top-k ids and scores on the card: torch.matmul + stable sort."""
    import torch
    s = q @ x.T
    top, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :k], top[:, :k]


def success_rate(scores, exact_scores, c):
    """Theorem-2 success: every rank of the top-k meets <o_i,q> >= c<o_i*,q>
    (ranks with a non-positive exact score hold vacuously)."""
    s, e = scores.double(), exact_scores.double()
    ok = (s >= c * e - 1e-5) | (e <= 0.0)
    return float(ok.all(dim=1).double().mean())


def compare_paths(q, ids_k, st_k, ids_p, st_p, flips, rows_of, block_of,
                  probe=None):
    """Kernel path vs plain path on the card: ids equal, or each difference
    explained by an exact-score tie, by a prefilter cut flip in a block
    that holds one of the rows that differ, or by a Quick-Probe group flip
    of that query (``probe``, from `probe_flips`). ``rows_of(ids)`` gives
    the rows of ids on the card, ``block_of(id)`` the base block of an id
    (-1 for a row outside the base)."""
    probe = probe or {}
    differ = (ids_k != ids_p).any(dim=1).nonzero().flatten().tolist()
    notes = []
    for b in differ:
        a, p = ids_k[b], ids_p[b]
        sa = rows_of(a).double() @ q[b].double()
        sp = rows_of(p).double() @ q[b].double()
        gap = float((sa - sp).abs().max())
        tol = float(_row_tol(rows_of(a), q[b]).max())
        rows = set((a[a != p].tolist())) | set(p[a != p].tolist())
        blocks = {block_of(r) for r in rows if r >= 0} - {-1}
        flipped = flips.get(b, {})
        reached = sorted(blocks & set(flipped))
        require(gap <= tol or reached or b in probe,
                f"query {b}: ids differ between kernel and plain path with "
                f"score gap {gap} > {tol}, no prefilter flip in the blocks of "
                f"the rows that differ (flipped blocks: {flipped}) and no "
                f"Quick-Probe group flip")
        notes.append(f"q{b}: gap {gap:.3g} (tol {tol:.3g}); prefilter flips in "
                     f"the blocks of its differing rows: "
                     f"{ {n: flipped[n] for n in reached} }; Quick-Probe flip "
                     f"margin {probe.get(b)}")
    pages_diff = int((st_k.pages != st_p.pages).sum())
    return differ, notes, pages_diff


def prefilter_flips(arrays, q, mask0, est_bnd, k):
    """Hold the kernel's round-1 sketch estimates against the plain ones
    (|d| <= 1e-5*|q||mu|+1e-6) and compare the two survivor masks. A block
    that survives under one and not the other is a cut flip only if the
    plain estimate lies within tolerance of the cut: |est + bnd - tau| <=
    tol of the block + the largest tol of the query's candidates (how far
    tau, a k-th largest of est - bnd, can move). Returns {query: {block:
    (est + bnd - tau) under the plain estimate}}."""
    import torch
    from repro_torch.core import search_common as sc
    from repro_torch.kernels import ops
    _, _, bnd, bvalid = est_bnd
    sk = (q, arrays.sk_mu, arrays.sk_codebooks, arrays.sk_codes)
    est_k = ops.sketch_scores(*sk, use_kernels=True)
    est_p = ops.sketch_scores(*sk, use_kernels=False)
    tol = REL * q.norm(dim=1)[:, None] * arrays.sk_mu.norm(dim=1)[None, :] + ABS
    diff = (est_k - est_p).abs()
    require(bool((diff <= tol).all()),
            f"sketch_scores exceeds |d| <= 1e-5*|q||mu|+1e-6 on the main "
            f"path's input: max excess {float((diff - tol).max())}")
    mk = sc.sketch_survivors_round1(mask0, est_k, bnd, bvalid, k)
    mp = sc.sketch_survivors_round1(mask0, est_p, bnd, bvalid, k)
    out = {}
    for b in (mk != mp).any(dim=1).nonzero().flatten().tolist():
        cand = mask0[b] & bvalid
        lb = torch.where(cand, est_p[b] - bnd[b], torch.full_like(est_p[b],
                                                                  float("-inf")))
        g = min(2 * k, lb.numel())
        lb = torch.cat([lb, lb.new_full(((-lb.numel()) % g,), float("-inf"))])
        tau = torch.sort(lb.view(-1, g).amax(dim=0)).values[g - k]
        tol_tau = float(tol[b][cand].max())
        out[b] = {}
        for n in (mk[b] != mp[b]).nonzero().flatten().tolist():
            margin = float(est_p[b, n] + bnd[b, n] - tau)
            require(abs(margin) <= float(tol[b, n]) + tol_tau,
                    f"query {b} block {n}: the survivor masks differ, but the "
                    f"plain estimate is {margin} from the cut, beyond "
                    f"{float(tol[b, n]) + tol_tau}")
            out[b][n] = margin
    return out, float(diff.max())


def _hex(t):
    return [float(v).hex() for v in t.flatten().tolist()]


def probe_flips(arrays, meta, q):
    """Hold the frontend's Quick-Probe on the kernel against the plain one:
    the bounds within 1e-6 |lb| + 1e-7, and the chosen group (its
    representative row and Test A) equal. A query whose choice differs is
    a flip only if the plain bounds put the two groups within tolerance of
    each other, or one of them within tolerance of the Test-A threshold;
    the two groups' bounds under both paths are printed in hex. Where the
    group is the same, the radius differs from the plain one in its last
    ulps (the kernel sums its m squares in index order, torch's reduction
    in its own); a round-1 block that this moves across its sphere test must
    have a sub-partition whose distance lies between the two cuts (margin 0:
    the radius's own difference moves it, nothing else), printed in hex.
    Returns ({query: normalized margin}, max |d lb|)."""
    import torch
    from repro_torch.core import search_device as sd
    from repro_torch.core.quick_probe import pack_codes, quick_probe_batch
    from repro_torch.kernels import ops
    table = sd._group_table(arrays)
    q_proj = q @ arrays.a
    q_l1 = q.abs().sum(dim=1)
    q_code = pack_codes(q_proj)
    lb_k = ops.binary_probe_lb(table.code, q_code, q_proj, use_kernels=True)
    lb_p = ops.binary_probe_lb(table.code, q_code, q_proj, use_kernels=False)
    tol = 1e-6 * lb_p.abs() + 1e-7
    diff = (lb_k - lb_p).abs()
    require(bool((diff <= tol).all()),
            f"binary_probe_lb on the main path's input: |d| beyond tolerance "
            f"by {float((diff - tol).max())}")
    rk, r0k, ok_k = quick_probe_batch(table, q_proj, q_l1, meta.c, meta.x_p,
                                      True)
    rp, r0p, ok_p = quick_probe_batch(table, q_proj, q_l1, meta.c, meta.x_p,
                                      False)
    denom = meta.c * (table.min_l1[None, :] + q_l1[:, None]) ** 2
    val = lb_p * lb_p / denom.clamp(min=1e-30)
    tol_val = 2.0 * tol * lb_p / denom.clamp(min=1e-30) + 1e-12
    out = {}
    for b in ((rk != rp) | (ok_k != ok_p)).nonzero().flatten().tolist():
        gk = int((table.rep_row == rk[b]).nonzero()[0])
        gp = int((table.rep_row == rp[b]).nonzero()[0])
        margins = [float((lb_p[b, gk] - lb_p[b, gp]).abs()
                         / (tol[b, gk] + tol[b, gp]))]
        margins += [float((val[b, g] - meta.x_p).abs() / tol_val[b, g])
                    for g in (gk, gp)]
        log(f"[probe] query {b}: kernel group {gk} (Test A {bool(ok_k[b])}), "
            f"plain group {gp} (Test A {bool(ok_p[b])}); bounds of the two "
            f"groups, kernel {_hex(lb_k[b, [gk, gp]])}, plain "
            f"{_hex(lb_p[b, [gk, gp]])}; normalized margins {margins}")
        require(min(margins) <= 1.0,
                f"query {b}: the Quick-Probe group differs between kernel "
                f"(group {gk}) and plain (group {gp}) with no bound within "
                f"tolerance (normalized margins {margins})")
        out[b] = min(margins)
    # the same group: a round-1 block whose sphere test the radius's last
    # ulps move is a flip at margin 0, a sub-partition between the cuts
    same = ((rk == rp) & (ok_k == ok_p)).nonzero().flatten()
    r_tol = 1e-6 * r0p.abs() + 1e-7
    r_err = (r0k - r0p).abs()
    require(bool((r_err[same] <= r_tol[same]).all()),
            f"quick_probe_select radius beyond 1e-6 relative on the main "
            f"path's input by {float((r_err - r_tol)[same].max())}")
    d_sp = sd.subpart_distances(arrays, q_proj)
    mk = sd.blocks_from_radii(arrays, d_sp, r0k)
    mp = sd.blocks_from_radii(arrays, d_sp, r0p)
    moved = {}
    for b, n in (mk != mp).nonzero().tolist():
        if b not in same.tolist():
            continue
        sp = arrays.block_sp_idx[n]
        sp = sp[sp >= 0].long()
        dist = d_sp[b, sp]
        cut_k = r0k[b] + arrays.sp_radius[sp]
        cut_p = r0p[b] + arrays.sp_radius[sp]
        apart = (dist <= cut_k) != (dist <= cut_p)
        require(bool(apart.any()),
                f"query {b} block {n}: the round-1 masks under the kernel's "
                f"and the plain radius differ, but no sub-partition lies "
                f"between the two cuts")
        i = int(apart.nonzero()[0])
        log(f"[probe] query {b} block {n}: radius kernel "
            f"{_hex(r0k[b])[0]} plain {_hex(r0p[b])[0]}; sub-partition "
            f"{int(sp[i])} at distance {_hex(dist[i])[0]} between the cuts "
            f"{_hex(cut_k[i])[0]} (kernel) and {_hex(cut_p[i])[0]} (plain)")
        moved.setdefault(b, {})[n] = 0.0
        out[b] = 0.0
    if moved:
        log(f"[probe] round-1 blocks moved by the radius's last ulps (query: "
            f"{{block: margin}}): {moved}")
    return out, float(diff.max())


def phase_main_path(label, pm, x, q):
    """One counted search through `ProMIPS.search`, held against the plain
    path, an exact top-k and the Theorem-2 floor. Returns the launches."""
    import torch
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.runtime import search as runtime_search
    from repro_torch.core import search_device as sd
    from repro_torch.kernels import ops
    from repro_torch.tune import cache as tune_cache
    meta = pm.meta
    k = SEARCH["k"]
    # -- the main path, counted
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    ids, scores, st = pm.search(q, **SEARCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{label}] main path launches {launches}; first search {first_s:.3f} s; "
        f"peak memory {peak / 2**20:.1f} MiB ({resident / 2**20:.1f} MiB "
        f"allocated before the search, +{(peak - resident) / 2**20:.1f} MiB "
        f"during it)")
    require(launches["block_mips"] > 0 and launches["sketch_scores"] > 0
            and launches["quick_probe_select"] > 0,
            f"a kernel of the main path was not launched: {launches}")
    require(ids.shape == (q.shape[0], k) and bool(torch.isfinite(scores).all()),
            "main path output has the wrong shape or non-finite scores")

    # -- the same search on the plain versions, on the card
    cfg = RuntimeConfig(use_kernels=False, **SEARCH)
    ids_p, _, st_p = runtime_search(pm.arrays, meta, q, cfg)
    mask0 = sd.select_frontend(pm.arrays, meta, q)[-1]
    est_bnd = sd.prefilter_round1(pm.arrays, q, mask0, k, meta.page_rows,
                                  SEARCH["prefilter_eps"], False)
    flips, sk_err = prefilter_flips(pm.arrays, q, mask0, est_bnd, k)
    probe, lb_err = probe_flips(pm.arrays, meta, q)
    row_of_id = torch.full((x.shape[0],), -1, dtype=torch.long, device=x.device)
    live = pm.arrays.ids >= 0
    row_of_id[pm.arrays.ids[live].long()] = live.nonzero().flatten()
    row_of_id = row_of_id.cpu()
    differ, notes, pages_diff = compare_paths(
        q, ids, st, ids_p, st_p, flips, lambda i: x[i.clamp(min=0).long()],
        lambda r: int(row_of_id[r]) // meta.page_rows, probe)
    log(f"[{label}] sketch_scores on this input: max|d|={sk_err:.3g} "
        f"(tol 1e-5*|q||mu|+1e-6); binary_probe_lb max|d|={lb_err:.3g} (tol "
        f"1e-6|lb|+1e-7); Quick-Probe flips (query: normalized margin) "
        f"{probe if probe else 'none'}")
    compare_drivers(label, lambda qb: pm.search(qb, **SEARCH), q)
    log(f"[{label}] kernel vs plain path: {len(differ)} of {q.shape[0]} queries "
        f"differ in ids; {pages_diff} differ in pages; prefilter cut flips "
        f"(query: {{block: est+bnd-tau}}) {flips if flips else 'none'}")
    for note in notes:
        log(f"[{label}]   {note}")

    # -- quality against the exact top-k
    eids, escores = exact_topk(x, q, k)
    inter = [len(set(ids[b].tolist()) & set(eids[b].tolist())) / k
             for b in range(q.shape[0])]
    recall = sum(inter) / len(inter)
    pages_mean = float(st.pages.double().mean())
    pages_frac = pages_mean / meta.n_blocks
    rate = success_rate(scores, escores, meta.c)
    p0 = meta.p
    floor = p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / q.shape[0])
    log(f"[{label}] pages_mean {pages_mean:.2f} pages_frac {pages_frac:.4f} "
        f"recall {recall:.4f} theorem-2 success {rate:.4f} (floor {floor:.4f}) "
        f"used_round2 {int(st.used_round2.sum())} exhausted "
        f"{int(st.exhausted.sum())}")
    require(rate >= floor, f"Theorem-2 floor missed: {rate} < {floor}")

    # -- what reading the tuning cache adds to each search on the host, and
    # what a stat of the cache file (made at most once a second) costs here
    def per_call_us(fn, n_calls=2000):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        return (time.perf_counter() - t0) / n_calls * 1e6

    path = tune_cache.cache_path()
    stat_us = (per_call_us(lambda: os.path.exists(path)) if path else 0.0)
    resolve_us = per_call_us(lambda: tune_cache.resolved(
        "runtime", meta.n, meta.d, device=q.device))
    log(f"[{label}] tuning-cache resolve (runtime knobs, this index's key): "
        f"{resolve_us:.2f} us a search on the host; one stat of the cache "
        f"file {stat_us:.2f} us")
    return launches


@contextlib.contextmanager
def host_driver():
    """Run `runtime.search`'s fused searches on the card through the host
    driver (`search_fused.search_batch_fused`: masks to the host, the tile
    planned in numpy) instead of the in-graph driver, for the A/B of
    phases 3-5."""
    from repro_torch.core import runtime, search_fused
    inner = runtime.search_batch

    def search_batch(arrays, meta, q, verification, **knobs):
        if verification == "fused":
            return search_fused.search_batch_fused(arrays, meta, q, **knobs)
        return inner(arrays, meta, q, verification=verification, **knobs)

    runtime.search_batch = search_batch
    try:
        yield
    finally:
        runtime.search_batch = inner


def _same_bits(a, b):
    """Equal bit for bit, through tuples (SearchStats, StreamStats)."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                                else a, b.view(torch.int32)
                                if b.dtype == torch.float32 else b))
    return a == b


def compare_drivers(label, search, q):
    """The in-graph driver (three searches on ``q``: the stages eager, then
    captured and replayed, then replayed) against the host driver on the
    same input: ids, scores and every stats field equal bit for bit."""
    import torch
    from repro_torch.core import search_graph
    got = [search(q) for _ in range(3)]
    with host_driver():
        want = search(q)
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        require(_same_bits(g, want), f"[{label}] the in-graph driver's search "
                f"{i} differs from the host driver's (ids, scores or a stats "
                "field)")
    n_graphs = sum(len(e.graphs) for e in search_graph._GRAPHS.values())
    log(f"[{label}] in-graph driver = host driver bit for bit (ids, scores, "
        f"every stats field) on the eager, capturing and replaying searches; "
        f"{n_graphs} CUDA graphs held")


def time_turns(label, search, q):
    """The two fused drivers in turns on one card: one graph pass that
    captures (its batches' stage variants), then host, graph, graph, host,
    each the median of 5 batches with its range; then one profiled batch
    under each."""
    med0, times0 = time_batches(search)
    runs = []
    for name in ("host", "graph", "graph", "host"):
        if name == "host":
            with host_driver():
                runs.append((name,) + time_batches(search))
        else:
            runs.append((name,) + time_batches(search))
    log(f"[{label}] search time per batch of {N_QUERIES}, graph driver's "
        f"first pass (eager stages and captures): median {med0:.3f} ms "
        f"{['%.3f' % t for t in times0]}")
    for name, med, times in runs:
        log(f"[{label}] search time per batch of {N_QUERIES}, {name} driver: "
            f"median {med:.3f} ms (range {min(times):.3f}-{max(times):.3f}) "
            f"{['%.3f' % t for t in times]}")
    with host_driver():
        phase_profile(search, q, f"{label} host driver")
    phase_profile(search, q, f"{label} graph driver")


def time_batches(search, n_batches=5, queries=None):
    """Median time of one search batch (CUDA events around the whole call
    ``search(queries)``, which synchronizes with the host each round), after
    one warm-up, and every batch's time in the batches' order.
    ``queries(seed)`` makes each batch (default: the LARGE_N recipe's, seeds
    2, 3, ...)."""
    import torch
    from repro_torch.data.synthetic import mf_factors
    if queries is None:
        def queries(seed):
            return mf_factors(N_QUERIES, RECIPE["d"], RECIPE["rank"],
                              decay=RECIPE["decay"], seed=seed)
    times = []
    for i in range(n_batches + 1):
        qb = torch.from_numpy(queries(2 + i)).cuda()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        search(qb)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], times


def phase_profile(search, q, label):
    """Where one batch's time goes: device time per kernel from a
    torch.profiler trace of one ``search(q)``, and the device's idle share of
    the wall time under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    search(q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search(q)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        name = name[5:] if name.startswith("void ") else name
        total, count = by_name.get(name[:70], (0.0, 0))
        by_name[name[:70]] = (total + e.time_range.end - e.time_range.start,
                              count + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    if busy_ms == 0:
        log(f"[profile {label}] device time not measured: the trace holds no "
            "CUDA events")
        return
    memcpy = {kind: sum(t for name, (t, _) in by_name.items()
                        if name.startswith(f"Memcpy {kind}")) / 1e3
              for kind in ("DtoH", "HtoD")}
    log(f"[profile {label}] one batch: wall {wall_ms:.3f} ms under the profiler, "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
        f"{sum(c for _, c in by_name.values())} device events; Memcpy DtoH "
        f"{memcpy['DtoH']:.3f} ms, HtoD {memcpy['HtoD']:.3f} ms")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        log(f"[profile {label}]   {t / 1e3:8.3f} ms  x{c:<3d} {name}")

# ---------------------------------------------------------------- phase 4b

# the modes of the promips backend at full budget on the n=1M index: the
# two-phase backends with the main path's sketch prefilter, and the
# progressive search with the facade's Cauchy-Schwarz pruning
MODES = (("two_phase/fused", dict(verification="fused", prefilter=True,
                                  prefilter_eps=0.1, dense_frac=0.8)),
         ("two_phase/batched", dict(verification="batched", prefilter=True,
                                    prefilter_eps=0.1)),
         ("two_phase/scan", dict(verification="scan", prefilter=True,
                                 prefilter_eps=0.1)),
         ("progressive", dict(mode="progressive", cs_prune=True)))
WALK_BUDGETS = (256, 4096)            # and every walk at full budget
HOST_QUERIES, INCREMENTAL_QUERIES = 8, 2
FACADE_BACKENDS = (("promips", dict(mode="progressive")), ("exact", {}),
                   ("h2alsh", {}), ("pq", {}), ("rangelsh", {}))
SCAN_REPLACES = ("src/repro/core/search_device.py:441,611 (lax.scan bodies, "
                 "no Pallas)")


def host_searches(pm, queries, conn, core):
    """Child process: the paper's host searches on the n=1M index, numpy
    only (the card belongs to the parent), on CPU core ``core`` alone (None:
    unpinned) so that it does not take the cores of the parent's timed
    work. The facade's ``search_path="host"`` in two-phase and progressive
    mode on `HOST_QUERIES` queries, each query's `HostStats` recorded as it
    passes, and Algorithm 1 (`search_incremental`) on
    `INCREMENTAL_QUERIES`. Sends a list of per-query dicts, or ("error",
    traceback)."""
    import traceback
    try:
        if core is not None:    # before numpy starts its threads
            os.sched_setaffinity(0, {core})
        from repro_torch.api.adapters import PromipsSearcher
        from repro_torch.core.runtime import RuntimeConfig
        out, seen = [], []

        def recorded(fn):
            def call(q, **kw):
                t0 = time.perf_counter()
                ids, scores, st = fn(q, **kw)
                seen.append((ids, st, time.perf_counter() - t0))
                return ids, scores, st
            return call

        pm.search_host = recorded(pm.search_host)
        pm.search_host_progressive = recorded(pm.search_host_progressive)
        for path, cfg in (("two_phase", RuntimeConfig(k=SEARCH["k"])),
                          ("progressive", RuntimeConfig(
                              k=SEARCH["k"], mode="progressive",
                              cs_prune=True))):
            seen.clear()
            facade = PromipsSearcher(pm, cfg, search_path="host")
            res = facade.search(queries[:HOST_QUERIES])
            for i, (ids, st, sec) in enumerate(seen):
                out.append(dict(path=path, q=i, ids=ids.tolist(),
                                pages=st.pages, candidates=st.candidates,
                                stopped_by=st.stopped_by,
                                probe_passed=st.probe_passed,
                                used_round2=st.used_round2, seconds=sec,
                                facade_ids=res.ids[i].tolist()))
        for i in range(INCREMENTAL_QUERIES):
            t0 = time.perf_counter()
            ids, _, st = pm.search_incremental(queries[i], k=SEARCH["k"])
            out.append(dict(path="incremental", q=i, ids=ids.tolist(),
                            pages=st.pages, candidates=st.candidates,
                            stopped_by=st.stopped_by, probe_passed=False,
                            used_round2=False,
                            seconds=time.perf_counter() - t0))
        conn.send(out)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def walk_inputs(pm, q, budget):
    """The rounds of a scan search and the walk of a progressive search on
    the card, as `ops.scan_blocks` argument sets: the frontend, the sketch
    prefilter and the compensation masks of the main path's scan search
    (round 2 carries the kernel's round-1 top-k), and the progressive gaps.
    Yields (label, positional args, keyword args)."""
    import torch
    from repro_torch.core import search_device as sd
    from repro_torch.kernels import ops
    arrays, meta = pm.arrays, pm.meta
    k, pr = SEARCH["k"], meta.page_rows
    _, q_l2sq, d_sp, r0, _, c_half, mask0 = sd.select_frontend(arrays, meta, q)
    mask_r1, est, bnd, bvalid = sd.prefilter_round1(
        arrays, q, mask0, k, pr, SEARCH["prefilter_eps"])
    empty = sd._empty_top(q.shape[0], k, q.device)

    def scan_args(mask, top):
        order = torch.sort((~mask).to(torch.uint8), dim=1,
                           stable=True).indices.int()
        return ((arrays.x, arrays.ids, q, order, top.scores.contiguous(),
                 top.rows.contiguous(), c_half.contiguous()),
                dict(k=k, page_rows=pr, budget=budget,
                     n_sel=mask.sum(dim=1, dtype=torch.int32)))

    args, kw = scan_args(mask_r1, empty)
    yield "scan round 1", args, kw
    top_s, top_r, _, _, done_a = ops.scan_blocks(*args, **kw)
    s_k = top_s[:, k - 1]
    _, _, mask1 = sd.compensation_masks(arrays, meta, d_sp, q_l2sq, s_k, r0,
                                        done_a, mask0, False, False)
    mask_r2 = sd.prefilter_round2(mask1, est, bnd, bvalid, s_k)
    yield ("scan round 2",) + scan_args(mask_r2, sd.TopK(top_s, top_r))
    gap = sd.block_gaps(arrays, q @ arrays.a)
    order = torch.sort(gap, dim=1, stable=True).indices.int()
    yield ("progressive", (arrays.x, arrays.ids, q, order, empty.scores,
                           empty.rows, c_half.contiguous()),
           dict(k=k, page_rows=pr, budget=min(budget, meta.n_blocks),
                block_gap=gap.contiguous(),
                block_max_l2sq=arrays.block_max_l2sq,
                q_l2sq=q_l2sq.contiguous(), c=meta.c, x_p=meta.x_p,
                cs_prune=True))


def _walk_top_exact(x, ids, qv, blocks, pr, init_rows, k):
    """The k best exact (float64) scores, descending and -inf padded, over
    the valid rows of a walked block list and the carried rows; and the
    number of valid rows walked."""
    import torch
    rows = (blocks[:, None] * pr + torch.arange(pr, device=x.device)).flatten()
    rows = rows[ids[rows] >= 0]
    pool = torch.cat([rows, init_rows[init_rows >= 0].long()]).unique()
    best = torch.full((k,), float("-inf"), dtype=torch.float64)
    if pool.numel():
        top = (x[pool].double() @ qv.double()).topk(min(k, pool.numel()))
        best[:top.values.numel()] = top.values.cpu()
    return best, int(rows.numel())


def check_walk(label, args, kw, got, want, meta):
    """Hold a kernel walk against the plain walk on the same inputs.

    - Every slot where both top-k's hold the same row: a finite score
      within REL |x_row| |q| + ABS of the plain one, an infinite one equal.
    - A query whose walk is the same (pages, candidates, done_a): each slot
      whose rows differ holds two rows whose exact scores tie within
      tolerance.
    - A query whose walk differs: a flip whose normalized margin is <= 1,
      a valid row of its walk range within tolerance of c_half (a
      Condition-A stop) or, in progressive mode, a block of its range whose
      gap lies within the radius's change over the k-th score's tolerance
      (a qualify flip). In scan mode each of the two outputs must then be
      the top-k of its own walk: its candidates the valid rows of its
      walked prefix, its exact scores those of the prefix's (and the
      carried rows') k best within tolerance.

    Returns (max |d top_s| on equal rows, {query: flip margin}, the number
    of tie slots)."""
    import torch
    x, ids, q, order, _, init_r, c_half = args
    pr, k = kw["page_rows"], kw["k"]
    g = [t.cpu() for t in got]
    w = [t.cpu() for t in want]
    same_r = g[1] == w[1]
    inf = torch.isinf(g[0]) | torch.isinf(w[0])
    require(bool((g[0][same_r & inf] == w[0][same_r & inf]).all()),
            f"scan_blocks {label}: an infinite top score differs on one row")
    fin = same_r & ~inf
    x_top = x[g[1].clamp(min=0).long().to(x.device)]                # (B, k, d)
    tol = (REL * x_top.double().norm(dim=-1)
           * q.double().norm(dim=1)[:, None] + ABS).cpu()
    err = (g[0].double() - w[0].double()).abs()
    require(bool((err[fin] <= tol[fin]).all()),
            f"scan_blocks {label}: top_s beyond tolerance by "
            f"{float((err - tol)[fin].max()) if fin.any() else 0.0}")
    max_err = float(err[fin].max()) if bool(fin.any()) else 0.0

    walk_differs = (g[2] != w[2]) | (g[3] != w[3]) | (g[4] != w[4])
    ties = 0
    for b, j in (~same_r & ~walk_differs[:, None]).nonzero().tolist():
        rg, rw = int(g[1][b, j]), int(w[1][b, j])
        require(rg >= 0 and rw >= 0,
                f"scan_blocks {label}: top_r[{b},{j}] {rg} vs {rw}")
        e = (x[[rg, rw]].double() @ q[b].double()).cpu()
        t = float(_row_tol(x[[rg, rw]], q[b]).max())
        require(abs(float(e[0] - e[1])) <= t,
                f"scan_blocks {label}: top_r[{b},{j}] {rg} vs {rw}: exact "
                f"scores {float(e[0])} vs {float(e[1])} are not a tie")
        ties += 1

    flips = {}
    for b in walk_differs.nonzero().flatten().tolist():
        limit = (int(kw["n_sel"][b]) if "n_sel" in kw else kw["budget"])
        blocks = order[b, :min(limit, kw["budget"])].long()
        rows = (blocks[:, None] * pr + torch.arange(pr, device=x.device)).flatten()
        rows = rows[ids[rows] >= 0]
        s64 = x[rows].double() @ q[b].double()
        tol_r = _row_tol(x[rows], q[b])
        margins = [float(((s64 - c_half[b].double()).abs() / tol_r).min())]
        if "block_gap" in kw:
            gap = kw["block_gap"][b, blocks].double()
            m_l2 = kw["block_max_l2sq"][blocks].double()
            ql = kw["q_l2sq"][b].double()
            for s_k in {float(g[0][b, -1]), float(w[0][b, -1])}:
                if not math.isfinite(s_k):
                    continue
                tol_s = float(tol_r.max())

                def radius(s):
                    return torch.sqrt(torch.clamp(meta.x_p * (
                        m_l2 + ql - 2.0 * s / meta.c), min=0.0))
                dr = (radius(s_k - tol_s) - radius(s_k + tol_s)).abs()
                margins.append(float(((gap - radius(s_k)).abs()
                                      / (dr + 1e-6 * radius(s_k))).min()))
        require(min(margins) <= 1.0,
                f"scan_blocks {label}: query {b}'s walk differs between the "
                f"kernel and the plain walk (pages {int(g[2][b])} vs "
                f"{int(w[2][b])}, done {bool(g[4][b])} vs {bool(w[4][b])}) "
                f"with no flip within tolerance (normalized margins "
                f"{margins})")
        flips[b] = min(margins)
        if "block_gap" in kw:
            continue
        for name, out in (("kernel", g), ("plain", w)):
            walked = order[b, :int(out[2][b])].long()
            best, n_rows = _walk_top_exact(x, ids, q[b], walked, pr,
                                           init_r[b], k)
            require(int(out[3][b]) == n_rows,
                    f"scan_blocks {label}: query {b}'s {name} walk counts "
                    f"{int(out[3][b])} candidates for {n_rows} valid rows")
            r = out[1][b].long()
            e = torch.full((k,), float("-inf"), dtype=torch.float64)
            e[r >= 0] = (x[r[r >= 0].to(x.device)].double()
                         @ q[b].double()).cpu()
            e = e.sort(descending=True).values
            t = float(tol_r.max()) if tol_r.numel() else ABS
            ok = (e == best) | ((e - best).abs() <= t)
            require(bool(ok.all()),
                    f"scan_blocks {label}: query {b}'s {name} top-k is not "
                    f"the top-k of its own walk (exact {e.tolist()} vs "
                    f"{best.tolist()})")
    return max_err, flips, ties


def walk_lengths(pages):
    """The live steps (pages) each query walked: mean, p50, p99, max and the
    query that sets the max."""
    p = pages.double().cpu()
    srt = p.sort().values
    n = srt.numel()
    return (f"mean {float(p.mean()):.1f} p50 {float(srt[n // 2]):.0f} p99 "
            f"{float(srt[min(n - 1, (99 * n) // 100)]):.0f} max "
            f"{float(srt[-1]):.0f} (query {int(p.argmax())})")


def visited_bound_ms(args, kw, visited):
    """Least time of a walk whose (B, NB) visited-block mask is known
    (`roofline.scan_blocks` over the union of the visited blocks). Returns
    (ms, bound_by, union)."""
    from repro_torch.launch import roofline
    q = args[2]
    union = int(visited.any(dim=0).sum())
    ms, bound_by = _bound(roofline.scan_blocks(
        q.shape[0], q.shape[1], kw["k"], kw["page_rows"], union,
        int(visited.sum())))
    return ms, bound_by, union


def jump_walk(args, kw):
    """The plain walk's function (`ref.scan_blocks_ref`, from a carried
    top-k sorted descending) computed by jumps: while a query's k-th score
    holds, the liveness of all its remaining steps is one tensor test, and
    the walk jumps to the first live step whose best valid row beats the
    k-th score and merges it as the plain walk's step does. One pass per
    merged step instead of one per step, so the full-budget progressive
    walk has a plain result and its visited blocks. Returns the five
    outputs and the (B, NB) visited mask."""
    import torch
    from repro_torch.kernels import ref
    x, ids, q, order, init_s, init_r, c_half = args
    k, pr = kw["k"], kw["page_rows"]
    prog = kw.get("block_gap") is not None
    b, nb = order.shape
    dev = q.device
    steps = min(kw["budget"], nb)
    o = order[:, :steps].long()
    ar = torch.arange(b, device=dev)
    offs = torch.arange(pr, device=dev, dtype=torch.int32)
    valid = (ids >= 0).view(nb, pr)
    scores = (x.float() @ q.float().T).T.reshape(b, nb, pr)
    s_o = torch.where(valid[o], scores[ar[:, None], o],
                      torch.full((), float("-inf"), device=dev))
    smax = s_o.amax(dim=2)
    del s_o
    vc = valid.sum(dim=1, dtype=torch.int32)[o]
    tidx = torch.arange(steps, device=dev)[None, :]
    if prog:
        lim = torch.full((b,), steps, dtype=torch.long, device=dev)
        gap_o = kw["block_gap"].gather(1, o)
        m_o = kw["block_max_l2sq"][o]
        ql = kw["q_l2sq"][:, None]
    else:
        lim = kw["n_sel"].long().clamp(max=steps)
    top_s, top_r = init_s.float().clone(), init_r.int().clone()
    done = top_s[:, k - 1] >= c_half
    cur = torch.zeros(b, dtype=torch.long, device=dev)
    pages = torch.zeros(b, dtype=torch.int32, device=dev)
    cand = torch.zeros(b, dtype=torch.int32, device=dev)
    visited = torch.zeros((b, nb), dtype=torch.bool, device=dev)
    while True:
        active = ~done & (cur < lim)
        if not bool(active.any()):
            break
        s_k = top_s[:, k - 1]
        live = (tidx >= cur[:, None]) & (tidx < lim[:, None]) & active[:, None]
        if prog:
            live &= ref.scan_qualify(gap_o, m_o, s_k[:, None], ql, kw["c"],
                                     kw["x_p"], kw["cs_prune"])
        beat = live & (smax > s_k[:, None])
        has = beat.any(dim=1)
        f = torch.where(has, beat.int().argmax(dim=1), lim)
        counted = live & (tidx <= f[:, None])
        pages += counted.sum(dim=1, dtype=torch.int32)
        cand += (counted * vc).sum(dim=1, dtype=torch.int32)
        visited.scatter_(1, o, visited.gather(1, o) | counted)
        idx = has.nonzero().flatten()
        if idx.numel():
            blk = o[idx, f[idx]]
            v = valid[blk]
            sv = torch.where(v, scores[idx, blk],
                             torch.full((), float("-inf"), device=dev))
            rv = torch.where(v, (blk.int() * pr)[:, None] + offs,
                             torch.full_like(v, -1, dtype=torch.int32))
            srt, si = torch.sort(torch.cat([top_s[idx], sv], dim=1), dim=1,
                                 descending=True, stable=True)
            top_r[idx] = torch.cat([top_r[idx], rv], dim=1).gather(1, si[:, :k])
            top_s[idx] = srt[:, :k]
            done[idx] |= top_s[idx, k - 1] >= c_half[idx]
        cur = torch.where(active, torch.where(has, f + 1, lim), cur)
    return top_s, top_r, pages, cand, done, visited


def same_walk(got, want):
    """The five walk outputs (top_s, top_r, pages, cand, done) equal bit
    for bit."""
    import torch
    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got[:5], want[:5]))


def flip_check(label, want, got, x, q, c_half, k):
    """Two searches on the card that must agree (scan = batched = fused at
    full budget): ids, pages, candidates, used_round2 and exhausted equal.
    Where only ids differ, each differing slot holds two rows whose exact
    scores tie within tolerance; where a counter differs, the query needs a
    row within tolerance of c_half (a Condition-A stop) or a rank tie in
    its two top-k's (a k-th score, and so Condition B, within tolerance).
    Returns {query: margin}."""
    import torch
    ids_w, _, st_w = want
    ids_g, _, st_g = got
    counters = ((st_w.pages != st_g.pages)
                | (st_w.candidates != st_g.candidates)
                | (st_w.used_round2 != st_g.used_round2)
                | (st_w.exhausted != st_g.exhausted))
    differ = ((ids_w != ids_g).any(dim=1) | counters).nonzero().flatten()
    flips = {}
    for b in differ.tolist():
        s64 = x.double() @ q[b].double()
        tol = _row_tol(x, q[b])
        if not bool(counters[b]):
            for j in (ids_w[b] != ids_g[b]).nonzero().flatten().tolist():
                rw, rg = int(ids_w[b, j]), int(ids_g[b, j])
                require(rw >= 0 and rg >= 0,
                        f"{label}: query {b} slot {j}: ids {rw} vs {rg}")
                gap = abs(float(s64[rw] - s64[rg]))
                t = float(max(tol[rw], tol[rg]))
                require(gap <= t, f"{label}: query {b} slot {j}: ids {rw} vs "
                        f"{rg} with exact scores {gap} apart, not a tie")
                flips[b] = max(flips.get(b, 0.0), gap / t)
            continue
        margins = [float(((s64 - c_half[b].double()).abs() / tol).min())]
        top = torch.cat([ids_w[b], ids_g[b]]).unique()
        top = top[top >= 0].long()
        st = torch.sort(s64[top], descending=True).values
        if st.numel() > 1:
            margins.append(float(((st[:-1] - st[1:]) / tol[top].max()).min()))
        require(min(margins) <= 1.0,
                f"{label}: query {b}'s counters differ with no flip within "
                f"tolerance (normalized margins {margins})")
        flips[b] = min(margins)
    return flips


def phase_modes(pm, x, q, x100k, q100k, timer):
    """The promips backend in every mode on the n=1M index (no rebuild),
    the paper's host search on it, `ops.mips_topk` at n=1M, and the facade
    with the four baselines on the n=100k rows. Returns (the scan_blocks
    record, the modes' launches, mips_topk's block_mips launches)."""
    import multiprocessing as mp
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api.adapters import PromipsSearcher
    from repro_torch.core import search_common as sc
    from repro_torch.core.metrics import overall_ratio, recall_at_k
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.runtime import search as runtime_search
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    k, meta, arrays = SEARCH["k"], pm.meta, pm.arrays
    p0 = meta.p
    floor = p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / q.shape[0])

    # the host searches run in a child process beside the card's work, on
    # one core of their own; the driving thread keeps off that core
    cores = os.sched_getaffinity(0)
    core = max(cores) if len(cores) > 1 else None
    ctx = mp.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=host_searches,
                        args=(pm, q[:HOST_QUERIES].cpu().numpy(), send, core))
    t_host = time.perf_counter()
    child.start()
    send.close()
    if core is not None:
        os.sched_setaffinity(0, cores - {core})
    log(f"[modes] host searches pinned to core {core} of {sorted(cores)}; "
        f"the driving thread keeps off it")
    try:
        # -- every mode at full budget, through the facade and the runtime
        eids, escores = exact_topk(x, q, k)
        c_half = sc.condition_a_threshold(arrays.max_l2sq,
                                          (q * q).sum(dim=1), meta.c)
        facade = PromipsSearcher(pm, RuntimeConfig(k=k))
        runs, launches, run_walk = {}, {}, None
        walk_call = ops.scan_blocks
        for label, knobs in MODES:
            cfg = RuntimeConfig(k=k, **knobs)
            # the walks of each timed search call (its rounds' pages and its
            # stats); before the first, the progressive run's first walk in
            # full for the full-budget walk check below
            calls = []

            def recorded(*a, **kw):
                nonlocal run_walk
                out = walk_call(*a, **kw)
                if calls:
                    calls[-1][0].append(out[2])
                elif label == "progressive" and run_walk is None:
                    run_walk = (a, kw, out)
                return out

            def timed(qb, cfg=cfg, calls=calls):
                calls.append(([], None))
                out = runtime_search(arrays, meta, qb, cfg, device=pm.device)
                calls[-1] = (calls[-1][0], out[2])

            ops.scan_blocks = recorded
            try:
                for name in ops.LAUNCHES:
                    ops.LAUNCHES[name] = 0
                out = runtime_search(arrays, meta, q, cfg, device=pm.device)
                torch.cuda.synchronize()
                launches[label] = dict(ops.LAUNCHES)
                runs[label] = out
                ids, scores, st = out
                res = facade.search(q, runtime=cfg)
                require(np.array_equal(res.ids, ids.cpu().numpy()),
                        f"[modes] {label}: the facade's ids differ from the "
                        f"runtime's")
                require(ids.shape == (q.shape[0], k)
                        and bool(torch.isfinite(scores).all()),
                        f"[modes] {label}: output has the wrong shape or "
                        f"non-finite scores")
                recall = float(np.mean([recall_at_k(ids[b].cpu().numpy(),
                                                    eids[b].cpu().numpy())
                                        for b in range(q.shape[0])]))
                rate = success_rate(scores, escores, meta.c)
                med, times = time_batches(timed)
            finally:
                ops.scan_blocks = walk_call
            log(f"[modes n=1M {label}] recall {recall:.4f} theorem-2 success "
                f"{rate:.4f} (floor {floor:.4f}) pages_mean "
                f"{float(st.pages.double().mean()):.2f} used_round2 "
                f"{int(st.used_round2.sum())} exhausted "
                f"{int(st.exhausted.sum())}; batch of {q.shape[0]}: median "
                f"{med:.3f} ms (range {min(times):.3f}-{max(times):.3f}); "
                f"launches {launches[label]}")
            # each timed batch's walks (the warm-up's first): the live steps
            # a query walked; scan walks round 2 only when a query needs it
            require(len(calls) == len(times) + 1,
                    f"[modes] {label}: {len(calls)} search calls recorded for "
                    f"{len(times)} timed batches and a warm-up")
            for i, (t, (pages, bst)) in enumerate(zip(times, calls[1:])):
                n_walks = (1 + int(bool(bst.used_round2.any()))
                           if label == "two_phase/scan" else
                           int(label == "progressive"))
                require(len(pages) == n_walks, f"[modes] {label}: batch "
                        f"{i + 1} made {len(pages)} walks, not {n_walks}")
                if pages:
                    log(f"[modes n=1M {label}] batch {i + 1}: {t:.3f} ms; "
                        + "; ".join(f"walk {r + 1} steps {walk_lengths(p)}"
                                    for r, p in enumerate(pages)))
            if label == "two_phase/scan":    # where a scan batch's time goes
                phase_profile(lambda qb, cfg=cfg: runtime_search(
                    arrays, meta, qb, cfg, device=pm.device), q,
                    f"modes n=1M {label}")
            require(rate >= floor, f"[modes] {label}: Theorem-2 floor missed: "
                    f"{rate} < {floor}")
        for label in ("two_phase/scan", "progressive"):
            require(launches[label]["scan_blocks"] > 0,
                    f"[modes] {label} launched no scan_blocks kernel")
        for other in ("two_phase/batched", "two_phase/fused"):
            flips = flip_check(f"[modes] scan vs {other}", runs["two_phase/scan"],
                               runs[other], x, q, c_half, k)
            log(f"[modes n=1M] two_phase/scan = {other} in ids, pages, "
                f"candidates, used_round2 and exhausted"
                + (f", but for flips (query: normalized margin) {flips}"
                   if flips else ", every query"))

        # -- the walk kernel against its plain version on the same inputs:
        # bit for bit (and within check_walk's account of ties and flips);
        # the full-budget progressive walk, whose step loop would take
        # minutes, on the modes run's own inputs against the jump walk
        scan_rec = None
        from repro_torch.kernels import ref
        for budget in (meta.n_blocks,) + WALK_BUDGETS:
            for label, args, kw in walk_inputs(pm, q, budget):
                prog = label == "progressive"
                full = budget == meta.n_blocks
                if full and prog:
                    args, kw, walked = run_walk
                    kw = {n: v for n, v in kw.items() if n != "use_kernels"}
                got = ops.scan_blocks(*args, **kw, use_kernels=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()    # the plain walk, timed once
                if full and prog:
                    want = jump_walk(args, kw)
                else:
                    want = ref.scan_blocks_ref(*args, **kw)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
                tag = f"[kernel scan_blocks: {label}, budget {budget}]"
                if full and prog:
                    err, flips, ties, visited = 0.0, {}, 0, want[5]
                    require(same_walk(got, walked), f"{tag} differs from "
                            f"the modes run's walk on the same inputs")
                    run_ids = runs["progressive"][0]
                    require(torch.equal(run_ids, torch.where(
                        got[1] >= 0, arrays.ids[got[1].clamp(min=0).long()],
                        torch.full_like(got[1], -1))),
                        f"{tag}: ids differ from the modes run's")
                else:
                    err, flips, ties = check_walk(label, args, kw, got,
                                                  want[:5], meta)
                    jw = jump_walk(args, kw)
                    require(same_walk(jw, want),
                            f"{tag}: the jump walk differs from the step loop")
                    visited = jw[5]
                require(same_walk(got, want), f"{tag}: the kernel's walk "
                        f"differs from the plain walk's bits")
                ms = timer.ms(lambda: ops.scan_blocks(*args, **kw,
                                                      use_kernels=True))
                line = (f"{tag} pages/query "
                        f"{float(got[2].float().mean()):.1f} "
                        f"done_a {int(got[4].sum())}: bit for bit, max|d "
                        f"top_s|={err:.3g} tie slots {ties} walk flips "
                        f"{flips if flips else 'none'}; walk steps "
                        f"{walk_lengths(got[2])}  device {ms:.4f} ms  "
                        f"plain {plain_ms:.4f} ms"
                        + (" (jump walk; equal to the modes run's walk and "
                           "ids)" if full and prog else ""))
                bound, by, union = visited_bound_ms(args, kw, visited)
                line += (f"  bound {bound:.4f} ms ({by}; {union} distinct "
                         f"pages read)")
                if scan_rec is None:     # the full-budget scan, round 1
                    scan_rec = dict(
                        name="scan_blocks", route="cuda",
                        source="src/repro_torch/kernels/csrc/scan_blocks.cu",
                        replaces=SCAN_REPLACES, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        library_ms=None)
                log(line)

        # -- ops.mips_topk over the whole corpus
        valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        before = ops.LAUNCHES["block_mips"]
        top_k, rows_k = ops.mips_topk(x, q, valid, k)
        topk_launches = ops.LAUNCHES["block_mips"] - before
        top_p, rows_p = ops.mips_topk(x, q, valid, k, use_kernels=False)
        torch.cuda.synchronize()
        require(topk_launches == 1, f"mips_topk launched block_mips "
                f"{topk_launches} times, not once")
        require(torch.equal(rows_k, rows_p), "mips_topk: the kernel route's "
                "rows differ from the plain route's")
        err = float((top_k - top_p).abs().max())
        t_tol = float((REL * x.norm(dim=1).max() * q.norm(dim=1).max()) + ABS)
        require(err <= t_tol, f"mips_topk scores differ by {err} > {t_tol}")
        exact_ok = (rows_k.long() == eids).all(dim=1)
        for b in (~exact_ok).nonzero().flatten().tolist():
            got_s, want_s = ((x[r.long()].double() @ q[b].double())
                             .sort(descending=True).values
                             for r in (rows_k[b], eids[b]))
            require(float((got_s - want_s).abs().max()) <= t_tol,
                    f"mips_topk query {b}: rows differ from the exact top-k "
                    "beyond a tie")
        ms = timer.ms(lambda: ops.mips_topk(x, q, valid, k))
        plain_ms = timer.ms(lambda: ops.mips_topk(x, q, valid, k,
                                                  use_kernels=False))
        mm_ms = timer.ms(lambda: torch.matmul(q, x.T))
        s = torch.matmul(q, x.T)
        tk_ms = timer.ms(lambda: torch.topk(s, k))
        both_ms = timer.ms(lambda: torch.topk(torch.matmul(q, x.T), k))
        del s
        bound = roofline.cost(
            2.0 * x.shape[0] * q.shape[0] * x.shape[1],
            x.numel() * 4 + x.shape[0] + q.numel() * 4 + 2 * q.shape[0] * k * 4)
        t_b, t_o = bound["t_memory_s"], bound["t_compute_s"]
        log(f"[mips_topk n=1M B={q.shape[0]} k={k}] block_mips route, one "
            f"launch: rows equal to the plain route, max|d score| {err:.3g}; "
            f"{int((~exact_ok).sum())} queries differ from the exact top-k "
            f"(ties within tolerance)  device {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  torch.topk(torch.matmul(q, x.T)), two calls: "
            f"{both_ms:.4f} ms (matmul {mm_ms:.4f} + topk {tk_ms:.4f})  bound "
            f"{1e3 * max(t_b, t_o):.4f} ms (bytes {1e3 * t_b:.4f}, operations "
            f"{1e3 * t_o:.4f})")

        # -- the facade and the baselines on the n=100k rows
        x100 = x100k.cpu().numpy()
        q100 = q100k.cpu().numpy()
        e_ids, e_scores = exact_topk(x100k, q100k, k)
        e_ids, e_scores = e_ids.cpu().numpy(), e_scores.cpu().numpy()
        for backend, opts in FACADE_BACKENDS:
            t0 = time.perf_counter()
            s = api.build(x100, backend=backend, device=DEVICE, **opts)
            build_s = time.perf_counter() - t0
            res = s.search(q100)
            recall = float(np.mean([recall_at_k(res.ids[b], e_ids[b])
                                    for b in range(len(q100))]))
            ratio = float(np.mean([overall_ratio(res.scores[b], e_scores[b])
                                   for b in range(len(q100))]))
            log(f"[facade n=100k {backend} {opts or ''}] recall {recall:.4f} "
                f"overall ratio {ratio:.4f} pages/query "
                f"{res.stats['pages'] / len(q100):.1f} build {build_s:.2f} s "
                f"search {res.stats['wall_time_s']:.3f} s for {len(q100)} "
                f"queries, index bytes {s.index_bytes}")
            require(res.ids.shape == (len(q100), k)
                    and np.isfinite(res.scores).all(),
                    f"facade {backend}: wrong shape or non-finite scores")
            if backend == "exact":
                require(recall >= 0.999, f"facade exact: recall {recall}")

        # -- the host searches' results
        t0 = time.perf_counter()
        require(recv.poll(600), "the host searches did not finish in 600 s")
        out = recv.recv()
        require(not (isinstance(out, tuple) and out[0] == "error"),
                f"the host searches failed:\n{out[1] if isinstance(out, tuple) else ''}")
        log(f"[host n=1M] child process: {time.perf_counter() - t_host:.1f} s "
            f"in all ({time.perf_counter() - t0:.1f} s waited for after the "
            f"card's work)")
        for path in ("two_phase", "progressive", "incremental"):
            rs = [r for r in out if r["path"] == path]
            rec = np.mean([recall_at_k(np.asarray(r["ids"]),
                                       eids[r["q"]].cpu().numpy()) for r in rs])
            if path != "incremental":
                require(all(r["ids"] == r["facade_ids"] for r in rs),
                        f"host {path}: the facade's ids differ")
            log(f"[host n=1M {path}] {len(rs)} queries: recall {rec:.4f}; "
                f"pages {[r['pages'] for r in rs]} candidates "
                f"{[r['candidates'] for r in rs]} stopped_by "
                f"{[r['stopped_by'] for r in rs]} probe_passed "
                f"{sum(r['probe_passed'] for r in rs)} used_round2 "
                f"{sum(r['used_round2'] for r in rs)}; seconds per query "
                f"{['%.2f' % r['seconds'] for r in rs]}")
    finally:
        os.sched_setaffinity(0, cores)
        if child.is_alive():
            child.join(timeout=1 if sys.exc_info()[0] else 600)
        if child.is_alive():
            child.terminate()
        child.join()
        recv.close()
    require(scan_rec is not None, "no scan_blocks record")
    mode_launches = {"scan_blocks": launches["two_phase/scan"]["scan_blocks"]
                     + launches["progressive"]["scan_blocks"]}
    return scan_rec, mode_launches, topk_launches


# ---------------------------------------------------------------- phase 5

def stream_from_index(pm):
    """A `MutableProMIPS` on the card over an index already built (no second
    build), through `from_state`: empty delta of the default n // 2 rows,
    `BUILD` as the rebuild kwargs."""
    import dataclasses
    import numpy as np
    from repro_torch.core.index import IndexArrays
    from repro_torch.stream import MutableProMIPS
    host = pm.index.arrays
    arrays = {f"base_{f}": np.asarray(getattr(host, f))
              for f in IndexArrays._fields}
    arrays.update(base_alive=np.asarray(host.ids) >= 0,
                  delta_x=np.zeros((0, pm.meta.d), np.float32),
                  delta_gids=np.zeros(0, np.int64),
                  delta_alive=np.zeros(0, bool))
    meta = dict(meta=dataclasses.asdict(pm.meta), build_kwargs=dict(BUILD),
                delta_capacity=pm.meta.n // 2, next_id=pm.meta.n, wal_seq=0,
                auto_compact=False)
    return MutableProMIPS.from_state(arrays, meta, device=DEVICE)


def stream_search(st, use_kernels=None):
    """``search(queries)`` of the stream with the shipped knobs."""
    from repro_torch.core.runtime import RuntimeConfig
    cfg = RuntimeConfig(use_kernels=use_kernels,
                        **{key: v for key, v in SEARCH.items() if key != "k"})
    return lambda qb: st.search(qb, k=SEARCH["k"], runtime=cfg)


def corpus_rows(n, seed):
    from repro_torch.data.synthetic import mf_factors
    return mf_factors(n, RECIPE["d"], RECIPE["rank"], decay=RECIPE["decay"],
                      norm_tail=RECIPE["norm_tail"], seed=seed)


def phase_stream_state(label, st, q, path_kernels, turns=False):
    """One state of a stream: its snapshot, one counted search through
    `MutableProMIPS.search`, held against the plain path, the host driver,
    an exact top-k over `alive_items()` and the Theorem-2 floor; then the
    time per batch, with ``turns`` of both drivers and their profiles.
    Returns the launches of the counted search."""
    import torch
    from repro_torch.core import search_device as sd
    from repro_torch.core.search_common import next_pow2
    from repro_torch.kernels import ops
    k = SEARCH["k"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = st.snapshot()
    torch.cuda.synchronize()
    snap_s = time.perf_counter() - t0
    arrays, meta = snap.arrays, snap.meta
    k_base = min(k + (next_pow2(snap.n_base_dead) if snap.n_base_dead else 0),
                 meta.n_pad)
    log(f"[{label}] snapshot {snap_s:.3f} s: base n={meta.n} "
        f"(dead {snap.n_base_dead}), delta {snap.delta_count} filled, "
        f"{int(snap.delta_valid.sum())} live, cap_q {snap.delta_x.shape[0]} "
        f"({snap.delta_x.numel() * 4 / 2**20:.1f} MiB copied); k_base {k_base}; "
        f"clean {snap.clean}")
    search = stream_search(st)
    # -- the stream path, counted
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    ids, scores, sst = search(q)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[{label}] stream path launches {launches}; first search "
        f"{first_s:.3f} s; peak memory {peak / 2**20:.1f} MiB "
        f"({resident / 2**20:.1f} MiB allocated before the search, "
        f"+{(peak - resident) / 2**20:.1f} MiB during it)")
    require(all(launches[name] > 0 for name in path_kernels),
            f"[{label}] a kernel of the path was not launched: {launches}")
    require(ids.shape == (q.shape[0], k) and bool((ids >= 0).all())
            and bool(torch.isfinite(scores).all()),
            f"[{label}] wrong shape, an empty slot or a non-finite score")

    # -- the live rows on the card, by global id
    gids, rows = st.alive_items()
    x_alive = torch.from_numpy(rows).cuda()
    gids_t = torch.from_numpy(gids).cuda()
    pos_of = torch.full((int(gids.max()) + 1,), -1, dtype=torch.long,
                        device="cuda")
    pos_of[gids_t] = torch.arange(len(gids), device="cuda")
    live_rows = snap.base_alive.nonzero().flatten()
    block_of = torch.full_like(pos_of, -1)
    block_of[arrays.ids[live_rows].long()] = live_rows // meta.page_rows
    block_of = block_of.cpu()

    # -- the same search on the plain versions
    ids_p, _, sst_p = stream_search(st, use_kernels=False)(q)
    mask0 = sd.select_frontend(arrays, meta, q)[-1]
    est_bnd = sd.prefilter_round1(arrays, q, mask0, k_base, meta.page_rows,
                                  SEARCH["prefilter_eps"], False)
    flips, _ = prefilter_flips(arrays, q, mask0, est_bnd, k_base)
    probe, _ = probe_flips(arrays, meta, q)
    differ, notes, pages_diff = compare_paths(
        q, ids, sst, ids_p, sst_p, flips,
        lambda i: x_alive[pos_of[i.clamp(min=0).long()]],
        lambda r: int(block_of[r]) if r < len(block_of) else -1, probe)
    log(f"[{label}] kernel vs plain path: {len(differ)} of {q.shape[0]} "
        f"queries differ in ids; {pages_diff} differ in pages; prefilter cut "
        f"flips at k_base (query: {{block: est+bnd-tau}}) "
        f"{flips if flips else 'none'}; Quick-Probe flips "
        f"{probe if probe else 'none'}")
    for note in notes:
        log(f"[{label}]   {note}")
    compare_drivers(label, search, q)

    # -- quality against the exact top-k over the live rows
    eidx, escores = exact_topk(x_alive, q, k)
    eids = gids_t[eidx].cpu()
    ids_c = ids.cpu()
    recall = sum(len(set(ids_c[b].tolist()) & set(eids[b].tolist())) / k
                 for b in range(q.shape[0])) / q.shape[0]
    rate = success_rate(scores, escores, meta.c)
    p0 = meta.p
    floor = p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / q.shape[0])
    log(f"[{label}] pages_mean {float(sst.pages.double().mean()):.2f} (base "
        f"{float(sst.base.pages.double().mean()):.2f} + delta sweep) recall@10 "
        f"{recall:.4f} over {len(gids)} live rows; theorem-2 success {rate:.4f} "
        f"(floor {floor:.4f}); exhausted {int(sst.exhausted.sum())}")
    require(rate >= floor, f"[{label}] Theorem-2 floor missed: {rate} < {floor}")
    require(recall >= 0.99, f"[{label}] recall@10 {recall} < 0.99")
    del x_alive, gids_t, pos_of

    if turns:
        time_turns(label, search, q)
    else:
        med, times = time_batches(search)
        log(f"[{label}] search time per batch of {N_QUERIES}: median "
            f"{med:.3f} ms over {len(times)} batches "
            f"{['%.3f' % t for t in times]}")
    return launches


def phase_compact_100k(pm, q):
    """Cell compact-100k: churn, a synchronous compaction and its search,
    then a background compaction with inserts and searches landing while
    it runs."""
    import numpy as np
    import torch
    from repro_torch.stream import Compactor
    st = stream_from_index(pm)
    n = pm.meta.n
    n_ins = -(-n // 9)                  # a 10% delta: 11,112 at n = 100k
    t0 = time.perf_counter()
    st.insert(np.arange(n, n + n_ins), corpus_rows(n_ins, seed=3))
    victims = np.random.RandomState(6).choice(n, 400, replace=False)
    st.delete(victims[:200])
    st.update(victims[200:], corpus_rows(200, seed=4))
    log(f"[compact-100k] {n_ins} inserts, 200 deletes, 200 updates in "
        f"{time.perf_counter() - t0:.3f} s (host); churn "
        f"{st.churn_fraction:.4f}")
    phase_stream_state("compact-100k before compaction", st, q,
                       ("quick_probe_select", "block_mips", "sketch_scores",
                        "mips_score"))
    t0 = time.perf_counter()
    st.compact()
    log(f"[compact-100k] compact() {time.perf_counter() - t0:.1f} s (host "
        f"rebuild over {st.meta.n} rows); churn {st.churn_fraction}")
    phase_stream_state("compact-100k after compact()", st, q,
                       ("quick_probe_select", "block_mips", "sketch_scores"))

    # -- a background compaction with writes and searches landing meanwhile
    st.compactor = Compactor()
    more = corpus_rows(1_000, seed=5)
    more_ids = np.arange(n + 20_000, n + 21_000)
    search = stream_search(st)
    t0 = time.perf_counter()
    st.compactor.start(st)
    in_flight = 0
    for i in range(10):
        in_flight += st.compactor.in_flight
        st.insert(more_ids[100 * i:100 * (i + 1)], more[100 * i:100 * (i + 1)])
        _, scores, _ = search(q)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(scores).all()),
                "[compact-100k] a search during the rebuild gave a non-finite score")
    writes_s = time.perf_counter() - t0
    st.join_compaction(timeout=600)
    log(f"[compact-100k] background compaction: {in_flight} of 10 insert "
        f"batches (100 rows each, a search on the card after each) landed "
        f"while the rebuild was in flight ({writes_s:.2f} s of writes and "
        f"searches); host rebuild {st.compactor.last_rebuild_s:.1f} s; "
        f"{time.perf_counter() - t0:.1f} s to join; runs {st.compactor.runs}")
    require(in_flight > 0 and st.compactor.runs == 1,
            "[compact-100k] no write landed during the background rebuild")
    gids, rows = st.alive_items()
    require(set(more_ids.tolist()) <= set(gids.tolist()),
            "[compact-100k] a row inserted during the rebuild is not alive")
    # the inserted rows as queries: each one that is in its own exact top-10
    # over the live rows must be found by the search
    qi = torch.from_numpy(more[:N_QUERIES]).cuda()
    ids, _, _ = search(qi)
    eidx, _ = exact_topk(torch.from_numpy(rows).cuda(), qi, SEARCH["k"])
    eids = torch.from_numpy(gids)[eidx.cpu()]
    own = [int(g) for g in more_ids[:N_QUERIES]]
    expected = [b for b in range(N_QUERIES) if own[b] in eids[b].tolist()]
    found = [b for b in expected if own[b] in ids[b].tolist()]
    recall = sum(len(set(ids[b].tolist()) & set(eids[b].tolist()))
                 for b in range(N_QUERIES)) / (N_QUERIES * SEARCH["k"])
    log(f"[compact-100k] after join: {len(found)} of {len(expected)} inserted "
        f"rows that are in their own exact top-10 are found; recall@10 of "
        f"those {N_QUERIES} queries {recall:.4f}")
    require(len(found) == len(expected) and recall >= 0.99,
            "[compact-100k] an inserted row was not found after the join")
    phase_stream_state("compact-100k after the background compaction", st, q,
                       ("quick_probe_select", "block_mips", "sketch_scores",
                        "mips_score"))


def phase_stream_1m(pm, q):
    """Cell stream-1M: state A (a 10% delta) and state B (2,000 base
    tombstones, k_base = 2,058). Returns state B's launches."""
    import numpy as np
    st = stream_from_index(pm)
    n = pm.meta.n
    n_ins = -(-n // 9)          # frac / (1 - frac) * n at frac 0.1: 111,112
    t0 = time.perf_counter()
    st.insert(np.arange(n, n + n_ins), corpus_rows(n_ins, seed=3))
    log(f"[stream-1M] state A: {n_ins} inserts in {time.perf_counter() - t0:.2f} s "
        f"(host); delta fraction {st.delta_fraction:.4f}")
    kernels = ("quick_probe_select", "block_mips", "sketch_scores", "mips_score")
    phase_stream_state("stream-1M state A", st, q, kernels, turns=True)
    rng = np.random.RandomState(5)
    base_ids = rng.choice(n, 2_000, replace=False)
    t0 = time.perf_counter()
    st.delete(base_ids[:1_000])
    st.update(base_ids[1_000:], corpus_rows(1_000, seed=4))
    st.delete(rng.choice(np.arange(n, n + n_ins), 1_112, replace=False))
    log(f"[stream-1M] state B: 1,000 base deletes, 1,000 base updates, "
        f"1,112 delta deletes in {time.perf_counter() - t0:.2f} s (host)")
    return phase_stream_state("stream-1M state B", st, q, kernels, turns=True)



# ---------------------------------------------------------------- phase 6

# the serve cell: tinyllama-1.1b at full width, the engine's own defaults
SERVE = dict(arch="tinyllama-1.1b", batch_slots=4, max_len=512, n_requests=16,
             prompt_lens=(24, 40), max_new_tokens=16, param_seed=0,
             traffic_seed=3)
VOCAB_INDEX = dict(m=8, c=0.9, p=0.9, norm_strata=4, seed=0)
# a token of the kernel path that differs from the plain path's must be a
# near-tie: the two tokens' logits (exact f32 logits of the shared context)
# within this of each other
LOGIT_TOL = 1e-4


def serve_prompts(vocab, n, lens, seed):
    rng = __import__("numpy").random.RandomState(seed)
    return [rng.randint(1, vocab, size=lens[i % len(lens)]).astype("int32")
            for i in range(n)]


def run_traffic(engine, prompts, max_new):
    """Submit every prompt and step the engine until it is idle. Returns
    (requests, step seconds, wall seconds); each step ends in a sync."""
    import torch
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    times = []
    t0 = time.perf_counter()
    while engine.queue or engine.active.any():
        ts = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    return reqs, times, time.perf_counter() - t0


class SearchLog:
    """Wraps an index's `search` to keep each searched batch's queries and
    returned top-1 (id, score), for the guarantee check."""

    def __init__(self, index):
        self.rows = []
        inner = index.search

        def search(queries, k=None, **opts):
            res = inner(queries, k=k, **opts)
            self.rows.append((queries.detach().clone(), res.ids[:, 0].copy(),
                              res.scores[:, 0].copy()))
            return res

        index.search = search

    def guarantee(self, live, c):
        """(rows searched, rows whose top-1 score >= c * the exact top-1
        over ``live`` (n_live, d) on the card)."""
        import torch
        n = ok = 0
        for qs, _, s1 in self.rows:
            exact = (qs.float() @ live.T).amax(dim=1).double().cpu()
            s1 = torch.from_numpy(s1).double()
            ok += int(((s1 >= c * exact - 1e-5) | (exact <= 0)).sum())
            n += len(s1)
        self.rows.clear()
        return n, ok


def explain_token_diffs(label, params, cfg, reqs_a, reqs_b):
    """Each request's tokens on two paths: equal, or the first position
    where they part is a near-tie of the exact logits of the shared context
    (|l[a] - l[b]| <= LOGIT_TOL). Returns the notes of the differences."""
    import torch
    from repro_torch.models import transformer as T
    notes = []
    for i, (ra, rb) in enumerate(zip(reqs_a, reqs_b)):
        if ra.out_tokens == rb.out_tokens:
            continue
        t = next(j for j, (x, y) in enumerate(zip(ra.out_tokens, rb.out_tokens))
                 if x != y)
        require(t > 0, f"[{label}] request {i}: the prefill tokens differ "
                "(prefill runs no kernel)")
        ctx = list(ra.prompt) + ra.out_tokens[:t]
        tokens = torch.tensor([ctx], device=DEVICE)
        _, lg = T.prefill(params, cfg, {"tokens": tokens}, len(ctx))
        a, b = ra.out_tokens[t], rb.out_tokens[t]
        margin = float((lg[0, a] - lg[0, b]).abs())
        require(margin <= LOGIT_TOL,
                f"[{label}] request {i} parts at token {t}: {a} vs {b} with "
                f"logit margin {margin} > {LOGIT_TOL}")
        notes.append(f"request {i} token {t}: {a} vs {b}, logit margin "
                     f"{margin:.3g} (tol {LOGIT_TOL})")
    return notes


def profile_step(engine, prompts, label):
    """Device time by kernel and the device's idle share over one decode
    step with every slot active (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:engine.b]:
        engine.submit(p, max_new_tokens=64)
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        name = name[5:] if name.startswith("void ") else name
        total, count = by_name.get(name[:70], (0.0, 0))
        by_name[name[:70]] = (total + e.time_range.end - e.time_range.start,
                              count + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    if busy_ms == 0:
        log(f"[profile serve {label}] device time not measured: the trace "
            "holds no CUDA events")
    else:
        log(f"[profile serve {label}] one {engine.logits_mode} decode step, "
            f"{engine.b} active slots: wall {wall_ms:.3f} ms under the "
            f"profiler, device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}")
        for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"[profile serve {label}]   {t / 1e3:8.3f} ms  x{c:<4d} {name}")
    while engine.queue or engine.active.any():
        engine.step()


def decode_graphs(engine):
    """The engine's two `_DecodeGraph`s, by attribute name."""
    return {"_decode": engine._decode, "_decode_hidden": engine._decode_hidden}


def use_graphs(engine, graphs, on):
    """Point the engine's decode functions at its CUDA graphs (``on``) or at
    the eager functions behind them (a test seam, not an engine option)."""
    for name, g in graphs.items():
        setattr(engine, name, g if on else g.step)


def check_graph_bits(label, engine, graphs):
    """One decode step, on the engine's cache as its traffic left it and a
    seeded token batch, through the engine's graph (replayed) and eagerly
    from the same cache: the output (logits or hidden state) and the cache
    must be equal bit for bit."""
    import numpy as np
    import torch
    variant = "_decode_hidden" if engine.logits_mode == "promips" else "_decode"
    g = graphs[variant]
    require(g.graph is not None, f"[serve {label}] {variant} was never captured")
    tok = torch.from_numpy(np.random.RandomState(7).randint(
        1, engine.cfg.vocab, (engine.b, 1)).astype("int32")).to(DEVICE)
    saved = {n: t.clone() for n, t in engine.cache.items()}
    out_g = g(engine.params, engine.cache, tok)[0].clone()
    cache_g = {n: t.clone() for n, t in engine.cache.items()}
    for n, t in engine.cache.items():
        t.copy_(saved[n])
    out_e = g.step(engine.params, engine.cache, tok)[0]
    torch.cuda.synchronize()
    what = "hidden state" if variant == "_decode_hidden" else "logits"
    diff = float((out_g - out_e).abs().max())
    same = torch.equal(out_g, out_e) and all(
        torch.equal(cache_g[n], engine.cache[n]) for n in saved)
    log(f"[serve {label}] a fixed step's {what} {tuple(out_g.shape)}, graph "
        f"replay vs eager: {'equal bit for bit' if same else 'DIFFER'} "
        f"(largest difference {diff:.3g})")
    require(same, f"[serve {label}] graph and eager {what} differ, largest "
            f"difference {diff}")


def timed_prefills(engine):
    """Record the wall time of each of the engine's prefill groups (each
    ends in a copy of its logits to the host). Returns the list."""
    inner, times = engine._prefill_group, []

    def prefill_group(group):
        t0 = time.perf_counter()
        inner(group)
        times.append(time.perf_counter() - t0)

    engine._prefill_group = prefill_group
    return times


def serve_run(label, engine, prompts, new, searches, live, meta, cfg):
    """One traffic run with the launch counts, the peak memory and the
    checks of its path; returns its numbers."""
    import torch
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    steps0 = engine.steps
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    prefills = timed_prefills(engine)
    reqs, times, wall = run_traffic(engine, prompts, new)
    del engine._prefill_group
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = engine.steps - steps0
    n_search = len(searches.rows)
    rows_searched, ok = searches.guarantee(live, meta.c)
    decoded = sum(len(r.out_tokens) - 1 for r in reqs)
    require(all(len(r.out_tokens) >= 1 and 0 <= min(r.out_tokens)
                and max(r.out_tokens) < cfg.vocab for r in reqs),
            f"[serve {label}] a request emitted no token or an id outside "
            "the vocab")
    times_ms = sorted(1e3 * t for t in times)
    median = times_ms[len(times_ms) // 2]
    log(f"[serve {label}] {len(reqs)} requests, {steps} steps, {decoded} "
        f"decoded tokens in {wall:.3f} s = {decoded / wall:.1f} tokens/s; step "
        f"median {median:.3f} ms (range {times_ms[0]:.3f}-{times_ms[-1]:.3f}); "
        f"{len(prefills)} prefills (eager) {1e3 * sum(prefills):.1f} ms in all; "
        f"launches {counts}; peak memory {peak / 2**20:.1f} MiB "
        f"({resident / 2**20:.1f} before + {(peak - resident) / 2**20:.1f})")
    if engine.use_kernels is None:
        require(counts["decode_attention"] == cfg.n_layers * steps,
                f"[serve {label}] decode_attention launched "
                f"{counts['decode_attention']} times in {steps} steps of "
                f"{cfg.n_layers} layers")
    else:
        require(not any(counts.values()),
                f"[serve {label}] a kernel was launched: {counts}")
    if engine.logits_mode == "promips":
        p0 = meta.p
        floor = p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / max(rows_searched, 1))
        share = ok / max(rows_searched, 1)
        log(f"[serve {label}] {n_search} searches; guarantee: {ok} of "
            f"{rows_searched} searched rows have a top-1 score >= c={meta.c} x "
            f"the exact top-1 over the live vocab: {share:.4f} (floor "
            f"{floor:.4f})")
        require(rows_searched > 0 and share >= floor,
                f"[serve {label}] guarantee share {share} < {floor}")
        if engine.use_kernels is None:
            require(counts["quick_probe_select"] == n_search
                    and counts["mips_score"] >= n_search,
                    f"[serve {label}] a search kernel was not launched once "
                    f"per search ({n_search}): {counts}")
    return dict(reqs=reqs, tokens=[r.out_tokens for r in reqs], counts=counts,
                steps=steps, searches=n_search, median_ms=median,
                tok_s=decoded / wall, peak=peak)


def graph_turns(label, engine, prompts, new, searches, live, meta, cfg,
                max_captures=1):
    """The traffic four times on one engine, eager, graph, graph, eager:
    equal tokens and launches in all four, and at most ``max_captures``
    captures of each decode variant. Returns the runs."""
    graphs = decode_graphs(engine)
    runs = []
    for turn, on in enumerate((False, True, True, False)):
        use_graphs(engine, graphs, on)
        runs.append(serve_run(f"{label} {'graph' if on else 'eager'} {turn + 1}",
                              engine, prompts, new, searches, live, meta, cfg))
    use_graphs(engine, graphs, True)
    require(all(r["tokens"] == runs[0]["tokens"] for r in runs),
            f"[serve {label}] the tokens differ between graph and eager runs")
    require(all(r["counts"] == runs[0]["counts"] for r in runs),
            f"[serve {label}] the launches differ between graph and eager: "
            f"{[r['counts'] for r in runs]}")
    caps = {name: g.captures for name, g in graphs.items()}
    log(f"[serve {label}] graph vs eager: tokens equal in all four runs, "
        f"launches equal ({runs[0]['counts']}); captures {caps}; graph "
        f"medians {runs[1]['median_ms']:.3f} / {runs[2]['median_ms']:.3f} ms "
        f"against eager {runs[0]['median_ms']:.3f} / {runs[3]['median_ms']:.3f}")
    require(all(n <= max_captures for n in caps.values()),
            f"[serve {label}] a decode variant was captured more than "
            f"{max_captures} times: {caps}")
    check_graph_bits(label, engine, graphs)
    return runs


def traced_steps(engine, prompts, new):
    """The traffic with the span tracer on and fencing: per step, the wall
    time and the totals of a ``decode`` span around the decode graph's
    replay (synchronized, so the search spans hold only the search) and
    of the ``search``, ``rescore`` and ``segments_merge`` spans. Returns
    the per-step rows; the spans go to build/serve_promips_spans.json."""
    import torch
    from repro_torch.obs import trace
    names = ("decode", "search", "rescore", "segments_merge")
    rows = []
    graph = engine._decode_hidden

    def fenced_decode(params, cache, token):
        with trace.span("decode") as sp:
            return sp.fence(graph(params, cache, token))

    engine._decode_hidden = fenced_decode
    trace.clear()
    trace.enable(fence=True)
    try:
        for p in prompts:
            engine.submit(p, max_new_tokens=new)
        while engine.queue or engine.active.any():
            n_before = trace.total()
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            sums = dict.fromkeys(names, 0.0)
            ring = trace.spans()
            for sp in ring[len(ring) - (trace.total() - n_before):]:
                if sp["name"] in sums:
                    sums[sp["name"]] += sp["dur_us"] / 1e3
            rows.append((wall, sums))
        trace.export_chrome_trace(os.path.join(ROOT, "build",
                                               "serve_promips_spans.json"))
    finally:
        engine._decode_hidden = graph
        trace.disable()
        trace.clear()
    return rows


def phase_serve():
    """The serve cell. Returns the launches of the counted promips run."""
    import torch
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import DecodeEngine, LoadgenConfig, generate, run_load
    cfg = get_config(SERVE["arch"])
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["param_seed"], device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} (padded {cfg.vocab_padded}); {n_params} f32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    emb = params["embed"][: cfg.vocab].cpu().numpy()
    kw = dict(VOCAB_INDEX)
    t0 = time.perf_counter()
    index = api.build(emb, backend="promips-stream",
                      guarantee=api.GuaranteeConfig(c=kw.pop("c"), p0=kw.pop("p")),
                      auto_compact=True, seed=kw.pop("seed"), device=DEVICE, **kw)
    meta = index.inner.meta
    log(f"[serve] vocab index (promips-stream over embed[:{cfg.vocab}], "
        f"{VOCAB_INDEX}): host build {time.perf_counter() - t0:.1f} s; "
        f"page_rows={meta.page_rows} NB={meta.n_blocks} G={meta.n_groups} "
        f"S={meta.n_subparts}")
    searches = SearchLog(index)
    prompts = serve_prompts(cfg.vocab, SERVE["n_requests"], SERVE["prompt_lens"],
                            SERVE["traffic_seed"])
    eng_kw = dict(batch_slots=SERVE["batch_slots"], max_len=SERVE["max_len"],
                  result_cache=0, device=DEVICE)
    new = SERVE["max_new_tokens"]
    live = torch.from_numpy(emb).to(DEVICE)
    run_args = (prompts, new, searches, live, meta, cfg)
    runs, engines, launches = {}, {}, None
    for mode in ("exact", "promips"):
        # the kernel path four times on one engine (eager, graph, graph,
        # eager), the plain path once through its graph
        engine = DecodeEngine(params, cfg, logits_mode=mode, use_kernels=None,
                              index=index if mode == "promips" else None,
                              **eng_kw)
        turns = graph_turns(f"{mode}/kernels", engine, *run_args)
        engines[mode] = engine
        runs[mode, "kernels"] = turns[2]
        plain = DecodeEngine(params, cfg, logits_mode=mode, use_kernels=False,
                             index=index if mode == "promips" else None,
                             **eng_kw)
        runs[mode, "plain"] = serve_run(f"{mode}/plain graph", plain, *run_args)
        caps = {name: g.captures for name, g in decode_graphs(plain).items()}
        require(max(caps.values()) == 1 and min(caps.values()) == 0,
                f"[serve {mode}/plain] captures {caps}, one variant once")
        del plain
        if mode == "promips":
            r = turns[2]
            pages_row = engine.pages / max(engine.searched_rows, 1)
            dense = cfg.vocab_padded * cfg.d_model * 4 // 4096
            log(f"[serve promips/kernels] {engine.searched_rows} rows searched "
                f"in four runs: {pages_row:.1f} blocks per row of "
                f"{meta.page_rows} x {cfg.d_model} f32 "
                f"({pages_row * meta.page_rows * cfg.d_model * 4 / 4096:.1f}"
                f" 4-KB pages) against the exact mode's dense scan of "
                f"{dense} 4-KB pages; per search quick_probe_select "
                f"{r['counts']['quick_probe_select'] / max(r['searches'], 1):.2f}"
                f", mips_score "
                f"{r['counts']['mips_score'] / max(r['searches'], 1):.2f} "
                f"launches")
            launches = dict(r["counts"], steps=r["steps"], searches=r["searches"])
        notes = explain_token_diffs(f"serve {mode}", params, cfg,
                                    runs[mode, "kernels"]["reqs"],
                                    runs[mode, "plain"]["reqs"])
        log(f"[serve {mode}] kernel vs plain path: "
            f"{len(notes)} of {len(prompts)} requests differ in tokens"
            + "".join(f"; {n}" for n in notes))
    ka, kb = runs["exact", "kernels"]["tokens"], runs["promips", "kernels"]["tokens"]
    same = sum(a == b for a, b in zip(ka, kb))
    tok_eq = sum(x == y for a, b in zip(ka, kb) for x, y in zip(a, b))
    tok_n = sum(min(len(a), len(b)) for a, b in zip(ka, kb))
    log(f"[serve] exact vs promips (kernel paths, not gated): {same} of "
        f"{len(prompts)} requests emit the same tokens; {tok_eq} of {tok_n} "
        f"token positions agree")
    engine = engines["promips"]
    graphs = decode_graphs(engine)
    profile_step(engine, prompts, "graph")
    use_graphs(engine, graphs, False)
    profile_step(engine, prompts, "eager")
    use_graphs(engine, graphs, True)
    searches.rows.clear()

    # -- the hot-query cache on repeated prompts, against the cache off
    repeated = prompts[:8] * 2
    outs = {}
    for cap in (0, 256):
        eng = DecodeEngine(params, cfg, logits_mode="promips", index=index,
                           **dict(eng_kw, result_cache=cap))
        reqs, _, wall = run_traffic(eng, repeated, new)
        outs[cap] = [r.out_tokens for r in reqs]
        st = eng.qcache.stats()
        log(f"[serve cache {cap}] {len(repeated)} requests (8 prompts twice): "
            f"{eng.searched_rows} rows searched, cache {st}, {wall:.3f} s")
    del eng
    searches.rows.clear()
    require(st["hits"] > 0, "[serve cache] no hit on repeated prompts")
    require(outs[0] == outs[256], "[serve cache] tokens differ with the cache on")

    # -- mutation: retire three emitted ids, then refresh one row; graph
    # against eager again in the mutated state
    emitted = [t for r in runs["promips", "kernels"]["reqs"]
               for t in r.out_tokens[1:] if t != engine.eos_id]
    retired = [int(t) for t, _ in
               sorted(((t, emitted.count(t)) for t in set(emitted)),
                      key=lambda tc: (-tc[1], tc[0]))[:3]]
    engine.delete(retired)
    reqs, _, wall = run_traffic(engine, prompts, new)
    hit = sorted({t for r in reqs for t in r.out_tokens} & set(retired))
    gids, rows = index.alive_items()
    live_rows = torch.from_numpy(rows).to(DEVICE)
    n_rows, ok = searches.guarantee(live_rows, meta.c)
    log(f"[serve mutation] deleted ids {retired} (the most emitted); the same "
        f"traffic again in {wall:.3f} s: retired ids emitted {hit or 'none'}; "
        f"guarantee {ok} of {n_rows} rows over {len(gids)} live rows")
    require(not hit, f"[serve mutation] a deleted id was emitted: {hit}")
    upd = int(next(t for t in range(1, cfg.vocab) if t not in retired))
    row = (params["embed"][upd] * 1.5).cpu().numpy()
    engine.update([upd], row[None])
    live_rows = torch.from_numpy(index.alive_items()[1]).to(DEVICE)
    mut = graph_turns("promips/kernels after the deletes and the update",
                      engine, prompts[:4], new, searches, live_rows, meta, cfg,
                      max_captures=2)
    hit = sorted({t for r in mut[0]["reqs"] for t in r.out_tokens}
                 & set(retired))
    log(f"[serve mutation] updated id {upd} (its row x 1.5, now in the delta "
        f"segment); 4 requests; retired ids emitted {hit or 'none'}; "
        f"captures of the hidden-state graph {graphs['_decode_hidden'].captures}"
        f" (one more after update() copied the embed table)")
    require(not hit, f"[serve mutation] a deleted id was emitted: {hit}")
    require(graphs["_decode_hidden"].captures == 2,
            "[serve mutation] the hidden-state graph was not captured once "
            f"more after update(): {graphs['_decode_hidden'].captures}")

    # -- the vocab search's spans against the step, fenced
    rows = traced_steps(engine, prompts, new)
    for i in range(0, len(rows), 8):
        log(f"[serve spans] steps {i}-{min(i + 8, len(rows)) - 1}, ms of wall"
            f" / decode / search / rescore / segments_merge: " + "; ".join(
                f"{w:.3f} / {s['decode']:.3f} / {s['search']:.3f} / "
                f"{s['rescore']:.3f} / {s['segments_merge']:.3f}"
                for w, s in rows[i:i + 8]))
    med = sorted(w for w, _ in rows)[len(rows) // 2]
    tot = {name: sum(s[name] for _, s in rows) for name in rows[0][1]}
    wall_sum = sum(w for w, _ in rows)
    log(f"[serve spans] {len(rows)} fenced promips steps after the mutations: "
        f"step median {med:.3f} ms; of {wall_sum:.1f} ms of steps, the decode "
        f"graph {tot['decode']:.1f} ms ({tot['decode'] / wall_sum:.3f}), search "
        f"{tot['search']:.1f} ms ({tot['search'] / wall_sum:.3f}; rescore "
        f"{tot['rescore']:.1f} inside it), segments_merge "
        f"{tot['segments_merge']:.1f} ms ({tot['segments_merge'] / wall_sum:.3f})"
        f"; Chrome trace build/serve_promips_spans.json")
    require(tot["search"] > 0 and tot["segments_merge"] > 0,
            "[serve spans] no search or segments_merge span was recorded")
    searches.rows.clear()

    # -- open-loop load at half the graph engine's throughput
    step_s = runs["promips", "kernels"]["median_ms"] / 1e3
    rate = 0.5 * SERVE["batch_slots"] / (new * step_s)
    lg = LoadgenConfig(rate_qps=rate, n_requests=max(1, round(10.0 * rate)),
                       pool_size=32, prompt_lens=SERVE["prompt_lens"],
                       max_new_tokens_choices=(new,), seed=SERVE["traffic_seed"])
    eng = DecodeEngine(params, cfg, logits_mode="promips", index=index,
                       **dict(eng_kw, result_cache=256))
    arrivals = generate(lg, cfg.vocab)
    prefills = timed_prefills(eng)
    summary = run_load(eng, arrivals, max_wall_s=120.0)
    searches.rows.clear()
    log(f"[serve loadgen] open loop, {lg.n_requests} requests at "
        f"{rate:.2f} requests/s (half of {SERVE['batch_slots']} slots / "
        f"({new} tokens x {1e3 * step_s:.3f} ms)), Zipf {lg.zipf_s} over "
        f"{lg.pool_size} prompts, graph engine, result cache 256: "
        f"{json.dumps(summary)}")
    log(f"[serve loadgen] {eng.steps} decode steps; {len(prefills)} prefills "
        f"(eager, one a prompt length admitted together) took "
        f"{sum(prefills):.3f} s of the {summary['wall_s']:.3f} s "
        f"(median {1e3 * sorted(prefills)[len(prefills) // 2]:.3f} ms)")
    require(summary["completed"] + round(summary["shed_frac"] * lg.n_requests)
            + round(summary["expired_frac"] * lg.n_requests) == lg.n_requests
            and summary["completed"] > 0,
            f"[serve loadgen] requests unaccounted for: {summary}")
    require(eng._decode_hidden.captures == 1,
            f"[serve loadgen] captures {eng._decode_hidden.captures}")
    engine.join_compaction(timeout=600)
    return launches


# ---------------------------------------------------------------- phase 7

N_SHARDS = 4


def counted(fn):
    """``fn()`` with every launch count set to 0 just before it and read just
    after: (its result, the launches it made)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def require_launched(label, launches, kernels):
    require(all(launches[name] > 0 for name in kernels),
            f"[{label}] a kernel of the path was not launched: {launches}")


def shard_flips(views, q):
    """The kernel path against the plain one, shard by shard: ``views`` is
    one (arrays, meta, k) a shard. Returns (prefilter cut flips {query:
    {(shard, block): margin}}, Quick-Probe flips {query: least margin})."""
    from repro_torch.core import search_device as sd
    flips, probe = {}, {}
    for s, (arrays, meta, k) in enumerate(views):
        mask0 = sd.select_frontend(arrays, meta, q)[-1]
        est_bnd = sd.prefilter_round1(arrays, q, mask0, k, meta.page_rows,
                                      SEARCH["prefilter_eps"], False)
        cut, _ = prefilter_flips(arrays, q, mask0, est_bnd, k)
        for b, blocks in cut.items():
            flips.setdefault(b, {}).update(
                {(s, n): m for n, m in blocks.items()})
        margins, _ = probe_flips(arrays, meta, q)
        for b, m in margins.items():
            probe[b] = min(probe.get(b, m), m)
    return flips, probe


class _Pages:
    """The stats `compare_paths` reads, for a search that reports its pages
    as one total."""

    def __init__(self, pages):
        import torch
        self.pages = torch.as_tensor(pages)


def quality(q, ids, scores, x_live, gids_live, c, p0):
    """Recall@k of ``ids`` against an exact top-k over the live rows
    ``x_live`` (global ids ``gids_live``, or their row numbers when None),
    the Theorem-2 share of ``scores`` and its floor for this batch."""
    k = ids.shape[1]
    eidx, escores = exact_topk(x_live, q, k)
    eids = (eidx if gids_live is None else gids_live[eidx]).cpu()
    ids = ids.cpu()
    recall = sum(len(set(ids[b].tolist()) & set(eids[b].tolist())) / k
                 for b in range(q.shape[0])) / q.shape[0]
    rate = success_rate(scores, escores, c)
    return recall, rate, p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / q.shape[0])


def phase_sharded_1m(pm, x, q):
    """Cell sharded-1M: the n=1M rows in 4 shards (`build_sharded` on the
    host), searched by `sharded_search` on one card, the shards in sequence:
    fused (the main path's config), batched and the default progressive.
    Returns the launches of each mode's search."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import search_graph
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.sharded import (build_sharded,
                                          device_put_sharded_index,
                                          sharded_search)
    label = "sharded-1M"
    k = SEARCH["k"]
    t0 = time.perf_counter()
    sh = build_sharded(x.cpu().numpy(), N_SHARDS, **BUILD)
    build_s = time.perf_counter() - t0
    a = sh.arrays
    t0 = time.perf_counter()
    dsh = device_put_sharded_index(sh, DEVICE)
    torch.cuda.synchronize()
    meta = dsh.meta
    real = {
        "rows": (a.ids >= 0).sum(axis=1).tolist(),
        "groups": (a.g_count > 0).sum(axis=1).tolist(),
        "sub-partitions": (a.sp_center[..., 0] != np.float32(1e30)).sum(
            axis=1).tolist(),
        "blocks": (a.block_sp_idx >= 0).any(axis=2).sum(axis=1).tolist(),
        "codewords": (a.sk_codebooks != 0).any(axis=(1, 3)).sum(
            axis=1).tolist()}
    log(f"[{label}] build_sharded {build_s:.1f} s (host, {N_SHARDS} shards), "
        f"upload {time.perf_counter() - t0:.2f} s; common meta NB "
        f"{meta.n_blocks} G {meta.n_groups} S {meta.n_subparts} K "
        f"{meta.sk_codewords} n_pad {meta.n_pad}; real per shard {real}")
    del sh, a

    knobs = {key: v for key, v in SEARCH.items() if key != "k"}
    cfgs = {"fused": RuntimeConfig(**knobs),
            "batched": RuntimeConfig(verification="batched", **knobs),
            "progressive": None}   # sharded_search's default

    def search(mode, qb=q, use_kernels=None):
        cfg = cfgs[mode]
        if use_kernels is not None:
            cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
        return sharded_search(dsh, qb, k, device=DEVICE, runtime=cfg)

    def captures():
        """CUDA graphs held for each shard's kernel-path fused searches."""
        return [sum(len(e.graphs) for e in search_graph._GRAPHS.values()
                    if e.arrays is view and e.cfg.on_kernels)
                for view in dsh.shards]

    def same(a, b):
        return _same_bits(a[:2], b[:2]) and int(a[2]) == int(b[2])

    # the plain path first: its graph keys are then the oldest, the ones
    # the cache evicts once the kernel path's and the unsharded index's join
    plain = search("fused", use_kernels=False)
    runs, caps, launches = [], [], {}
    for i in range(3):
        out, used = counted(lambda: search("fused"))
        runs.append(out)
        caps.append(captures())
        if i == 0:
            launches["fused"] = used
    require_launched(label, launches["fused"],
                     ("quick_probe_select", "sketch_scores", "block_mips"))
    require(all(same(r, runs[0]) for r in runs[1:]),
            f"[{label}] the eager, capturing and replaying searches differ")
    require(all(c == 0 for c in caps[0]) and all(c > 0 for c in caps[1])
            and caps[2] == caps[1],
            f"[{label}] graph captures per shard after each search {caps}: "
            "want none, then some, then no more")
    fused = runs[0]
    with host_driver():
        want = search("fused")
    require(same(fused, want), f"[{label}] the fused sharded search differs "
            "from the per-shard host driver merged by the same rule")
    batched, launches["batched"] = counted(lambda: search("batched"))
    require_launched(label, launches["batched"],
                     ("quick_probe_select", "sketch_scores", "mips_score"))
    require(same(fused, batched), f"[{label}] fused and batched differ in "
            "ids, scores or pages")
    progressive, launches["progressive"] = counted(
        lambda: search("progressive"))
    require_launched(label, launches["progressive"], ("scan_blocks",))
    log(f"[{label}] launches of one sharded search: " + "; ".join(
        f"{mode} {{{', '.join(f'{n}: {c}' for n, c in used.items() if c)}}}"
        for mode, used in launches.items()))
    log(f"[{label}] fused = per-shard host driver = batched bit for bit (ids, "
        f"scores, pages {int(fused[2])}); graph captures per shard after the "
        f"eager, capturing and replaying searches {caps}")

    # -- the kernel path against the plain path
    n_pad = meta.n_pad
    pos = torch.full((x.shape[0],), -1, dtype=torch.long, device=DEVICE)
    live = dsh.arrays.ids >= 0
    flat = torch.arange(live.numel(), device=DEVICE).view(live.shape)
    pos[dsh.arrays.ids[live].long()] = flat[live]
    pos = pos.cpu()
    flips, probe = shard_flips([(view, meta, k) for view in dsh.shards], q)
    differ, notes, pages_diff = compare_paths(
        q, fused[0], _Pages(fused[2]), plain[0], _Pages(plain[2]), flips,
        lambda i: x[i.clamp(min=0).long()],
        lambda r: (int(pos[r]) // n_pad, int(pos[r]) % n_pad // meta.page_rows),
        probe)
    log(f"[{label}] kernel vs plain path: {len(differ)} of {q.shape[0]} "
        f"queries differ in ids; pages {int(fused[2])} vs {int(plain[2])}; "
        f"prefilter cut flips (query: {{(shard, block): est+bnd-tau}}) "
        f"{flips if flips else 'none'}; Quick-Probe flips "
        f"{probe if probe else 'none'}")
    for note in notes:
        log(f"[{label}]   {note}")

    # -- quality against an exact top-k over the 1M rows
    for mode, out in (("fused", fused), ("progressive", progressive)):
        ids, scores, pages = out
        recall, rate, floor = quality(q, ids, scores, x, None, meta.c, meta.p)
        # the default progressive search's budget of 64 blocks truncates:
        # its share is reported, not held to the floor
        require(mode != "fused" or rate >= floor,
                f"[{label}] Theorem-2 floor missed: {rate} < {floor}")
        log(f"[{label}] {mode}: recall@10 {recall:.4f}, theorem-2 success "
            f"{rate:.4f} (floor {floor:.4f}), pages_mean "
            f"{int(pages) / q.shape[0]:.2f} over {N_SHARDS} shards")

    # -- time per batch, in turns with the unsharded index on the same
    # queries: one pass of each first (it captures its batches' variants)
    unsharded = lambda qb: pm.search(qb, **SEARCH)   # noqa: E731
    sharded = lambda qb: search("fused", qb)          # noqa: E731
    time_batches(unsharded)
    time_batches(sharded)
    caps_before = captures()
    turns = [(name, fn) + time_batches(fn) for name, fn in (
        ("unsharded", unsharded), ("sharded", sharded),
        ("sharded", sharded), ("unsharded", unsharded))]
    require(captures() == caps_before, f"[{label}] a timed replay captured: "
            f"{caps_before} -> {captures()}")
    for name, _, med, times in turns:
        log(f"[{label}] search time per batch of {N_QUERIES}, {name} "
            f"(graph driver): median {med:.3f} ms (range {min(times):.3f}-"
            f"{max(times):.3f}) {['%.3f' % t for t in times]}")
    phase_profile(sharded, q, f"{label} fused")
    return launches


# ---------------------------------------------------------------- phase 8

def probe_bits(arrays, meta, q, b):
    """Query ``b``'s Quick-Probe on the kernel and on the plain path, in
    hex: the chosen group, its bound under each and the radius under each
    (`ROADMAP.md` Queue 3 item 7)."""
    from repro_torch.core import search_device as sd
    from repro_torch.core.quick_probe import pack_codes, quick_probe_batch
    from repro_torch.kernels import ops
    table = sd._group_table(arrays)
    q_proj = q @ arrays.a
    q_l1 = q.abs().sum(dim=1)
    out = []
    for use in (True, False):
        row, radius, ok = quick_probe_batch(table, q_proj, q_l1, meta.c,
                                            meta.x_p, use)
        g = int((table.rep_row == row[b]).nonzero()[0])
        lb = ops.binary_probe_lb(table.code, pack_codes(q_proj), q_proj,
                                 use_kernels=use)[b, g]
        out.append(f"{'kernel' if use else 'plain'} group {g} (Test A "
                   f"{bool(ok[b])}) bound {_hex(lb)[0]} radius "
                   f"{_hex(radius[b])[0]}")
    return "; ".join(out)


def sharded_stream_state(label, s, q, cfg, path_kernels, tie_query=None):
    """One state of a `sharded` facade index: a counted search held against
    the plain path (flips per shard, at each shard's over-fetched k),
    against an exact top-k over the live rows (recall >= 0.99, no dead id)
    and the Theorem-2 floor; ``tie_query``'s Quick-Probe printed in hex a
    shard. Returns (ids, scores, stats, launches)."""
    import dataclasses
    import torch
    from repro_torch.core.search_common import next_pow2
    res, launches = counted(lambda: s.search(q, runtime=cfg))
    require_launched(label, launches, path_kernels)
    plain = s.search(q, runtime=dataclasses.replace(cfg, use_kernels=False))
    gids, rows = s.alive_items()
    x_alive = torch.from_numpy(rows).to(DEVICE)
    gids_t = torch.from_numpy(gids).to(DEVICE)
    pos_of = torch.full((int(gids.max()) + 1,), -1, dtype=torch.long,
                        device=DEVICE)
    pos_of[gids_t] = torch.arange(len(gids), device=DEVICE)
    block_of, views = {}, []
    for sh_i, shard in enumerate(s.inner.shards):
        snap = shard.snapshot()
        meta = snap.meta
        k_base = min(cfg.k + (next_pow2(snap.n_base_dead)
                              if snap.n_base_dead else 0), meta.n_pad)
        views.append((snap.arrays, meta, k_base))
        live_rows = snap.base_alive.nonzero().flatten()
        for g, r in zip(snap.arrays.ids[live_rows].tolist(),
                        live_rows.tolist()):
            block_of[g] = (sh_i, r // meta.page_rows)
    flips, probe = shard_flips(views, q)
    if tie_query is not None:
        for sh_i, (arrays, meta, _) in enumerate(views):
            log(f"[{label}] query {tie_query}, shard {sh_i}: "
                f"{probe_bits(arrays, meta, q, tie_query)}")
    ids_k = torch.from_numpy(res.ids).to(DEVICE)
    ids_p = torch.from_numpy(plain.ids).to(DEVICE)
    differ, notes, _ = compare_paths(
        q, ids_k, _Pages(res.stats["pages"]), ids_p,
        _Pages(plain.stats["pages"]), flips,
        lambda i: x_alive[pos_of[i.clamp(min=0).long()]],
        lambda r: block_of.get(r, -1), probe)
    log(f"[{label}] launches {launches}; kernel vs plain path: {len(differ)} "
        f"of {q.shape[0]} queries differ in ids; pages {res.stats['pages']} "
        f"vs {plain.stats['pages']}; prefilter cut flips at k_base "
        f"{flips if flips else 'none'}; Quick-Probe flips "
        f"{probe if probe else 'none'}")
    for note in notes:
        log(f"[{label}]   {note}")
    require(set(res.ids.ravel().tolist()) <= set(gids.tolist()),
            f"[{label}] a search returned an id that is not alive")
    scores = torch.from_numpy(res.scores).to(DEVICE)
    recall, rate, floor = quality(q, ids_k, scores, x_alive, gids_t,
                                  s.guarantee.c, s.guarantee.p0)
    require(rate >= floor, f"[{label}] Theorem-2 floor missed: {rate} < {floor}")
    require(recall >= 0.99, f"[{label}] recall@10 {recall} < 0.99")
    med, times = time_batches(lambda qb: s.search(qb, runtime=cfg))
    log(f"[{label}] recall@10 {recall:.4f} over {len(gids)} live rows; "
        f"theorem-2 success {rate:.4f} (floor {floor:.4f}); pages "
        f"{res.stats['pages']} ({res.stats['pages'] / q.shape[0]:.2f} a "
        f"query), exhausted {res.stats['exhausted']}; search time per batch "
        f"of {N_QUERIES}: median {med:.3f} ms (range {min(times):.3f}-"
        f"{max(times):.3f})")
    return res, launches


def _same_result(a, b):
    """Two `SearchResult`s equal bit for bit: ids, scores, every stats field
    but the wall time."""
    import numpy as np
    stats = [{k: v for k, v in r.stats.items() if k != "wall_time_s"}
             for r in (a, b)]
    return (np.array_equal(a.ids, b.ids)
            and np.array_equal(a.scores.view(np.int32), b.scores.view(np.int32))
            and stats[0] == stats[1])


def phase_sharded_stream_100k(x100k, q, tmp):
    """Cell sharded-stream-100k: the `sharded` backend (4 shards on the card)
    through `api.build`, the compact-100k writes, `compact()`, and a save /
    `api.load` round trip on the card. Returns the churned search's
    launches."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core.runtime import RuntimeConfig
    label = "sharded-stream-100k"
    k = SEARCH["k"]
    t0 = time.perf_counter()
    s = api.build(x100k.cpu().numpy(), backend="sharded",
                  guarantee=api.GuaranteeConfig(c=BUILD["c"], p0=BUILD["p"],
                                                k=k),
                  seed=BUILD["seed"], page_bytes=4096, n_shards=N_SHARDS,
                  m=BUILD["m"], k_p=BUILD["k_p"], k_sp=BUILD["k_sp"],
                  norm_strata=BUILD["norm_strata"], prefilter=True,
                  prefilter_eps=SEARCH["prefilter_eps"], device=DEVICE)
    log(f"[{label}] api.build(backend='sharded', n_shards={N_SHARDS}) "
        f"{time.perf_counter() - t0:.1f} s (host); shards of "
        f"{[sh.meta.n for sh in s.inner.shards]} rows, runtime {s.runtime}")
    cfg = RuntimeConfig(**{key: v for key, v in SEARCH.items() if key != "k"},
                        k=k)
    n = x100k.shape[0]
    n_ins = -(-n // 9)
    t0 = time.perf_counter()
    s.insert(np.arange(n, n + n_ins), corpus_rows(n_ins, seed=3))
    victims = np.random.RandomState(6).choice(n, 400, replace=False)
    s.delete(victims[:200])
    s.update(victims[200:], corpus_rows(200, seed=4))
    per_shard = [(sh.delta_fraction, sh._n_base_dead) for sh in s.inner.shards]
    log(f"[{label}] {n_ins} inserts, 200 deletes, 200 updates in "
        f"{time.perf_counter() - t0:.3f} s (host); per shard (delta fraction, "
        f"base tombstones) {[(round(f, 4), d) for f, d in per_shard]}")
    kernels = ("quick_probe_select", "block_mips", "sketch_scores",
               "mips_score")
    # query 57: where a round-1 block once moved by the plain radius's
    # last ulp (ROADMAP Queue 3 item 7)
    _, launches = sharded_stream_state(f"{label} churned", s, q, cfg,
                                       kernels, tie_query=57)
    saved = {}
    for state in ("churned", "compacted"):
        if state == "compacted":
            t0 = time.perf_counter()
            s.compact()
            log(f"[{label}] compact() {time.perf_counter() - t0:.1f} s (host "
                f"rebuild of {N_SHARDS} shards)")
            sharded_stream_state(f"{label} compacted", s, q, cfg,
                                 kernels[:3])
        path = os.path.join(tmp, f"{label}-{state}")
        t0 = time.perf_counter()
        s.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = api.load(path, device=DEVICE)
        load_s = time.perf_counter() - t0
        want, got = s.search(q, runtime=cfg), loaded.search(q, runtime=cfg)
        require(_same_result(got, want) and loaded.runtime == s.runtime,
                f"[{label}] {state}: the loaded index's search differs from "
                "the saved one's")
        require(_same_result(loaded.search(q), s.search(q)),
                f"[{label}] {state}: the loaded index's default search differs")
        saved[state] = (save_s, load_s, api.saved_bytes(path))
        del loaded
    for state, (save_s, load_s, nbytes) in saved.items():
        log(f"[{label}] {state}: save {save_s:.2f} s, api.load on the card "
            f"{load_s:.2f} s, saved_bytes {nbytes}; the loaded search equals "
            f"the saved index's bit for bit (ids, scores, every stats field)")
    log(f"[{label}] maintenance_status {s.maintenance_status()}")
    return launches


# ---------------------------------------------------------------- phase 9

def _wal_boundaries(path):
    """Byte offset of every record boundary of a WAL file (the first just
    past the magic)."""
    from repro_torch.robust.wal import _HDR, WAL_MAGIC
    with open(path, "rb") as f:
        blob = f.read()
    offs = [len(WAL_MAGIC)]
    while offs[-1] + _HDR.size <= len(blob):
        length, _ = _HDR.unpack_from(blob, offs[-1])
        offs.append(offs[-1] + _HDR.size + length)
    require(offs[-1] == len(blob), f"{path}: the log does not end on a record")
    return blob, offs


def _cut_copy(wal_dir, dst, nbytes):
    """A durability directory at ``dst`` whose log is the first ``nbytes``
    of ``wal_dir``'s; the snapshot is linked, not copied."""
    os.makedirs(dst)
    os.symlink(os.path.join(wal_dir, "snapshot"), os.path.join(dst, "snapshot"))
    with open(os.path.join(wal_dir, "wal.log"), "rb") as f:
        blob = f.read(nbytes)
    with open(os.path.join(dst, "wal.log"), "wb") as f:
        f.write(blob)
    return dst


def phase_durable_1m(pm1m, q1m, pm100k, q100k, tmp):
    """Cell durable-stream-1M: a write-ahead-logged `promips-stream` over the
    n=1M index takes phase 5's state-B writes and is recovered on the card
    from its full log and from one whose last record is torn; then a short
    logged stream at n=100k with a compaction, recovered from cuts right
    after its begin and its commit markers. Returns the launches of the
    recovered stream's search."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api.adapters import StreamSearcher
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.robust import read_records, recover, verify_dir
    label = "durable-stream-1M"
    k = SEARCH["k"]
    cfg = RuntimeConfig(**{key: v for key, v in SEARCH.items() if key != "k"},
                        k=k)

    def result(stream, q):
        return stream.search(q, k=k, runtime=cfg)

    wd = os.path.join(tmp, "wal-1m")
    live = StreamSearcher(stream_from_index(pm1m), cfg)
    t0 = time.perf_counter()
    live.enable_wal(wd)
    save_s = time.perf_counter() - t0
    snap = os.path.join(wd, "snapshot")
    t0 = time.perf_counter()
    require(verify_dir(snap), f"[{label}] the snapshot has no manifest")
    verify_s = time.perf_counter() - t0
    log(f"[{label}] enable_wal: snapshot save {save_s:.2f} s, "
        f"{api.saved_bytes(snap)} bytes, verify {verify_s:.2f} s")

    # phase 5's state-B writes
    n = pm1m.meta.n
    n_ins = -(-n // 9)
    rows = corpus_rows(n_ins, seed=3)
    rng = np.random.RandomState(5)
    base_ids = rng.choice(n, 2_000, replace=False)
    upd = corpus_rows(1_000, seed=4)
    delta_del = rng.choice(np.arange(n, n + n_ins), 1_112, replace=False)
    ops = [("insert", np.arange(n, n + n_ins), rows),
           ("delete", base_ids[:1_000]),
           ("update", base_ids[1_000:], upd),
           ("delete", delta_del)]
    n_rows = n_ins + 1_000 + 1_000 + 1_112

    def apply(target, op):
        getattr(target, op[0])(*op[1:])

    def timed_writes(target, before_last=None):
        total = 0.0
        for i, op in enumerate(ops):
            if i == len(ops) - 1 and before_last is not None:
                before_last()
            t0 = time.perf_counter()
            apply(target, op)
            total += time.perf_counter() - t0
        return total

    torn_want = []
    wal_s = timed_writes(live, lambda: torn_want.append(result(live.inner,
                                                               q1m)))
    shadow = stream_from_index(pm1m)
    plain_s = timed_writes(shadow)
    want, launches = counted(lambda: result(live.inner, q1m))
    require_launched(label, launches, ("quick_probe_select", "block_mips",
                                       "sketch_scores", "mips_score"))
    require(_same_bits(result(shadow, q1m), want),
            f"[{label}] the logged stream's search differs from the same "
            "writes without a log")
    del shadow
    wal_path = os.path.join(wd, "wal.log")
    recs, good, clean = read_records(wal_path)
    require(clean and good == os.path.getsize(wal_path),
            f"[{label}] the live log does not end on a record")
    log(f"[{label}] {n_rows} rows written in {len(ops)} calls: with the WAL "
        f"{wal_s:.3f} s ({n_rows / wal_s:.0f} rows/s), without "
        f"{plain_s:.3f} s ({n_rows / plain_s:.0f} rows/s); log "
        f"{os.path.getsize(wal_path)} bytes, {len(recs)} records "
        f"{[r.op for r in recs]}; wal_lag {live.wal_lag()}")

    # -- recovery from the full log and from a torn last record
    blob, offs = _wal_boundaries(wal_path)
    cases = (("full log", wd, want),
             ("torn last record", _cut_copy(
                 wd, os.path.join(tmp, "torn"), (offs[-2] + offs[-1]) // 2),
              torn_want[0]))
    for name, directory, expect in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = recover(directory, attach=False, device=DEVICE)
        rec_s = time.perf_counter() - t0
        got = result(rec.inner, q1m)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        require(_same_bits(got, expect),
                f"[{label}] recovery from the {name} differs from the live "
                "stream (ids, scores or a stats field)")
        log(f"[{label}] recover() from the {name}: {rec_s:.2f} s (snapshot "
            f"load, verify and replay of {rec.inner._wal_seq} records), "
            f"{first_s:.2f} s to the first answered search; equal bit for "
            f"bit to the live stream"
            f"{' before its last record' if 'torn' in name else ''}")
        del rec
    gc.collect()
    torch.cuda.empty_cache()

    # -- n=100k: cuts right after a compaction's begin and commit markers
    label = "durable-stream-100k"
    wd = os.path.join(tmp, "wal-100k")
    live = StreamSearcher(stream_from_index(pm100k), cfg)
    live.enable_wal(wd)
    shadow = stream_from_index(pm100k)
    n = pm100k.meta.n
    ops = [("insert", np.arange(n, n + 2_000), corpus_rows(2_000, seed=7)),
           ("delete", np.arange(0, n, n // 100)),
           ("compact",),
           ("insert", np.arange(n + 2_000, n + 2_500),
            corpus_rows(500, seed=8)),
           ("delete", np.arange(n, n + 2_000, 100))]
    shadow_at = {}
    t0 = time.perf_counter()
    for i, op in enumerate(ops):
        apply(live, op)
        apply(shadow, op)
        if i == 1:
            shadow_at["compact_begin"] = result(shadow, q100k)
        elif i == 2:
            shadow_at["compact_commit"] = result(shadow, q100k)
    log(f"[{label}] {len(ops)} ops on a logged stream and on a shadow "
        f"without a log, one compact() each: {time.perf_counter() - t0:.1f} s")
    wal_path = os.path.join(wd, "wal.log")
    recs, _, _ = read_records(wal_path)
    _, offs = _wal_boundaries(wal_path)
    for marker, want in shadow_at.items():
        cut = [r.op for r in recs].index(marker) + 1
        directory = _cut_copy(wd, os.path.join(tmp, marker), offs[cut])
        t0 = time.perf_counter()
        rec = recover(directory, attach=False, device=DEVICE)
        rec_s = time.perf_counter() - t0
        require(_same_bits(result(rec.inner, q100k), want),
                f"[{label}] recovery cut after {marker} differs from the "
                "shadow stream at that point")
        log(f"[{label}] cut after record {cut} ({marker}): recover() "
            f"{rec_s:.2f} s, equal bit for bit to the shadow stream")
    require(_same_bits(result(live.inner, q100k), result(shadow, q100k)),
            f"[{label}] the logged stream differs from its shadow at the end")
    return launches


# ---------------------------------------------------------------- phase 10

# the tuner's workload at the LARGE_N point: the CLI's build defaults (=
# BUILD) and search options, with the main path's prefilter
TUNE_SEARCH = dict(k=10, norm_adaptive=True, cs_prune=True, prefilter=True,
                   prefilter_eps=0.1)


def phase_tuner(pm, q):
    """Phase 10: `tune.search.tune_point` at the LARGE_N point on the card
    (`make_cutout(100_000, 128, 64)` is the n=100k index ``pm`` and its
    queries ``q``, the same rows, seeds and build), writing into a temporary
    copy of the committed cache; the cache-driven search against the
    explicit one; then the CLI in a subprocess. Returns the tuner's
    launches."""
    import numpy as np
    import torch
    from repro_torch.tune import cache, cutout, space
    from repro_torch.tune import search as tsearch
    label = "tuner"
    tmp = tempfile.mkdtemp(prefix="tune-", dir=os.path.join(ROOT, "build"))
    saved_env = os.environ.get(cache.ENV_VAR)
    try:
        path = os.path.join(tmp, "tuning.json")
        shutil.copyfile(os.path.join(ROOT, "results", "tune", "tuning.json"),
                        path)
        with open(path) as f:
            before_text = f.read()
        before = json.loads(before_text)["entries"]
        x, qc = cutout.make_cutout(100_000, 128, N_QUERIES)
        require(np.array_equal(qc, q.cpu().numpy()),
                f"[{label}] the cutout's queries are not the n=100k cell's")
        t0 = time.perf_counter()
        entry, launches = counted(lambda: tsearch.tune_point(
            x, qc, build_opts=dict(BUILD), search_opts=dict(TUNE_SEARCH),
            device=DEVICE, budget_s=90.0, reps=5, include_build=False,
            stages=True, roofline=True, write=True, path=path,
            progress=lambda msg: log(f"[{label}] {msg}")))
        tune_s = time.perf_counter() - t0
        require_launched(label, launches, ("block_mips", "sketch_scores",
                                           "quick_probe_select"))
        trace = entry["trace"]
        for rec in trace["candidates"]:
            status = rec.get("status")
            require(status and not status.startswith("error"),
                    f"[{label}] candidate {rec} has no status or failed")
            if "ratio_incumbent_over_candidate" in rec:
                log(f"[{label}] {rec['knob']}={rec['value']!r}: incumbent/"
                    f"candidate x{rec['ratio_incumbent_over_candidate']:.4f} "
                    f"({rec['incumbent_us_per_query']:.3f} vs "
                    f"{rec['candidate_us_per_query']:.3f} us a query), parity "
                    f"kept, {status}; search bound {rec['roofline_s'] * 1e6:.3f}"
                    f" us ({rec['bound']}), roofline_frac "
                    f"{rec['roofline_frac']:.4f}")
            else:
                log(f"[{label}] {rec.get('knob')}={rec.get('value')!r}: "
                    f"{status}")
        summary = trace["summary"]
        best = entry["runtime"]
        log(f"[{label}] tune_point {tune_s:.1f} s (budget 90 s; "
            f"{summary['n_candidates']} candidates measured): tuned {best}, "
            f"build {entry['build']}; tuned x"
            f"{summary['speedup_tuned_vs_default']:.4f} vs hand-picked "
            f"({summary['best_us_per_query']:.3f} vs "
            f"{summary['baseline_us_per_query']:.3f} us a query); launches "
            f"{launches}")
        for stage, rec in trace["stages_best"].items():
            if stage == "_tile":
                log(f"[{label}] stage cutout: round-1 tile {rec}")
                continue
            log(f"[{label}] stage {stage}: {rec['us']:.3f} us, bound "
                f"{rec['roofline_s'] * 1e6:.4f} us ({rec['bound']}; "
                f"{rec['flops']:.4g} flops, {rec['bytes']:.4g} bytes), "
                f"roofline_frac {rec['roofline_frac']:.4f}")

        # -- the written key names the card and torch; the JAX entry stays
        key = space.shape_key(100_000, 128, DEVICE)
        require(entry["key"] == key
                and f"cuda-{torch.cuda.get_device_name(0)}" in key
                and key.endswith(f":torch{torch.__version__}"),
                f"[{label}] written key {entry.get('key')!r} does not name the "
                f"card and torch")
        with open(path) as f:
            after = json.load(f)
        require(set(after["entries"]) == set(before) | {key},
                f"[{label}] the cache's keys are {sorted(after['entries'])}")
        written = after["entries"].pop(key)
        require(json.dumps(after, indent=1, sort_keys=True) + "\n"
                == before_text,
                f"[{label}] the JAX entries changed as text")
        log(f"[{label}] wrote {key!r} (platform {written['key']['platform']!r}"
            f", torch {written['key']['torch_version']}); the JAX entries "
            f"{sorted(before)} unchanged as text")

        # -- the runtime reads it: knobs left None = the tuned knobs
        # passed explicitly; the tuned search = the hand-picked one; no
        # cache = the explicit hand-picked search
        baseline = dict(space.HAND_PICKED["runtime"],
                        prefilter_eps=TUNE_SEARCH["prefilter_eps"])
        tuned_fn = tsearch._search_fn(pm, q, TUNE_SEARCH, best)
        hand_fn = tsearch._search_fn(pm, q, TUNE_SEARCH, baseline)
        os.environ[cache.ENV_VAR] = path
        cache.clear_memo()
        from_cache = pm.search(q, **TUNE_SEARCH)
        explicit = pm.search(q, **TUNE_SEARCH, dense_frac=best["dense_frac"],
                             tile_cap=(pm.meta.n_blocks if best["tile_cap"]
                                       is None else best["tile_cap"]))
        require(_same_bits(from_cache, explicit),
                f"[{label}] the cache-driven search differs from the explicit "
                f"tuned one")
        tuned, hand = tuned_fn(), hand_fn()
        require(torch.equal(tuned[0], hand[0]) and torch.equal(tuned[1],
                                                               hand[1]),
                f"[{label}] the tuned search differs from the hand-picked one "
                f"in ids or scores")
        os.environ[cache.ENV_VAR] = ""
        cache.clear_memo()
        require(_same_bits(pm.search(q, **TUNE_SEARCH), hand),
                f"[{label}] with the cache off, the search differs from the "
                f"explicit hand-picked one")
        turns = []
        for name, fn in (("hand-picked", hand_fn), ("tuned", tuned_fn),
                         ("tuned", tuned_fn), ("hand-picked", hand_fn)):
            med, times = time_batches(lambda qb, f=fn: f())
            turns.append(f"{name} {med:.3f} ms ({min(times):.3f}-"
                         f"{max(times):.3f})")
        log(f"[{label}] cache-driven = explicit tuned search bit for bit (ids, "
            f"scores, every stats field); tuned = hand-picked in ids and "
            f"scores; cache off = explicit hand-picked bit for bit. Medians "
            f"of 5 batches of {N_QUERIES} in turns: {'; '.join(turns)}")

        # -- the CLI, as a user runs it
        out = os.path.join(tmp, "cli.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--n", "20000",
             "--prefilter", "--budget-s", "20", "--out", out],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
            text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0,
                f"[{label}] python -m repro_torch.tune exited "
                f"{proc.returncode}: {proc.stderr[-2000:]}")
        cli_key = space.shape_key(20_000, 128, DEVICE)
        with open(out) as f:
            cli_entry = json.load(f)["entries"].get(cli_key)
        require(cli_entry is not None and not any(
            r["status"].startswith("error")
            for r in cli_entry["trace"]["candidates"]),
            f"[{label}] the CLI did not write {cli_key!r} cleanly")
        log(f"[{label}] python -m repro_torch.tune --n 20000 --prefilter "
            f"--budget-s 20 --out <tmp>: exit 0 in {cli_s:.1f} s, wrote "
            f"{cli_key!r}: runtime {cli_entry['runtime']}")
    finally:
        if saved_env is None:
            os.environ.pop(cache.ENV_VAR, None)
        else:
            os.environ[cache.ENV_VAR] = saved_env
        cache.clear_memo()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------- phase 11

# the paper's four proxies (Table III): full size, but SIFT at its scaled
# 200,000 rows (the n=1M SIFT-shaped index runs in phase 4)
DATASET_CELLS = (("netflix", False), ("yahoo", False), ("p53", False),
                 ("sift", True))
QUICKSTART = dict(c=0.9, p0=0.5, k=10, m=6)


def phase_datasets():
    """Phase 11: each dataset proxy through `api.build(backend="promips")`
    with the quickstart's guarantee and the main path's knobs, searched on
    the kernels and on the plain path (ids equal, scores within REL / ABS,
    flips reported), the progressive mode, quality against an exact top-k;
    then `examples/quickstart_torch.py` in a subprocess. Returns the
    launches of each dataset's search."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import search_device as sd
    from repro_torch.core import search_graph
    from repro_torch.core.metrics import overall_ratio
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.runtime import search as _runtime_search
    from repro_torch.data.synthetic import paper_dataset, paper_queries
    k = QUICKSTART["k"]

    def runtime_search(arrays, meta, q, cfg):
        return _runtime_search(arrays, meta, q, cfg, device=DEVICE)

    cfg = RuntimeConfig(**{key: v for key, v in SEARCH.items() if key != "k"},
                        k=k)
    guarantee = api.GuaranteeConfig(c=QUICKSTART["c"], p0=QUICKSTART["p0"],
                                    k=k)
    p0 = guarantee.p0
    floor = p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / N_QUERIES)
    all_launches = {}
    for name, scaled in DATASET_CELLS:
        label = f"dataset {name}"
        t0 = time.perf_counter()
        x = paper_dataset(name, scaled=scaled)
        qn = paper_queries(name, N_QUERIES)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s = api.build(x, backend="promips", guarantee=guarantee, seed=0,
                      m=QUICKSTART["m"], prefilter=True,
                      prefilter_eps=SEARCH["prefilter_eps"], device=DEVICE)
        build_s = time.perf_counter() - t0
        pm = s.pm
        meta = pm.meta
        xt = torch.from_numpy(x).cuda()
        q = torch.from_numpy(qn).cuda()
        del x
        log(f"[{label}] {tuple(xt.shape)} ({'scaled' if scaled else 'full'}),"
            f" made in {gen_s:.1f} s; api.build(backend='promips', m 6, c 0.9,"
            f" p0 0.5) {build_s:.1f} s on the host: NB {meta.n_blocks} G "
            f"{meta.n_groups} S {meta.n_subparts} page_rows {meta.page_rows} "
            f"sketch M {meta.sk_subspaces} K {meta.sk_codewords}")

        # -- the kernels, counted, with the peak memory
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (ids, scores, st), launches = counted(
            lambda: runtime_search(pm.arrays, meta, q, cfg))
        peak = torch.cuda.max_memory_allocated()
        require_launched(label, launches, ("block_mips", "sketch_scores",
                                           "quick_probe_select"))
        require(ids.shape == (N_QUERIES, k)
                and bool(torch.isfinite(scores).all()),
                f"[{label}] output has the wrong shape or non-finite scores")
        facade = s.search(qn, runtime=cfg)
        require(np.array_equal(facade.ids, ids.cpu().numpy()),
                f"[{label}] the facade's ids differ from the runtime's")

        # -- the plain path on the card: ids equal, scores within REL / ABS
        ids_p, scores_p, st_p = runtime_search(
            pm.arrays, meta, q, dataclasses.replace(cfg, use_kernels=False))
        mask0 = sd.select_frontend(pm.arrays, meta, q)[-1]
        est_bnd = sd.prefilter_round1(pm.arrays, q, mask0, k, meta.page_rows,
                                      SEARCH["prefilter_eps"], False)
        flips, sk_err = prefilter_flips(pm.arrays, q, mask0, est_bnd, k)
        probe, lb_err = probe_flips(pm.arrays, meta, q)
        row_of_id = torch.full((xt.shape[0],), -1, dtype=torch.long)
        live = (pm.arrays.ids >= 0).cpu()
        row_of_id[pm.arrays.ids.cpu()[live].long()] = live.nonzero().flatten()
        differ, notes, pages_diff = compare_paths(
            q, ids, st, ids_p, st_p, flips,
            lambda i: xt[i.clamp(min=0).long()],
            lambda r: int(row_of_id[r]) // meta.page_rows, probe)
        require(torch.equal(ids, ids_p),
                f"[{label}] ids differ between kernels and plain path: "
                f"{notes}")
        tol = (REL * xt[ids.clamp(min=0).long()].double().norm(dim=-1)
               * q.double().norm(dim=-1)[:, None] + ABS)
        err = (scores.double() - scores_p.double()).abs()
        require(bool((err <= tol).all()),
                f"[{label}] scores beyond REL/ABS by {float((err - tol).max())}")
        log(f"[{label}] kernel vs plain path: ids equal; max|d score| "
            f"{float(err.max()):.3g}; {pages_diff} queries differ in pages; "
            f"sketch max|d| {sk_err:.3g}, binary_probe_lb max|d| {lb_err:.3g}; "
            f"prefilter cut flips {flips if flips else 'none'}; Quick-Probe "
            f"flips {probe if probe else 'none'}")

        # -- quality against the exact top-k
        eids, escores = exact_topk(xt, q, k)
        recall = sum(len(set(ids[b].tolist()) & set(eids[b].tolist())) / k
                     for b in range(N_QUERIES)) / N_QUERIES
        ratio = float(np.mean([overall_ratio(a, e) for a, e in zip(
            scores.cpu().numpy(), escores.cpu().numpy())]))
        rate = success_rate(scores, escores, guarantee.c)
        require(rate >= floor, f"[{label}] Theorem-2 floor missed: {rate} < "
                               f"{floor}")
        med, times = time_batches(
            lambda qb: runtime_search(pm.arrays, meta, qb, cfg),
            queries=lambda seed: paper_queries(name, N_QUERIES, seed=seed))

        # -- the progressive mode: full budget on the kernels, and against
        # the plain walk at budget 256 (the plain walk at full budget takes
        # minutes)
        prog = RuntimeConfig(k=k, mode="progressive", cs_prune=True)
        (ids_g, scores_g, st_g), l_prog = counted(
            lambda: runtime_search(pm.arrays, meta, q, prog))
        require_launched(f"{label} progressive", l_prog, ("scan_blocks",))
        prog256 = dataclasses.replace(prog, budget=256)
        got = runtime_search(pm.arrays, meta, q, prog256)
        want = runtime_search(pm.arrays, meta, q,
                              dataclasses.replace(prog256, use_kernels=False))
        require(torch.equal(got[0], want[0])
                and torch.equal(got[2].pages, want[2].pages),
                f"[{label}] progressive at budget 256: kernels and plain "
                f"path differ")
        recall_g = sum(len(set(ids_g[b].tolist()) & set(eids[b].tolist())) / k
                       for b in range(N_QUERIES)) / N_QUERIES
        med_g, times_g = time_batches(
            lambda qb: runtime_search(pm.arrays, meta, qb, prog), n_batches=3,
            queries=lambda seed: paper_queries(name, N_QUERIES, seed=seed))
        log(f"[{label}] fused: recall@10 {recall:.4f}, overall ratio "
            f"{ratio:.4f}, theorem-2 share {rate:.4f} (floor {floor:.4f}), "
            f"pages a query {float(st.pages.double().mean()):.2f} of "
            f"{meta.n_blocks}, exhausted {int(st.exhausted.sum())}; median "
            f"batch {med:.3f} ms (range {min(times):.3f}-{max(times):.3f}); "
            f"launches {launches}; peak memory {peak / 2**20:.1f} MiB "
            f"({resident / 2**20:.1f} MiB before the search)")
        log(f"[{label}] progressive (full budget, Cauchy-Schwarz): recall@10 "
            f"{recall_g:.4f}, pages a query "
            f"{float(st_g.pages.double().mean()):.2f}, median batch "
            f"{med_g:.3f} ms (range {min(times_g):.3f}-{max(times_g):.3f}), "
            f"launches {l_prog}; at budget 256 kernels = plain path in ids "
            f"and pages")
        all_launches[name] = launches
        del s, pm, xt, q
        search_graph.clear_graphs()
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", "quickstart_torch.py")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    require(proc.returncode == 0 and "bit-identical=True" in proc.stdout,
            f"examples/quickstart_torch.py exited {proc.returncode}: "
            f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    for line in proc.stdout.strip().splitlines():
        log(f"[quickstart_torch] {line}")
    log(f"[quickstart_torch] exit 0 in {time.perf_counter() - t0:.1f} s")
    return all_launches


# ---------------------------------------------------------------- phase 12

# 12a: the four dense configs, reduced; 48 tokens (h2o-danube's reduced
# window is 32), microbatches 2, remat full / dots, compression on qwen3
TRAIN_PARITY = (("tinyllama-1.1b", "full", False), ("phi4-mini-3.8b", "dots", False),
                ("qwen3-32b", "dots", True), ("h2o-danube-3-4b", "full", False))
# 12b: launch.train.main at tinyllama-1.1b's full width
TRAIN_FULL = ["--arch", "tinyllama-1.1b", "--batch", "8", "--seq", "256",
              "--microbatches", "2", "--steps", "8", "--ckpt-every", "4",
              "--log-every", "1"]
# card = CPU: losses, grad norms, lrs and every leaf within the tolerance of
# `train.parity` (GRAD_TOL, relative to each leaf's largest; the parameters
# beyond Adam's allowance; compression's flips within FLIP_MARGIN)


def _cpu_to_card(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.map(lambda t: t.to(DEVICE), tree)


def phase_train_parity(card):
    """Phase 12a: three `make_train_step` steps of each reduced dense config
    on the card and on `device="cpu"` from one set of parameters (made on
    the CPU, copied to the card), TF32 off (PyTorch's default, set again in
    phase 1). Without compression both run free; with it each card step
    starts from the CPU state (an int8 flip moves a parameter by up to a
    step, and the difference would grow), flips counted with margins."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.train import loop, parity
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 is on for matmuls: card = CPU needs full f32")
    log(f"[train parity] TF32 for matmuls: "
        f"{torch.backends.cuda.matmul.allow_tf32} (PyTorch's default)")
    tol = parity.GRAD_TOL
    for name, remat, compress in TRAIN_PARITY:
        cfg = get_config(name).reduced()
        tcfg = loop.TrainCfg(lr=1e-3, warmup=2, total_steps=20, microbatches=2,
                             remat=remat, compress_grads=compress)
        cpu = loop.init_state(T.init_params(cfg, seed=0, device="cpu"), tcfg)
        gpu = _cpu_to_card(cpu)
        step = loop.make_train_step(cfg, tcfg)
        stream = TokenStream(vocab=cfg.vocab, batch=4, seq=48, seed=1)
        allowance = None
        for i in range(3):
            batch = stream.batch_at(i)
            if compress:
                gpu = _cpu_to_card(cpu)
            gpu, gm = step(gpu, batch)
            cpu, cm = step(cpu, batch)
            errs = {k: parity.rel(gm[k], cm[k]) for k in ("loss", "grad_norm", "lr")}
            allowance = parity.adam_allowance(allowance, cpu, float(cm["lr"]))
            r = parity.compare_states(gpu, cpu, allowance=allowance)
            log(f"[train parity {name}] step {i} ({remat}, microbatches 2"
                f"{', compressed' if compress else ''}): loss {float(gm['loss']):.6f}; "
                f"max rel diff loss {errs['loss']:.3e} grad_norm "
                f"{errs['grad_norm']:.3e} lr {errs['lr']:.3e} params "
                f"{r['params']:.3e} mu {r['mu']:.3e} nu {r['nu']:.3e}"
                + (f" ef {r['ef']:.3e}" if compress else "")
                + f"; Adam allowance used by {r['allowed']} elements; flips "
                f"{r['flips']} (largest margin {r['flip_margin']:.3e}); worst "
                f"{r['worst']} (on {card})")
            for key in ("loss", "grad_norm", "lr", "params", "mu", "nu", "ef"):
                got = errs.get(key, r.get(key, 0.0))
                require(got <= tol, f"[train parity {name}] step {i}: {key} "
                        f"differs by {got:.3e} > {tol:.0e} between card and CPU")
            require(r["flip_margin"] <= parity.FLIP_MARGIN,
                    f"[train parity {name}] step {i}: a flip {r['flip_margin']:.3e} "
                    f"from its rounding boundary > {parity.FLIP_MARGIN:.2e}")


def _timed_train_main(argv, times, ckpts, restores):
    """`launch.train.main(argv)` with each step timed (host clock to a
    synchronize), each checkpoint's host copy and write timed and sized,
    and each restore timed."""
    import torch
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.launch import train as launch_train
    make_step, save, restore = (launch_train.make_train_step, ckpt_lib.save,
                                ckpt_lib.restore)

    def timed_make(*a, **kw):
        fn = make_step(*a, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out
        return run

    def timed_save(ckpt_dir, step, tree, *, blocking=True):
        import threading
        t0 = time.perf_counter()
        writer = save(ckpt_dir, step, tree, blocking=False)
        rec = dict(step=step, copy_s=time.perf_counter() - t0)

        def finish():
            writer.join()
            rec["write_s"] = time.perf_counter() - t0
            path = os.path.join(ckpt_dir, f"step_{step}")
            rec["bytes"] = sum(os.path.getsize(os.path.join(path, f))
                               for f in os.listdir(path))
            ckpts.append(rec)
        done = threading.Thread(target=finish)
        done.start()
        if blocking:
            done.join()
            return None
        return done

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return out

    launch_train.make_train_step = timed_make
    ckpt_lib.save, ckpt_lib.restore = timed_save, timed_restore
    try:
        return launch_train.main(argv)
    finally:
        launch_train.make_train_step = make_step
        ckpt_lib.save, ckpt_lib.restore = save, restore


def train_gemm_flops(cfg, tokens):
    """The 2-D matmul FLOPs of one train step under remat full: the
    forward, the backward (twice the forward) and the recompute of each
    layer's GEMMs but ``w_down`` (whose output the backward never reads)."""
    d, ff, dh = cfg.d_model, cfg.d_ff, cfg.head_dim_
    layer = 2 * (2 * d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh
                 + 3 * d * ff)
    fwd = tokens * (cfg.n_layers * layer + 2 * d * cfg.vocab_padded)
    return 3 * fwd + tokens * cfg.n_layers * (layer - 2 * ff * d)


def _train_profile(cfg, state, batch, card):
    """One donated train step under torch.profiler: device time by aten op
    (the GEMMs ``aten::mm``, the attention einsums ``aten::bmm``, the
    embedding backward), the AdamW update (a ``record_function`` range
    around `adamw_update`) and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.train import loop
    update = loop.adamw_update

    def ranged(*a, **kw):
        with record_function("adamw_update"):
            return update(*a, **kw)

    loop.adamw_update = ranged
    try:
        tcfg = loop.TrainCfg(lr=3e-4, warmup=10, total_steps=8, microbatches=2)
        step = loop.make_train_step(cfg, tcfg, donate=True)
        state, _ = step(state, batch)            # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        loop.adamw_update = update
    by_kernel = {}
    for e in prof.events():
        # the range's own span on the device timeline is no kernel
        if e.device_type != DeviceType.CUDA or e.name == "adamw_update":
            continue
        name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
        name = name[5:] if name.startswith("void ") else name
        total, count = by_kernel.get(name[:70], (0.0, 0))
        by_kernel[name[:70]] = (total + e.time_range.end - e.time_range.start,
                                count + 1)
    busy_ms = sum(t for t, _ in by_kernel.values()) / 1e3
    if busy_ms == 0:
        log("[train profile] device time not measured: the trace holds no "
            "CUDA events")
        return state
    ops = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = ev.cuda_time_total
        ops[ev.key] = (dev / 1e3, ev.count)
    log(f"[train profile] one step of tinyllama-1.1b at full width (batch 8 x "
        f"256 tokens, microbatches 2, remat full): wall {wall_ms:.3f} ms under "
        f"the profiler, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f} (on {card})")
    for key, label in (("aten::mm", "GEMMs (aten::mm)"),
                       ("aten::bmm", "attention einsums (aten::bmm)"),
                       ("adamw_update", "optimizer (adamw_update range)"),
                       ("aten::embedding_dense_backward", "embedding backward"),
                       ("aten::embedding_backward", "embedding backward (outer)")):
        t, c = ops.get(key, (0.0, 0))
        log(f"[train profile]   {t:9.3f} ms  x{c:<5d} {label} "
            f"({100 * t / busy_ms:.1f}% of busy)")
    for name, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[train profile]   kernel {t / 1e3:9.3f} ms  x{c:<5d} {name}")
    from repro_torch.launch.roofline import PEAK_FP32
    flops = train_gemm_flops(cfg, batch["tokens"].size)
    mm_ms = ops.get("aten::mm", (0.0, 0))[0]
    if mm_ms:
        log(f"[train profile] GEMM FLOPs {flops:.4e} (analytic): "
            f"{flops / mm_ms / 1e9:.2f} TFLOP/s in aten::mm, "
            f"{flops / mm_ms / 1e9 / (PEAK_FP32 / 1e12):.3f} of the f32 peak "
            f"{PEAK_FP32 / 1e12:.0f} TFLOP/s; their least time "
            f"{1e3 * flops / PEAK_FP32:.3f} ms (operations) against the "
            f"step's device busy {busy_ms:.3f} ms (on {card})")
    return state


def phase_train_full(card, tmp):
    """Phase 12b: `launch.train.main` at tinyllama-1.1b's full width (22
    layers, d 2048, 32 heads, 4 KV heads, d_ff 5632, vocab 32,000): 8 steps
    of batch 8 x 256 tokens in 2 microbatches, checkpoints every 4 steps
    under the gitignored build/. The loss falls; step_4 and step_8 are
    complete; a second run from step_4 (step_8 removed) reproduces steps
    4-7's losses bit for bit, or within 1e-5 relative with the leaves of
    two identical steps that differ named. Then two identical steps from
    one state (embedding backward and GEMMs deterministic?) and a profile."""
    import gc
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed import checkpoint as ckpt_lib
    from repro_torch.models import transformer as T
    from repro_torch.train import loop, parity
    cfg = get_config("tinyllama-1.1b")
    ckpt = os.path.join(tmp, "ckpt")
    free = shutil.disk_usage(tmp).free
    state_bytes = 3 * 4 * cfg.param_count()
    log(f"[train] {cfg.name}: {cfg.param_count():,} parameters, train state "
        f"{state_bytes / 1e9:.2f} GB in f32; {free / 1e9:.1f} GB free on the "
        f"checkpoint disk")
    require(free > 2.2 * state_bytes, "not enough disk for two checkpoints")
    torch.cuda.reset_peak_memory_stats()
    times, ckpts, restores = [], [], []
    t0 = time.perf_counter()
    argv = TRAIN_FULL + ["--device", DEVICE, "--ckpt-dir", ckpt]
    losses = _timed_train_main(argv, times, ckpts,
                               restores)
    run1_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    med = sorted(times)[len(times) // 2]
    tokens = 8 * 256
    log(f"[train] run 1: {len(losses)} steps in {run1_s:.1f} s; losses "
        f"{[round(x, 6) for x in losses]}; step times "
        f"{[round(x, 4) for x in times]} s; median {med:.4f} s = "
        f"{tokens / med:,.0f} tokens/s; first step {times[0]:.4f} s; peak "
        f"memory {peak / 2**30:.2f} GiB (max_memory_allocated) (on {card})")
    for rec in ckpts:
        log(f"[train] checkpoint step_{rec['step']}: {rec['bytes']:,} bytes, "
            f"host copy {rec['copy_s']:.2f} s, written in {rec['write_s']:.2f} "
            f"s ({rec['bytes'] / rec['write_s'] / 1e9:.2f} GB/s) (on {card})")
    require(len(losses) == 8 and all(math.isfinite(x) for x in losses),
            f"run 1 losses {losses}")
    require(losses[-1] < losses[0], f"the loss does not fall: {losses}")
    require(ckpt_lib.latest_step(ckpt) == 8, "step_8 is not the latest step")
    for step in (4, 8):
        require(os.path.exists(os.path.join(ckpt, f"step_{step}", ".complete")),
                f"step_{step} is not complete")
    shutil.rmtree(os.path.join(ckpt, "step_8"))
    gc.collect()
    torch.cuda.empty_cache()
    times2, ckpts2 = [], []
    t0 = time.perf_counter()
    resumed = _timed_train_main(argv, times2,
                                ckpts2, restores)
    log(f"[train] run 2 from step_4: {len(resumed)} steps in "
        f"{time.perf_counter() - t0:.1f} s; restore {restores[-1]:.2f} s; "
        f"losses {[round(x, 6) for x in resumed]} (on {card})")
    require(len(resumed) == 4, f"the resumed run ran {len(resumed)} steps")
    exact = resumed == losses[4:]
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[4:]))
    log(f"[train] resumed steps 4-7 = run 1's: bit for bit {exact}, largest "
        f"relative gap {gap:.3e}")
    require(ckpt_lib.latest_step(ckpt) == 8, "run 2 did not write step_8")
    shutil.rmtree(ckpt)
    gc.collect()
    torch.cuda.empty_cache()

    # two identical steps from one state: what a rerun relies on
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    tcfg = loop.TrainCfg(lr=3e-4, warmup=10, total_steps=8, microbatches=2)
    state = loop.init_state(T.init_params(cfg, generator=gen, device=DEVICE), tcfg)
    batch = TokenStream(vocab=cfg.vocab, batch=8, seq=256).batch_at(0)
    step = loop.make_train_step(cfg, tcfg)
    a, ma = step(state, batch)
    b, mb = step(state, batch)
    names = parity.leaf_names(state.params)
    differ = [f"{part} {names[i % len(names)]}"
              for part, la, lb in (("params", a.params, b.params),
                                   ("mu", a.opt.mu, b.opt.mu),
                                   ("nu", a.opt.nu, b.opt.nu))
              for i, (x, y) in enumerate(zip(tree_lib.leaves(la), tree_lib.leaves(lb)))
              if not torch.equal(x, y)]
    same_loss = float(ma["loss"]) == float(mb["loss"])
    log(f"[train] two identical steps: loss equal {same_loss}, leaves that "
        f"differ: {differ or 'none'} (embed's gradient is F.embedding's "
        f"backward)")
    if not exact:
        require(gap <= 1e-5, f"resumed losses differ by {gap:.3e} > 1e-5")
        log(f"[train] the resume is not bit for bit; leaves of two identical "
            f"steps that differ: {differ}")
    del a, b
    gc.collect()
    state = _train_profile(cfg, state, batch, card)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_s=med, tokens_s=tokens / med, peak=peak, ckpts=ckpts)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t_start = time.perf_counter()

    card = phase_setup()
    timer = Timer(torch)
    log(f"[phase 1] {time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    pm1m, x1m, q1m = build_size(1_000_000)
    records = phase_kernels(pm1m, q1m, timer) + phase_kernels_serve(pm1m, q1m,
                                                                    timer)
    log(f"[phase 2] {time.perf_counter() - t0:.1f} s (with the n=1M build)")

    t0 = time.perf_counter()
    pm100k, x100k, q100k = build_size(100_000)
    phase_main_path("n=100k", pm100k, x100k, q100k)
    log(f"[n=100k] JAX CPU record (not the port's): pages_mean "
        f"{JAX_CPU_RECORD_100K['pages_mean']} pages_frac "
        f"{JAX_CPU_RECORD_100K['pages_frac']} recall {JAX_CPU_RECORD_100K['recall']}")
    log(f"[phase 3] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_compact_100k(pm100k, q100k)
    log(f"[phase 5, compact-100k] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = phase_main_path("n=1M", pm1m, x1m, q1m)
    time_turns("n=1M", lambda qb: pm1m.search(qb, **SEARCH), q1m)
    log(f"[phase 4] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scan_rec, mode_launches, topk_launches = phase_modes(pm1m, x1m, q1m,
                                                         x100k, q100k, timer)
    records.append(scan_rec)
    launches.update(mode_launches)
    log(f"[phase 4b] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stream_launches = phase_stream_1m(pm1m, q1m)
    from repro_torch.core import search_graph
    search_graph.clear_graphs()      # their pools hold the n=1M scratch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 5, stream-1M] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serve_launches = phase_serve()
    log(f"[phase 6] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sharded_launches = phase_sharded_1m(pm1m, x1m, q1m)
    del x1m
    search_graph.clear_graphs()
    log(f"[phase 7, sharded-1M] {time.perf_counter() - t0:.1f} s")
    # the snapshots and logs of phases 8-9, in the gitignored build/ dir
    tmp = tempfile.mkdtemp(prefix="durability-",
                           dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        sharded_stream_launches = phase_sharded_stream_100k(x100k, q100k, tmp)
        del x100k
        log(f"[phase 8, sharded-stream-100k] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        durable_launches = phase_durable_1m(pm1m, q1m, pm100k, q100k, tmp)
        log(f"[phase 9, durable-stream-1M] {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    tuner_launches = phase_tuner(pm100k, q100k)
    log(f"[phase 10, tuner] {time.perf_counter() - t0:.1f} s")
    del pm1m, q1m, pm100k, q100k
    search_graph.clear_graphs()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dataset_launches = phase_datasets()
    log(f"[phase 11, datasets] {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_train_parity(card)
    log(f"[phase 12a, train parity] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="train-", dir=os.path.join(ROOT, "build"))
    try:
        phase_train_full(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[phase 12b, train tinyllama-1.1b] {time.perf_counter() - t0:.1f} s")
    log("[launches] one search of each new path: sharded-1M "
        f"{sharded_launches}; sharded-stream-100k (churned) "
        f"{sharded_stream_launches}; durable-stream-1M (state B, logged) "
        f"{durable_launches}; the tuner's whole run {tuner_launches}; the "
        f"datasets' fused searches {dataset_launches}")

    # each kernel's count from the path whose shapes its record was timed
    # at: the static main path for block_mips, sketch_scores and
    # quick_probe_select, the stream for mips_score, the serve run for
    # binary_probe_lb (no path launches it since quick_probe_select took
    # its place in the frontend) and decode_attention
    launches["mips_score"] = stream_launches["mips_score"]
    for name in ("binary_probe_lb", "decode_attention"):
        launches[name] = serve_launches[name]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    # block_mips also serves ops.mips_topk (phase 4b), launched once there
    records[0]["mips_topk_launches"] = topk_launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mips_topk_launches")
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [{key: rec[key] for key in keys if key in rec}
                                  for rec in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
