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
     Every search of phases 3-5 also runs binary_probe_lb (the Quick-Probe
     group bounds of the frontend); each choice of group that differs
     between the kernel and the plain path is reported with its margin;
  6. the serve path (`serve.DecodeEngine`) at the full width of
     tinyllama-1.1b (22 layers, d_model 2048, 32 heads, 4 KV heads, vocab
     32,000 padded to 32,256), random f32 weights from a seeded generator,
     4 batch slots, max_len 512, 16 requests with prompts of 24 and 40
     tokens and 16 new tokens each: exact and ProMIPS logits, each on the
     kernels (decode_attention in every layer of every step; the vocab
     search's binary_probe_lb and mips_score) and on the plain versions,
     tokens held kernel against plain (each difference explained by a logit
     margin below LOGIT_TOL), the c-approximation of every searched row
     against the exact top-1 over the live vocab (the Theorem-2 floor), the
     hot-query cache (hits, tokens equal to a cache-off run), deletes and an
     update of vocab rows; step times, tokens/s, pages, launches per step,
     peak memory, and a torch.profiler trace of one decode step.
Phase 2 also holds binary_probe_lb (at the vocab index's and the n=1M
index's shapes) and decode_attention (at the serve shape and at the
decode_32k shape, B=8, S=32,768) against their plain versions, with the
same four times, and mips_score at the serve search's tile (R=32,000,
B=4, d=2,048). Two bit-for-bit checks fail the run if they do not hold:
mips_score's small-batch path against its tile path at the serve tile
(1% of the rows invalid, exactly -1e30), and sketch_scores against the
ordered LUT sum `ref.sketch_scores_lut_ref` at n=1M, at both of the
kernel's query-group sizes there (8 for the batch of 64, 4 for its first
4 queries). The B sweep of mips_score (B = 1..64 at the serve tile and at
the stream delta's shape, the small path, the tile path and torch.matmul +
masked_fill_ in turns) prints one line per shape; its crossover sets the
kernel's B_SMALL.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
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


def block_mips_bound_ms(args, k, page_rows):
    """Least time for one round: bytes (selected pages, flags, queries,
    carried and written top-k, cnt) over HBM rate vs fp32 operations (every
    selected (query, page) pair scored once) over the fp32 rate."""
    x, valid, q, slots, sel, init_s, init_r, c_half = args
    b, d = q.shape
    n_slots = slots.shape[0]
    pages_read = int(sel.any(dim=0).sum())
    nbytes = (pages_read * page_rows * (d * 4 + 1) + b * d * 4 + n_slots * 4
              + b * n_slots + 2 * b * k * 8 + b * 4 + b * n_slots * 4 + b * 8)
    ops = 2.0 * d * page_rows * float(sel.sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mips_score_bound_ms(x, q):
    """Rows read once, scores written once, over the HBM rate, against
    2 R B d fp32 operations over the fp32 rate."""
    r, d = x.shape
    b = q.shape[0]
    nbytes = r * d * 4 + b * d * 4 + r + r * b * 4
    ops = 2.0 * r * b * d
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sketch_bound_ms(q, codebooks, codes):
    b, d = q.shape
    m, kcw, sub_d = codebooks.shape
    nb = codes.shape[0]
    nbytes = nb * m * 4 + m * kcw * sub_d * 4 + b * d * 4 + b * nb * 4
    ops = 2.0 * b * m * kcw * sub_d + float(b) * nb * m
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def binary_probe_bound_ms(b, g, m):
    """Codes (int64), query codes and projections read once, bounds
    written once, against one multiply-add per bit and the scale."""
    nbytes = g * 8 + b * 8 + b * m * 4 + b * g * 4
    ops = float(b) * g * (2 * m + 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def decode_attention_bound_ms(q, k, cache_len):
    """The cache rows each sequence needs (cache_len of them, all S when it
    is 0) read once for K and V, q read and the output written once, against
    2 dh operations for the score and 2 dh for P.V per (position, query
    row)."""
    b, kh, g, dh = q.shape
    s = k.shape[1]
    n = cache_len.clamp(max=s)
    rows = int(n.masked_fill(n <= 0, s).sum())
    nbytes = 2 * rows * kh * dh * 4 + 2 * q.numel() * 4 + b * 4
    ops = float(rows) * kh * g * 4 * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def check_decode_attention(timer, label, b, s, lens, seed, kh=4, g=8, dh=64):
    """decode_attention against its plain version on seeded normal inputs
    (|d| <= 1e-5 max|v| + 1e-6), timed, with scaled_dot_product_attention
    (length mask, enable_gqa) as the library yardstick. Returns the kernel
    line's record."""
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
    want = ops.decode_attention(*args, use_kernels=False)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    tol = 1e-5 * v.abs().amax(dim=(1, 2, 3))[:, None, None, None] + 1e-6
    require(bool((diff <= tol).all()),
            f"decode_attention {label}: |d| beyond 1e-5 max|v|+1e-6 by "
            f"{float((diff - tol).max())}")
    qs = q.reshape(b, kh * g, 1, dh)
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    mask = (torch.arange(s, device=DEVICE)[None, :]
            < cache_len[:, None].long())[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = float((sdpa().reshape(b, kh, g, dh) - want).abs().max())
    rec = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:66",
        max_abs_err=float(diff.max()),
        ms=timer.ms(lambda: ops.decode_attention(*args, use_kernels=True)),
        call_ms=timer.ms(lambda: ops.decode_attention(*args, use_kernels=True),
                         hold=False),
        plain_ms=timer.ms(lambda: ops.decode_attention(*args, use_kernels=False)),
        library_ms=timer.ms(sdpa))
    rec["bound_ms"], rec["bound_by"] = decode_attention_bound_ms(q, k, cache_len)
    log(f"[kernel decode_attention: {label}] B={b} S={s} KH={kh} G={g} dh={dh} "
        f"cache_len={lens if len(lens) <= 8 else '...'}: max|d|="
        f"{rec['max_abs_err']:.3g} (tol 1e-5 max|v|+1e-6)  device "
        f"{rec['ms']:.4f} ms (call with host {rec['call_ms']:.4f} ms)  plain "
        f"{rec['plain_ms']:.4f} ms  scaled_dot_product_attention "
        f"{rec['library_ms']:.4f} ms (max|d| to plain {lib_err:.3g})  bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
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
    """The slice-3 kernels against their plain versions: binary_probe_lb at
    the vocab index's shape (every one of the 256 sign codes of m = 8,
    B = 4) and at the n=1M index's (its group table, the batch's
    projections); decode_attention at the serve shape and at the
    decode_32k shape; mips_score at the serve search's union tile. Returns
    the records of the kernel line (the serve shapes)."""
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
    da_rec = check_decode_attention(timer, "serve shape", 4, 512,
                                    [1, 37, 300, 512], seed=12)
    lens = [32768, 1, 20000, 4097, 64, 31000, 12345, 27000]
    check_decode_attention(timer, "decode_32k shape", 8, 32768, lens, seed=13)
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
    return [bp_rec, da_rec]


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


def probe_flips(arrays, meta, q):
    """Hold the frontend's Quick-Probe on the kernel against the plain one:
    the bounds within 1e-6 |lb| + 1e-7, and the chosen group (its
    representative row and Test A) equal. A query whose choice differs is
    a flip only if the plain bounds put the two groups within tolerance of
    each other, or one of them within tolerance of the Test-A threshold.
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
    rk, _, ok_k = quick_probe_batch(table, q_proj, q_l1, meta.c, meta.x_p, True)
    rp, _, ok_p = quick_probe_batch(table, q_proj, q_l1, meta.c, meta.x_p, False)
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
        require(min(margins) <= 1.0,
                f"query {b}: the Quick-Probe group differs between kernel "
                f"(group {gk}) and plain (group {gp}) with no bound within "
                f"tolerance (normalized margins {margins})")
        out[b] = min(margins)
    return out, float(diff.max())


def phase_main_path(label, pm, x, q):
    """One counted search through `ProMIPS.search`, held against the plain
    path, an exact top-k and the Theorem-2 floor. Returns the launches."""
    import torch
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.core.runtime import search as runtime_search
    from repro_torch.core import search_device as sd
    from repro_torch.kernels import ops
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
            and launches["binary_probe_lb"] > 0,
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
        f"1e-6|lb|+1e-7); Quick-Probe group flips (query: normalized "
        f"margin) {probe if probe else 'none'}")
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
    return launches


def time_batches(search, n_batches=5):
    """Median time of one search batch (CUDA events around the whole call
    ``search(queries)``, which synchronizes with the host each round), after
    one warm-up."""
    import torch
    from repro_torch.data.synthetic import mf_factors
    times = []
    for i in range(n_batches + 1):
        qb = torch.from_numpy(mf_factors(N_QUERIES, RECIPE["d"], RECIPE["rank"],
                                         decay=RECIPE["decay"], seed=2 + i)).cuda()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        search(qb)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], times


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
    log(f"[profile {label}] one batch: wall {wall_ms:.3f} ms under the profiler, "
        f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        log(f"[profile {label}]   {t / 1e3:8.3f} ms  x{c:<3d} {name}")

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
    return MutableProMIPS.from_state(arrays, meta, device="cuda")


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


def phase_stream_state(label, st, q, path_kernels, profile=False):
    """One state of a stream: its snapshot, one counted search through
    `MutableProMIPS.search`, held against the plain path, an exact top-k
    over `alive_items()` and the Theorem-2 floor; then the time per batch
    and, if asked, a profile. Returns the launches of the counted search."""
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
        f"{flips if flips else 'none'}; Quick-Probe group flips "
        f"{probe if probe else 'none'}")
    for note in notes:
        log(f"[{label}]   {note}")

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

    med, times = time_batches(search)
    log(f"[{label}] search time per batch of {N_QUERIES}: median {med:.3f} ms "
        f"over {len(times)} batches {['%.3f' % t for t in times]}")
    if profile:
        phase_profile(search, q, label)
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
                       ("binary_probe_lb", "block_mips", "sketch_scores",
                        "mips_score"))
    t0 = time.perf_counter()
    st.compact()
    log(f"[compact-100k] compact() {time.perf_counter() - t0:.1f} s (host "
        f"rebuild over {st.meta.n} rows); churn {st.churn_fraction}")
    phase_stream_state("compact-100k after compact()", st, q,
                       ("binary_probe_lb", "block_mips", "sketch_scores"))

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
                       ("binary_probe_lb", "block_mips", "sketch_scores",
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
    kernels = ("binary_probe_lb", "block_mips", "sketch_scores", "mips_score")
    phase_stream_state("stream-1M state A", st, q, kernels)
    rng = np.random.RandomState(5)
    base_ids = rng.choice(n, 2_000, replace=False)
    t0 = time.perf_counter()
    st.delete(base_ids[:1_000])
    st.update(base_ids[1_000:], corpus_rows(1_000, seed=4))
    st.delete(rng.choice(np.arange(n, n + n_ins), 1_112, replace=False))
    log(f"[stream-1M] state B: 1,000 base deletes, 1,000 base updates, "
        f"1,112 delta deletes in {time.perf_counter() - t0:.2f} s (host)")
    return phase_stream_state("stream-1M state B", st, q, kernels, profile=True)



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


def profile_step(engine, prompts):
    """Device time by kernel and the device's idle share over one promips
    decode step with every slot active (torch.profiler)."""
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
        log("[profile serve] device time not measured: the trace holds no "
            "CUDA events")
    else:
        log(f"[profile serve] one promips decode step, 4 active slots: wall "
            f"{wall_ms:.3f} ms under the profiler, device busy {busy_ms:.3f} "
            f"ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:18]:
            log(f"[profile serve]   {t / 1e3:8.3f} ms  x{c:<4d} {name}")
    while engine.queue or engine.active.any():
        engine.step()


def phase_serve():
    """The serve cell. Returns the launches of the counted promips run."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import DecodeEngine
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
    runs, launches = {}, None
    for mode in ("exact", "promips"):
        for path, use in (("kernels", None), ("plain", False)):
            engine = DecodeEngine(params, cfg, logits_mode=mode, use_kernels=use,
                                  index=index if mode == "promips" else None,
                                  **eng_kw)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            for name in ops.LAUNCHES:
                ops.LAUNCHES[name] = 0
            reqs, times, wall = run_traffic(engine, prompts, new)
            counts = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            n_search = len(searches.rows)
            rows_searched, ok = searches.guarantee(live, meta.c)
            decoded = sum(len(r.out_tokens) - 1 for r in reqs)
            require(all(len(r.out_tokens) >= 1 and 0 <= min(r.out_tokens)
                        and max(r.out_tokens) < cfg.vocab for r in reqs),
                    f"[serve {mode}/{path}] a request emitted no token or an "
                    "id outside the vocab")
            times_ms = sorted(1e3 * t for t in times)
            log(f"[serve {mode}/{path}] {len(reqs)} requests, {engine.steps} "
                f"steps, {engine.prefill_calls} prefills, {decoded} decoded "
                f"tokens in {wall:.3f} s = {decoded / wall:.1f} tokens/s; step "
                f"median {times_ms[len(times_ms) // 2]:.3f} ms (range "
                f"{times_ms[0]:.3f}-{times_ms[-1]:.3f}); launches {counts}; "
                f"peak memory {peak / 2**20:.1f} MiB ({resident / 2**20:.1f} "
                f"before + {(peak - resident) / 2**20:.1f})")
            steps = engine.steps
            if path == "kernels":
                require(counts["decode_attention"] == cfg.n_layers * steps,
                        f"[serve {mode}] decode_attention launched "
                        f"{counts['decode_attention']} times in {steps} steps "
                        f"of {cfg.n_layers} layers")
            else:
                require(not any(counts.values()),
                        f"[serve {mode}/plain] a kernel was launched: {counts}")
            if mode == "promips":
                pages_row = engine.pages / max(engine.searched_rows, 1)
                dense = cfg.vocab_padded * cfg.d_model * 4 // 4096
                log(f"[serve {mode}/{path}] {n_search} searches over "
                    f"{engine.searched_rows} rows: {pages_row:.1f} blocks per "
                    f"row of {meta.page_rows} x {cfg.d_model} f32 "
                    f"({pages_row * meta.page_rows * cfg.d_model * 4 / 4096:.1f}"
                    f" 4-KB pages) against the exact mode's dense scan of "
                    f"{dense} 4-KB pages; per search binary_probe_lb "
                    f"{counts['binary_probe_lb'] / max(n_search, 1):.2f}, "
                    f"mips_score {counts['mips_score'] / max(n_search, 1):.2f} "
                    f"launches")
                p0 = meta.p
                floor = p0 - 3.0 * math.sqrt(p0 * (1.0 - p0) / max(rows_searched, 1))
                share = ok / max(rows_searched, 1)
                log(f"[serve {mode}/{path}] guarantee: {ok} of {rows_searched} "
                    f"searched rows have a top-1 score >= c={meta.c} x the "
                    f"exact top-1 over the live vocab: {share:.4f} (floor "
                    f"{floor:.4f})")
                require(rows_searched > 0 and share >= floor,
                        f"[serve {mode}/{path}] guarantee share {share} < {floor}")
                if path == "kernels":
                    require(counts["binary_probe_lb"] == n_search
                            and counts["mips_score"] >= n_search,
                            f"[serve promips] a search kernel was not launched "
                            f"once per search ({n_search}): {counts}")
                    launches = dict(counts, steps=steps, searches=n_search)
            runs[mode, path] = (engine, reqs)
        notes = explain_token_diffs(f"serve {mode}", params, cfg,
                                    runs[mode, "kernels"][1],
                                    runs[mode, "plain"][1])
        log(f"[serve {mode}] kernel vs plain path: "
            f"{len(notes)} of {len(prompts)} requests differ in tokens"
            + "".join(f"; {n}" for n in notes))
    same = sum(a.out_tokens == b.out_tokens for a, b in
               zip(runs["exact", "kernels"][1], runs["promips", "kernels"][1]))
    tok_eq = sum(x == y for a, b in zip(runs["exact", "kernels"][1],
                                        runs["promips", "kernels"][1])
                 for x, y in zip(a.out_tokens, b.out_tokens))
    tok_n = sum(min(len(a.out_tokens), len(b.out_tokens)) for a, b in
                zip(runs["exact", "kernels"][1], runs["promips", "kernels"][1]))
    log(f"[serve] exact vs promips (kernel paths, not gated): {same} of "
        f"{len(prompts)} requests emit the same tokens; {tok_eq} of {tok_n} "
        f"token positions agree")
    profile_step(runs["promips", "kernels"][0], prompts)
    searches.rows.clear()

    # -- the hot-query cache on repeated prompts, against the cache off
    repeated = prompts[:8] * 2
    outs = {}
    for cap in (0, 256):
        engine = DecodeEngine(params, cfg, logits_mode="promips", index=index,
                              **dict(eng_kw, result_cache=cap))
        reqs, _, wall = run_traffic(engine, repeated, new)
        outs[cap] = [r.out_tokens for r in reqs]
        st = engine.qcache.stats()
        log(f"[serve cache {cap}] {len(repeated)} requests (8 prompts twice): "
            f"{engine.searched_rows} rows searched, cache {st}, {wall:.3f} s")
    searches.rows.clear()
    require(st["hits"] > 0, "[serve cache] no hit on repeated prompts")
    require(outs[0] == outs[256], "[serve cache] tokens differ with the cache on")

    # -- mutation: retire three emitted ids, then refresh one row
    engine = runs["promips", "kernels"][0]
    emitted = [t for r in runs["promips", "kernels"][1] for t in r.out_tokens[1:]
               if t != engine.eos_id]
    retired = [int(t) for t, _ in
               sorted(((t, emitted.count(t)) for t in set(emitted)),
                      key=lambda tc: (-tc[1], tc[0]))[:3]]
    engine.delete(retired)
    reqs, _, wall = run_traffic(engine, prompts, new)
    hit = sorted({t for r in reqs for t in r.out_tokens} & set(retired))
    gids, rows = index.alive_items()
    n_rows, ok = searches.guarantee(torch.from_numpy(rows).to(DEVICE), meta.c)
    log(f"[serve mutation] deleted ids {retired} (the most emitted); the same "
        f"traffic again in {wall:.3f} s: retired ids emitted {hit or 'none'}; "
        f"guarantee {ok} of {n_rows} rows over {len(gids)} live rows")
    require(not hit, f"[serve mutation] a deleted id was emitted: {hit}")
    upd = int(next(t for t in range(1, cfg.vocab) if t not in retired))
    row = (params["embed"][upd] * 1.5).cpu().numpy()
    engine.update([upd], row[None])
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    reqs, _, wall = run_traffic(engine, prompts[:4], new)
    hit = sorted({t for r in reqs for t in r.out_tokens} & set(retired))
    log(f"[serve mutation] updated id {upd} (its row x 1.5, now in the delta "
        f"segment); 4 requests in {wall:.3f} s, launches {dict(ops.LAUNCHES)}; "
        f"retired ids emitted {hit or 'none'}")
    require(not hit, f"[serve mutation] a deleted id was emitted: {hit}")
    engine.join_compaction(timeout=600)
    return launches


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
    del pm100k, x100k
    log(f"[phase 5, compact-100k] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = phase_main_path("n=1M", pm1m, x1m, q1m)
    search_1m = lambda qb: pm1m.search(qb, **SEARCH)  # noqa: E731
    med, times = time_batches(search_1m)
    log(f"[n=1M] search time per batch of {N_QUERIES}: median {med:.3f} ms over "
        f"{len(times)} batches {['%.3f' % t for t in times]}")
    phase_profile(search_1m, q1m, "n=1M")
    del x1m
    log(f"[phase 4] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stream_launches = phase_stream_1m(pm1m, q1m)
    del pm1m, q1m
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 5, stream-1M] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    serve_launches = phase_serve()
    log(f"[phase 6] {time.perf_counter() - t0:.1f} s")

    # each kernel's count from the path whose shapes its record was timed
    # at: the static main path for block_mips and sketch_scores, the stream
    # for mips_score, the serve run for binary_probe_lb and decode_attention
    launches["mips_score"] = stream_launches["mips_score"]
    for name in ("binary_probe_lb", "decode_attention"):
        launches[name] = serve_launches[name]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [{key: rec[key] for key in keys}
                                  for rec in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
