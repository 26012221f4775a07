"""Analytic roofline of the port's kernels and search stages on one H100.

The counterpart of the JAX package's `repro.launch.roofline.kernel_cost`,
which reads XLA's compile-time ``cost_analysis``. PyTorch has nothing like
it, so every count here is computed from shapes (and, where the work depends
on the data, from the counts this run's data needs: the pages a tile reads,
the (query, page) pairs it scores, the rows a decode reads). Each count is
the LEAST work the function must do: every input byte read once, every
output byte written once, every arithmetic operation of the function once,
whatever a kernel reads again or computes twice. The records therefore carry
``static_upper_bound: False``: they are a floor on the time, where XLA's
figures sum every branch of a switch and are an upper bound on the traffic.

Each function returns JAX's record keys: ``flops``, ``bytes``,
``t_compute_s`` (flops over the fp32 rate outside the tensor cores),
``t_memory_s`` (bytes over the HBM rate), ``roofline_s`` (the larger) and
``bound`` (``"compute"`` or ``"memory"``).

Constants: NVIDIA's data sheet for the H100 SXM at its 700 W limit. A card
set to a lower power limit runs below them under load.
"""
from __future__ import annotations

HBM_BW = 3.35e12       # bytes/s
PEAK_FP32 = 67e12      # FLOP/s, fp32 outside the tensor cores


def cost(flops: float, nbytes: float) -> dict:
    """The roofline record of ``flops`` operations moving ``nbytes``."""
    t_comp = float(flops) / PEAK_FP32
    t_mem = float(nbytes) / HBM_BW
    return {"flops": float(flops), "bytes": float(nbytes),
            "t_compute_s": t_comp, "t_memory_s": t_mem,
            "roofline_s": max(t_comp, t_mem),
            "bound": "compute" if t_comp >= t_mem else "memory",
            "static_upper_bound": False}


def add(*records: dict) -> dict:
    """One record for work done in sequence: flops and bytes summed."""
    return cost(sum(r["flops"] for r in records),
                sum(r["bytes"] for r in records))


# ---------------------------------------------------------------- kernels

def block_mips(b: int, d: int, k: int, page_rows: int, n_slots: int,
               pages_read: int, pairs: int) -> dict:
    """One fused verification round (`kernels/csrc/block_mips.cu`): the
    ``pages_read`` pages selected by any query (rows and validity flags),
    the queries, the slot table and the (B, NS) selection, the carried top-k
    in and out, c_half and the (B, NS) counts, pages and candidates out;
    2 d flops per row of each of the ``pairs`` selected (query, page)
    pairs."""
    nbytes = (pages_read * page_rows * (d * 4 + 1) + b * d * 4 + n_slots * 4
              + b * n_slots + 2 * b * k * 8 + b * 4 + b * n_slots * 4 + b * 8)
    return cost(2.0 * d * page_rows * pairs, nbytes)


def mips_score(r: int, b: int, d: int) -> dict:
    """The (R, B) score matrix (`mips_score.cu`): rows, queries and the row
    flags read once, the scores written once; 2 R B d flops."""
    return cost(2.0 * r * b * d, r * d * 4 + b * d * 4 + r + r * b * 4)


def sketch_scores(b: int, d: int, nb: int, m: int, kcw: int,
                  sub_d: int) -> dict:
    """The prefilter estimates (`sketch_scores.cu`): the (NB, M) codes, the
    codebooks and the queries read once, the (B, NB) estimates written; the
    per-query LUT (2 B M K sub_d flops) and M additions per estimate."""
    nbytes = nb * m * 4 + m * kcw * sub_d * 4 + b * d * 4 + b * nb * 4
    return cost(2.0 * b * m * kcw * sub_d + float(b) * nb * m, nbytes)


def binary_probe_lb(b: int, g: int, m: int) -> dict:
    """The Theorem-3 bounds alone (`binary_probe.cu` `binary_probe_lb`):
    codes (int64), query codes and projections read once, the (B, G) bounds
    written; one multiply-add per bit and the scale."""
    return cost(float(b) * g * (2 * m + 1),
                g * 8 + b * 8 + b * m * 4 + b * g * 4)


def quick_probe_select(b: int, g: int, m: int) -> dict:
    """The whole Quick-Probe (`binary_probe.cu` `quick_probe_select`): the
    group table's codes (int64), min-l1 values and counts and the batch's
    projections and l1 norms read once, the chosen representative read once
    a query, three outputs a query; one multiply-add per bit and about ten
    operations of Test A per (query, group)."""
    nbytes = g * (8 + 4 + 4) + b * (m * 4 + 4) + b * (m * 4 + 4) + b * 9
    return cost(float(b) * g * (2 * m + 10), nbytes)


def decode_attention(b: int, kh: int, g: int, dh: int, rows: int) -> dict:
    """One-token GQA attention (`decode_attention.cu`) over ``rows`` cached
    positions in all (the sum over the batch of each sequence's length):
    K and V of those rows read once, q read and the output written once;
    2 dh flops for the score and 2 dh for P.V per (position, query row)."""
    nbytes = 2 * rows * kh * dh * 4 + 2 * b * kh * g * dh * 4 + b * 4
    return cost(float(rows) * kh * g * 4 * dh, nbytes)


def scan_blocks(b: int, d: int, k: int, page_rows: int, union_pages: int,
                pages_walked: int) -> dict:
    """A block walk (`scan_blocks.cu`): the ``union_pages`` distinct pages
    any query walked (rows and ids) read once, the ``pages_walked`` order
    entries, the queries, the top-k in and out; 2 d flops per row of each
    walked (query, page)."""
    nbytes = (union_pages * page_rows * (d * 4 + 4) + pages_walked * 4
              + b * d * 4 + 4 * b * k * 8 + b * 13)
    return cost(2.0 * d * page_rows * pages_walked, nbytes)


# ---------------------------------------------------------------- stages

def select_frontend(b: int, d: int, m: int, g: int, s: int, nb: int,
                    kmax: int) -> dict:
    """`core/search_device.py` `select_frontend` for a (B, d) batch over an
    index of G groups, S sub-partitions and NB blocks of at most KMAX
    sub-partitions: the projection (B d in, d m of A, 2 B d m flops), the
    l1 and squared-l2 norms (2 B d flops each), `quick_probe_select`, the
    (B, S) distances to the sub-partition centers (the (S, m) centers and
    the radii read, 2 B S m flops and 3 B S for the norms and the root), the
    sphere test (2 B S), and the (B, NB) mask from the (NB, KMAX) table
    (B NB KMAX ors). Written: the projection, the norms, the distances, the
    radius, Test A, c_half and the mask (one byte an entry)."""
    probe = quick_probe_select(b, g, m)
    nbytes = (b * d * 4 + d * m * 4 + s * m * 4 + s * 4 + s * 4 + nb * kmax * 4
              + b * m * 4 + 2 * b * 4 + b * s * 4 + b * 4 + b + b * 4 + b * nb)
    flops = (2.0 * b * d * m + 4.0 * b * d + 2.0 * b * s * m + 5.0 * b * s
             + float(b) * nb * kmax)
    return add(probe, cost(flops, nbytes))


def prefilter_round1(b: int, d: int, nb: int, m: int, kcw: int, sub_d: int,
                     page_rows: int) -> dict:
    """`prefilter_round1`: `sketch_scores`, then the error band (the (NB,)
    errors read, a multiply a (query, block)), the block validity from the
    (NB page_rows,) ids, and the survivor cut (the (B, NB) mask in and out,
    a subtraction, an addition and two compares a (query, block)); the
    estimates and the band are written for round 2."""
    sk = sketch_scores(b, d, nb, m, kcw, sub_d)
    nbytes = nb * 4 + nb * page_rows * 4 + b * nb + b * nb + b * nb * 4
    return add(sk, cost(5.0 * b * nb, nbytes))


# one planned tile of the fused verification is one `block_mips` round
fused_verify_tile = block_mips


def topk_rescore(b: int, k: int, d: int) -> dict:
    """`runtime._rescore`: the B k returned rows and the queries read once,
    the (B, k) scores written; 2 d flops a row."""
    return cost(2.0 * b * k * d, b * k * d * 4 + b * k * 4 + b * d * 4
                + b * k * 4)


__all__ = ["HBM_BW", "PEAK_FP32", "cost", "add", "block_mips", "mips_score",
           "sketch_scores", "binary_probe_lb", "quick_probe_select",
           "decode_attention", "scan_blocks", "select_frontend",
           "prefilter_round1", "fused_verify_tile", "topk_rescore"]
