"""Frozen least-work counts of the port's search kernels, and the H100's
peaks: a copy of `repro_torch.launch.roofline`'s `cost`, `block_mips`,
`sketch_scores`, `quick_probe_select` and `mips_score`, kept here so that a
change to the program's copy cannot move the yardstick.

Each count is the LEAST work the function must do: every input byte read
once, every output byte written once, every arithmetic operation once,
whatever a kernel reads again or computes twice. Where the work depends on
the data, the caller passes what these inputs need. So the least time
(``roofline_s``) is a floor, and its share of a measured time cannot pass
100% unless the time leaves out part of the work.

Constants: NVIDIA's data sheet for the H100 SXM at its 700 W limit.
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
            "bound": "compute" if t_comp >= t_mem else "memory"}


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


def quick_probe_select(b: int, g: int, m: int) -> dict:
    """The whole Quick-Probe (`binary_probe.cu` `quick_probe_select`): the
    group table's codes (int64), min-l1 values and counts and the batch's
    projections and l1 norms read once, the chosen representative read once
    a query, three outputs a query; one multiply-add per bit and about ten
    operations of Test A per (query, group)."""
    nbytes = g * (8 + 4 + 4) + b * (m * 4 + 4) + b * (m * 4 + 4) + b * 9
    return cost(float(b) * g * (2 * m + 10), nbytes)
