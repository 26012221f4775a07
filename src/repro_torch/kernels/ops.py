"""Public kernel entries, the same names as `repro.kernels.ops`.

Dispatch is by the tensors' device: CUDA tensors launch the hand-written
kernel, CPU tensors take the plain PyTorch version. ``use_kernels=False``
asks for the plain version on the card (the counterpart of
``use_pallas=False``, used to hold the kernels against it);
``use_kernels=True`` on CPU tensors raises. There is no fallback: a kernel
that cannot run raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import binary_probe as _binary_probe
from . import block_mips as _block_mips
from . import decode_attention as _decode_attention
from . import mips_score as _mips_score
from . import ref
from . import scan_blocks as _scan_blocks
from . import sketch_scores as _sketch_scores
from .build import LAUNCHES

__all__ = ["BLOCK_MIPS_MAX_K", "LAUNCHES", "binary_probe_lb", "block_mips",
           "block_mips_cached", "decode_attention", "mips_score", "mips_topk",
           "quick_probe_select", "scan_blocks", "sketch_scores"]

# the largest k `mips_topk` routes through `block_mips`, the JAX package's
# `block_mips.MAX_K`
BLOCK_MIPS_MAX_K = 128


def _use_kernel(t, use_kernels: Optional[bool], name: str) -> bool:
    if use_kernels is None:
        return t.is_cuda
    if use_kernels and not t.is_cuda:
        raise ValueError(f"{name}: use_kernels=True needs CUDA tensors, got "
                         f"{t.device}")
    return bool(use_kernels)


def mips_score(x, q, valid, *, use_kernels: Optional[bool] = None):
    """(R, B) scores <x[r], q[b]>, exactly -1e30 on invalid rows; see
    `ref.mips_score_ref`."""
    if _use_kernel(x, use_kernels, "mips_score"):
        return _mips_score.mips_score(x, q, valid)
    return ref.mips_score_ref(x, q, valid)


def block_mips(x, valid, q, slots, sel, init_scores, init_rows, c_half, *,
               k: int, page_rows: int, dense: bool = False,
               use_kernels: Optional[bool] = None):
    """Fused verification round: (top_s (B, k), top_r (B, k), cnt (B, NS),
    pages (B,), cand (B,)); see `ref.block_mips_ref`. ``dense`` only lets
    the plain version skip its row gather."""
    if _use_kernel(x, use_kernels, "block_mips"):
        return _block_mips.block_mips(x, valid, q, slots, sel, init_scores,
                                      init_rows, c_half, k=k,
                                      page_rows=page_rows)
    return ref.block_mips_ref(x, valid, q, slots, sel, init_scores, init_rows,
                              c_half, k=k, page_rows=page_rows, dense=dense)


def sketch_scores(q, sk_mu, codebooks, codes, *,
                  use_kernels: Optional[bool] = None):
    """(B, NB) sketch estimates est[b, n] = <q_b, decoded centroid n>: the
    LUT kernel on the card, the GEMM over ``sk_mu`` in the plain version."""
    if _use_kernel(q, use_kernels, "sketch_scores"):
        return _sketch_scores.sketch_scores(q, codebooks, codes)
    return ref.sketch_scores_ref(q, sk_mu)


def block_mips_cached(scores_full, valid, slots, sel, init_scores, init_rows,
                      c_half, *, k: int, page_rows: int):
    """Compensation round over a cached (B, n_pad) score matrix; plain
    version only, as in the JAX package (on the card the kernel walks the
    pages instead)."""
    return ref.block_mips_cached_ref(scores_full, valid, slots, sel,
                                     init_scores, init_rows, c_half,
                                     k=k, page_rows=page_rows)


def mips_topk(x, q, valid, k: int, *, use_kernels: Optional[bool] = None,
              page_rows: int = 32):
    """Full-corpus top-k: (scores (B, k), rows (B, k)) of x (R, d) against
    q (B, d), invalid rows left out.

    Routed as the JAX package's `ops.mips_topk`: for k <= `BLOCK_MIPS_MAX_K`
    one `block_mips` round over every page of ``x`` (padded to ``page_rows``
    rows, every (query, page) selected, c_half = float32 max, so Condition A
    never stops it): the kernel on CUDA tensors, its plain version
    elsewhere; where fewer than k rows are valid the remaining slots are
    -1 with -inf scores. For larger k, `mips_score` and a top-k with ties to
    the lower row (invalid rows score -1e30 there, as in the JAX route)."""
    if k <= BLOCK_MIPS_MAX_K:
        r, d = x.shape
        b = q.shape[0]
        rp = -(-r // page_rows) * page_rows
        xpad = torch.nn.functional.pad(x.float(), (0, 0, 0, rp - r))
        vpad = torch.nn.functional.pad(valid.bool(), (0, rp - r))
        n_blocks = rp // page_rows
        dev = x.device
        slots = torch.arange(n_blocks, dtype=torch.int32, device=dev)
        sel = torch.ones((b, n_blocks), dtype=torch.bool, device=dev)
        init_s = torch.full((b, k), float("-inf"), device=dev)
        init_r = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        c_half = torch.full((b,), torch.finfo(torch.float32).max, device=dev)
        top, rows, _, _, _ = block_mips(
            xpad, vpad, q.float().contiguous(), slots, sel, init_s, init_r,
            c_half, k=k, page_rows=page_rows, dense=True,
            use_kernels=use_kernels)
        return top, rows
    scores = mips_score(x, q, valid, use_kernels=use_kernels)    # (R, B)
    return ref.topk_stable(scores.T, k)


def scan_blocks(x, ids, q, order, init_scores, init_rows, c_half, *, k: int,
                page_rows: int, budget: int, n_sel=None, block_gap=None,
                block_max_l2sq=None, q_l2sq=None, c: float = 1.0,
                x_p: float = 0.0, cs_prune: bool = False,
                use_kernels: Optional[bool] = None):
    """The block walk of the scan (``n_sel`` given) and progressive
    (``block_gap``, ``block_max_l2sq``, ``q_l2sq`` given) searches:
    (top_s (B, k), top_r (B, k), pages (B,), cand (B,), done_a (B,)); see
    `ref.scan_blocks_ref`."""
    kw = dict(k=k, page_rows=page_rows, budget=budget, n_sel=n_sel,
              block_gap=block_gap, block_max_l2sq=block_max_l2sq,
              q_l2sq=q_l2sq, c=c, x_p=x_p, cs_prune=cs_prune)
    if _use_kernel(x, use_kernels, "scan_blocks"):
        return _scan_blocks.scan_blocks(x, ids, q, order, init_scores,
                                        init_rows, c_half, **kw)
    return ref.scan_blocks_ref(x, ids, q, order, init_scores, init_rows,
                               c_half, **kw)


def binary_probe_lb(codes, q_code, q_proj, *,
                    use_kernels: Optional[bool] = None):
    """(B, G) Theorem-3 group lower bounds for a query batch: codes (G,)
    int64, q_code (B,) int64, q_proj (B, m) f32; see
    `ref.binary_probe_lb_ref`. The batched form of the JAX package's
    per-query ``binary_probe_lb(codes, q_code, q_proj)``."""
    if _use_kernel(q_proj, use_kernels, "binary_probe_lb"):
        return _binary_probe.binary_probe_lb(codes, q_code, q_proj)
    return ref.binary_probe_lb_ref(codes, q_code, q_proj)


def quick_probe_select(code, min_l1, count, rep_proj, rep_row, q_proj, q_l1,
                       c: float, x_p: float, *,
                       use_kernels: Optional[bool] = None):
    """Batched Quick-Probe (Algorithm 2) over a group table: (rep_row (B,)
    i32, radius (B,) f32, test_a_passed (B,) bool); see
    `ref.quick_probe_select_ref`. The function of the JAX package's
    `core.quick_probe.quick_probe_batch`, one launch on the card."""
    if _use_kernel(q_proj, use_kernels, "quick_probe_select"):
        return _binary_probe.quick_probe_select(
            code, min_l1, count, rep_proj, rep_row, q_proj, q_l1, c, x_p)
    return ref.quick_probe_select_ref(code, min_l1, count, rep_proj, rep_row,
                                      q_proj, q_l1, c, x_p)


def decode_attention(q, k, v, cache_len, *,
                     use_kernels: Optional[bool] = None):
    """One-token GQA attention against a KV cache: q (B, KH, G, dh), k and v
    (B, S, KH, dh), cache_len (B,) -> (B, KH, G, dh); see
    `ref.decode_attention_ref`. The kernel takes f32 and dh in
    {32, 64, 128}."""
    if _use_kernel(q, use_kernels, "decode_attention"):
        return _decode_attention.decode_attention(
            q, k, v, cache_len.to(torch.int32).contiguous())
    return ref.decode_attention_ref(q, k, v, cache_len)
