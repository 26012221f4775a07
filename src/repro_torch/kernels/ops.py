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
from . import sketch_scores as _sketch_scores
from .build import LAUNCHES

__all__ = ["LAUNCHES", "binary_probe_lb", "block_mips", "block_mips_cached",
           "decode_attention", "mips_score", "quick_probe_select",
           "sketch_scores"]


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
