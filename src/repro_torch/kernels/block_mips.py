"""Wrapper of the CUDA `block_mips` kernel (`csrc/block_mips.cu`): one fused
verification round over a slot list of pages, the port of
`repro.kernels.block_mips.block_mips`. Its plain version is
`ref.block_mips_ref`; `ops.block_mips` picks between them by device.
"""
from __future__ import annotations

import torch

from . import build
from .build import require

TILE_ROWS = 64    # rows per chunk (RT in the source); page_rows <= it


def block_mips(x, valid, q, slots, sel, init_scores, init_rows, c_half, *,
               k: int, page_rows: int):
    """Launch the kernel on CUDA tensors.

    x (n_pad, d) f32; valid (n_pad,) bool; q (B, d) f32; slots (NS,) i32,
    ascending block ids (padding slots have an all-False ``sel`` column);
    sel (B, NS) bool; init_scores (B, k) f32; init_rows (B, k) i32;
    c_half (B,) f32. Returns (top_s (B, k) f32, top_r (B, k) i32,
    cnt (B, NS) i32, pages (B,) i32, cand (B,) i32).
    """
    if not x.is_cuda:
        raise ValueError(f"block_mips kernel needs CUDA tensors, got {x.device}")
    dev = x.device
    n_pad, d = x.shape
    b = q.shape[0]
    n_slots = slots.shape[0]
    if k < 1:
        raise ValueError(f"block_mips kernel needs k >= 1, got {k}")
    if not 1 <= page_rows <= TILE_ROWS or n_pad % page_rows:
        raise ValueError(f"block_mips kernel needs 1 <= page_rows <= {TILE_ROWS}"
                         f" dividing n_pad={n_pad}, got {page_rows}")
    if b < 1 or n_slots < 1:
        raise ValueError(f"block_mips kernel needs B >= 1 and NS >= 1, got "
                         f"B={b}, NS={n_slots}")
    for name, t, dtype, shape in (
            ("x", x, torch.float32, (n_pad, d)),
            ("valid", valid, torch.bool, (n_pad,)),
            ("q", q, torch.float32, (b, d)),
            ("slots", slots, torch.int32, (n_slots,)),
            ("sel", sel, torch.bool, (b, n_slots)),
            ("init_scores", init_scores, torch.float32, (b, k)),
            ("init_rows", init_rows, torch.int32, (b, k)),
            ("c_half", c_half, torch.float32, (b,))):
        require("block_mips", name, t, dtype, shape, dev)

    kp2 = 1 << (k - 1).bit_length()     # the merge's sort width
    i32 = dict(dtype=torch.int32, device=dev)
    top_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    top_r = torch.empty((b, k), **i32)
    cnt = torch.empty((b, n_slots), **i32)
    pages = torch.empty((b,), **i32)
    cand = torch.empty((b,), **i32)
    # the selected pairs' row scores; written only where sel is set
    scr = torch.empty((b, n_slots, page_rows), dtype=torch.float32, device=dev)
    keys = torch.empty((b, kp2), dtype=torch.int64, device=dev)
    lib = build.library()
    work = torch.empty((lib.block_mips_work_bytes(b, n_slots, page_rows),),
                       dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.block_mips_launch(
            x.data_ptr(), valid.data_ptr(), q.data_ptr(), slots.data_ptr(),
            sel.data_ptr(), init_scores.data_ptr(), init_rows.data_ptr(),
            c_half.data_ptr(), top_s.data_ptr(), top_r.data_ptr(),
            cnt.data_ptr(), pages.data_ptr(), cand.data_ptr(), scr.data_ptr(),
            keys.data_ptr(), work.data_ptr(), b, d, n_slots, k, page_rows,
            kp2, work.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "block_mips")
    build.count_launch("block_mips")
    return top_s, top_r, cnt, pages, cand
