"""Wrapper of the CUDA `scan_blocks` kernel (`csrc/scan_blocks.cu`): the
block walk of the scan and progressive searches, one CTA per query, the
counterpart of the `lax.scan` bodies of `repro.core.search_device`
(`_scan_blocks`, `search_batch_progressive`), which have no Pallas kernel.
Its plain version is `ref.scan_blocks_ref`; `ops.scan_blocks` picks
between them by device.
"""
from __future__ import annotations

import torch

from . import build
from .build import require

MAX_PAGE_ROWS = 256   # rows the kernel scores per chunk (NR in the source)


def scan_blocks(x, ids, q, order, init_scores, init_rows, c_half, *, k: int,
                page_rows: int, budget: int, n_sel=None, block_gap=None,
                block_max_l2sq=None, q_l2sq=None, c: float = 1.0,
                x_p: float = 0.0, cs_prune: bool = False):
    """Launch the kernel on CUDA tensors; the arguments and results of
    `ref.scan_blocks_ref`.

    x (n_pad, d) f32; ids (n_pad,) i32; q (B, d) f32; order (B, NB) i32;
    init_scores (B, k) f32; init_rows (B, k) i32; c_half (B,) f32; scan
    mode with n_sel (B,) i32, progressive mode with block_gap (B, NB) f32,
    block_max_l2sq (NB,) f32 and q_l2sq (B,) f32. Raises where the top-k
    and the query do not fit in one CTA's shared memory."""
    if not x.is_cuda:
        raise ValueError(f"scan_blocks kernel needs CUDA tensors, got {x.device}")
    progressive = block_gap is not None
    if progressive == (n_sel is not None):
        raise ValueError("scan_blocks: give n_sel (scan) or block_gap "
                         "(progressive), not both or neither")
    dev = x.device
    n_pad, d = x.shape
    b, nb = order.shape
    if k < 1 or budget < 0:
        raise ValueError(f"scan_blocks kernel needs k >= 1 and budget >= 0, "
                         f"got k={k}, budget={budget}")
    if not 1 <= page_rows <= MAX_PAGE_ROWS or n_pad != nb * page_rows:
        raise ValueError(f"scan_blocks kernel needs 1 <= page_rows <= "
                         f"{MAX_PAGE_ROWS} and n_pad = NB * page_rows, got "
                         f"page_rows={page_rows}, n_pad={n_pad}, NB={nb}")
    if b < 1:
        raise ValueError("scan_blocks kernel needs B >= 1")
    checks = [("x", x, torch.float32, (n_pad, d)),
              ("ids", ids, torch.int32, (n_pad,)),
              ("q", q, torch.float32, (b, d)),
              ("order", order, torch.int32, (b, nb)),
              ("init_scores", init_scores, torch.float32, (b, k)),
              ("init_rows", init_rows, torch.int32, (b, k)),
              ("c_half", c_half, torch.float32, (b,))]
    if progressive:
        checks += [("block_gap", block_gap, torch.float32, (b, nb)),
                   ("block_max_l2sq", block_max_l2sq, torch.float32, (nb,)),
                   ("q_l2sq", q_l2sq, torch.float32, (b,))]
    else:
        checks += [("n_sel", n_sel, torch.int32, (b,))]
    for name, t, dtype, shape in checks:
        require("scan_blocks", name, t, dtype, shape, dev)
    lib = build.library()
    smem = lib.scan_blocks_smem_bytes(d, k)
    if smem > lib.scan_blocks_max_smem():
        raise ValueError(f"scan_blocks kernel: the top-k (k={k}) and the query "
                         f"(d={d}) need {smem} bytes of shared memory, above "
                         f"the {lib.scan_blocks_max_smem()} a CTA may have")
    top_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    top_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    pages = torch.empty((b,), dtype=torch.int32, device=dev)
    cand = torch.empty((b,), dtype=torch.int32, device=dev)
    done = torch.empty((b,), dtype=torch.bool, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.scan_blocks_launch(
            x.data_ptr(), ids.data_ptr(), q.data_ptr(), order.data_ptr(),
            ptr(n_sel), ptr(block_gap), ptr(block_max_l2sq), ptr(q_l2sq),
            init_scores.data_ptr(), init_rows.data_ptr(), c_half.data_ptr(),
            top_s.data_ptr(), top_r.data_ptr(), pages.data_ptr(),
            cand.data_ptr(), done.data_ptr(), b, d, nb, k, page_rows,
            budget, int(progressive), int(cs_prune), float(c), float(x_p),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "scan_blocks")
    build.count_launch("scan_blocks")
    return top_s, top_r, pages, cand, done
