"""Wrapper of the CUDA `scan_blocks` kernel (`csrc/scan_blocks.cu`): the
block walk of the scan and progressive searches, each query's walk split
into segments scored on every SM; the scan stop is found by counting the
rows >= c_half and the progressive walk replayed from per-step records. The
counterpart of the `lax.scan` bodies of
`repro.core.search_device` (`_scan_blocks`, `search_batch_progressive`),
which have no Pallas kernel. Its plain version is `ref.scan_blocks_ref`;
`ops.scan_blocks` picks between them by device.
"""
from __future__ import annotations

import torch

from . import build
from .build import require

MAX_PAGE_ROWS = 256   # rows the kernel scores per tile (R in the source)
# the most scratch one launch takes: a larger batch is walked in parts
SCRATCH_CAP = 1 << 30


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
    does not fit in one CTA's shared memory. A batch whose scratch would
    pass `SCRATCH_CAP` is walked in parts, one launch (and one count) each."""
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
        raise ValueError(f"scan_blocks kernel: the top-k (k={k}) and the "
                         f"staging ring need {smem} bytes of shared memory, above "
                         f"the {lib.scan_blocks_max_smem()} a CTA may have")
    top_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    top_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    pages = torch.empty((b,), dtype=torch.int32, device=dev)
    cand = torch.empty((b,), dtype=torch.int32, device=dev)
    done = torch.empty((b,), dtype=torch.bool, device=dev)
    # the scratch (segment flags, step records, row scores) follows from the
    # shapes alone, so a call reads nothing back and can be captured
    part = max(1, min(b, SCRATCH_CAP // lib.scan_blocks_scratch_bytes(
        1, nb, page_rows, budget)))
    scratch = torch.empty(
        (lib.scan_blocks_scratch_bytes(part, nb, page_rows, budget),),
        dtype=torch.uint8, device=dev)

    def ptr(t, lo):
        return None if t is None else t[lo:].data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, b, part):
            n = min(part, b - lo)
            err = lib.scan_blocks_launch(
                x.data_ptr(), ids.data_ptr(), ptr(q, lo), ptr(order, lo),
                ptr(n_sel, lo), ptr(block_gap, lo),
                None if block_max_l2sq is None else block_max_l2sq.data_ptr(),
                ptr(q_l2sq, lo), ptr(init_scores, lo), ptr(init_rows, lo),
                ptr(c_half, lo), ptr(top_s, lo), ptr(top_r, lo),
                ptr(pages, lo), ptr(cand, lo), ptr(done, lo), n, d, nb, k,
                page_rows, budget, int(progressive), int(cs_prune), float(c),
                float(x_p), scratch.data_ptr(), scratch.numel(), stream)
            build.check(err, "scan_blocks")
            build.count_launch("scan_blocks")
    return top_s, top_r, pages, cand, done
