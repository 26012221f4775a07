"""Wrapper of the CUDA `mips_score` kernel (`csrc/mips_score.cu`): the
scores of candidate rows against a query batch with invalid rows masked,
the port of `repro.kernels.mips_topk.mips_score`. Its plain version is
`ref.mips_score_ref`; `ops.mips_score` picks between them by device.

The kernel has two paths with one sum order, chosen by its launcher: a
batch of at most ``B_SMALL`` queries (a constant of `csrc/mips_score.cu`,
read by `b_small`) whose zero-padded copy fits in shared memory takes the
small-batch path (rows streamed once, bound by bytes), any other the tile
path. Every score is the same fmaf chain over depth on either path, so the
two give bit-identical scores.
"""
from __future__ import annotations

import torch

from . import build
from .build import require

# `path` of the launcher: its own choice, or one path forced (the tests and
# the B sweep of `chip_smoke.py` compare the two)
AUTO, SMALL, TILE = 0, 1, 2


def b_small() -> int:
    """The largest batch the small-batch path takes (the kernel's B_SMALL)."""
    return build.library().mips_score_b_small()


def _launch(x, q, valid, path: int = AUTO):
    """Launch the kernel on checked CUDA tensors; count it."""
    r, d = x.shape
    b = q.shape[0]
    dev = x.device
    out = torch.empty((r, b), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.mips_score_launch(
            x.data_ptr(), q.data_ptr(), valid.data_ptr(), out.data_ptr(), r, b,
            d, path, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "mips_score")
    build.count_launch("mips_score")
    return out


def mips_score(x, q, valid):
    """Launch the kernel on CUDA tensors: x (R, d) f32, q (B, d) f32,
    valid (R,) bool -> (R, B) f32, exactly -1e30 on invalid rows."""
    if not x.is_cuda:
        raise ValueError(f"mips_score kernel needs CUDA tensors, got {x.device}")
    dev = x.device
    r, d = x.shape
    b = q.shape[0]
    for name, t, dtype, shape in (("x", x, torch.float32, (r, d)),
                                  ("q", q, torch.float32, (b, d)),
                                  ("valid", valid, torch.bool, (r,))):
        require("mips_score", name, t, dtype, shape, dev)
    if r < 1 or b < 1 or d < 1:
        raise ValueError(f"mips_score kernel needs R, B, d >= 1, got R={r}, "
                         f"B={b}, d={d}")
    return _launch(x, q, valid)
