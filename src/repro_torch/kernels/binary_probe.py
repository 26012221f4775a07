"""Wrapper of the CUDA `binary_probe_lb` kernel (`csrc/binary_probe.cu`):
the Quick-Probe group lower bounds of Theorem 3 for a query batch, the
batched port of `repro.kernels.binary_probe.binary_probe_lb`. Its plain
version is `ref.binary_probe_lb_ref`; `ops.binary_probe_lb` picks between
them by device.
"""
from __future__ import annotations

import torch

from . import build
from .build import require

MAX_M = 30


def binary_probe_lb(codes, q_code, q_proj):
    """Launch the kernel on CUDA tensors: codes (G,) int64 group sign codes,
    q_code (B,) int64 query codes, q_proj (B, m) f32 -> (B, G) f32."""
    if not q_proj.is_cuda:
        raise ValueError(f"binary_probe_lb kernel needs CUDA tensors, got "
                         f"{q_proj.device}")
    dev = q_proj.device
    b, m = q_proj.shape
    g = codes.shape[0]
    for name, t, dtype, shape in (("codes", codes, torch.int64, (g,)),
                                  ("q_code", q_code, torch.int64, (b,)),
                                  ("q_proj", q_proj, torch.float32, (b, m))):
        require("binary_probe_lb", name, t, dtype, shape, dev)
    if not 1 <= m <= MAX_M or b < 1 or g < 1:
        raise ValueError(f"binary_probe_lb kernel takes 1 <= m <= {MAX_M} and "
                         f"B, G >= 1; got m={m}, B={b}, G={g}")
    out = torch.empty((b, g), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.binary_probe_lb_launch(
            codes.data_ptr(), q_code.data_ptr(), q_proj.data_ptr(),
            out.data_ptr(), b, g, m, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "binary_probe_lb")
    build.LAUNCHES["binary_probe_lb"] += 1
    return out
