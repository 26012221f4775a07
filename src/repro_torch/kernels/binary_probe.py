"""Wrappers of the CUDA Quick-Probe kernels (`csrc/binary_probe.cu`).

`binary_probe_lb`: the group lower bounds of Theorem 3 for a query batch,
the batched port of `repro.kernels.binary_probe.binary_probe_lb`; its plain
version is `ref.binary_probe_lb_ref`. `quick_probe_select`: the whole
Quick-Probe of the search frontend (bounds, Test A, the chosen group and
its radius) in one launch; its plain version is
`ref.quick_probe_select_ref`. `ops` picks between kernel and plain version
by device.
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
    build.count_launch("binary_probe_lb")
    return out


def quick_probe_select(code, min_l1, count, rep_proj, rep_row, q_proj, q_l1,
                       c: float, x_p: float):
    """Launch the fused Quick-Probe on CUDA tensors: the group table code
    (G,) int64, min_l1 (G,) f32, count (G,) i32, rep_proj (G, m) f32,
    rep_row (G,) i32; the batch q_proj (B, m) f32, q_l1 (B,) f32. Returns
    (rep_row (B,) i32, radius (B,) f32, test_a_passed (B,) bool)."""
    if not q_proj.is_cuda:
        raise ValueError(f"quick_probe_select kernel needs CUDA tensors, got "
                         f"{q_proj.device}")
    dev = q_proj.device
    b, m = q_proj.shape
    g = code.shape[0]
    for name, t, dtype, shape in (("code", code, torch.int64, (g,)),
                                  ("min_l1", min_l1, torch.float32, (g,)),
                                  ("count", count, torch.int32, (g,)),
                                  ("rep_proj", rep_proj, torch.float32, (g, m)),
                                  ("rep_row", rep_row, torch.int32, (g,)),
                                  ("q_proj", q_proj, torch.float32, (b, m)),
                                  ("q_l1", q_l1, torch.float32, (b,))):
        require("quick_probe_select", name, t, dtype, shape, dev)
    if not 1 <= m <= MAX_M or b < 1 or g < 1:
        raise ValueError(f"quick_probe_select kernel takes 1 <= m <= {MAX_M} "
                         f"and B, G >= 1; got m={m}, B={b}, G={g}")
    row = torch.empty((b,), dtype=torch.int32, device=dev)
    radius = torch.empty((b,), dtype=torch.float32, device=dev)
    passed = torch.empty((b,), dtype=torch.bool, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.quick_probe_select_launch(
            code.data_ptr(), min_l1.data_ptr(), count.data_ptr(),
            rep_proj.data_ptr(), rep_row.data_ptr(), q_proj.data_ptr(),
            q_l1.data_ptr(), row.data_ptr(), radius.data_ptr(),
            passed.data_ptr(), b, g, m, float(c), float(x_p),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "quick_probe_select")
    build.count_launch("quick_probe_select")
    return row, radius, passed
