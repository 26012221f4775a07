"""Wrapper of the CUDA `decode_attention` kernel (`csrc/decode_attention.cu`):
one-token GQA attention against a KV cache with a per-sequence length, the
port of `repro.kernels.decode_attention.decode_attention`. Its plain version
is `ref.decode_attention_ref` (the arithmetic of `flash_decode`);
`ops.decode_attention` picks between them by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .build import require

TILE = 64          # cache positions per shared-memory tile (the .cu's TILE)
HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b: int, kh: int, s: int, n_sm: int):
    """(splits, chunk): S cut into ``splits`` chunks of ``chunk`` positions
    (a multiple of the tile), enough CTAs for about two per SM."""
    want = max(1, -(-2 * n_sm // (b * kh)))
    chunk = -(-s // want)
    chunk = -(-chunk // TILE) * TILE
    return -(-s // chunk), chunk


def decode_attention(q, k, v, cache_len):
    """Launch the kernel on CUDA tensors: q (B, KH, G, dh) f32, k and v
    (B, S, KH, dh) f32, cache_len (B,) int32 -> (B, KH, G, dh) f32. Takes
    dh in {32, 64, 128} and G <= 32."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    dev = q.device
    b, kh, g, dh = q.shape
    s = k.shape[1]
    for name, t, dtype, shape in (("q", q, torch.float32, (b, kh, g, dh)),
                                  ("k", k, torch.float32, (b, s, kh, dh)),
                                  ("v", v, torch.float32, (b, s, kh, dh)),
                                  ("cache_len", cache_len, torch.int32, (b,))):
        require("decode_attention", name, t, dtype, shape, dev)
    if dh not in HEAD_DIMS or not 1 <= g <= 32 or b < 1 or s < 1:
        raise ValueError(f"decode_attention kernel takes dh in {HEAD_DIMS}, "
                         f"1 <= G <= 32 and B, S >= 1; got dh={dh}, G={g}, "
                         f"B={b}, S={s}")
    splits, chunk = split_plan(b, kh, s, _sm_count(dev.index))
    part_m = torch.empty((splits, b, kh, g), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((splits, b, kh, g, dh), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), b, s, kh, g, dh, splits, chunk,
            ctypes.c_float(dh ** -0.5),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out
