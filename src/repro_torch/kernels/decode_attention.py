"""Wrapper of the CUDA `decode_attention` kernel (`csrc/decode_attention.cuh`):
one-token GQA attention against a KV cache with a per-sequence length, the
port of `repro.kernels.decode_attention.decode_attention`. Like it, the
kernel takes f32 or bf16 inputs, computes in f32 and writes q's dtype, at
any head width dh that is a multiple of 8 up to 128. Its
plain version is `ref.decode_attention_ref` (the arithmetic of
`flash_decode`); `ops.decode_attention` picks between them by device. On
request the same launch also writes each query row's log-sum-exp
(``return_lse``), with which the pieces of a sequence split over ranks are
merged (`models.attention.merge_pieces`); the output then stays in f32 for
the merge, and rounded to q's dtype it equals the output alone bit for
bit.

One launch per call, with no host sync: the partial-state scratch is sized
from the shapes alone, and the per-row tickets with which the kernel's CTAs
find the last chunk of a row live in one int32 array per device, zeroed
once when it is allocated (the kernel leaves it zero). An array that a call
outgrows is replaced by a larger one and kept alive, so a CUDA graph that
captured the old address can still replay. A call can be captured once an
eager call of the same shapes has allocated the tickets: a capture that
would need more tickets raises. Calls share the tickets, so an eager call
on another stream than the previous one first makes its stream wait for
that one; a graph replay must not overlap another call on the device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .build import require

DTYPES = (torch.float32, torch.bfloat16)
DH_MAX = 128
B_MAX = 4096          # the kernel's prefix sum over B lives in shared memory

_tickets: dict = {}      # device index -> int32 tensor, all zero between calls
_outgrown: list = []     # earlier ticket arrays: a captured graph may hold one
_last_stream: dict = {}  # device index -> stream of the previous eager call


@functools.lru_cache(maxsize=None)
def _scratch_floats(index: int, b: int, s: int, kh: int, g: int, dh: int,
                    elem_bytes: int) -> int:
    """Partial-state floats for these shapes on device ``index`` (the grid,
    and with it the slot count, depends on the device's SMs and on the
    instance, which the element size picks)."""
    with torch.cuda.device(index):
        n = build.library().decode_attention_scratch_floats(b, s, kh, g, dh,
                                                            elem_bytes)
    if n < 0:
        raise ValueError(f"decode_attention kernel does not take B={b}, S={s}, "
                         f"KH={kh}, G={g}, dh={dh}, {elem_bytes}-byte elements")
    return n


def _ticket_array(dev: torch.device, n: int, capturing: bool) -> torch.Tensor:
    t = _tickets.get(dev.index)
    if t is None or t.numel() < n:
        if capturing:
            raise RuntimeError(
                f"decode_attention: a captured call needs {n} tickets on "
                f"{dev}; make one eager call of these shapes before capturing")
        if t is not None:
            _outgrown.append(t)
        t = torch.zeros(max(n, 1024, 0 if t is None else 2 * t.numel()),
                        dtype=torch.int32, device=dev)
        _tickets[dev.index] = t
    return t


def _serialize(dev: torch.device, stream, capturing: bool) -> None:
    """Order this call after the previous eager call on the device when that
    one ran on another stream (they share the tickets)."""
    if capturing:
        return
    prev = _last_stream.get(dev.index)
    if prev is not None and prev != stream:
        stream.wait_stream(prev)
    _last_stream[dev.index] = stream


def decode_attention(q, k, v, cache_len, return_lse: bool = False):
    """Launch the kernel on CUDA tensors: q (B, KH, G, dh), k and v
    (B, S, KH, dh), all f32 or all bf16, cache_len (B,) int32 ->
    (B, KH, G, dh) in q's dtype; with ``return_lse`` the output in f32 and
    the (B, KH, G) f32 log-sum-exp of each row's scaled scores (-inf where
    cache_len <= 0). Takes dh a multiple of 8 up to 128, G <= 32 and
    B <= 4096; raises ValueError on anything else."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    dev = q.device
    b, kh, g, dh = q.shape
    s = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention kernel takes q/k/v in {DTYPES}, "
                         f"got {q.dtype}")
    for name, t, dtype, shape in (("q", q, q.dtype, (b, kh, g, dh)),
                                  ("k", k, q.dtype, (b, s, kh, dh)),
                                  ("v", v, q.dtype, (b, s, kh, dh)),
                                  ("cache_len", cache_len, torch.int32, (b,))):
        require("decode_attention", name, t, dtype, shape, dev)
    # a multiple of 8: a bf16 row is whole 16-byte chunks
    if (not 8 <= dh <= DH_MAX or dh % 8 or not 1 <= g <= 32
            or not 1 <= b <= B_MAX or s < 1):
        raise ValueError(f"decode_attention kernel takes dh a multiple of 8 "
                         f"from 8 to {DH_MAX}, 1 <= G <= 32, 1 <= B <= "
                         f"{B_MAX} and S >= 1; got dh={dh}, G={g}, B={b}, "
                         f"S={s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    capturing = torch.cuda.is_current_stream_capturing()
    tickets = _ticket_array(dev, b * kh * g, capturing)
    stream = torch.cuda.current_stream(dev)
    _serialize(dev, stream, capturing)
    elem_bytes = q.element_size()
    part = torch.empty(_scratch_floats(dev.index, b, s, kh, g, dh, elem_bytes),
                       dtype=torch.float32,
                       device=dev)
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse else q.dtype,
                      device=dev)
    lse = (torch.empty((b, kh, g), dtype=torch.float32, device=dev)
           if return_lse else None)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, kh, g, dh,
            elem_bytes, ctypes.c_float(dh ** -0.5), stream.cuda_stream)
    build.check(err, "decode_attention")
    build.count_launch("decode_attention")
    return (out, lse) if return_lse else out
