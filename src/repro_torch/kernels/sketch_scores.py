"""Wrapper of the CUDA `sketch_scores` kernel (`csrc/sketch_scores.cu`): the
PQ-sketch block estimates of the verification prefilter, the port of
`repro.kernels.block_mips.sketch_scores`. Its plain version is the GEMM
over the decoded centroids, `ref.sketch_scores_ref`; the two sum the same
subspace products in another order and agree to float tolerance. The
kernel is bit-identical to the ordered LUT sum `ref.sketch_scores_lut_ref`.
"""
from __future__ import annotations

import torch

from . import build
from .build import require
from .ref import sketch_lut


def sketch_scores(q, codebooks, codes):
    """Launch the kernel on CUDA tensors: q (B, d) f32, codebooks (M, K, d/M)
    f32, codes (NB, M) i32 in [0, K) -> est (B, NB) f32."""
    if not q.is_cuda:
        raise ValueError(f"sketch_scores kernel needs CUDA tensors, got {q.device}")
    dev = q.device
    b, d = q.shape
    m, n_codewords, sub_d = codebooks.shape
    nb = codes.shape[0]
    for name, t, dtype, shape in (
            ("q", q, torch.float32, (b, d)),
            ("codebooks", codebooks, torch.float32, (m, n_codewords, sub_d)),
            ("codes", codes, torch.int32, (nb, m))):
        require("sketch_scores", name, t, dtype, shape, dev)
    if m * sub_d != d or b < 1 or nb < 1:
        raise ValueError(f"sketch_scores: d={d} != M*sub_d={m}*{sub_d}, or "
                         f"an empty batch (B={b}, NB={nb})")
    if m * n_codewords * 4 > 232448:
        raise ValueError(f"sketch_scores kernel: one query's table "
                         f"({m}x{n_codewords} f32) exceeds shared memory")
    lut = sketch_lut(q, codebooks)
    est = torch.empty((b, nb), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.sketch_scores_launch(
            codes.data_ptr(), lut.data_ptr(), est.data_ptr(), b, nb, m,
            n_codewords, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "sketch_scores")
    build.count_launch("sketch_scores")
    return est
