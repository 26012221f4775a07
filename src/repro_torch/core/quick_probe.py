"""Quick-Probe (paper Section V, Algorithm 2); port of `repro.core.quick_probe`.

Every projected point gets a sign code (bit i = 1 iff P_i(o) >= 0); points
sharing a code form a group. Theorem 3 gives a per-group lower bound on the
projected distance, Test A picks the passing group with the smallest bound
(== the first hit of the paper's ascending-LB scan), else the group with the
largest tested value.

The table build is host numpy (bit-identical to the JAX package's). The
query side is torch: codes are carried as int64 (m <= 30), since XOR and
shifts on torch uint32 are thin, especially on CUDA.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops


def pack_codes_np(p_pts: np.ndarray) -> np.ndarray:
    """Sign codes of projected points, packed to uint32. (n, m) -> (n,)."""
    n, m = p_pts.shape
    if m > 30:
        raise ValueError("projected dimension must fit a packed uint32 code")
    bits = (p_pts >= 0.0).astype(np.uint32)
    weights = (1 << np.arange(m, dtype=np.uint32))
    return (bits * weights[None, :]).sum(axis=1).astype(np.uint32)


def pack_codes(p_pts: torch.Tensor) -> torch.Tensor:
    """Torch version of :func:`pack_codes_np`. (..., m) -> (...,) int64."""
    m = p_pts.shape[-1]
    weights = torch.ones((), dtype=torch.int64, device=p_pts.device) << torch.arange(
        m, dtype=torch.int64, device=p_pts.device)
    return ((p_pts >= 0.0).to(torch.int64) * weights).sum(dim=-1)


class GroupTable(NamedTuple):
    """Per-group Quick-Probe metadata (G groups).

    code:     (G,) — the group's sign code (uint32 on host, int64 as a tensor).
    min_l1:   (G,) f32 — min ||o||_1 (ORIGINAL space) among members.
    rep_proj: (G, m) f32 — projected point of that min-l1 member.
    rep_row:  (G,) i32 — its row in the sorted data layout.
    count:    (G,) i32 — group size (0 marks padding).
    """

    code: object
    min_l1: object
    rep_proj: object
    rep_row: object
    count: object


def build_group_table(codes: np.ndarray, l1: np.ndarray, p_pts: np.ndarray,
                      max_groups: int | None = None) -> GroupTable:
    """Host-side group construction (pre-processing phase).

    ``codes``/``l1``/``p_pts`` are in the final sorted data layout, so
    ``rep_row`` indexes directly into the index's sorted arrays.
    ``max_groups`` caps the table at the groups with the SMALLEST min
    ||o||_1, kept in code-sorted order; None keeps every distinct sign code.
    """
    order = np.lexsort((l1, codes))
    sc = codes[order]
    boundaries = np.concatenate([[0], np.nonzero(np.diff(sc))[0] + 1, [len(sc)]])
    g_code, g_min_l1, g_rep_proj, g_rep_row, g_count = [], [], [], [], []
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        if s == e:
            continue
        rows = order[s:e]
        rep = rows[0]  # lexsort => first member has min ||o||_1
        g_code.append(sc[s])
        g_min_l1.append(l1[rep])
        g_rep_proj.append(p_pts[rep])
        g_rep_row.append(rep)
        g_count.append(e - s)
    if max_groups is not None and len(g_code) > int(max_groups):
        keep = np.sort(np.argsort(np.asarray(g_min_l1, np.float32),
                                  kind="stable")[: int(max_groups)])
        g_code = [g_code[i] for i in keep]
        g_min_l1 = [g_min_l1[i] for i in keep]
        g_rep_proj = [g_rep_proj[i] for i in keep]
        g_rep_row = [g_rep_row[i] for i in keep]
        g_count = [g_count[i] for i in keep]
    return GroupTable(
        code=np.asarray(g_code, np.uint32),
        min_l1=np.asarray(g_min_l1, np.float32),
        rep_proj=np.asarray(g_rep_proj, np.float32),
        rep_row=np.asarray(g_rep_row, np.int32),
        count=np.asarray(g_count, np.int32),
    )


def quick_probe_batch(table: GroupTable, q_proj: torch.Tensor,
                      q_l1: torch.Tensor, c: float, x_p: float,
                      use_kernels: Optional[bool] = None):
    """Batch-native Algorithm 2 for a (B, m) query batch.

    The (B, G) Theorem-3 lower bounds come from `ops.binary_probe_lb` (the
    CUDA kernel on CUDA tensors, its plain version elsewhere, as
    ``use_kernels`` says). Test A: LB^2 >= x_p * c * (min_l1 + ||q||_1)^2.
    Among passing groups the smallest LB wins (`torch.argmin` returns the
    first minimum, as `jnp` does); with none passing, the largest tested
    value.

    Returns (rep_row (B,), radius (B,), test_a_passed (B,)).
    """
    q_code = pack_codes(q_proj)                                      # (B,)
    lb = ops.binary_probe_lb(table.code, q_code, q_proj,
                             use_kernels=use_kernels)                # (B, G)
    valid = table.count > 0
    denom = c * (table.min_l1[None, :] + q_l1[:, None]) ** 2
    val = lb * lb / torch.clamp(denom, min=1e-30)
    passes = (val >= x_p) & valid[None, :]

    any_pass = passes.any(dim=1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=q_proj.device)
    first_pass = torch.argmin(torch.where(passes, lb, inf), dim=1)
    best_val = torch.argmax(torch.where(valid[None, :], val, -inf), dim=1)
    chosen = torch.where(any_pass, first_pass, best_val)            # (B,)

    rep = table.rep_proj[chosen]                                    # (B, m)
    radius = torch.sqrt(((rep - q_proj) ** 2).sum(dim=-1))
    return table.rep_row[chosen], radius, any_pass
