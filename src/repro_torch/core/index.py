"""ProMIPS index: the build product tying together projections, Quick-Probe
groups, the iDistance layout and the block sketch; port of
`repro.core.index`.

`build_index` is host numpy and gives the JAX package's arrays bit for bit
for the same input and seed. `to_device` turns them into tensors on one
device. Row-indexed arrays are padded to a multiple of ``page_rows``;
padding rows carry id -1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .chi2 import chi2_ppf_host
from .dim_opt import optimized_projected_dimension
from .idistance import IDistanceLayout, build_idistance
from .projections import make_projection, project
from .quick_probe import GroupTable, build_group_table, pack_codes_np
from .sketch import build_block_sketch, pick_subspaces


class IndexArrays(NamedTuple):
    """Index arrays (numpy on host, tensors after `to_device`). Leading dims:
    n_pad rows, G groups, S sub-partitions, NB = n_pad / page_rows blocks."""

    a: object             # (d, m) projection matrix
    x: object             # (n_pad, d) original points, sorted layout
    p: object             # (n_pad, m) projected points, sorted layout
    ids: object           # (n_pad,) original row ids (-1 = padding)
    l2sq: object          # (n_pad,) squared 2-norms (0 for padding)
    max_l2sq: object      # () ||o_M||^2
    g_code: object        # (G,) uint32 on host, int64 as a tensor
    g_min_l1: object      # (G,)
    g_rep_proj: object    # (G, m)
    g_rep_row: object     # (G,)
    g_count: object       # (G,)
    sp_center: object     # (S, m)
    sp_radius: object     # (S,)
    sp_start: object      # (S+1,) row offsets into the sorted layout
    sp_max_l2sq: object   # (S,) max ||o||^2 per sub-partition
    block_sp_lo: object   # (NB,) first sub-partition overlapping each block
    block_sp_hi: object   # (NB,) one-past-last sub-partition of each block
    block_max_l2sq: object  # (NB,) max ||o||^2 over the block's sub-partitions
    block_sp_idx: object  # (NB, KMAX) sub-partitions per block (-1 pad)
    sk_mu: object         # (NB, d) PQ-decoded block centroids
    sk_codebooks: object  # (M_sk, K_sk, d/M_sk) sketch PQ codebooks
    sk_codes: object      # (NB, M_sk) int32 sketch PQ codes
    sk_err: object        # (NB,) max ||o_r - mu~_b|| over valid rows


@dataclass(frozen=True)
class IndexMeta:
    n: int
    d: int
    m: int
    c: float
    p: float
    x_p: float               # Psi_m^{-1}(p), static threshold
    page_rows: int
    page_bytes: int
    n_pad: int
    n_blocks: int
    n_groups: int
    n_subparts: int
    k_p: int
    n_key: int
    k_sp: int
    seed: int
    norm_strata: int = 1
    sk_subspaces: int = 0    # sketch PQ subspaces (0 = index has no sketch)
    sk_codewords: int = 0    # sketch PQ codewords per subspace
    max_probe_groups: Optional[int] = None


class ProMIPSIndex(NamedTuple):
    arrays: IndexArrays
    meta: IndexMeta
    layout: Optional[IDistanceLayout]  # host-only build product


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    asking for it on a machine without a card raises instead of falling
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _stratified_layout(x, p_pts, k_p, n_key, k_sp, seed, norm_strata):
    """Build the iDistance layout per norm-quantile stratum so sub-partitions
    are norm-homogeneous. ``norm_strata=1`` is the paper's partition."""
    if norm_strata <= 1:
        return build_idistance(p_pts, k_p=k_p, n_key=n_key, k_sp=k_sp, seed=seed)
    norms = np.linalg.norm(x, axis=1)
    edges = np.quantile(norms, np.linspace(0, 1, norm_strata + 1)[1:-1])
    strat = np.searchsorted(edges, norms)
    perms, centers, radii, sp_c, sp_r, sp_k, sp_p, sizes, keys = ([] for _ in range(9))
    key_base = 0
    eps_acc, c_key_max = [], 1
    for s in range(norm_strata):
        rows = np.nonzero(strat == s)[0]
        if len(rows) == 0:
            continue
        lay = build_idistance(p_pts[rows], k_p=k_p, n_key=n_key, k_sp=k_sp, seed=seed + s)
        perms.append(rows[lay.perm])
        centers.append(lay.part_center)
        radii.append(lay.part_radius)
        sp_c.append(lay.sp_center)
        sp_r.append(lay.sp_radius)
        sp_k.append(lay.sp_key + key_base)
        sp_p.append(lay.sp_part + len(np.concatenate(centers)) - lay.part_center.shape[0])
        sizes.append(np.diff(lay.sp_start))
        keys.append(lay.keys + key_base)
        key_base += int(lay.sp_key.max()) + 2 if len(lay.sp_key) else 1
        eps_acc.append(lay.eps)
        c_key_max = max(c_key_max, lay.c_key)
    sp_start = np.concatenate([[0], np.cumsum(np.concatenate(sizes))]).astype(np.int64)
    return IDistanceLayout(
        perm=np.concatenate(perms).astype(np.int64),
        part_center=np.concatenate(centers),
        part_radius=np.concatenate(radii),
        eps=float(np.mean(eps_acc)),
        c_key=c_key_max,
        keys=np.concatenate(keys),
        sp_center=np.concatenate(sp_c),
        sp_radius=np.concatenate(sp_r),
        sp_start=sp_start,
        sp_key=np.concatenate(sp_k),
        sp_part=np.concatenate(sp_p),
    )


def build_index(
    x: np.ndarray,
    *,
    m: Optional[int] = None,
    c: float = 0.9,
    p: float = 0.5,
    k_p: int = 5,
    n_key: int = 40,
    k_sp: int = 10,
    page_bytes: int = 4096,
    seed: int = 0,
    norm_strata: int = 1,
    max_probe_groups: Optional[int] = None,
) -> ProMIPSIndex:
    """Pre-process (paper Fig. 2 left box + Algorithm 4) on the host.

    x: (n, d) float32 data points. Returns numpy arrays; `to_device` ships
    them. ``norm_strata > 1`` enables the norm-stratified layout;
    ``max_probe_groups`` caps the Quick-Probe group table.
    """
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if m is None:
        m = optimized_projected_dimension(n)
    m = int(min(m, 30))

    a = make_projection(d, m, seed=seed)
    p_pts = project(x, a).astype(np.float32)

    layout = _stratified_layout(x, p_pts, k_p, n_key, k_sp, seed, norm_strata)
    perm = layout.perm
    xs, ps = x[perm], p_pts[perm]
    l1 = np.abs(xs).sum(axis=1).astype(np.float32)
    l2sq = (xs * xs).sum(axis=1).astype(np.float32)

    codes = pack_codes_np(ps)
    groups: GroupTable = build_group_table(codes, l1, ps,
                                           max_groups=max_probe_groups)

    page_rows = max(1, page_bytes // (4 * d))
    n_pad = int(math.ceil(n / page_rows)) * page_rows
    n_blocks = n_pad // page_rows

    def pad_rows(arr, fill=0):
        pad = n_pad - n
        if pad == 0:
            return arr
        width = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, width, constant_values=fill)

    sp_start = layout.sp_start
    n_sp = len(layout.sp_radius)
    sp_max_l2sq = np.asarray(
        [l2sq[sp_start[s]:sp_start[s + 1]].max() for s in range(n_sp)], np.float32
    )
    block_lo = np.searchsorted(sp_start, np.arange(n_blocks) * page_rows, side="right") - 1
    last_row = np.minimum((np.arange(n_blocks) + 1) * page_rows, n) - 1
    block_hi = np.searchsorted(sp_start, last_row, side="right")
    block_lo = np.clip(block_lo, 0, len(sp_start) - 2)
    block_hi = np.clip(block_hi, block_lo + 1, len(sp_start) - 1)
    kmax = int((block_hi - block_lo).max())
    block_sp_idx = np.full((n_blocks, kmax), -1, np.int32)
    block_max_l2sq = np.zeros(n_blocks, np.float32)
    for b in range(n_blocks):
        sps = np.arange(block_lo[b], block_hi[b])
        block_sp_idx[b, : len(sps)] = sps
        block_max_l2sq[b] = sp_max_l2sq[sps].max()

    sk_subspaces = pick_subspaces(d, target=16)
    sk_codewords = min(256, n_blocks)
    sk_mu, sk_codebooks, sk_codes, sk_err = build_block_sketch(
        pad_rows(xs), pad_rows(perm.astype(np.int32), fill=-1), page_rows,
        sk_subspaces, sk_codewords, seed=seed)

    arrays = IndexArrays(
        a=a,
        x=pad_rows(xs),
        p=pad_rows(ps),
        ids=pad_rows(perm.astype(np.int32), fill=-1),
        l2sq=pad_rows(l2sq),
        max_l2sq=np.float32(l2sq.max()),
        g_code=groups.code,
        g_min_l1=groups.min_l1,
        g_rep_proj=groups.rep_proj,
        g_rep_row=groups.rep_row,
        g_count=groups.count,
        sp_center=layout.sp_center,
        sp_radius=layout.sp_radius,
        sp_start=sp_start.astype(np.int32),
        sp_max_l2sq=sp_max_l2sq,
        block_sp_lo=block_lo.astype(np.int32),
        block_sp_hi=block_hi.astype(np.int32),
        block_max_l2sq=block_max_l2sq,
        block_sp_idx=block_sp_idx,
        sk_mu=sk_mu,
        sk_codebooks=sk_codebooks,
        sk_codes=sk_codes,
        sk_err=sk_err,
    )
    meta = IndexMeta(
        n=n, d=d, m=m, c=c, p=p,
        x_p=chi2_ppf_host(p, m),
        page_rows=page_rows, page_bytes=page_bytes,
        n_pad=n_pad, n_blocks=n_blocks,
        n_groups=len(groups.code), n_subparts=len(layout.sp_radius),
        k_p=k_p, n_key=n_key, k_sp=k_sp, seed=seed, norm_strata=norm_strata,
        sk_subspaces=sk_subspaces, sk_codewords=sk_codewords,
        max_probe_groups=max_probe_groups,
    )
    return ProMIPSIndex(arrays=arrays, meta=meta, layout=layout)


def to_device(arrays: IndexArrays, device) -> IndexArrays:
    """Numpy index arrays -> tensors on ``device``.

    Float arrays stay float32 and integer arrays int32, except the group
    codes, which become int64 (the XOR/shift arithmetic of Quick-Probe).
    Raises on sketch codes outside the codebooks: the sketch kernel indexes
    its table with them unchecked.
    """
    dev = resolve_device(device)
    codes = np.asarray(arrays.sk_codes)
    n_codewords = np.asarray(arrays.sk_codebooks).shape[1]
    if codes.size and (codes.min() < 0 or codes.max() >= n_codewords):
        raise ValueError(f"sk_codes outside [0, {n_codewords})")
    out = {}
    for name, arr in zip(IndexArrays._fields, arrays):
        arr = np.asarray(arr)
        if name == "g_code":
            arr = arr.astype(np.int64)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        out[name] = torch.from_numpy(np.array(arr, order="C")).to(dev)
    return IndexArrays(**out)
