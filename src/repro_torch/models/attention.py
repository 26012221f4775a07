"""GQA attention and the encoder-decoder's cross attention; port of
`repro.models.attention`.

The training and prefill path (`attention_train`) is the JAX package's
blockwise causal online softmax in plain torch ops, with the JAX
``custom_vjp`` backward as a `torch.autograd.Function` (`_FlashCore`); the
JAX package computes both in jnp with no Pallas kernel, so the port has no
kernel for them either. The decode path
(`flash_decode`) is `kernels.ops.decode_attention`: the hand-written CUDA
kernel on CUDA tensors, its plain version (the arithmetic of the JAX
`flash_decode`) elsewhere. Cross attention (`cross_attention`, over the
encoder K/V of `encode_kv`) is plain torch, as it is `jnp` in JAX.

Under a mesh context ``tp`` (`distributed.tensor_parallel`) the training
and prefill functions take this rank's pieces: ``wq`` / ``wk`` / ``wv``
column-parallel, ``wo`` row-parallel. Where a rank's ``wq`` columns are
whole heads it attends those heads ("heads" mode) over its own KV heads,
or, where its ``wk`` columns are less than a KV head (KH < model), over
the KV head its q heads share, picked from the gathered K/V. Where they
are not whole heads (H not a multiple of ``model``) q, k and v are
gathered and every rank attends every head, then keeps its rows of ``wo``
("whole" mode).

The decode step under a mesh context follows its cache's layout
(`sharding.KVLayout`, from `cache_specs`):

- KV heads over ``model``: this rank's q heads and KV heads, as training
  projects them; `ops.decode_attention` (the kernel) on its heads; ``wo``
  row-parallel.
- ``head_dim`` over ``model``: q, k and v projected whole (the q/k norms
  and RoPE need every depth), each rank keeps every head's dh slice. The
  scores are partial dots over that slice, summed over ``model``, then the
  softmax and P.V on the slice; the slices are gathered back to whole
  heads for ``wo``'s row pieces, which are heads-major. JAX computes this
  layout as GSPMD's partition of the jnp `flash_decode` (the scores'
  psum), with no Pallas kernel, so these are torch ops too
  (`_head_dim_piece`).
- the sequence over ``model``, over the data axes (context parallelism,
  with heads or dh over ``model``) or over both: each rank attends its
  piece of the positions, at the lengths ``clamp(len - first, 0, piece)``,
  through the kernel's log-sum-exp output, and the pieces are merged with
  a log-sum-exp rescale (`merge_pieces`). A piece with no position weighs
  exactly 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp_lib
from ..kernels import ops
from .layers import Leaf, apply_rope, init_tree, rms_norm

NEG_INF = -1e30


def attention_spec(cfg) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    spec = {"wq": Leaf((d, h * dh)), "wk": Leaf((d, kh * dh)),
            "wv": Leaf((d, kh * dh)),
            "wo": Leaf((h * dh, d), scale=(h * dh) ** -0.5)}
    if cfg.qk_norm:
        spec["q_norm"] = Leaf((dh,), ones=True)
        spec["k_norm"] = Leaf((dh,), ones=True)
    return spec


def init_attention(cfg, *, generator=None, device,
                   dtype=torch.float32) -> dict:
    return init_tree(attention_spec(cfg), generator=generator, device=device,
                     dtype=dtype)


def _mask_for(s, block, blk_idx, *, window: int, bidirectional: bool, device):
    q_pos = torch.arange(s, device=device)
    kv_pos = blk_idx * block + torch.arange(block, device=device)
    if bidirectional:
        return (kv_pos[None, :] < s).expand(s, block)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask & (kv_pos[None, :] < s)


def _kv_blocks(x, block):
    """(B, S, KH, dh) zero-padded to whole blocks: (B, nblk * block, KH, dh)."""
    pad = -(-x.shape[1] // block) * block - x.shape[1]
    return F.pad(x, (0, 0, 0, 0, 0, pad))


def _flash_fwd_impl(qf, k, v, window, bidirectional, block):
    """qf: (B, KH, G, S, dh) pre-scaled f32; k, v: (B, S, KH, dh) f32.
    Online-softmax forward over KV blocks; returns (out (B, KH, G, S, dh),
    lse (B, KH, G, S))."""
    b, kh, g, s, dh = qf.shape
    kf, vf = _kv_blocks(k, block), _kv_blocks(v, block)
    m = torch.full((b, kh, g, s), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros((b, kh, g, s), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((b, kh, g, s, dh), dtype=torch.float32, device=qf.device)
    for i in range(kf.shape[1] // block):
        k_blk = kf[:, i * block:(i + 1) * block]
        v_blk = vf[:, i * block:(i + 1) * block]
        scores = torch.einsum("bkgsd,btkd->bkgst", qf, k_blk)
        mask = _mask_for(s, block, i, window=window,
                         bidirectional=bidirectional, device=qf.device)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, v_blk)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def _flash_bwd_impl(qf, k, v, out, lse, d_out, window, bidirectional, block):
    """The JAX `_flash_bwd`: the scores recomputed block by block from
    (out, lse), so memory stays linear in S. Returns (dqf, dk, dv)."""
    s = qf.shape[3]
    kf, vf = _kv_blocks(k, block), _kv_blocks(v, block)
    delta = torch.sum(d_out * out, dim=-1)                  # (B, KH, G, S)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for i in range(kf.shape[1] // block):
        k_blk = kf[:, i * block:(i + 1) * block]
        v_blk = vf[:, i * block:(i + 1) * block]
        scores = torch.einsum("bkgsd,btkd->bkgst", qf, k_blk)
        mask = _mask_for(s, block, i, window=window,
                         bidirectional=bidirectional, device=qf.device)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        p = torch.exp(scores - lse[..., None])              # (B, KH, G, S, t)
        dvs.append(torch.einsum("bkgst,bkgsd->btkd", p, d_out))
        dp = torch.einsum("bkgsd,btkd->bkgst", d_out, v_blk)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bkgst,btkd->bkgsd", ds, k_blk)
        dks.append(torch.einsum("bkgst,bkgsd->btkd", ds, qf))
    return dq, torch.cat(dks, dim=1)[:, :s], torch.cat(dvs, dim=1)[:, :s]


class _FlashCore(torch.autograd.Function):
    """The JAX ``_flash_core`` custom_vjp: the forward keeps only (qf, k, v,
    out, lse) for the backward, which streams the KV blocks again. Autograd
    records neither block loop."""

    @staticmethod
    def forward(ctx, qf, k, v, window, bidirectional, block):
        out, lse = _flash_fwd_impl(qf, k, v, window, bidirectional, block)
        ctx.save_for_backward(qf, k, v, out, lse)
        ctx.cfg = (window, bidirectional, block)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        qf, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(qf, k, v, out, lse, d_out.contiguous(),
                                     *ctx.cfg)
        return dq, dk, dv, None, None, None


def _flash_causal(q, k, v, *, window: int = 0, block: int = 512,
                  bidirectional: bool = False):
    """Blockwise online-softmax attention, q (B, S, H, dh), k and v
    (B, S, KH, dh) -> (B, S, H, dh): the JAX `_flash_causal`, with K/V
    zero-padded to whole blocks and masked as there. Forward and backward
    both stream KV blocks (`_FlashCore`): activation memory is O(S)."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = (q.reshape(b, s, kh, g, dh) * dh ** -0.5).float().permute(0, 2, 3, 1, 4)
    out = _FlashCore.apply(qf, k.float(), v.float(), window, bidirectional,
                           block)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def _heads_mode(tp, cfg, params) -> bool:
    """Whether this rank's ``wq`` columns are whole q heads."""
    nq, dh = params["wq"].shape[-1], cfg.head_dim_
    return tp_lib.split(tp, nq, cfg.n_heads * dh) and nq % dh == 0


def _project_kv(tp, cfg, params, x, heads: bool):
    """K and V (B, S, KH', dh) of ``x`` (already past `copy_in`): this
    rank's KV heads in heads mode where ``wk``'s columns are whole KV heads,
    else every KV head (gathered under a split, whole on one process)."""
    b, s, _ = x.shape
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    nk = params["wk"].shape[-1]
    if heads and tp_lib.split(tp, nk, kh * dh) and nk % dh == 0:
        k = (x @ params["wk"]).reshape(b, s, nk // dh, dh)
        v = (x @ params["wv"]).reshape(b, s, nk // dh, dh)
    else:
        k = tp_lib.cols(tp, x, params["wk"], kh * dh).reshape(b, s, kh, dh)
        v = tp_lib.cols(tp, x, params["wv"], kh * dh).reshape(b, s, kh, dh)
    return k, v


def _pick_kv(tp, cfg, hl: int, k, v):
    """The KV heads this rank's ``hl`` q heads attend, where ``k`` / ``v``
    hold every KV head (heads mode with KH < model, or KH not split)."""
    if k.shape[2] != cfg.n_kv_heads:
        return k, v
    g = cfg.n_heads // cfg.n_kv_heads
    first = tp.rank * hl // g
    n = max(1, hl // g)
    return k[:, :, first:first + n], v[:, :, first:first + n]


def _project_qkv(params, cfg, x, positions, tp=None):
    """q, k, v (B, S, heads, dh) after the q/k norms and RoPE: q the heads
    this rank attends (its own in heads mode, every head in whole mode and
    on one process), k / v as `_project_kv`."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim_
    heads = _heads_mode(tp, cfg, params)
    x = tp_lib.copy_in(tp, x)
    if heads:
        q = (x @ params["wq"]).reshape(b, s, -1, dh)
    else:
        q = tp_lib.cols(tp, x, params["wq"], h * dh).reshape(b, s, h, dh)
    k, v = _project_kv(tp, cfg, params, x, heads)
    if cfg.qk_norm:
        qn, kn = tp_lib.copy_in(tp, params["q_norm"], params["k_norm"])
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_train(params, cfg, x, positions, *, bidirectional: bool = False,
                    tp=None):
    """Full (training / prefill) attention. x: (B, S, d) -> ((B, S, d),
    (k, v)). Under a mesh context ``tp``, (k, v) are this rank's KV heads
    where it holds whole ones, else every KV head."""
    q, k, v = _project_qkv(params, cfg, x, positions, tp)
    heads = _heads_mode(tp, cfg, params)
    window = cfg.window if cfg.attn == "swa" else 0
    kq, vq = _pick_kv(tp, cfg, q.shape[2], k, v) if heads else (k, v)
    out = _flash_causal(q, kq, vq, window=window, bidirectional=bidirectional)
    b, s = out.shape[:2]
    out = out.reshape(b, s, -1)
    if heads:
        return tp_lib.row(tp, out, params["wo"]), (k, v)
    return tp_lib.rows(tp, out, params["wo"], cfg.n_heads * cfg.head_dim_), (k, v)


def flash_decode(q, k_cache, v_cache, cache_len, *,
                 use_kernels: Optional[bool] = None, tp=None, layout=None):
    """One-token decode against the KV cache. q (B, H, dh); caches
    (B, S, KH, dh); cache_len (B,). Returns (B, H, dh). Runs
    `ops.decode_attention` (the kernel on CUDA tensors unless
    ``use_kernels`` is False).

    Under a mesh context ``tp`` with the cache in ``layout``
    (`sharding.KVLayout`), q and the caches are this rank's pieces
    (`decode_qkv`) and ``cache_len`` the whole sequence's lengths; returns
    this rank's heads under a heads split, else every head, whole."""
    b, h, dh = q.shape
    kh = k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, dh)
    if layout is None or (layout.split != "head_dim" and not layout.seq_axes):
        out = ops.decode_attention(qg, k_cache, v_cache, cache_len,
                                   use_kernels=use_kernels)
        return out.reshape(b, h, dh)
    s_loc = k_cache.shape[1]
    first = layout.seq_piece(tp.mesh, s_loc)
    lens = torch.clamp(cache_len - first, 0, s_loc).to(torch.int32)
    if layout.split == "head_dim":
        out, lse = _head_dim_piece(tp, qg, k_cache, v_cache, lens)
    else:
        out, lse = ops.decode_attention(qg, k_cache, v_cache, lens,
                                        use_kernels=use_kernels,
                                        return_lse=True)
    if layout.seq_axes:
        out = merge_pieces(tp, layout.seq_axes, out, lse)
    if layout.split == "head_dim":
        out = tp.all_gather(out.contiguous(), -1)
    # the pieces in f32 to here: one rounding to q's dtype, where the JAX
    # `flash_decode` rounds
    return out.reshape(b, h, -1).to(q.dtype)


def _head_dim_piece(tp, qg, k_cache, v_cache, lens):
    """Attention with every head's depths split over ``model``: qg
    (B, KH, G, dh / model), the caches (B, S, KH, dh / model), ``lens`` the
    valid positions of the piece. The scores' partial dots summed over
    ``model``, positions at or past ``lens`` masked with -1e30 as
    `flash_decode`'s; P.V on this rank's depths. Returns (out (B, KH, G,
    dh / model) f32, lse (B, KH, G), -inf where lens is 0)."""
    scale = (qg.shape[-1] * tp.size) ** -0.5
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float() * scale,
                          k_cache.float())
    scores = tp_lib.all_sum(tp, scores)
    mask = torch.arange(k_cache.shape[1], device=qg.device)[None, :] < lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float()) / torch.clamp(
        l, min=1e-30)[..., None]
    lse = torch.where((lens <= 0)[:, None, None], torch.full_like(m, -torch.inf),
                      m + torch.log(l))
    return out, lse


def merge_pieces(tp, axes, out, lse):
    """The attention over a sequence cut into pieces over the mesh
    ``axes``, from each rank's normalised ``out`` (..., dh) over its piece
    and the piece's ``lse`` (...): the pieces gathered (one collective) and
    added in piece order with weights exp(lse - max lse), so every rank
    holds the same result, in f32. A piece whose lse is -inf (no position
    of its own) weighs exactly 0."""
    both = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    both = tp.all_gather(both.contiguous(), 0, axes=axes)
    return combine_pieces(both[..., :-1], both[..., -1])


def combine_pieces(outs, lses):
    """The attention over the whole sequence from its pieces' normalised
    outputs ``outs`` (n, ..., dh) and log-sum-exps ``lses`` (n, ...), in
    piece order: sum_i w_i out_i / sum_i w_i with w_i = exp(lse_i - max_j
    lse_j). A piece with lse -inf weighs exactly 0 (no NaN: where every
    piece is empty the max is taken as 0 and the result is 0)."""
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)
    num = (w[..., None] * outs.float()).sum(dim=0)
    return num / torch.clamp(w.sum(dim=0), min=1e-30)[..., None]


def decode_qkv(params, cfg, x, positions, tp=None, layout=None):
    """This token's q (B, H', dh') and k, v (B, 1, KH', dh') after the
    q/k norms and RoPE, cut to this rank's piece of the cache's ``layout``
    (`sharding.KVLayout`): its q heads and KV heads under a heads split
    (`_project_qkv`), every head's dh slice under a head_dim split, every
    head whole where the sequence takes ``model``; whole on one
    process."""
    if layout is None or layout.split == "heads":
        q, k, v = _project_qkv(params, cfg, x, positions, tp)
        return q[:, 0], k, v
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x = tp_lib.copy_in(tp, x)
    q = tp_lib.cols(tp, x, params["wq"], h * dh).reshape(b, s, h, dh)
    k = tp_lib.cols(tp, x, params["wk"], kh * dh).reshape(b, s, kh, dh)
    v = tp_lib.cols(tp, x, params["wv"], kh * dh).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        qn, kn = tp_lib.copy_in(tp, params["q_norm"], params["k_norm"])
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if layout.split == "head_dim":
        part = tp.part(dh)
        q, k, v = q[..., part], k[..., part], v[..., part]
    return q[:, 0], k, v


def decode_out(params, cfg, att, tp=None, layout=None):
    """``att`` (B, H', dh) @ ``wo``: on one process the whole product,
    under a heads split this rank's heads against its rows (summed over
    ``model``), else every head against its rows of ``wo``
    (`tensor_parallel.rows`)."""
    y = att.reshape(att.shape[0], 1, -1)
    if layout is None:
        return y @ params["wo"]
    if layout.split == "heads":
        return tp_lib.row(tp, y, params["wo"])
    return tp_lib.rows(tp, y, params["wo"], cfg.n_heads * cfg.head_dim_)


def attention_decode(params, cfg, x, k_cache, v_cache, cache_len, *,
                     use_kernels: Optional[bool] = None):
    """Single-token decode. x: (B, 1, d); the caches already hold this
    token's K/V at position cache_len - 1."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim_
    positions = (cache_len - 1)[:, None]
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    out = flash_decode(q.reshape(b, h, dh), k_cache, v_cache, cache_len,
                       use_kernels=use_kernels)
    return out.reshape(b, 1, h * dh) @ params["wo"], (k_new, v_new)


def decode_kv(params, cfg, x, cache_len):
    """This token's K/V, for the cache write before attention."""
    positions = (cache_len - 1)[:, None]
    _, k_new, v_new = _project_qkv(params, cfg, x, positions)
    return k_new, v_new


def cross_attention(params, cfg, x, enc_k, enc_v, enc_len, tp=None):
    """Decoder -> encoder attention (whisper). x (B, S, d); enc_k, enc_v
    (B, T, KH, dh), the cached encoder K/V; enc_len (B,). Every target
    position attends the first ``enc_len`` encoder positions (no causal
    mask, no RoPE), as the JAX `cross_attention`: the scores in f32, K/V
    repeated over each KV head's G query heads. Under a mesh context
    ``tp``: this rank's pieces, and ``enc_k`` / ``enc_v`` from `encode_kv`
    under the same context."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    heads = _heads_mode(tp, cfg, params)
    x = tp_lib.copy_in(tp, x)
    q = ((x @ params["wq"]) if heads else tp_lib.cols(tp, x, params["wq"], h * dh)
         ).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(q, tp_lib.copy_in(tp, params["q_norm"]), cfg.norm_eps)
    g = h // kh
    k = enc_k.float().repeat_interleave(g, dim=2)
    v = enc_v.float().repeat_interleave(g, dim=2)
    if heads:
        # the einsums below contract the KV head axis too (the JAX
        # `cross_attention`'s): a rank adds the KV heads it holds and the
        # sums go over ``model``
        k, v = k.sum(dim=2, keepdim=True), v.sum(dim=2, keepdim=True)
        if enc_k.shape[2] != kh:
            k, v = tp_lib.all_sum(tp, k), tp_lib.all_sum(tp, v)
        h = q.shape[2]
    scores = torch.einsum("bshd,btkd->bhst", q.float() * dh ** -0.5, k)
    mask = (torch.arange(enc_k.shape[1], device=x.device)[None, :]
            < enc_len[:, None])
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,btkd->bshd", w, v)
    out = out.reshape(b, s, h * dh).to(x.dtype)
    if heads:
        return tp_lib.row(tp, out, params["wo"])
    return tp_lib.rows(tp, out, params["wo"], cfg.n_heads * dh)


def encode_kv(params, cfg, enc_out, tp=None):
    """The encoder output's K/V for cross attention, (B, T, KH, dh) each;
    under a mesh context ``tp``, `_project_kv`'s heads."""
    k, v = _project_kv(tp, cfg, params, tp_lib.copy_in(tp, enc_out),
                       _heads_mode(tp, cfg, params))
    if cfg.qk_norm:
        k = rms_norm(k, tp_lib.copy_in(tp, params["k_norm"]), cfg.norm_eps)
    return k, v


__all__ = ["attention_decode", "attention_spec", "attention_train",
           "combine_pieces", "cross_attention", "decode_kv", "decode_out",
           "decode_qkv",
           "encode_kv", "flash_decode", "init_attention", "merge_pieces"]
