"""GQA attention; port of `repro.models.attention` for the dense decoder.

The prefill path (`attention_train`) is the JAX package's blockwise causal
online softmax in plain torch ops; the JAX package computes it in jnp with
no Pallas kernel, so the port has no kernel for it either. The decode path
(`flash_decode`) is `kernels.ops.decode_attention`: the hand-written CUDA
kernel on CUDA tensors, its plain version (the arithmetic of the JAX
`flash_decode`) elsewhere.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def init_attention(cfg, *, generator=None, device,
                   dtype=torch.float32) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kw = dict(generator=generator, device=device, dtype=dtype)
    params = {
        "wq": dense_init((d, h * dh), **kw),
        "wk": dense_init((d, kh * dh), **kw),
        "wv": dense_init((d, kh * dh), **kw),
        "wo": dense_init((h * dh, d), scale=(h * dh) ** -0.5, **kw),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((dh,), dtype=dtype, device=device)
        params["k_norm"] = torch.ones((dh,), dtype=dtype, device=device)
    return params


def _project_qkv(params, cfg, x, positions):
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kh, dh)
    v = (x @ params["wv"]).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_for(s, block, blk_idx, *, window: int, bidirectional: bool, device):
    q_pos = torch.arange(s, device=device)
    kv_pos = blk_idx * block + torch.arange(block, device=device)
    if bidirectional:
        return (kv_pos[None, :] < s).expand(s, block)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask & (kv_pos[None, :] < s)


def _flash_causal(q, k, v, *, window: int = 0, block: int = 512,
                  bidirectional: bool = False):
    """Blockwise online-softmax attention, q (B, S, H, dh), k and v
    (B, S, KH, dh) -> (B, S, H, dh): the JAX `_flash_causal` forward, with
    K/V zero-padded to whole blocks and masked as there."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = (q.reshape(b, s, kh, g, dh) * dh ** -0.5).float().permute(0, 2, 3, 1, 4)
    nblk = -(-s // block)
    pad = nblk * block - s
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pad))
    m = torch.full((b, kh, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, s, dh), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        k_blk = kf[:, i * block:(i + 1) * block]
        v_blk = vf[:, i * block:(i + 1) * block]
        scores = torch.einsum("bkgsd,btkd->bkgst", qf, k_blk)
        mask = _mask_for(s, block, i, window=window,
                         bidirectional=bidirectional, device=q.device)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def attention_train(params, cfg, x, positions, *, bidirectional: bool = False):
    """Full (prefill) attention. x: (B, S, d) -> ((B, S, d), (k, v))."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    window = cfg.window if cfg.attn == "swa" else 0
    out = _flash_causal(q, k, v, window=window, bidirectional=bidirectional)
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ params["wo"], (k, v)


def flash_decode(q, k_cache, v_cache, cache_len, *,
                 use_kernels: Optional[bool] = None):
    """One-token decode against the KV cache. q (B, H, dh); caches
    (B, S, KH, dh); cache_len (B,). Returns (B, H, dh). Runs
    `ops.decode_attention` (the kernel on CUDA tensors unless
    ``use_kernels`` is False)."""
    b, h, dh = q.shape
    kh = k_cache.shape[2]
    out = ops.decode_attention(q.reshape(b, kh, h // kh, dh), k_cache, v_cache,
                               cache_len, use_kernels=use_kernels)
    return out.reshape(b, h, dh)


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


__all__ = ["attention_decode", "attention_train", "decode_kv", "flash_decode",
           "init_attention"]
