"""The dense decoder (``block_pattern == "attn"`` without MoE); port of the
serving half of `repro.models.transformer`: `init_params`, `prefill`,
`init_cache` and `decode_step`.

Parameters are the JAX package's pytree as a dict of tensors: ``embed``
(vocab_padded, d), ``final_norm`` (d,), ``unembed`` (d, vocab_padded) when
the embeddings are untied, and ``blocks`` with every leaf stacked along a
leading layer axis (``ln1``, ``ln2``, ``attn``: ``wq wk wv wo``, ``mlp``:
``w_gate w_up w_down``). The layers run as a Python loop where JAX scans.

The cache is ``{"len": (B,) int32, "k", "v": (L, B, max_len, KH, dh)}``, as
in JAX. Unlike JAX's functional update, `decode_step` writes the new K/V
and lengths into the cache tensors in place (no copy of the whole cache per
step) and returns the same dict, so the three tensors never change
identity and a CUDA graph captured over them stays valid. Other block
patterns, MoE and modality frontends raise `NotImplementedError` (ROADMAP
Queue 1 item 12).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.index import resolve_device
from . import attention as attn_lib
from .layers import apply_mlp, dense_init, init_mlp, rms_norm

MASKED = -1e30   # logits of the vocab padding rows


def check_supported(cfg) -> None:
    if cfg.block_pattern != "attn" or cfg.moe is not None or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention decoder is ported (block "
            f"pattern {cfg.block_pattern!r}, moe {cfg.moe is not None}, "
            f"frontend {cfg.frontend!r}); the rest is ROADMAP Queue 1 item 12")


def _stacked(n: int, fn):
    """The trees ``fn()`` of ``n`` layers, each leaf stacked along a new
    leading axis (the JAX package's ``_stack_init`` layout)."""
    return _stack([fn() for _ in range(n)])


def _stack(trees):
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def init_params(cfg, *, generator: Optional[torch.Generator] = None,
                seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Random parameters on ``device`` from ``generator`` (a new one seeded
    with ``seed`` on ``device`` when None): truncated-normal fan-in weights,
    unit norms, the embedding at scale 0.02, as the JAX `init_params`."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    kw = dict(generator=generator, device=dev, dtype=dtype)
    vp, d = cfg.vocab_padded, cfg.d_model
    params = {
        "embed": dense_init((vp, d), scale=0.02, **kw),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((d, vp), **kw)

    def block():
        return {"ln1": torch.ones((d,), dtype=dtype, device=dev),
                "ln2": torch.ones((d,), dtype=dtype, device=dev),
                "attn": attn_lib.init_attention(cfg, **kw),
                "mlp": init_mlp(d, cfg.d_ff, **kw)}

    params["blocks"] = _stacked(cfg.n_layers, block)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


def _logits(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, MASKED)
    return logits


def _attn_backbone(params, cfg, x, positions, *, collect_kv: bool = False):
    """The attention blocks over a whole sequence. Returns (x, kv) with kv
    the stacked (L, B, S, KH, dh) keys and values when ``collect_kv``."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        h, (k, v) = attn_lib.attention_train(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), positions)
        x = x + h
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
               device="cuda") -> dict:
    check_supported(cfg)
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    kv_len = min(max_len, cfg.window) if cfg.attn == "swa" else max_len
    k = torch.zeros((cfg.n_layers, batch_size, kv_len, kh, dh), dtype=dtype,
                    device=device)
    return {"len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
            "k": k, "v": torch.zeros_like(k)}


def _write_kv(cache_k, k_new, pos):
    """Write one token's K/V at each sequence's position, in place.
    cache (B, S, KH, dh), k_new (B, 1, KH, dh), pos (B,). A position past
    the cache is clamped to its last row, as `lax.dynamic_update_slice`
    clamps the start index."""
    pos = torch.clamp(pos.long(), 0, cache_k.shape[1] - 1)
    cache_k[torch.arange(cache_k.shape[0], device=cache_k.device), pos] = (
        k_new[:, 0].to(cache_k.dtype))


def decode_step(params, cfg, cache, token, *, return_hidden: bool = False,
                use_kernels: Optional[bool] = None):
    """token: (B, 1) int. Returns (logits (B, vocab_padded) f32, cache); with
    ``return_hidden`` the post-norm hidden state (B, d) instead of logits
    (what the ProMIPS logit search queries). ``use_kernels`` goes to
    `ops.decode_attention` (None: the kernel on CUDA tensors)."""
    check_supported(cfg)
    x = params["embed"][token.long()]                           # (B, 1, d)
    b = x.shape[0]
    new_len = cache["len"] + 1
    kv_len = cache["k"].shape[2]
    pos_write = new_len - 1
    if cfg.attn == "swa":
        pos_write = pos_write % kv_len
    att_len = torch.clamp(new_len, max=kv_len)
    positions = (new_len - 1)[:, None]
    for i in range(cfg.n_layers):
        lp = _layer(params["blocks"], i)
        kc, vc = cache["k"][i], cache["v"][i]
        h_in = rms_norm(x, lp["ln1"], cfg.norm_eps)
        # q, k and v of this token in one projection: the JAX decode_step
        # projects q again after `decode_kv`, to the same values
        q, k_new, v_new = attn_lib._project_qkv(lp["attn"], cfg, h_in,
                                                positions)
        _write_kv(kc, k_new, pos_write)
        _write_kv(vc, v_new, pos_write)
        att = attn_lib.flash_decode(q[:, 0], kc, vc, att_len,
                                    use_kernels=use_kernels)
        x = x + att.reshape(b, 1, -1) @ lp["attn"]["wo"]
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    cache["len"].copy_(new_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x[:, 0], cache
    return _logits(params, cfg, x)[:, 0], cache


def prefill(params, cfg, batch, max_len: int):
    """Run the whole prompt, build the cache (K/V sized to ``max_len``) and
    return (cache, last-position logits (B, vocab_padded)). batch: tokens
    (B, S)."""
    check_supported(cfg)
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    dtype = params["embed"].dtype
    kv_len = min(max_len, cfg.window) if cfg.attn == "swa" else max_len
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x, (ks, vs) = _attn_backbone(params, cfg, x, positions, collect_kv=True)
    if s > kv_len:
        ks, vs = ks[:, :, -kv_len:], vs[:, :, -kv_len:]
    else:
        ks = F.pad(ks, (0, 0, 0, 0, 0, kv_len - s))
        vs = F.pad(vs, (0, 0, 0, 0, 0, kv_len - s))
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=tokens.device),
             "k": ks.to(dtype).contiguous(), "v": vs.to(dtype).contiguous()}
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return cache, _logits(params, cfg, x)[:, 0]


__all__ = ["check_supported", "decode_step", "init_cache", "init_params",
           "prefill"]
