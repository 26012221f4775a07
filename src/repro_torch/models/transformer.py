"""The attention-block models; port of `repro.models.transformer` for the
``"attn"`` block pattern (dense, MoE, the vision-stub frontend) and the
``"encdec"`` one (whisper's encoder-decoder with its audio-stub frontend):
`init_params`, the training loss (`loss_fn`, `cross_entropy`, the remat
policies), `prefill`, `init_cache` and `decode_step`.

Parameters are the JAX package's pytree as a dict of tensors: ``embed``
(vocab_padded, d), ``final_norm`` (d,), ``unembed`` (d, vocab_padded) when
the embeddings are untied, ``frontend_proj`` (d, d) with a frontend, and
``blocks`` with every leaf stacked along a leading layer axis (``ln1``,
``ln2``, ``attn``: ``wq wk wv wo``; ``mlp``: ``w_gate w_up w_down``, or
``moe``: ``router w_gate w_up w_down`` and ``shared``; the decoder of an
encoder-decoder adds ``ln_x`` and ``xattn``). An encoder-decoder also has
``enc_blocks`` and ``enc_norm``. The layers run as a Python loop where JAX
scans.

The cache is ``{"len": (B,) int32, "k", "v": (L, B, max_len, KH, dh)}``, as
in JAX; an encoder-decoder's adds the encoder K/V ``xk``, ``xv`` (L, B,
frontend_len, KH, dh) and ``enc_len`` (B,). Unlike JAX's functional update,
`decode_step` writes the new K/V and lengths into the cache tensors in
place (no copy of the whole cache per step) and returns the same dict, so
its tensors never change identity and a CUDA graph captured over them stays
valid. The recurrent block patterns (``xlstm_7_1``, ``zamba2``) raise
`NotImplementedError` (ROADMAP Queue 1 item 12).

`loss_fn` runs the layers on `torch.unbind` views of the stacked leaves,
so the backward stacks each leaf's layer gradients once (the JAX scan's
transpose) instead of adding a full-size gradient per layer.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.index import resolve_device
from . import attention as attn_lib
from . import moe as moe_lib
from .layers import Leaf, apply_mlp, init_tree, mlp_spec, rms_norm

MASKED = -1e30   # logits of the vocab padding rows
PATTERNS = ("attn", "encdec")


def check_supported(cfg) -> None:
    if cfg.block_pattern not in PATTERNS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.block_pattern!r} block pattern is not "
            f"ported; the port runs {PATTERNS} (dense, MoE, vision and "
            f"encoder-decoder models); the recurrent xlstm_7_1 and zamba2 "
            f"families are ROADMAP Queue 1 item 12")


def _block_spec(cfg, *, cross: bool = False) -> dict:
    """One layer's leaves, in draw order: the norms, attention, then the
    MLP or the MoE; a decoder layer of an encoder-decoder adds ``ln_x`` and
    the cross attention."""
    d = cfg.d_model
    spec = {"ln1": Leaf((d,), ones=True), "ln2": Leaf((d,), ones=True),
            "attn": attn_lib.attention_spec(cfg)}
    if cfg.moe is not None:
        spec["moe"] = moe_lib.moe_spec(cfg)
    else:
        spec["mlp"] = mlp_spec(d, cfg.d_ff)
    if cross:
        spec["ln_x"] = Leaf((d,), ones=True)
        spec["xattn"] = attn_lib.attention_spec(cfg)
    return spec


class Stacked(NamedTuple):
    """A spec's layer stack: ``n`` layers of the leaves of ``spec``."""
    n: int
    spec: dict


def param_spec(cfg) -> dict:
    """The parameter tree as `Leaf` specs, in draw order: the embedding, the
    final norm, the unembedding when untied, ``frontend_proj`` with a
    frontend, then the stacks (`Stacked`): ``enc_blocks`` and ``enc_norm``
    of an encoder-decoder, and ``blocks``."""
    vp, d = cfg.vocab_padded, cfg.d_model
    spec = {"embed": Leaf((vp, d), scale=0.02),
            "final_norm": Leaf((d,), ones=True)}
    if not cfg.tie_embeddings:
        spec["unembed"] = Leaf((d, vp))
    if cfg.frontend != "none":
        spec["frontend_proj"] = Leaf((d, d))
    if cfg.block_pattern == "encdec":
        spec["enc_blocks"] = Stacked(cfg.enc_layers, _block_spec(cfg))
        spec["enc_norm"] = Leaf((d,), ones=True)
        spec["blocks"] = Stacked(cfg.n_layers, _block_spec(cfg, cross=True))
    else:
        spec["blocks"] = Stacked(cfg.n_layers, _block_spec(cfg))
    return spec


def init_params(cfg, *, generator: Optional[torch.Generator] = None,
                seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Random parameters on ``device`` from ``generator`` (a new one seeded
    with ``seed`` on ``device`` when None): truncated-normal fan-in weights,
    unit norms, the embedding at scale 0.02, as the JAX `init_params`. Each
    stacked leaf is allocated once and filled layer by layer
    (`layers.init_tree`), so the peak is the parameters' bytes."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    kw = dict(generator=generator, device=dev, dtype=dtype)
    params = {}
    for key, node in param_spec(cfg).items():
        if isinstance(node, Stacked):
            params[key] = init_tree(node.spec, n=node.n, **kw)
        else:
            params[key] = init_tree(node, **kw)
    return params


def _logits(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, MASKED)
    return logits


def cross_entropy(logits, labels):
    """Stable CE with label -1 = ignore. logits (..., V) f32, labels (...,)."""
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = torch.where(valid, lse - ll, torch.zeros_like(lse))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of the 2-D matmuls (the weight GEMMs), recompute
    the rest: `checkpoint_dots_with_no_batch_dims`. The attention einsums
    are batched (``aten.bmm``) and are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, policy: Optional[str]):
    if policy in (None, "none"):
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(policy)


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked parameter tree, each leaf split with
    `torch.unbind` (views, no copy; under autograd the backward stacks the
    layer gradients once)."""
    if isinstance(tree, dict):
        parts = {key: _unstack(val, n) for key, val in tree.items()}
        return [{key: parts[key][i] for key in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _ffn(lp, cfg, x):
    """The layer's MLP or MoE on the normed ``x``: (h, aux or None)."""
    h_in = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None and "moe" in lp:
        return moe_lib.apply_moe(lp["moe"], cfg, h_in,
                                 capacity_factor=cfg.moe.capacity_factor)
    return apply_mlp(lp["mlp"], h_in), None


def _attn_backbone(params, cfg, x, positions, *, remat="full",
                   bidirectional: bool = False, collect_kv: bool = False,
                   blocks_key: str = "blocks"):
    """The attention blocks of ``params[blocks_key]`` over a whole
    sequence, each under the ``remat`` policy. Returns (x, aux, kv): aux the
    sum of the MoE layers' load-balance losses (0 without MoE), kv the
    stacked (L, B, S, KH, dh) keys and values when ``collect_kv``."""

    def block(x, aux, lp):
        h, kv = attn_lib.attention_train(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
            bidirectional=bidirectional)
        x = x + h
        h, a = _ffn(lp, cfg, x)
        if a is not None:
            aux = aux + a
        return x + h, aux, (kv if collect_kv else None)

    step = _maybe_remat(block, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    blocks = params[blocks_key]
    for lp in _unstack(blocks, blocks["ln1"].shape[0]):
        x, aux, kv = step(x, aux, lp)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, aux, kv


FRONTEND_KEYS = {"vision": "patches", "audio": "frames"}


def frontend_key(cfg) -> Optional[str]:
    """The batch key of the config's frontend input (None without one)."""
    return FRONTEND_KEYS.get(cfg.frontend)


def stub_inputs(cfg, b: int, *, device, dtype=torch.float32) -> dict:
    """The frontend's zero input for ``b`` rows, as the JAX engine passes
    it: (b, frontend_len, d) zeros under `frontend_key`; {} without a
    frontend."""
    key = frontend_key(cfg)
    if key is None:
        return {}
    return {key: torch.zeros((b, cfg.frontend_len, cfg.d_model), dtype=dtype,
                             device=device)}


def _embed_inputs(params, cfg, batch):
    """Token embedding, with the vision stub's projected patches prepended.
    Returns (x, label_offset). `F.embedding`, not advanced indexing: its
    CUDA backward is deterministic (`chip_smoke.py` phase 12b runs two
    identical steps)."""
    x = F.embedding(batch["tokens"].long(), params["embed"])
    if cfg.frontend == "vision":
        patches = batch["patches"] @ params["frontend_proj"]
        return torch.cat([patches.to(x.dtype), x], dim=1), cfg.frontend_len
    return x, 0


def loss_fn(params, cfg, batch, *, remat: str = "full"):
    """batch: tokens (B, S) int, labels (B, S) int (-1 ignored), plus
    patches (B, F, d) for the vision stub or frames (B, F, d) for the
    encoder-decoder, tensors on the parameters' device. Returns
    (loss + 0.01 * aux, {"loss", "aux"})."""
    check_supported(cfg)
    if cfg.block_pattern == "encdec":
        return _loss_encdec(params, cfg, batch, remat=remat)
    x, offset = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux, _ = _attn_backbone(params, cfg, x, positions, remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if offset:
        x = x[:, offset:]
    loss = cross_entropy(_logits(params, cfg, x), batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def _encode(params, cfg, frames, remat):
    """The encoder over the projected frames: (B, F, d) after ``enc_norm``."""
    frames = frames @ params["frontend_proj"]
    b, f, _ = frames.shape
    enc_pos = torch.arange(f, device=frames.device).expand(b, f)
    enc, _, _ = _attn_backbone(params, cfg, frames, enc_pos, remat=remat,
                               bidirectional=True, blocks_key="enc_blocks")
    return rms_norm(enc, params["enc_norm"], cfg.norm_eps)


def _loss_encdec(params, cfg, batch, *, remat="full"):
    enc = _encode(params, cfg, batch["frames"], remat)
    b, f, _ = enc.shape
    enc_len = torch.full((b,), f, dtype=torch.int32, device=enc.device)
    x = F.embedding(batch["tokens"].long(), params["embed"])
    s = x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def block(x, enc, lp):
        h, _ = attn_lib.attention_train(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), positions)
        x = x + h
        x = x + attn_lib.cross_attention(
            lp["xattn"], cfg, rms_norm(x, lp["ln_x"], cfg.norm_eps),
            *attn_lib.encode_kv(lp["xattn"], cfg, enc), enc_len)
        return x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))

    step = _maybe_remat(block, remat)
    for lp in _unstack(params["blocks"], cfg.n_layers):
        x = step(x, enc, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = cross_entropy(_logits(params, cfg, x), batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss, {"loss": loss, "aux": aux}


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
               device="cuda") -> dict:
    check_supported(cfg)
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    kv_len = min(max_len, cfg.window) if cfg.attn == "swa" else max_len
    k = torch.zeros((cfg.n_layers, batch_size, kv_len, kh, dh), dtype=dtype,
                    device=device)
    cache = {"len": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device),
             "k": k, "v": torch.zeros_like(k)}
    if cfg.block_pattern == "encdec":
        xk = torch.zeros((cfg.n_layers, batch_size, cfg.frontend_len, kh, dh),
                         dtype=dtype, device=device)
        cache.update(xk=xk, xv=torch.zeros_like(xk),
                     enc_len=torch.zeros((batch_size,), dtype=torch.int32,
                                         device=device))
    return cache


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
    `ops.decode_attention` (None: the kernel on CUDA tensors). An
    encoder-decoder's layers also attend the cached encoder K/V."""
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
    encdec = cfg.block_pattern == "encdec"
    for i, lp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
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
        if encdec:
            x = x + attn_lib.cross_attention(
                lp["xattn"], cfg, rms_norm(x, lp["ln_x"], cfg.norm_eps),
                cache["xk"][i], cache["xv"][i], cache["enc_len"])
        x = x + _ffn(lp, cfg, x)[0]
    cache["len"].copy_(new_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x[:, 0], cache
    return _logits(params, cfg, x)[:, 0], cache


def prefill(params, cfg, batch, max_len: int):
    """Run the whole prompt, build the cache (K/V sized to ``max_len``) and
    return (cache, last-position logits (B, vocab_padded)). batch: tokens
    (B, S), plus patches (B, F, d) for the vision stub (the cache then holds
    F + S positions) or frames (B, F, d) for an encoder-decoder, whose
    prefill runs the encoder only, as in JAX: the cache gets the encoder
    K/V and length 0, and the logits are those of the last encoder
    position."""
    check_supported(cfg)
    tokens = batch["tokens"].long()
    b = tokens.shape[0]
    dtype = params["embed"].dtype
    if cfg.block_pattern == "encdec":
        enc = _encode(params, cfg, batch["frames"], "none")
        f = enc.shape[1]
        cache = init_cache(cfg, b, max_len, dtype, device=tokens.device)
        kvs = [attn_lib.encode_kv(lp["xattn"], cfg, enc)
               for lp in _unstack(params["blocks"], cfg.n_layers)]
        cache["xk"] = torch.stack([k for k, _ in kvs]).to(dtype)
        cache["xv"] = torch.stack([v for _, v in kvs]).to(dtype)
        cache["enc_len"].fill_(f)
        x = rms_norm(enc[:, -1:], params["final_norm"], cfg.norm_eps)
        return cache, _logits(params, cfg, x)[:, 0]
    kv_len = min(max_len, cfg.window) if cfg.attn == "swa" else max_len
    x, _ = _embed_inputs(params, cfg, batch)
    st = x.shape[1]
    positions = torch.arange(st, device=tokens.device).expand(b, st)
    x, _, (ks, vs) = _attn_backbone(params, cfg, x, positions, remat="none",
                                    collect_kv=True)
    if st > kv_len:
        ks, vs = ks[:, :, -kv_len:], vs[:, :, -kv_len:]
    else:
        ks = F.pad(ks, (0, 0, 0, 0, 0, kv_len - st))
        vs = F.pad(vs, (0, 0, 0, 0, 0, kv_len - st))
    cache = {"len": torch.full((b,), st, dtype=torch.int32,
                               device=tokens.device),
             "k": ks.to(dtype).contiguous(), "v": vs.to(dtype).contiguous()}
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return cache, _logits(params, cfg, x)[:, 0]


__all__ = ["PATTERNS", "check_supported", "cross_entropy", "decode_step",
           "init_cache", "init_params", "loss_fn", "prefill"]
