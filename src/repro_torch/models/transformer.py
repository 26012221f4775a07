"""The models of the serve and training paths; port of
`repro.models.transformer` for every block pattern: ``"attn"`` (dense, MoE,
the vision-stub frontend), ``"encdec"`` (whisper's encoder-decoder with its
audio-stub frontend), ``"xlstm_7_1"`` (groups of seven mLSTM layers and one
sLSTM layer) and ``"zamba2"`` (groups of Mamba2 layers, each followed by one
attention + MLP block whose weights all groups share, and a tail of the
layers left over): `init_params`, the training loss (`loss_fn`,
`cross_entropy`, the remat policies), `prefill`, `init_cache` and
`decode_step`.

Parameters are the JAX package's pytree as a dict of tensors: ``embed``
(vocab_padded, d), ``final_norm`` (d,), ``unembed`` (d, vocab_padded) when
the embeddings are untied, ``frontend_proj`` (d, d) with a frontend, and
``blocks`` with every leaf stacked along a leading layer axis (``ln1``,
``ln2``, ``attn``: ``wq wk wv wo``; ``mlp``: ``w_gate w_up w_down``, or
``moe``: ``router w_gate w_up w_down`` and ``shared``; the decoder of an
encoder-decoder adds ``ln_x`` and ``xattn``). An encoder-decoder also has
``enc_blocks`` and ``enc_norm``. The xLSTM has ``mlstm`` and ``ln_m``
stacked (groups, 7), ``slstm`` and ``ln_s`` stacked (groups,); the hybrid
``mamba`` and ``mamba_ln`` stacked (groups, shared_attn_every), with
``mamba_tail`` and ``mamba_tail_ln`` (rem,) when the layers do not divide
into groups, and ``shared``, one attention block. The layers run as a
Python loop where JAX scans.

The cache is ``{"len": (B,) int32, "k", "v": (L, B, max_len, KH, dh)}``, as
in JAX; an encoder-decoder's adds the encoder K/V ``xk``, ``xv`` (L, B,
frontend_len, KH, dh) and ``enc_len`` (B,). The xLSTM's holds the mLSTM
states ``mlstm_c`` (G, 7, B, H, P, P), ``mlstm_n`` and ``mlstm_m`` (-inf at
the start), and ``slstm``, a tuple of four (G, B, H, P) tensors (h, c, n,
m); the hybrid's ``mamba_h`` (G, every, B, H, P, N), ``mamba_conv``,
``tail_h`` / ``tail_conv`` with a tail, and the shared block's K/V
``shared_k``, ``shared_v`` (G, B, max_len, KH, dh). Unlike JAX's
functional update, `decode_step` writes the new K/V, states and lengths
into the cache tensors in place (no copy of the whole cache per step) and
returns the same dict, so its tensors never change identity and a CUDA
graph captured over them stays valid.

The recurrent `prefill` keeps the JAX semantics
(`src/repro/models/transformer.py:511-524`): it runs the chunked backbone
for the last position's logits and returns `init_cache`'s zero states with
``len`` = S, so decoding starts from zero recurrent state and the hybrid's
shared attention attends S zero K/V rows. `loss_fn` trains them through
the same backbones, each group under the remat policy.

`loss_fn` runs the layers on `torch.unbind` views of the stacked leaves,
so the backward stacks each leaf's layer gradients once (the JAX scan's
transpose) instead of adding a full-size gradient per layer.

`loss_fn` and `prefill` take a mesh context ``tp``
(`distributed.tensor_parallel`; None: one process): the parameters are
then this rank's pieces under `sharding.param_specs` and each block splits
its compute over ``model`` (`attention`, `layers.apply_mlp`, `moe`,
`ssm`, `xlstm`). The embedding, split on the vocab, sums its masked
lookups over ``model``; the tied ``embed.T`` or the untied ``unembed``
piece gives a vocab piece of the logits, and the cross entropy reduces
over the pieces (`tensor_parallel.cross_entropy`). ``frontend_proj`` and
the norms stay whole.

`decode_step` takes the same context, its cache in `cache_specs`' layout
(this rank's batch rows; ``kv_layout``, a `sharding.KVLayout`, says how
the K/V are cut): each attention layer projects and writes the piece of
this token's K/V its cache holds (`_write_kv`: under a sequence split only
the rank that holds the written position writes) and attends its piece
(`attention.flash_decode`); the recurrent steps run on their state's
pieces (`ssm.mamba_step`, `xlstm.mlstm_step` / `slstm_step`); the MLP and
the MoE split as in training; the logits come out as this rank's vocab
piece.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.index import resolve_device
from ..distributed import tensor_parallel as tp_lib
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from . import xlstm as xlstm_lib
from .layers import Leaf, apply_mlp, init_tree, mlp_spec, rms_norm

MASKED = -1e30   # logits of the vocab padding rows
PATTERNS = ("attn", "encdec", "xlstm_7_1", "zamba2")
RECURRENT = ("xlstm_7_1", "zamba2")


def check_supported(cfg) -> None:
    """Raise on a block pattern that is none of `PATTERNS` (the JAX
    `init_params` raises ValueError on one)."""
    if cfg.block_pattern not in PATTERNS:
        raise ValueError(f"{cfg.name}: unknown block pattern "
                         f"{cfg.block_pattern!r}; the patterns are {PATTERNS}")


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
    """A spec's layer stack: ``n`` layers of the leaves of ``spec`` (a
    `Leaf` or a dict of them); a tuple ``n`` stacks along several leading
    axes, as (groups, layers a group)."""
    n: Union[int, Tuple[int, ...]]
    spec: object


def _zamba_groups(cfg):
    """(groups, layers a group, tail layers) of the hybrid."""
    every = cfg.shared_attn_every
    return cfg.n_layers // every, every, cfg.n_layers % every


def param_spec(cfg) -> dict:
    """The parameter tree as `Leaf` specs, in draw order: the embedding, the
    final norm, the unembedding when untied, ``frontend_proj`` with a
    frontend, then the stacks (`Stacked`): ``enc_blocks`` and ``enc_norm``
    of an encoder-decoder, and ``blocks``; the xLSTM's ``mlstm``,
    ``slstm``, ``ln_m`` and ``ln_s``; the hybrid's ``mamba``,
    ``mamba_ln``, the tail's and ``shared``."""
    check_supported(cfg)
    vp, d = cfg.vocab_padded, cfg.d_model
    ones = Leaf((d,), ones=True)
    spec = {"embed": Leaf((vp, d), scale=0.02), "final_norm": ones}
    if not cfg.tie_embeddings:
        spec["unembed"] = Leaf((d, vp))
    if cfg.frontend != "none":
        spec["frontend_proj"] = Leaf((d, d))
    if cfg.block_pattern == "encdec":
        spec["enc_blocks"] = Stacked(cfg.enc_layers, _block_spec(cfg))
        spec["enc_norm"] = ones
        spec["blocks"] = Stacked(cfg.n_layers, _block_spec(cfg, cross=True))
    elif cfg.block_pattern == "xlstm_7_1":
        groups = cfg.n_layers // 8
        spec["mlstm"] = Stacked((groups, 7), xlstm_lib.mlstm_spec(cfg))
        spec["slstm"] = Stacked(groups, xlstm_lib.slstm_spec(cfg))
        spec["ln_m"] = Stacked((groups, 7), ones)
        spec["ln_s"] = Stacked(groups, ones)
    elif cfg.block_pattern == "zamba2":
        groups, every, rem = _zamba_groups(cfg)
        spec["mamba"] = Stacked((groups, every), ssm_lib.mamba_spec(cfg))
        spec["mamba_ln"] = Stacked((groups, every), ones)
        if rem:
            spec["mamba_tail"] = Stacked(rem, ssm_lib.mamba_spec(cfg))
            spec["mamba_tail_ln"] = Stacked(rem, ones)
        spec["shared"] = _block_spec(cfg)
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


def _logits(params, cfg, x, tp=None):
    """The f32 logits of ``x``; under a mesh context ``tp`` with the vocab
    split, this rank's vocab piece (rows ``tp.rank * V / model`` on)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    pad = torch.arange(w.shape[-1], device=x.device)
    if tp_lib.split(tp, w.shape[-1], cfg.vocab_padded):
        pad = pad + tp.rank * w.shape[-1]
        x = tp_lib.copy_in(tp, x)
    logits = (x @ w).float()
    if cfg.vocab_padded != cfg.vocab:
        logits = logits.masked_fill(pad >= cfg.vocab, MASKED)
    return logits


def _loss(params, cfg, x, labels, tp):
    """The cross entropy of ``x``'s logits (over vocab pieces under a
    split)."""
    logits = _logits(params, cfg, x, tp)
    if logits.shape[-1] == cfg.vocab_padded:
        return cross_entropy(logits, labels)
    return tp_lib.cross_entropy(tp, logits, labels,
                                tp.rank * logits.shape[-1])


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


def _take(tree, *idx):
    """Layer ``idx`` of a stacked tree: every leaf indexed (a view)."""
    if isinstance(tree, dict):
        return {key: _take(val, *idx) for key, val in tree.items()}
    return tree[idx]


def _ffn(lp, cfg, x, tp=None, aux: bool = True):
    """The layer's MLP or MoE on the normed ``x``: (h, aux or None); the
    MoE's load-balance loss only with ``aux``."""
    h_in = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None and "moe" in lp:
        return moe_lib.apply_moe(lp["moe"], cfg, h_in,
                                 capacity_factor=cfg.moe.capacity_factor,
                                 tp=tp, aux=aux)
    return apply_mlp(lp["mlp"], h_in, tp, cfg.d_ff), None


def _attn_backbone(params, cfg, x, positions, *, remat="full",
                   bidirectional: bool = False, collect_kv: bool = False,
                   blocks_key: str = "blocks", tp=None):
    """The attention blocks of ``params[blocks_key]`` over a whole
    sequence, each under the ``remat`` policy. Returns (x, aux, kv): aux the
    sum of the MoE layers' load-balance losses (0 without MoE), kv the
    stacked (L, B, S, KH, dh) keys and values when ``collect_kv``."""

    def block(x, aux, lp):
        h, kv = attn_lib.attention_train(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
            bidirectional=bidirectional, tp=tp)
        x = x + h
        h, a = _ffn(lp, cfg, x, tp)
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


def _xlstm_backbone(params, cfg, x, *, remat="none", tp=None):
    """The xLSTM's groups over a whole sequence: seven mLSTM layers
    (`mlstm_chunked`) and one sLSTM layer (`slstm_scan`) a group, each a
    pre-norm residual, the group under the ``remat`` policy (where JAX
    puts it); the final states are dropped, as in JAX."""
    eps = cfg.norm_eps
    groups = cfg.n_layers // 8

    def group(x, mlstm, ln_m, slstm, ln_s):
        for lp, ln in zip(mlstm, ln_m):
            h, _ = xlstm_lib.mlstm_chunked(lp, cfg, rms_norm(x, ln, eps), tp=tp)
            x = x + h
        h, _ = xlstm_lib.slstm_scan(slstm, cfg, rms_norm(x, ln_s, eps), tp)
        return x + h

    step = _maybe_remat(group, remat)
    for mlstm, ln_m, slstm, ln_s in zip(
            _unstack(params["mlstm"], groups), _unstack(params["ln_m"], groups),
            _unstack(params["slstm"], groups), _unstack(params["ln_s"], groups)):
        x = step(x, _unstack(mlstm, 7), _unstack(ln_m, 7), slstm, ln_s)
    return x


def _zamba_backbone(params, cfg, x, positions, *, remat="none", tp=None):
    """The hybrid over a whole sequence: each group's Mamba2 layers
    (`mamba_chunked`) then the shared block, the group under the ``remat``
    policy (where JAX puts it; the shared block's gradient sums over the
    groups), then the tail's Mamba2 layers outside it; the final states are
    dropped, as in JAX."""
    eps = cfg.norm_eps
    groups, every, rem = _zamba_groups(cfg)

    def mamba(x, lp, ln):
        h, _ = ssm_lib.mamba_chunked(lp, cfg, rms_norm(x, ln, eps), tp=tp)
        return x + h

    def group(x, layers, lns, sp):
        for lp, ln in zip(layers, lns):
            x = mamba(x, lp, ln)
        h, _ = attn_lib.attention_train(sp["attn"], cfg,
                                        rms_norm(x, sp["ln1"], eps), positions,
                                        tp=tp)
        x = x + h
        return x + apply_mlp(sp["mlp"], rms_norm(x, sp["ln2"], eps), tp,
                             cfg.d_ff)

    step = _maybe_remat(group, remat)
    for layers, lns in zip(_unstack(params["mamba"], groups),
                           _unstack(params["mamba_ln"], groups)):
        x = step(x, _unstack(layers, every), _unstack(lns, every),
                 params["shared"])
    if rem:
        for lp, ln in zip(_unstack(params["mamba_tail"], rem),
                          _unstack(params["mamba_tail_ln"], rem)):
            x = mamba(x, lp, ln)
    return x


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


def _embed_inputs(params, cfg, batch, tp=None):
    """Token embedding, with the vision stub's projected patches prepended.
    Returns (x, label_offset). `F.embedding`, not advanced indexing: its
    CUDA backward is deterministic (`chip_smoke.py` phase 12b runs two
    identical steps). Under a mesh context, over the vocab pieces
    (`tensor_parallel.embed`)."""
    x = tp_lib.embed(tp, batch["tokens"].long(), params["embed"],
                     cfg.vocab_padded)
    if cfg.frontend == "vision":
        patches = batch["patches"] @ params["frontend_proj"]
        return torch.cat([patches.to(x.dtype), x], dim=1), cfg.frontend_len
    return x, 0


def loss_fn(params, cfg, batch, *, remat: str = "full", tp=None):
    """batch: tokens (B, S) int, labels (B, S) int (-1 ignored), plus
    patches (B, F, d) for the vision stub or frames (B, F, d) for the
    encoder-decoder, tensors on the parameters' device. Returns
    (loss + 0.01 * aux, {"loss", "aux"}); aux is 0 but for MoE layers.
    ``remat`` (none, full or dots) wraps each attention layer, each xLSTM
    group and each hybrid group, as in JAX. Under a mesh context ``tp``
    the parameters are this rank's pieces (the module's docstring) and the
    loss is the whole batch's on every rank of the ``model`` axis."""
    check_supported(cfg)
    if cfg.block_pattern == "encdec":
        return _loss_encdec(params, cfg, batch, remat=remat, tp=tp)
    x, offset = _embed_inputs(params, cfg, batch, tp)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_pattern == "xlstm_7_1":
        x = _xlstm_backbone(params, cfg, x, remat=remat, tp=tp)
    elif cfg.block_pattern == "zamba2":
        x = _zamba_backbone(params, cfg, x, positions, remat=remat, tp=tp)
    else:
        x, aux, _ = _attn_backbone(params, cfg, x, positions, remat=remat,
                                   tp=tp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if offset:
        x = x[:, offset:]
    loss = _loss(params, cfg, x, batch["labels"], tp)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def _encode(params, cfg, frames, remat, tp=None):
    """The encoder over the projected frames: (B, F, d) after ``enc_norm``."""
    frames = frames @ params["frontend_proj"]
    b, f, _ = frames.shape
    enc_pos = torch.arange(f, device=frames.device).expand(b, f)
    enc, _, _ = _attn_backbone(params, cfg, frames, enc_pos, remat=remat,
                               bidirectional=True, blocks_key="enc_blocks",
                               tp=tp)
    return rms_norm(enc, params["enc_norm"], cfg.norm_eps)


def _loss_encdec(params, cfg, batch, *, remat="full", tp=None):
    enc = _encode(params, cfg, batch["frames"], remat, tp)
    b, f, _ = enc.shape
    enc_len = torch.full((b,), f, dtype=torch.int32, device=enc.device)
    x = tp_lib.embed(tp, batch["tokens"].long(), params["embed"],
                     cfg.vocab_padded)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def block(x, enc, lp):
        h, _ = attn_lib.attention_train(
            lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), positions,
            tp=tp)
        x = x + h
        x = x + attn_lib.cross_attention(
            lp["xattn"], cfg, rms_norm(x, lp["ln_x"], cfg.norm_eps),
            *attn_lib.encode_kv(lp["xattn"], cfg, enc, tp), enc_len, tp)
        return x + apply_mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps),
                             tp, cfg.d_ff)

    step = _maybe_remat(block, remat)
    for lp in _unstack(params["blocks"], cfg.n_layers):
        x = step(x, enc, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = _loss(params, cfg, x, batch["labels"], tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss, {"loss": loss, "aux": aux}


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
               device="cuda") -> dict:
    """The zero cache of ``batch_size`` sequences, as the JAX
    `init_cache`: K/V sized to ``max_len`` (the window under SWA); the
    recurrent states in f32 (the conv states in ``dtype``), each
    stabiliser m at -inf."""
    check_supported(cfg)
    device = resolve_device(device)
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    kv_len = min(max_len, cfg.window) if cfg.attn == "swa" else max_len
    f32 = dict(dtype=torch.float32, device=device)
    cache = {"len": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device)}
    if cfg.block_pattern == "xlstm_7_1":
        groups, h = cfg.n_layers // 8, cfg.n_heads
        p = cfg.d_model // h
        cache["mlstm_c"] = torch.zeros((groups, 7, batch_size, h, p, p), **f32)
        cache["mlstm_n"] = torch.zeros((groups, 7, batch_size, h, p), **f32)
        cache["mlstm_m"] = torch.full((groups, 7, batch_size, h), -torch.inf,
                                      **f32)
        shape = (groups, batch_size, h, p)
        cache["slstm"] = (torch.zeros(shape, **f32), torch.zeros(shape, **f32),
                          torch.zeros(shape, **f32),
                          torch.full(shape, -torch.inf, **f32))
        return cache
    if cfg.block_pattern == "zamba2":
        groups, every, rem = _zamba_groups(cfg)
        ssm = cfg.ssm
        h = ssm.expand * cfg.d_model // ssm.head_dim
        conv_c = ssm.expand * cfg.d_model + 2 * ssm.state_dim
        state = (batch_size, h, ssm.head_dim, ssm.state_dim)
        conv = (batch_size, ssm.conv_dim - 1, conv_c)
        cache["mamba_h"] = torch.zeros((groups, every, *state), **f32)
        cache["mamba_conv"] = torch.zeros((groups, every, *conv), dtype=dtype,
                                          device=device)
        if rem:
            cache["tail_h"] = torch.zeros((rem, *state), **f32)
            cache["tail_conv"] = torch.zeros((rem, *conv), dtype=dtype,
                                             device=device)
        k = torch.zeros((groups, batch_size, kv_len, kh, dh), dtype=dtype,
                        device=device)
        cache.update(shared_k=k, shared_v=torch.zeros_like(k))
        return cache
    k = torch.zeros((cfg.n_layers, batch_size, kv_len, kh, dh), dtype=dtype,
                    device=device)
    cache.update(k=k, v=torch.zeros_like(k))
    if cfg.block_pattern == "encdec":
        xk = torch.zeros((cfg.n_layers, batch_size, cfg.frontend_len, kh, dh),
                         dtype=dtype, device=device)
        cache.update(xk=xk, xv=torch.zeros_like(xk),
                     enc_len=torch.zeros((batch_size,), dtype=torch.int32,
                                         device=device))
    return cache


def _write_kv(cache_k, k_new, pos, first: int = 0, s_whole=None):
    """Write one token's K/V at each sequence's position, in place.
    cache (B, S, KH, dh), k_new (B, 1, KH, dh), pos (B,). A position past
    the cache is clamped to its last row, as `lax.dynamic_update_slice`
    clamps the start index. Where the cache is this rank's piece of a
    sequence of ``s_whole`` positions starting at ``first``, the position
    is clamped in the whole sequence and only rows whose position lies in
    the piece are written (no host sync: the others are rewritten with
    what they hold)."""
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    if s_whole is None:
        pos = torch.clamp(pos.long(), 0, cache_k.shape[1] - 1)
        cache_k[rows, pos] = k_new[:, 0].to(cache_k.dtype)
        return
    pos = torch.clamp(pos.long(), 0, s_whole - 1) - first
    mine = (pos >= 0) & (pos < cache_k.shape[1])
    pos = torch.clamp(pos, 0, cache_k.shape[1] - 1)
    cache_k[rows, pos] = torch.where(mine[:, None, None],
                                     k_new[:, 0].to(cache_k.dtype),
                                     cache_k[rows, pos])


def _write_state(cache_state, new_state) -> None:
    """Copy a layer's new recurrent state into its cache views, in place."""
    for dst, src in zip(cache_state, new_state):
        dst.copy_(src)


class _Attend:
    """One decode step's attention context: the lengths and the write
    position of the whole sequence (the K/V cache holds ``kv_len``
    positions, a window under SWA), and under a mesh context this rank's
    piece of it (``kv_layout``)."""

    def __init__(self, cfg, kv_local: int, new_len, tp, layout, use_kernels,
                 *, window: bool):
        self.tp, self.layout, self.use_kernels = tp, layout, use_kernels
        pieces = tp.mesh.axis_size(layout.seq_axes) if layout is not None else 1
        kv_len = kv_local * pieces
        self.pos_write = new_len - 1
        if window and cfg.attn == "swa":
            self.pos_write = self.pos_write % kv_len
        self.att_len = torch.clamp(new_len, max=kv_len)
        self.positions = (new_len - 1)[:, None]
        self.write = {}
        if pieces > 1:
            self.write = dict(first=layout.seq_piece(tp.mesh, kv_local),
                              s_whole=kv_len)

    def __call__(self, params, cfg, h_in, kc, vc):
        """Project this token (``h_in`` normed), write its K/V into the
        layer's cache (in place) and attend: (B, 1, d) after ``wo``."""
        q, k_new, v_new = attn_lib.decode_qkv(params, cfg, h_in,
                                              self.positions, self.tp,
                                              self.layout)
        _write_kv(kc, k_new, self.pos_write, **self.write)
        _write_kv(vc, v_new, self.pos_write, **self.write)
        att = attn_lib.flash_decode(q, kc, vc, self.att_len,
                                    use_kernels=self.use_kernels,
                                    tp=self.tp, layout=self.layout)
        return attn_lib.decode_out(params, cfg, att, self.tp, self.layout)


def _decode_attn(params, cfg, cache, x, new_len, use_kernels, tp=None,
                 layout=None):
    """The attention blocks' decode (``attn`` and ``encdec``): each layer
    writes this token's K/V into the cache and attends its rows; an
    encoder-decoder's layers also attend the cached encoder K/V (whole
    over ``model`` under a split)."""
    # q, k and v of this token in one projection: the JAX decode_step
    # projects q again after `decode_kv`, to the same values
    attend = _Attend(cfg, cache["k"].shape[2], new_len, tp, layout,
                     use_kernels, window=True)
    encdec = cfg.block_pattern == "encdec"
    for i, lp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        x = x + attend(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                       cache["k"][i], cache["v"][i])
        if encdec:
            x = x + attn_lib.cross_attention(
                lp["xattn"], cfg, rms_norm(x, lp["ln_x"], cfg.norm_eps),
                cache["xk"][i], cache["xv"][i], cache["enc_len"], tp)
        x = x + _ffn(lp, cfg, x, tp, aux=False)[0]
    return x


def _decode_xlstm(params, cfg, cache, x, tp=None):
    """The xLSTM's decode: each mLSTM and sLSTM layer steps its state (this
    rank's piece of P under a split) and writes it back into the cache."""
    eps = cfg.norm_eps
    for g in range(cfg.n_layers // 8):
        for j in range(7):
            state = (cache["mlstm_c"][g, j], cache["mlstm_n"][g, j],
                     cache["mlstm_m"][g, j])
            h, new = xlstm_lib.mlstm_step(
                _take(params["mlstm"], g, j), cfg,
                rms_norm(x, params["ln_m"][g, j], eps), state, tp)
            _write_state(state, new)
            x = x + h
        state = tuple(t[g] for t in cache["slstm"])
        h, new = xlstm_lib.slstm_step(_take(params["slstm"], g), cfg,
                                      rms_norm(x, params["ln_s"][g], eps),
                                      state, tp)
        _write_state(state, new)
        x = x + h
    return x


def _mamba_decode(lp, ln, cfg, x, h_state, conv_state, tp=None):
    """One Mamba2 layer's decode step, its states written back in place."""
    h, new = ssm_lib.mamba_step(lp, cfg, rms_norm(x, ln, cfg.norm_eps),
                                (h_state, conv_state), tp)
    _write_state((h_state, conv_state), new)
    return x + h


def _decode_zamba(params, cfg, cache, x, new_len, use_kernels, tp=None,
                  layout=None):
    """The hybrid's decode: each group's Mamba2 layers, then the shared
    block, which writes this token's K/V into the group's ``shared_k`` /
    ``shared_v`` and attends its rows (`flash_decode`), then the tail."""
    sp = params["shared"]
    # JAX takes no window modulus here
    attend = _Attend(cfg, cache["shared_k"].shape[2], new_len, tp, layout,
                     use_kernels, window=False)
    groups, every, rem = _zamba_groups(cfg)
    for g in range(groups):
        for j in range(every):
            x = _mamba_decode(_take(params["mamba"], g, j),
                              params["mamba_ln"][g, j], cfg, x,
                              cache["mamba_h"][g, j], cache["mamba_conv"][g, j],
                              tp)
        x = x + attend(sp["attn"], cfg, rms_norm(x, sp["ln1"], cfg.norm_eps),
                       cache["shared_k"][g], cache["shared_v"][g])
        x = x + apply_mlp(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps), tp,
                          cfg.d_ff)
    for j in range(rem):
        x = _mamba_decode(_take(params["mamba_tail"], j),
                          params["mamba_tail_ln"][j], cfg, x,
                          cache["tail_h"][j], cache["tail_conv"][j], tp)
    return x


def decode_step(params, cfg, cache, token, *, return_hidden: bool = False,
                use_kernels: Optional[bool] = None, tp=None, kv_layout=None):
    """token: (B, 1) int. Returns (logits (B, vocab_padded) f32, cache); with
    ``return_hidden`` the post-norm hidden state (B, d) instead of logits
    (what the ProMIPS logit search queries). ``use_kernels`` goes to
    `ops.decode_attention` (None: the kernel on CUDA tensors); the xLSTM
    runs no attention. Every cache leaf is updated in place.

    Under a mesh context ``tp`` the parameters are this rank's pieces, the
    cache and ``token`` its pieces in `cache_specs`' layout, whose K/V cut
    ``kv_layout`` names (`sharding.kv_layout`); the logits are this rank's
    vocab piece (see the module's docstring)."""
    check_supported(cfg)
    if tp is not None and kv_layout is None and \
            cfg.block_pattern != "xlstm_7_1":
        raise ValueError("decode_step under a mesh needs the cache's kv_layout")
    if tp is None:
        kv_layout = None
        x = params["embed"][token.long()]                       # (B, 1, d)
    else:
        x = tp_lib.embed(tp, token.long(), params["embed"], cfg.vocab_padded)
    new_len = cache["len"] + 1
    if cfg.block_pattern == "xlstm_7_1":
        x = _decode_xlstm(params, cfg, cache, x, tp)
    elif cfg.block_pattern == "zamba2":
        x = _decode_zamba(params, cfg, cache, x, new_len, use_kernels, tp,
                          kv_layout)
    else:
        x = _decode_attn(params, cfg, cache, x, new_len, use_kernels, tp,
                         kv_layout)
    cache["len"].copy_(new_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x[:, 0], cache
    return _logits(params, cfg, x, tp)[:, 0], cache


def _cache_layout(cache, cfg, max_len, tp, cache_specs):
    """``cache`` (this rank's batch rows; each leaf whole over ``model`` or
    already this rank's piece of it) in the layout of ``cache_specs``
    (`launch.specs.cache_shardings`): a dim the spec splits (over
    ``model``, or the sequence over the data axes under context
    parallelism, where every data rank ran the whole batch) is sliced where
    it is whole, a dim it keeps whole is gathered where it is a piece."""
    if tp is None:
        return cache
    mesh = tp.mesh
    b = cache["len"].shape[0] * mesh.axis_size(cache_specs["len"][0])
    whole = init_cache(cfg, b, max_len, device="meta")

    def one(t, ref, spec):
        if isinstance(t, tuple):
            return tuple(one(*leaf) for leaf in zip(t, ref, spec))
        for dim, entry in enumerate(tuple(spec) + (None,) * (t.dim() - len(spec))):
            n = mesh.axis_size(entry)
            if n > 1 and t.shape[dim] == ref.shape[dim]:
                k = t.shape[dim] // n
                t = t.narrow(dim, mesh.index(entry) * k, k).contiguous()
            elif entry is None and t.shape[dim] != ref.shape[dim]:
                t = tp.all_gather(t.contiguous(), dim)
        return t

    return {key: one(val, whole[key], cache_specs[key])
            for key, val in cache.items()}


def prefill(params, cfg, batch, max_len: int, *, tp=None, cache_specs=None):
    """Run the whole prompt, build the cache (K/V sized to ``max_len``) and
    return (cache, last-position logits (B, vocab_padded)). batch: tokens
    (B, S), plus patches (B, F, d) for the vision stub (the cache then holds
    F + S positions) or frames (B, F, d) for an encoder-decoder, whose
    prefill runs the encoder only, as in JAX: the cache gets the encoder
    K/V and length 0, and the logits are those of the last encoder
    position. A recurrent model's prefill runs its chunked backbone for the
    logits and returns the zero cache with length S, as in JAX.

    Under a mesh context ``tp`` the parameters are this rank's pieces and
    ``batch`` its rows: the cache comes out in ``cache_specs``' layout
    (`_cache_layout`) and the logits as this rank's vocab piece."""
    check_supported(cfg)
    tokens = batch["tokens"].long()
    b = tokens.shape[0]
    dtype = params["embed"].dtype

    def done(cache, x):
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        return (_cache_layout(cache, cfg, max_len, tp, cache_specs),
                _logits(params, cfg, x, tp)[:, 0])

    if cfg.block_pattern in RECURRENT:
        x, _ = _embed_inputs(params, cfg, batch, tp)
        s = x.shape[1]
        if cfg.block_pattern == "xlstm_7_1":
            x = _xlstm_backbone(params, cfg, x, tp=tp)
        else:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
            x = _zamba_backbone(params, cfg, x, positions, tp=tp)
        cache = init_cache(cfg, b, max_len, dtype, device=tokens.device)
        cache["len"].fill_(s)
        return done(cache, x)
    if cfg.block_pattern == "encdec":
        enc = _encode(params, cfg, batch["frames"], "none", tp)
        f = enc.shape[1]
        cache = init_cache(cfg, b, max_len, dtype, device=tokens.device)
        kvs = [attn_lib.encode_kv(lp["xattn"], cfg, enc, tp)
               for lp in _unstack(params["blocks"], cfg.n_layers)]
        cache["xk"] = torch.stack([k for k, _ in kvs]).to(dtype)
        cache["xv"] = torch.stack([v for _, v in kvs]).to(dtype)
        cache["enc_len"].fill_(f)
        return done(cache, enc)
    kv_len = min(max_len, cfg.window) if cfg.attn == "swa" else max_len
    x, _ = _embed_inputs(params, cfg, batch, tp)
    st = x.shape[1]
    positions = torch.arange(st, device=tokens.device).expand(b, st)
    x, _, (ks, vs) = _attn_backbone(params, cfg, x, positions, remat="none",
                                    collect_kv=True, tp=tp)
    if st > kv_len:
        ks, vs = ks[:, :, -kv_len:], vs[:, :, -kv_len:]
    else:
        ks = F.pad(ks, (0, 0, 0, 0, 0, kv_len - st))
        vs = F.pad(vs, (0, 0, 0, 0, 0, kv_len - st))
    cache = {"len": torch.full((b,), st, dtype=torch.int32,
                               device=tokens.device),
             "k": ks.to(dtype).contiguous(), "v": vs.to(dtype).contiguous()}
    return done(cache, x)


__all__ = ["PATTERNS", "RECURRENT", "check_supported", "cross_entropy", "decode_step",
           "init_cache", "init_params", "loss_fn", "prefill"]
