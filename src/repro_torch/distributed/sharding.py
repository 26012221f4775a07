"""Logical -> physical sharding rules; counterpart of
`repro.distributed.sharding` (the rules copied, not imported).

Parameters are sharded by *name-path rules* applied to the trailing
dimensions (leading scan-stack axes stay unsharded); every rule checks
divisibility against the mesh and falls back to replication, so one rule set
serves every (arch x mesh) cell. Inputs/caches get family-aware specs from
``batch_specs`` / ``cache_specs``.

Data-parallel axes: ("pod", "data") when the mesh has a pod axis, else
("data",). Tensor/expert axes: "model".

A spec is a `P`: a tuple with one entry a dim (None, an axis name, or a
tuple of names, the first major), JAX's ``PartitionSpec`` without jax. The
mesh is a `launch.mesh.Mesh`. `shard` cuts this rank's piece of a tensor,
`gather` joins the pieces back (an all-gather), and `reshard` moves a piece
from one spec to another.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .. import tree as tree_lib


class P(tuple):
    """A partition spec: ``P(None, "model")``. A one-name tuple entry is
    that name, as JAX normalizes ``("data",)`` to ``"data"``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1
                                     else p for p in parts))

    def __repr__(self):
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    return mesh.axis_size(_entry_axes(axes))


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _spec_for(path: str, shape, mesh) -> P:
    """Trailing-dims PartitionSpec for one parameter."""
    model_ok = lambda d: _fits(shape[d], mesh, "model")
    nd = len(shape)

    def pad(*trailing):
        return P(*([None] * (nd - len(trailing)) + list(trailing)))

    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    if name == "embed":
        return pad("model", None) if model_ok(-2) else pad(None, None)
    if name == "unembed":
        return pad(None, "model") if model_ok(-1) else pad(None, None)
    if name in ("wq", "wk", "wv", "w_gates", "w_up", "w_gate", "in_proj", "w_if"):
        if parent == "moe":
            # MoE experts (…, E, d, ff): shard experts if divisible, else ff
            if _fits(shape[-3], mesh, "model"):
                return pad("model", None, None)
            return pad(None, None, "model") if model_ok(-1) else pad(None, None, None)
        return pad(None, "model") if model_ok(-1) else pad(None, None)
    if name in ("wo", "w_down", "out_proj"):
        if parent == "moe":  # MoE (…, E, ff, d)
            if _fits(shape[-3], mesh, "model"):
                return pad("model", None, None)
            return pad(None, "model", None) if _fits(shape[-2], mesh, "model") else pad(None, None, None)
        return pad("model", None) if model_ok(-2) else pad(None, None)
    if name == "router":
        return pad(None, None)
    return P(*([None] * nd))  # norms, gates, biases, conv, frontend


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and tuples (a `P` is a leaf),
    the counterpart of `jax.tree_util.tree_map_with_path`: a path holds the
    dict keys and the tuple indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return tuple(tree_map_with_path(fn, v, (*path, i))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params_shape: Any, mesh):
    """PartitionSpec tree for a params (shape) tree."""
    return tree_map_with_path(
        lambda path, leaf: _spec_for(_path_str(path), tuple(leaf.shape), mesh),
        params_shape)


def zero1_specs(params_shape: Any, mesh):
    """Optimizer-state / grad-accumulator specs (ZeRO-1 partitioning).

    The 'data' axis is appended to the dim that is ALREADY model-sharded
    (P(..., ("model","data"))), so a parameter's moment is a slice of its
    piece and the way back an all-gather over 'data' alone. Params with no
    model-sharded dim (norms, biases — tiny) stay replicated; one with no
    extendable model dim (MoE expert-sharded stacks) of at least 2^20
    elements has its largest free dim sharded over data."""
    base = param_specs(params_shape, mesh)
    dsz = axis_size(mesh, "data")

    def upgrade(leaf, spec):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (dim, pt) in enumerate(zip(shape, parts)):
            if pt == "model" and dim % (axis_size(mesh, "model") * dsz) == 0:
                parts[i] = ("model", "data")
                return P(*parts)
        best, best_size = None, 0
        for i, (dim, pt) in enumerate(zip(shape, parts)):
            if pt is None and dim % dsz == 0 and dim > best_size:
                best, best_size = i, dim
        if best is not None and leaf.numel() >= 1 << 20:
            parts[best] = "data"
        return P(*parts)

    return tree_lib.map(upgrade, params_shape, base)


# ---------------------------------------------------------------------------
# input / cache specs per shape cell
# ---------------------------------------------------------------------------

def batch_specs(cfg, shape, mesh):
    """Specs for the train/prefill batch dict."""
    dp = dp_axes(mesh)
    bdim = dp if _fits(shape.global_batch, mesh, dp) else None
    spec = {
        "tokens": P(bdim, None),
        "labels": P(bdim, None),
    }
    if cfg.frontend == "vision":
        spec["patches"] = P(bdim, None, None)
    if cfg.frontend == "audio":
        spec["frames"] = P(bdim, None, None)
    return spec


def cache_specs(cfg, shape, mesh):
    """Specs for the decode cache.

    KV model-axis placement preference: kv_heads > head_dim > sequence.
    Sequence sharding is the fallback (h2o-danube: kh=8, dh=120) and the
    long-context path for unshardable batch (long_500k, B=1), where the
    sequence goes over data (context parallelism)."""
    dp = dp_axes(mesh)
    b = shape.global_batch
    bdim = dp if _fits(b, mesh, dp) else None
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    if bdim is None:
        # batch unshardable (long_500k, B=1): context parallelism — shard
        # sequence over data, heads/dim over model when divisible
        hd = "model" if _fits(kh, mesh, "model") else (
            "model" if _fits(dh, mesh, "model") else None)
        if hd and _fits(kh, mesh, "model"):
            kv = P(None, None, "data", "model", None)
        elif hd:
            kv = P(None, None, "data", None, "model")
        else:
            kv = P(None, None, ("data", "model"), None, None)
    elif _fits(kh, mesh, "model"):
        kv = P(None, bdim, None, "model", None)
    elif _fits(dh, mesh, "model"):
        kv = P(None, bdim, None, None, "model")
    else:
        kv = P(None, bdim, "model", None, None)
    specs = {"len": P(bdim)}
    if cfg.block_pattern in ("attn", "encdec"):
        specs["k"] = kv
        specs["v"] = kv
    if cfg.block_pattern == "encdec":
        specs["xk"] = P(None, bdim, None, None, None)
        specs["xv"] = P(None, bdim, None, None, None)
        specs["enc_len"] = P(bdim)
    if cfg.block_pattern == "xlstm_7_1":
        # C:(G,7,B,H,P,P) n:(G,7,B,H,P) m:(G,7,B,H); H tiny -> shard P
        pm = "model" if _fits(cfg.d_model // cfg.n_heads, mesh, "model") else None
        specs["mlstm_c"] = P(None, None, bdim, None, pm, None)
        specs["mlstm_n"] = P(None, None, bdim, None, pm)
        specs["mlstm_m"] = P(None, None, bdim, None)
        specs["slstm"] = tuple(P(None, bdim, None, pm) for _ in range(4))
    if cfg.block_pattern == "zamba2":
        inner = cfg.ssm.expand * cfg.d_model
        h = inner // cfg.ssm.head_dim
        hm = "model" if _fits(h, mesh, "model") else None
        specs["mamba_h"] = P(None, None, bdim, hm, None, None)
        specs["mamba_conv"] = P(None, None, bdim, None, None)
        if cfg.n_layers % cfg.shared_attn_every:
            specs["tail_h"] = P(None, bdim, hm, None, None)
            specs["tail_conv"] = P(None, bdim, None, None)
        # shared attention caches: (n_groups, B, S, KH, dh), the kv rule
        specs["shared_k"] = kv
        specs["shared_v"] = kv
    return specs


class KVLayout(NamedTuple):
    """How a decode cell's K/V cache (B, S, KH, dh a layer) lies on the
    mesh under `cache_specs`' kv rule, for the decode step to split its
    attention the same way.

    ``split`` is what ``model`` cuts besides the sequence: ``"heads"`` (the
    KV heads), ``"head_dim"`` (every head's slice of dh) or None (neither:
    the sequence takes ``model``). ``seq_axes`` are the axes the sequence
    is cut over, in the spec's order (major first): () when whole,
    ``("model",)`` where neither KH nor dh divides ``model``, the data
    axes under context parallelism (a batch that does not split, such as
    long_500k's B = 1), ``("data", "model")`` for both."""
    split: Optional[str]
    seq_axes: tuple

    @property
    def name(self) -> str:
        """``heads``, ``head_dim``, ``sequence`` (over ``model``) or, with
        the sequence over a data axis, ``context+<split or sequence>``."""
        what = self.split or "sequence"
        if any(a != "model" for a in self.seq_axes):
            return "context+" + what
        return what

    def seq_piece(self, mesh, s_local: int) -> int:
        """The first position of this rank's piece of the sequence, whose
        pieces are ``s_local`` long."""
        if not self.seq_axes:
            return 0
        return mesh.index(self.seq_axes) * s_local


def kv_layout(cfg, shape, mesh) -> Optional[KVLayout]:
    """The `KVLayout` of the decode cell ``shape`` on ``mesh`` (None for a
    model with no K/V cache: the xLSTM)."""
    specs = cache_specs(cfg, shape, mesh)
    kv = specs.get("k", specs.get("shared_k"))
    if kv is None:
        return None
    split = ("heads" if kv[3] == "model" else
             "head_dim" if kv[4] == "model" else None)
    return KVLayout(split, _entry_axes(kv[2]))


def decode_token_spec(cfg, shape, mesh):
    dp = dp_axes(mesh)
    bdim = dp if _fits(shape.global_batch, mesh, dp) else None
    return P(bdim, None)


def logits_spec(cfg, mesh):
    return P(None, "model") if _fits(cfg.vocab_padded, mesh, "model") else P(None, None)


# ---------------------------------------------------------------------------
# pieces on the ranks
# ---------------------------------------------------------------------------

def _padded(spec, ndim: int) -> list:
    spec = list(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {P(*spec)} has more entries than {ndim} dims")
    return [_entry_axes(e) for e in spec] + [()] * (ndim - len(spec))


def shard_shape(spec, shape, mesh) -> tuple:
    """The per-device shape of a ``shape`` array under ``spec``: JAX's
    ``NamedSharding(mesh, spec).shard_shape(shape)``. Raises ValueError
    where a dim does not divide."""
    out = []
    for dim, axes in zip(shape, _padded(spec, len(shape))):
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways under {P(*spec)}")
        out.append(dim // n)
    return tuple(out)


def reshard(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """``x``, this rank's piece under ``src``, as its piece under ``dst``.

    Where ``dst`` splits every dim over ``src``'s axes and then more (a
    ZeRO moment from its parameter), a local slice: a view of ``x``. Where
    ``src`` does (back to the parameter), an all-gather over the extra
    axes. Otherwise the whole array is gathered and sliced. The choice
    depends on the specs alone, so every rank takes the same branch."""
    pairs = list(zip(_padded(src, x.ndim), _padded(dst, x.ndim)))
    if all(d[:len(s)] == s for s, d in pairs):
        return _slice(x, [d[len(s):] for s, d in pairs], dst, mesh)
    if all(s[:len(d)] == d for s, d in pairs):
        for dim, (s, d) in enumerate(pairs):
            x = mesh.all_gather(x, s[len(d):], dim)
        return x
    return reshard(reshard(x, src, P(), mesh), P(), dst, mesh)


def slice_piece(x: torch.Tensor, src, dst, mesh, coords=None) -> torch.Tensor:
    """``x``, this rank's piece under ``src``, cut to its piece under
    ``dst`` where ``dst`` splits every dim over ``src``'s axes and then
    more (a ZeRO-1 moment's layout from its parameter's): a view. With
    ``coords``, the piece of the rank at those coordinates along the extra
    axes (the ranks that share ``x``)."""
    pairs = list(zip(_padded(src, x.ndim), _padded(dst, x.ndim)))
    if not all(d[:len(s)] == s for s, d in pairs):
        raise ValueError(f"{P(*dst)} does not refine {P(*src)}")
    return _slice(x, [d[len(s):] for s, d in pairs], dst, mesh, coords)


def _slice(x: torch.Tensor, split, spec, mesh, coords=None) -> torch.Tensor:
    """``x`` with each dim cut into the pieces of its axes in ``split``:
    this rank's piece (or the piece of the rank at ``coords``), a view."""
    if all(mesh.axis_size(axes) == 1 for axes in split):
        return x
    index = []
    for n, axes in zip(x.shape, split):
        k = mesh.axis_size(axes)
        if n % k:
            raise ValueError(f"dim {n} of a piece does not split {k} ways "
                             f"under {P(*spec)}")
        i = mesh.index(axes, coords) if k > 1 else 0
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    return x[tuple(index)]


def shard(tensor: torch.Tensor, spec, mesh, coords=None) -> torch.Tensor:
    """This rank's piece of the whole ``tensor`` under ``spec`` (a view),
    or the piece of the rank at ``coords`` (a dict of axis coordinates;
    any mesh, an abstract one too)."""
    return _slice(tensor, _padded(spec, tensor.ndim), spec, mesh, coords)


def gather(piece: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole array from every rank's ``piece`` under ``spec``: an
    all-gather over the axes of each split dim (collective)."""
    return reshard(piece, spec, P(), mesh)


def shard_tree(tree, specs, mesh):
    """Each leaf's piece under its spec (``specs``: the same tree of `P`),
    a copy where the piece is smaller than the leaf."""
    def one(t, spec):
        piece = shard(t, spec, mesh)
        return piece if piece.shape == t.shape else piece.clone()
    return tree_lib.map(one, tree, specs)


def gather_tree(tree, specs, mesh):
    """Each leaf whole again (collective: every rank calls it)."""
    return tree_lib.map(lambda t, spec: gather(t, spec, mesh), tree, specs)


__all__ = ["KVLayout", "P", "axis_size", "batch_specs", "cache_specs", "decode_token_spec",
           "dp_axes", "gather", "gather_tree", "kv_layout", "logits_spec", "param_specs",
           "reshard", "shard", "shard_shape", "shard_tree", "slice_piece",
           "tree_map_with_path", "zero1_specs"]
