"""Mixture-of-Experts layer: a top-k softmax router and a dispatch by
permutation; port of `repro.models.moe`.

Per sequence (each batch row apart, as in JAX): the router in f32, softmax,
top-k, gates renormalised; the (token, slot) pairs stably sorted by expert;
the first ``capacity = max(1, int(cf * S * topk / E))`` pairs of each
expert's run kept, the rest dropped; the kept tokens gathered into (E, C)
capacity buffers; three expert matmuls; the gated outputs combined back to
their tokens. Shared experts (qwen2-moe: 4 shared + 60 routed) are applied
densely. The aux loss is the Switch-style load balance.

Every expert runs its whole capacity buffer, as in JAX, so a decode step
reads every routed expert's weights. The JAX einsums, gathers and scatters
are plain ``jnp`` with no Pallas kernel, so these are plain torch ops too.
Two choices keep the layer deterministic on the card (a CUDA graph replay
equal to the eager call bit for bit):

- the dispatch is a gather (each kept (expert, slot) reads its token), not
  the JAX ``.set`` scatter, whose only duplicate index is the trap row;
- the combine adds each token's contributions in the order of the expert
  sort, the order in which the JAX scatter-add applies them, from a gather
  through the sort's inverse, not with the atomic ``index_add_``.

Router ties go to the lower expert index, as `lax.top_k` does: the top-k is
the head of a stable descending sort.

Under a mesh context ``tp`` the router stays whole on every rank (its rule
replicates it) and each rank routes every token, as the tokens are whole
across ``model``. Where the experts split over ``model`` a rank fills and
runs only its experts' buffers; otherwise each expert's d_ff splits
(`_spec_for`'s ``moe`` branch) and every buffer runs on every rank against
its columns and rows. Either way a rank's combine is a partial sum, added
over ``model`` with the shared experts' (split as the MLP).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp_lib
from .layers import Leaf, init_tree, mlp_spec


def moe_spec(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    spec = {"router": Leaf((d, e), scale=d ** -0.5, dtype=torch.float32),
            "w_gate": Leaf((e, d, ff)), "w_up": Leaf((e, d, ff)),
            "w_down": Leaf((e, ff, d))}
    if cfg.moe.n_shared:
        spec["shared"] = mlp_spec(d, cfg.moe.n_shared * ff)
    return spec


def init_moe(cfg, *, generator=None, device, dtype=torch.float32) -> dict:
    return init_tree(moe_spec(cfg), generator=generator, device=device,
                     dtype=dtype)


def capacity(cfg, s: int, capacity_factor: float) -> int:
    """Kept pairs per expert in a row of ``s`` tokens (static)."""
    return max(1, int(capacity_factor * s * cfg.moe.top_k / cfg.moe.n_experts))


class Route(NamedTuple):
    """The dispatch of a (B, S, d) batch, per row, over the S * topk
    (token, slot) pairs in expert order."""
    probs: torch.Tensor          # (B, S, E) f32 router softmax
    choice: torch.Tensor         # (B, S, topk) chosen experts, best first
    order: torch.Tensor          # (B, S*topk) the stable sort by expert
    sorted_token: torch.Tensor   # (B, S*topk)
    sorted_gate: torch.Tensor    # (B, S*topk) renormalised gates
    keep: torch.Tensor           # (B, S*topk) bool: within capacity
    dest: torch.Tensor           # (B, S*topk) e * C + slot, E * C if dropped
    run_start: torch.Tensor      # (B, E) first sorted pair of each expert
    run_len: torch.Tensor        # (B, E) pairs routed to each expert


def route(params, cfg, x, capacity_factor: float = 1.25) -> Route:
    b, s, _ = x.shape
    e, topk = cfg.moe.n_experts, cfg.moe.top_k
    dev = x.device
    probs = torch.softmax(x.float() @ params["router"], dim=-1)   # (B, S, E)
    choice = torch.argsort(probs, dim=-1, descending=True,
                           stable=True)[..., :topk]
    gate = torch.gather(probs, -1, choice)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_expert = choice.reshape(b, s * topk)
    flat_token = (torch.arange(s * topk, device=dev) // topk).expand(
        b, s * topk)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_token = torch.gather(flat_token, 1, order)
    sorted_gate = torch.gather(gate.reshape(b, s * topk), 1, order)

    cap = capacity(cfg, s, capacity_factor)
    experts = torch.arange(e, device=dev).expand(b, e).contiguous()
    run_start = torch.searchsorted(sorted_expert, experts)
    run_len = torch.searchsorted(sorted_expert, experts, right=True) - run_start
    pos = torch.arange(s * topk, device=dev).expand(b, s * topk)
    slot = pos - torch.gather(run_start, 1, sorted_expert)
    keep = slot < cap
    dest = torch.where(keep, sorted_expert * cap + slot,
                       torch.full_like(slot, e * cap))
    return Route(probs, choice, order, sorted_token, sorted_gate, keep, dest,
                 run_start, run_len)


def apply_moe(params, cfg, x, *, capacity_factor: float = 1.25, tp=None,
              aux: bool = True):
    """x (B, S, d) -> ((B, S, d), aux). Under a mesh context ``tp`` the
    expert stacks are this rank's pieces (see the module's docstring).
    Without ``aux`` (the decode step, which drops it as JAX's does) the
    load-balance loss is not computed and aux is None."""
    b, s, d = x.shape
    e, topk = cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(cfg, s, capacity_factor)
    r = route(params, cfg, x, capacity_factor)
    dev = x.device
    split = tp_lib.active(tp)
    e_loc = params["w_gate"].shape[0]
    e0 = tp.rank * e_loc if split and tp_lib.split(tp, e_loc, e) else 0
    gate = r.sorted_gate
    if split and e_loc == e and not tp_lib.split(
            tp, params["w_gate"].shape[-1], cfg.d_ff):
        raise ValueError("an MoE layer whole on every rank under a split")
    if split:
        # the tokens and the gates enter compute that differs between ranks
        x, gate = tp_lib.copy_in(tp, x, gate)

    # dispatch: slot c of expert j holds the (run_start[j] + c)-th sorted
    # pair's token when c < the run's length, zero otherwise
    c = torch.arange(cap, device=dev)
    start = r.run_start[:, e0:e0 + e_loc]
    src = start[:, :, None] + c                             # (B, E, C)
    filled = c < torch.clamp(r.run_len[:, e0:e0 + e_loc], max=cap)[:, :, None]
    src = torch.clamp(src, max=s * topk - 1).reshape(b, e_loc * cap)
    tok = torch.gather(r.sorted_token, 1, src)              # (B, E*C)
    buf = torch.gather(x, 1, tok[..., None].expand(b, e_loc * cap, d))
    buf = torch.where(filled.reshape(b, e_loc * cap, 1), buf,
                      torch.zeros_like(buf))

    # the experts, batched over E: (E, B*C, d) x (E, d, ff)
    h = buf.reshape(b, e_loc, cap, d).transpose(0, 1).reshape(e_loc, b * cap, d)
    g = F.silu(torch.bmm(h, params["w_gate"]))
    u = torch.bmm(h, params["w_up"])
    y = torch.bmm(g * u, params["w_down"])                  # (E, B*C, d)
    y = y.reshape(e_loc, b, cap, d).transpose(0, 1).reshape(b, e_loc * cap, d)

    # combine: each sorted pair's gated output, back at (token, slot) through
    # the sort's inverse, then each token's slots added in sort order
    dest, keep = r.dest, r.keep
    if e_loc != e:
        dest = dest - e0 * cap
        keep = keep & (dest >= 0) & (dest < e_loc * cap)
        dest = torch.clamp(dest, min=0)
    contrib = torch.gather(
        y, 1, torch.clamp(dest, max=e_loc * cap - 1)[..., None].expand(
            b, s * topk, d))
    contrib = torch.where(keep[..., None], contrib, torch.zeros_like(contrib))
    contrib = contrib * gate[..., None].to(contrib.dtype)
    inv = torch.argsort(r.order, dim=1)                     # pair -> sorted pos
    per_tok = torch.gather(contrib, 1, inv[..., None].expand(b, s * topk, d))
    per_tok = per_tok.reshape(b, s, topk, d)
    rank = torch.argsort(inv.reshape(b, s, topk), dim=-1)  # slots in sort order
    per_tok = torch.gather(per_tok, 2, rank[..., None].expand(b, s, topk, d))
    out = torch.zeros((b, s, d), dtype=y.dtype, device=dev)
    for j in range(topk):
        out = out + per_tok[:, :, j]

    if cfg.moe.n_shared:
        sh = params["shared"]
        if split and not tp_lib.split(tp, sh["w_gate"].shape[-1],
                                      cfg.moe.n_shared * cfg.d_ff):
            raise ValueError("shared experts whole under a split MoE layer")
        out = out + (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]
    if split:
        out = tp_lib.reduce(tp, out)
    if not aux:
        return out, None

    # the share of tokens whose first choice is each expert (one_hot's
    # mean, with no host check of the indices: the step stays capturable);
    # under a mesh, both means over the whole batch (`data_mean`)
    density = (r.choice[..., :1] == torch.arange(e, device=dev)).float().mean(
        dim=(0, 1))
    router_prob = r.probs.mean(dim=(0, 1))
    if tp is not None:
        density = tp_lib.data_mean(tp, density)
        router_prob = tp_lib.data_mean(tp, router_prob)
    return out, e * torch.sum(density * router_prob)


__all__ = ["Route", "apply_moe", "capacity", "init_moe", "moe_spec", "route"]
