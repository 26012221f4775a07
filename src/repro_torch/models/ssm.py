"""Mamba2-style selective state-space block (SSD), chunked for prefill and
single-step for decode; port of `repro.models.ssm` in plain torch ops (the
JAX block is `jnp` outside any Pallas kernel).

The block: in_proj -> short depthwise causal conv -> per-head scalar decay
a = exp(-exp(a_log) dt) -> state update h = a h + dt x B^T -> y = C h + D x
-> gated RMS norm -> out_proj. State: (B, H, P, N), P the head dim, N
``cfg.ssm.state_dim``; the conv state (B, K - 1, Cd) holds the last K - 1
pre-conv inputs.

``softplus`` is `jax.nn.softplus`, ``logaddexp(x, 0)``: `F.softplus`
returns x itself above its threshold of 20.

Under a mesh context ``tp`` ``in_proj`` is column-parallel and its
pieces, which mix the fields ``[z | x | B | C | dt]``, are gathered; the
conv runs on every channel; the SSD runs over the heads whose rows of
``out_proj`` this rank holds (where they are whole heads; else over every
head), the gated norm's sum of squares added over ``model``, and
``out_proj`` is row-parallel. The decode step (`mamba_step`) does the same
on the state's pieces: ``mamba_h`` split on the heads where they divide
(`cache_specs`), ``mamba_conv`` whole on every rank. Every rank leaves the
same conv state bit for bit: the gathered projection is the same bytes on
every rank (each rank's piece joined in rank order), and the conv weights
are whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp_lib
from .layers import Leaf, rms_norm, rms_norm_pieces
from .scan_util import scan as _scan


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _dims(cfg):
    d = cfg.d_model
    inner = cfg.ssm.expand * d
    p = cfg.ssm.head_dim
    h = inner // p
    n = cfg.ssm.state_dim
    return d, inner, h, p, n


def mamba_spec(cfg) -> dict:
    """One Mamba2 layer's leaves in the JAX `init_mamba`'s order; ``a_log``
    (log of 1..16 spread over the heads), ``d_skip`` (ones) and
    ``dt_bias`` (zeros) are f32 constants whatever the tree's dtype."""
    d, inner, h, p, n = _dims(cfg)
    f32 = torch.float32
    return {
        # order: [z(inner) | x(inner) | B(n) | C(n) | dt(h)]
        "in_proj": Leaf((d, 2 * inner + 2 * n + h)),
        "conv_w": Leaf((cfg.ssm.conv_dim, inner + 2 * n), scale=0.3),
        "a_log": Leaf((h,), dtype=f32, fill=lambda: torch.log(
            torch.linspace(1.0, 16.0, h, dtype=f32))),
        "d_skip": Leaf((h,), dtype=f32, fill=lambda: torch.ones(h)),
        "dt_bias": Leaf((h,), dtype=f32, fill=lambda: torch.zeros(h)),
        "norm": Leaf((inner,), ones=True),
        "out_proj": Leaf((inner, d)),
    }


def _split_proj(cfg, proj):
    d, inner, h, p, n = _dims(cfg)
    return (proj[..., :inner], proj[..., inner:2 * inner + 2 * n],
            proj[..., 2 * inner + 2 * n:])


def _causal_conv(xbc, conv_w, conv_state=None):
    """Short depthwise causal conv. xbc: (B, S, Cd); conv_w: (K, Cd);
    conv_state (B, K - 1, Cd) or None (zeros). Returns (silu(out), the new
    conv state: the last K - 1 inputs)."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, *xbc.shape[2:]))
    else:
        pad = conv_state
    xp = torch.cat([pad.to(xbc.dtype), xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * conv_w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return F.silu(out), new_state


def _pad_time(t, sp):
    """``t`` (B, S, ...) zero-padded along S to ``sp`` rows."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, sp - t.shape[1]))


def _intra_kernel(rel, causal, dt_c):
    """A chunk's causal kernel G[t, s] = exp(cum[t] - cum[s]) dt[s] from
    ``rel`` = cum[t] - cum[s] (B, L, L, H) and ``dt_c`` (B, L, H). The mask
    goes inside the exp: above the diagonal exp(rel) may overflow, and
    where(causal, exp(rel), 0) would send 0 * inf = NaN back to rel in the
    backward; exp(-inf) = 0 gives the same forward bits."""
    return torch.exp(torch.where(causal, rel, -torch.inf)) * dt_c[:, None]


def mamba_chunked(params, cfg, x, *, chunk: int = 256, tp=None):
    """Prefill pass. x: (B, S, d) -> ((B, S, d), (h (B, H, P, N), conv
    state)). The sequence is zero-padded to whole chunks of ``chunk``, as
    in JAX; each chunk adds the carried state's decayed contribution and
    its own causal term. Under a mesh context ``tp`` the leaves are this
    rank's pieces and h holds the heads it ran."""
    d, inner, h, p, n = _dims(cfg)
    b, s, _ = x.shape
    x = tp_lib.copy_in(tp, x)
    conv_w, a_log, dt_bias, d_skip, norm = tp_lib.copy_in(
        tp, *(params[k] for k in ("conv_w", "a_log", "dt_bias", "d_skip",
                                  "norm")))
    proj = tp_lib.cols(tp, x, params["in_proj"], 2 * inner + 2 * n + h)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, conv_w)
    xs = xbc[..., :inner]
    bmat = xbc[..., inner:inner + n]
    cmat = xbc[..., inner + n:]
    n_rows = params["out_proj"].shape[0]
    heads = tp_lib.split(tp, n_rows, inner) and n_rows % p == 0
    if heads:
        mine, hs = tp.part(inner), tp.part(h)
        xs, z, norm = xs[..., mine], z[..., mine], norm[mine]
        dt, a_log, dt_bias, d_skip = dt[..., hs], a_log[hs], dt_bias[hs], d_skip[hs]
    hl = xs.shape[-1] // p
    y, h_fin = _ssd(xs.reshape(b, s, hl, p), bmat, cmat, dt, a_log, dt_bias,
                    d_skip, chunk)
    y = y.reshape(b, s, hl * p).to(x.dtype)
    if heads:
        y = rms_norm_pieces(tp, y * F.silu(z), norm, inner, cfg.norm_eps)
        return tp_lib.row(tp, y, params["out_proj"]), (h_fin, conv_state)
    y = rms_norm(y * F.silu(z), norm, cfg.norm_eps)
    return tp_lib.rows(tp, y, params["out_proj"], inner), (h_fin, conv_state)


def _ssd(xs, bmat, cmat, dt, a_log, dt_bias, d_skip, chunk: int):
    """The chunked SSD scan of xs (B, S, H, P) with B / C (B, S, N) and the
    raw dt (B, S, H): (y (B, S, H, P) f32 with the D skip, final h). The
    state is f32, so bf16 inputs meet it as f32 (jnp's einsum promotes them
    there), but C.B is taken in the inputs' dtype, as the JAX einsum of
    the two takes it (in bf16 its output is rounded to bf16 before the f32
    kernel G)."""
    b, s, h, p = xs.shape
    xs = xs.float()
    n = bmat.shape[-1]
    dt = softplus(dt.float() + dt_bias)                             # (B,S,H)
    a = torch.exp(-torch.exp(a_log)[None, None] * dt)               # (0, 1)

    nchunk = -(-s // chunk)
    sp = nchunk * chunk
    if sp != s:
        xs, bmat, cmat, dt, a = (_pad_time(t, sp)
                                 for t in (xs, bmat, cmat, dt, a))
    xs = xs.reshape(b, nchunk, chunk, h, p)
    bmat = bmat.reshape(b, nchunk, chunk, n)
    cmat = cmat.reshape(b, nchunk, chunk, n)
    bmat_in, cmat_in, bmat, cmat = bmat, cmat, bmat.float(), cmat.float()
    dt = dt.reshape(b, nchunk, chunk, h)
    a = a.reshape(b, nchunk, chunk, h)

    log_a = torch.log(torch.clamp(a, min=1e-20))
    cum = torch.cumsum(log_a, dim=2)                               # (B,NC,L,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xs.device))[None, :, :, None]

    def body(hstate, blk):
        xs_c, b_in, c_in, b_c, c_c, dt_c, cum_c = blk   # b_c, c_c f32
        total = cum_c[:, -1]                                       # (B,H)
        # inter-chunk: y_inter[t] = C_t . (decay(0..t) * h_in)
        y_inter = torch.einsum("bln,bhpn->blhp", c_c, hstate) * torch.exp(
            cum_c)[..., None]
        # intra-chunk: causal kernel G[t,s] = exp(cum[t]-cum[s]) dt[s]
        rel = cum_c[:, :, None, :] - cum_c[:, None, :, :]          # (B,L,L,H)
        g = _intra_kernel(rel, causal, dt_c)
        scores = torch.einsum("bln,bmn->blm", c_in, b_in)          # (B,L,L)
        # "blm,blmh,bmhp->blhp" in two steps: no (B, L, L, H, P) temporary
        w = (scores[..., None] * g).permute(0, 3, 1, 2)            # (B,H,L,L)
        y_intra = torch.matmul(w, xs_c.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        # state update: h_out = decay_total h_in + sum_s decay(s..end) dt_s x_s b_s^T
        decay_out = torch.exp(total[:, None] - cum_c)              # (B,L,H)
        dx = dt_c[..., None] * xs_c                                # (B,L,H,P)
        h_new = torch.exp(total)[..., None, None] * hstate + torch.einsum(
            "blhp,bln->bhpn", decay_out[..., None] * dx, b_c)
        return h_new, y_inter + y_intra

    h0 = torch.zeros((b, h, p, n), dtype=torch.float32, device=xs.device)
    blks = tuple(t.movedim(1, 0) for t in (xs, bmat_in, cmat_in, bmat, cmat,
                                             dt, cum))
    h_fin, ys = _scan(body, h0, blks)
    y = ys.movedim(0, 1).reshape(b, sp, h, p)[:, :s]
    y = y + d_skip[None, None, :, None] * xs.reshape(b, sp, h, p)[:, :s]
    return y, h_fin


def mamba_step(params, cfg, x, state, tp=None):
    """Decode step. x: (B, 1, d); state = (h (B, H, P, N), conv (B, K-1,
    Cd)). Returns ((B, 1, d), (h, conv)), new tensors. Under a mesh context
    ``tp`` the leaves and h are this rank's pieces (h its heads where it
    holds a piece of them)."""
    d, inner, h, p, n = _dims(cfg)
    b = x.shape[0]
    hstate, conv_state = state
    x = tp_lib.copy_in(tp, x)
    proj = tp_lib.cols(tp, x, params["in_proj"], 2 * inner + 2 * n + h)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], conv_state)
    xbc = xbc[:, 0]
    xs = xbc[..., :inner]
    bmat = xbc[..., inner:inner + n]
    cmat = xbc[..., inner + n:]
    dt, a_log, dt_bias, d_skip, norm = (dt[:, 0], params["a_log"],
                                        params["dt_bias"], params["d_skip"],
                                        params["norm"])
    heads = tp_lib.split(tp, hstate.shape[1], h)
    if heads:
        mine, hs = tp.part(inner), tp.part(h)
        xs, z, norm = xs[..., mine], z[..., mine], norm[mine]
        dt, a_log, dt_bias, d_skip = dt[..., hs], a_log[hs], dt_bias[hs], d_skip[hs]
    hl = hstate.shape[1]
    xs = xs.reshape(b, hl, p)
    dt1 = softplus(dt.float() + dt_bias)                           # (B,H)
    a = torch.exp(-torch.exp(a_log)[None] * dt1)
    h_new = a[..., None, None] * hstate + (
        (dt1[..., None] * xs.float())[..., None] * bmat.float()[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cmat.float(), h_new)
    y = y + d_skip[None, :, None] * xs
    y = y.reshape(b, 1, hl * p).to(x.dtype)
    if heads:
        y = rms_norm_pieces(tp, y * F.silu(z), norm, inner, cfg.norm_eps)
        return tp_lib.row(tp, y, params["out_proj"]), (h_new, conv_state)
    y = rms_norm(y * F.silu(z), norm, cfg.norm_eps)
    return (tp_lib.rows(tp, y, params["out_proj"], inner),
            (h_new, conv_state))


__all__ = ["mamba_chunked", "mamba_spec", "mamba_step", "softplus"]
