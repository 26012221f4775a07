"""xLSTM blocks (arXiv:2405.04517); port of `repro.models.xlstm` in plain
torch ops (the JAX blocks are `jnp` outside any Pallas kernel): the mLSTM
(matrix memory, chunk-parallel) and the sLSTM (scalar memory with
recurrent R weights, sequential).

mLSTM state: C (B, H, P, P) matrix memory, n (B, H, P) normalizer and the
log-space stabiliser m (B, H), which starts at -inf; exponential input
gate, sigmoid forget gate. sLSTM state: the tuple (h, c, n, m), each
(B, H, P), m starting at -inf. Every -inf path (``maximum`` with -inf,
``exp(-inf) = 0``) gives JAX's values. ``softplus`` is ``logaddexp(x, 0)``
(`ssm.softplus`), as `jax.nn.softplus`.

Under a mesh context ``tp`` (the prefill and training passes) ``w_up`` (``[x_in | gate]``) and ``w_if`` (``[i | f]``)
are column-parallel and gathered, their pieces mixing fields. Where a
rank's ``wq`` / ``wk`` / ``wv`` columns are whole heads the mLSTM runs over
those heads, and the sLSTM over the heads of its ``w_gates`` columns (a
head's pre-activations are contiguous: no gather); the norm's sum of
squares is added over ``model`` and ``w_down`` is row-parallel. Where they
are not whole heads (4 heads on a ``model`` axis of 16) the products are
gathered and the recurrence runs whole on every rank.

The decode steps take the cache's layout (`cache_specs`): every state
split on P, the head's depth, where P divides ``model`` (the heads are too
few to split), else whole. The products are gathered whole. The mLSTM
updates its piece of C (B, H, P / model, P) and n on its rows of k; the
read-out's sums over P (q C and q n) are partial and added over
``model``. The sLSTM's recurrence mixes every depth of a head, so its four
states are gathered whole, the cell steps whole on every rank and each
keeps its piece.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp_lib
from .layers import Leaf, rms_norm, rms_norm_pieces
from .scan_util import scan as _scan
from .ssm import _pad_time, softplus


def _dims(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    return d, h, d // h


def mlstm_spec(cfg) -> dict:
    """One mLSTM layer's leaves in the JAX `init_mlstm`'s order. ``w_if``
    (the input and forget gates' weights) is f32 whatever the tree's dtype;
    ``if_bias`` is the f32 constant zeros(H), then 3 + 0.5 i / (H - 1)."""
    d, h, p = _dims(cfg)
    f32 = torch.float32
    return {
        "w_up": Leaf((d, 2 * d)),                   # [x_in | gate]
        "wq": Leaf((d, d)), "wk": Leaf((d, d)), "wv": Leaf((d, d)),
        "w_if": Leaf((d, 2 * h), scale=d ** -0.5, dtype=f32),
        "if_bias": Leaf((2 * h,), dtype=f32, fill=lambda: torch.cat([
            torch.zeros(h),
            3.0 + torch.arange(h, dtype=f32) * 0.5 / max(h - 1, 1)])),
        "norm": Leaf((d,), ones=True),
        "w_down": Leaf((d, d)),
    }


def _gates(if_pre, h):
    """The mLSTM's log input gate and log forget gate (log sigmoid), f32,
    from the f32 pre-activations ``x @ w_if + if_bias``."""
    return if_pre[..., :h], -softplus(-if_pre[..., h:])


def mlstm_chunked(params, cfg, x, *, chunk: int = 256, tp=None):
    """Prefill pass. x: (B, S, d) -> ((B, S, d), final (C, n, m)). The
    sequence is zero-padded to whole chunks, as in JAX. Under a mesh
    context ``tp`` the leaves are this rank's pieces."""
    d, h, p = _dims(cfg)
    b, s, _ = x.shape
    x = tp_lib.copy_in(tp, x)
    norm, if_bias = tp_lib.copy_in(tp, params["norm"], params["if_bias"])
    x_in, gate = tp_lib.cols(tp, x, params["w_up"], 2 * d).chunk(2, dim=-1)
    log_i, log_f = _gates(
        tp_lib.cols(tp, x.float(), params["w_if"], 2 * h) + if_bias, h)
    nq = params["wq"].shape[-1]
    heads = tp_lib.split(tp, nq, d) and nq % p == 0
    if heads:
        proj = lambda w: (x_in @ params[w]).reshape(b, s, nq // p, p)
        hs = tp.part(h)
        log_i, log_f = log_i[..., hs], log_f[..., hs]
        gate, norm = gate[..., tp.part(d)], norm[tp.part(d)]
    else:
        proj = lambda w: tp_lib.cols(tp, x_in, params[w], d).reshape(b, s, h, p)
    q, k, v = proj("wq") * (p ** -0.5), proj("wk") * (p ** -0.5), proj("wv")
    y, carry = _mlstm_scan(q, k, v, log_i, log_f, chunk)
    y = y.to(x.dtype)
    if heads:
        y = rms_norm_pieces(tp, y, norm, d, cfg.norm_eps) * F.silu(gate)
        return tp_lib.row(tp, y, params["w_down"]), carry
    y = rms_norm(y, norm, cfg.norm_eps) * F.silu(gate)
    return tp_lib.rows(tp, y, params["w_down"], d), carry


def _mlstm_scan(q, k, v, log_i, log_f, chunk: int):
    """The chunked mLSTM over q, k, v (B, S, H, P) and the log gates
    (B, S, H): (y (B, S, H P) f32, final (C, n, m)). The carry is f32, so
    bf16 inputs meet it as f32 (jnp's einsum promotes them there), but q.k
    is taken in the inputs' dtype, as the JAX einsum of the two takes it
    (in bf16 its output is rounded to bf16 before the f32 weights)."""
    b, s, h, p = q.shape
    nchunk = -(-s // chunk)
    sp = nchunk * chunk
    if sp != s:
        q, k, v, log_i, log_f = (_pad_time(t, sp)
                                 for t in (q, k, v, log_i, log_f))
    blks = tuple(t.reshape(b, nchunk, chunk, *t.shape[2:]).movedim(1, 0)
                 for t in (q, k, q.float(), k.float(), v.float(), log_i,
                           log_f))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]

    def body(carry, blk):
        c_st, n_st, m_st = carry      # (B,H,P,P), (B,H,P), (B,H)
        q_in, k_in, q_c, k_c, v_c, li_c, lf_c = blk    # q_c, k_c, v_c f32
        cumf = torch.cumsum(lf_c, dim=1)                             # (B,L,H)
        # stabiliser: running max of (cumf + m_in) vs intra log weights
        log_in = cumf + m_st[:, None]                  # decay of the carry-in
        intra = cumf[:, :, None, :] - cumf[:, None, :, :] + li_c[:, None, :, :]
        intra = torch.where(causal, intra, -torch.inf)
        m_new = torch.maximum(log_in, intra.amax(dim=2))             # (B,L,H)
        e_in = torch.exp(log_in - m_new)
        # inter-chunk contribution
        y_inter = torch.einsum("blhp,bhpr->blhr", q_c, c_st) * e_in[..., None]
        n_inter = torch.einsum("blhp,bhp->blh", q_c, n_st) * e_in
        # intra-chunk
        w = torch.exp(intra - m_new[:, :, None, :])                  # (B,L,L,H)
        scores = torch.einsum("blhp,bmhp->blmh", q_in, k_in) * w
        y_intra = torch.einsum("blmh,bmhr->blhr", scores, v_c)
        n_intra = scores.sum(dim=2)                                  # (B,L,H)
        denom = torch.maximum(torch.abs(n_inter + n_intra), torch.exp(-m_new))
        y = (y_inter + y_intra) / denom[..., None]
        # state to the next chunk
        tot = cumf[:, -1]                                            # (B,H)
        m_out = torch.maximum(tot + m_st,
                              (tot[:, None] - cumf + li_c).amax(dim=1))
        decay_out = torch.exp(tot[:, None] - cumf + li_c - m_out[:, None])
        f_out = torch.exp(tot + m_st - m_out)
        c_new = f_out[..., None, None] * c_st + torch.einsum(
            "blhp,blhr->bhpr", decay_out[..., None] * k_c, v_c)
        n_new = f_out[..., None] * n_st + torch.einsum(
            "blh,blhp->bhp", decay_out, k_c)
        return (c_new, n_new, m_out), y

    kw = dict(dtype=torch.float32, device=q.device)
    carry = (torch.zeros((b, h, p, p), **kw), torch.zeros((b, h, p), **kw),
             torch.full((b, h), -torch.inf, **kw))
    carry, ys = _scan(body, carry, blks)
    return ys.movedim(0, 1).reshape(b, sp, h * p)[:, :s], carry


def mlstm_step(params, cfg, x, state, tp=None):
    """Decode step. x: (B, 1, d); state (C, n, m). Returns ((B, 1, d),
    (C, n, m)), new tensors. Under a mesh context ``tp`` the leaves are
    this rank's pieces and C (B, H, P', P) and n (B, H, P') its piece of P
    where they hold one (the module's docstring)."""
    d, h, p = _dims(cfg)
    b = x.shape[0]
    c_st, n_st, m_st = state
    x = tp_lib.copy_in(tp, x)
    x_in, gate = tp_lib.cols(tp, x, params["w_up"], 2 * d).chunk(2, dim=-1)
    proj = lambda w: tp_lib.cols(tp, x_in[:, 0], params[w], d).reshape(b, h, p)
    q = proj("wq") * (p ** -0.5)
    k = proj("wk") * (p ** -0.5)
    v = proj("wv")
    log_i, log_f = _gates(tp_lib.cols(tp, x[:, 0].float(), params["w_if"],
                                      2 * h) + params["if_bias"], h)
    split = tp_lib.split(tp, c_st.shape[-2], p)
    if split:
        q, k = q[..., tp.part(p)], k[..., tp.part(p)]
    m_new = torch.maximum(log_f + m_st, log_i)
    f_ = torch.exp(log_f + m_st - m_new)
    i_ = torch.exp(log_i - m_new)
    c_new = f_[..., None, None] * c_st + i_[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_[..., None] * n_st + i_[..., None] * k
    # the f32 state promotes q, as jnp.einsum does (a no-op in f32)
    num = torch.einsum("bhp,bhpr->bhr", q.to(c_new.dtype), c_new)
    qn = (q * n_new).sum(dim=-1)
    if split:
        both = tp_lib.all_sum(tp, torch.cat([num, qn[..., None]], dim=-1))
        num, qn = both[..., :p], both[..., p]
    den = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, d).to(x.dtype)
    y = rms_norm(y, params["norm"], cfg.norm_eps) * F.silu(gate)
    return tp_lib.rows(tp, y, params["w_down"], d), (c_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with recurrent weights, sequential by construction.
# ---------------------------------------------------------------------------

def slstm_spec(cfg) -> dict:
    """One sLSTM layer's leaves in the JAX `init_slstm`'s order; ``bias``
    is the f32 constant (zeros(2d), ones(d), zeros(d)): the forget gate's
    pre-activation starts at 1."""
    d, h, p = _dims(cfg)
    return {
        "w_gates": Leaf((d, 4 * d)),                # z, i, f, o pre-acts
        "r_gates": Leaf((h, p, 4 * p), scale=p ** -0.5),
        "bias": Leaf((4 * d,), dtype=torch.float32, fill=lambda: torch.cat([
            torch.zeros(2 * d), torch.ones(d), torch.zeros(d)])),
        "norm": Leaf((d,), ones=True),
        "w_down": Leaf((d, d)),
    }


def _slstm_cell(params, cfg, wx_t, state):
    """One step. wx_t: (B, 4 h P) input pre-activations of the h heads of
    ``params["r_gates"]``; state (h, c, n, m)."""
    d, _, p = _dims(cfg)
    h = params["r_gates"].shape[0]
    h_prev, c_prev, n_prev, m_prev = state
    # a decode step's f32 state promotes the weights, as jnp.einsum does
    rh = torch.einsum("bhp,hpr->bhr", h_prev,
                      params["r_gates"].to(h_prev.dtype))           # (B,H,4P)
    pre = wx_t.reshape(-1, h, 4 * p) + rh + params["bias"].reshape(h, 4 * p)
    z, i_raw, f_raw, o = pre.float().chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = -softplus(-f_raw)
    m_new = torch.maximum(log_f + m_prev, i_raw)
    i_ = torch.exp(i_raw - m_new)
    f_ = torch.exp(log_f + m_prev - m_new)
    c_new = f_ * c_prev + i_ * z
    n_new = f_ * n_prev + i_
    # maximum, not clamp: at a tie it splits the gradient as jnp.maximum does
    h_new = o * c_new / torch.maximum(n_new, n_new.new_full((), 1e-6))
    return (h_new.to(wx_t.dtype), c_new, n_new, m_new)


def slstm_scan(params, cfg, x, tp=None):
    """Prefill pass, a loop over time. x: (B, S, d) -> ((B, S, d), final
    (h, c, n, m)). Under a mesh context ``tp`` the leaves are this rank's
    pieces and the state holds the heads it ran."""
    d, h, p = _dims(cfg)
    b, s, _ = x.shape
    x = tp_lib.copy_in(tp, x)
    r_gates, bias, norm = tp_lib.copy_in(
        tp, params["r_gates"], params["bias"], params["norm"])
    nw = params["w_gates"].shape[-1]
    heads = tp_lib.split(tp, nw, 4 * d) and nw % (4 * p) == 0
    if heads:
        wx = x @ params["w_gates"]              # this rank's heads, whole
        cell = {"r_gates": r_gates[tp.part(h)], "bias": bias[tp.part(4 * d)]}
        norm = norm[tp.part(d)]
    else:
        wx = tp_lib.cols(tp, x, params["w_gates"], 4 * d)          # (B,S,4d)
        cell = {"r_gates": r_gates, "bias": bias}
    hl = cell["r_gates"].shape[0]
    kw = dict(dtype=torch.float32, device=x.device)
    state = (torch.zeros((b, hl, p), dtype=x.dtype, device=x.device),
             torch.zeros((b, hl, p), **kw), torch.zeros((b, hl, p), **kw),
             torch.full((b, hl, p), -torch.inf, **kw))

    def body(st, wx_t):
        st = _slstm_cell(cell, cfg, wx_t, st)
        return st, st[0]

    state, hs = _scan(body, state, wx.movedim(1, 0))
    y = hs.movedim(0, 1).reshape(b, s, hl * p)
    if heads:
        y = rms_norm_pieces(tp, y, norm, d, cfg.norm_eps)
        return tp_lib.row(tp, y, params["w_down"]), state
    y = rms_norm(y, norm, cfg.norm_eps)
    return tp_lib.rows(tp, y, params["w_down"], d), state


def slstm_step(params, cfg, x, state, tp=None):
    """Decode step. x: (B, 1, d); state (h, c, n, m). Under a mesh
    context ``tp`` the leaves are this rank's pieces and each state (B, H,
    P') its piece of P where it holds one: the pieces are gathered, the
    cell steps whole and each rank keeps its piece."""
    d, h, p = _dims(cfg)
    b = x.shape[0]
    split = tp_lib.split(tp, state[0].shape[-1], p)
    if split:
        whole = tp.all_gather(torch.stack([t.float() for t in state]), -1)
        state = tuple(t.to(s.dtype) for t, s in zip(whole.unbind(0), state))
    # h in the activations' dtype: the JAX cache's h takes the cell's output
    # dtype after a step (the port's cache buffer keeps its f32 allocation
    # and holds the same values), so from the second step on JAX computes
    # h @ r_gates in that dtype. At the first step h is zero and either
    # dtype gives the same bits.
    state = (state[0].to(x.dtype), *state[1:])
    x = tp_lib.copy_in(tp, x)
    state = _slstm_cell(params, cfg,
                        tp_lib.cols(tp, x[:, 0], params["w_gates"], 4 * d),
                        state)
    y = rms_norm(state[0].reshape(b, 1, d), params["norm"], cfg.norm_eps)
    if split:
        state = tuple(t[..., tp.part(p)] for t in state)
    return tp_lib.rows(tp, y, params["w_down"], d), state


__all__ = ["mlstm_chunked", "mlstm_spec", "mlstm_step", "slstm_scan",
           "slstm_spec", "slstm_step"]
