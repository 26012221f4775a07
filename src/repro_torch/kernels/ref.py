"""Plain PyTorch versions of the port's kernels (port of
`repro.kernels.ref`). They are the CPU path of `ops` and what the CUDA
kernels are held against on the card.

Ties follow `jax.lax.top_k`: the lower index wins, and in a merge the
carried entries come first. `torch.topk` promises no order among ties, so
the top-k here is a stable descending sort.
"""
from __future__ import annotations

import torch

NEG_INF = float("-inf")
MASKED = -1e30   # what `mips_score` writes on invalid rows (not -inf)


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along dim 1, descending, ties to the lower index."""
    s, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), idx[:, :k].contiguous()


def mips_score_ref(x, q, valid):
    """scores = x @ q.T, exactly -1e30 on invalid rows: x (R, d), q (B, d),
    valid (R,) -> (R, B) f32."""
    scores = x.float() @ q.float().T
    return torch.where(valid.bool()[:, None], scores,
                       torch.full_like(scores, MASKED))


def block_mips_ref(x, valid, q, slots, sel, init_scores, init_rows, c_half,
                   *, k: int, page_rows: int, dense: bool = False):
    """One fused verification round (the `block_mips` contract).

    x (n_pad, d) f32; valid (n_pad,) bool; q (B, d); slots (NS,) int block
    ids, ascending, padding slots allowed (their ``sel`` column is False);
    sel (B, NS) bool; init_scores/init_rows (B, k) carried top-k; c_half (B,)
    Condition-A thresholds. ``dense=True`` promises ``slots ==
    arange(n_blocks)``, so ``x`` is scored in place without a gather.

    Returns (top_s (B, k) f32, top_r (B, k) i32, cnt (B, NS) i32,
    pages (B,) i32, cand (B,) i32).
    """
    n_slots = sel.shape[1]
    d = x.shape[1]
    if dense:
        xt, rvalid = x, valid.bool()
        rows_flat = torch.arange(n_slots * page_rows, dtype=torch.int32,
                                 device=x.device)
    else:
        sl = slots.long()
        rows_flat = (sl[:, None] * page_rows
                     + torch.arange(page_rows, device=x.device)).reshape(-1).int()
        xt = x.view(-1, page_rows, d)[sl].reshape(-1, d)
        rvalid = valid.view(-1, page_rows)[sl].reshape(-1).bool()
    scores = (xt.float() @ q.float().T).T                        # (B, R)
    return _verify_core(scores, rvalid, sel, init_scores, init_rows, c_half,
                        rows_flat, k=k, page_rows=page_rows)


def block_mips_cached_ref(scores_full, valid, slots, sel, init_scores,
                          init_rows, c_half, *, k: int, page_rows: int):
    """Compensation round over CACHED scores: the previous round scored the
    whole corpus in place (dense tile), so this round's slots are a subset
    of the (B, n_pad) matrix ``scores_full``; no new dot products."""
    sl = slots.long()
    rows_flat = (sl[:, None] * page_rows
                 + torch.arange(page_rows, device=sl.device)).reshape(-1)
    scores = scores_full[:, rows_flat]                           # (B, R)
    rvalid = valid.view(-1, page_rows)[sl].reshape(-1).bool()
    return _verify_core(scores, rvalid, sel, init_scores, init_rows, c_half,
                        rows_flat.int(), k=k, page_rows=page_rows)


def _verify_core(scores, rvalid, sel, init_scores, init_rows, c_half,
                 rows_flat, *, k: int, page_rows: int):
    """Condition-A accounting + top-k merge over a (B, R) score tile.

    A slot is live iff it is selected and the carried hits ``n0`` plus the
    hits of earlier selected slots are still below k (the sequential-scan
    stop); pages/candidates count live slots; the top-k keeps live valid
    rows merged after the carried entries."""
    b, r = scores.shape
    n_slots = r // page_rows
    sel = sel.bool()
    ge = (scores >= c_half[:, None]) & rvalid[None, :]           # (B, R)
    cnt = (ge.view(b, n_slots, page_rows).sum(dim=2) * sel).int()  # (B, NS)
    n0 = (init_scores >= c_half[:, None]).sum(dim=1)             # carried hits
    ex_cum = torch.cumsum(cnt.long(), dim=1) - cnt               # exclusive
    live = sel & ((n0[:, None] + ex_cum) < k)
    pages = live.sum(dim=1).int()
    vcnt = rvalid.view(n_slots, page_rows).sum(dim=1)
    cand = (live.long() * vcnt[None, :]).sum(dim=1).int()

    row_live = live[:, :, None] & rvalid.view(1, n_slots, page_rows)
    masked = torch.where(row_live.reshape(b, -1), scores,
                         torch.full_like(scores, NEG_INF))
    tile_s, idx = topk_stable(masked, min(k, r))
    tile_r = torch.where(tile_s > NEG_INF, rows_flat.long()[idx],
                         torch.full_like(idx, -1)).int()
    merged_s = torch.cat([init_scores.float(), tile_s], dim=1)
    merged_r = torch.cat([init_rows.int(), tile_r], dim=1)
    top_s, pos = topk_stable(merged_s, k)
    return top_s, merged_r.gather(1, pos), cnt, pages, cand


MIN_SCORE = -1e30   # `search_common.MIN_SCORE`: the floor of the running score


def scan_qualify(gap, local_max_l2sq, best_ip, q_l2sq, c: float, x_p: float,
                 cs_prune: bool):
    """The progressive walk's per-block test: `search_common.adaptive_radii`
    then `gap_select`, the same f32 operations in the same order (the CUDA
    kernel repeats them with IEEE intrinsics, so the two agree bit for
    bit): r = sqrt(max(x_p * (M + |q|^2 - 2 max(best, MIN_SCORE) / c), 0)),
    -1 where cs_prune and sqrt(M) sqrt(|q|^2) < best; qualified iff
    gap <= r and r >= 0."""
    denom = local_max_l2sq + q_l2sq - 2.0 * torch.clamp(best_ip, min=MIN_SCORE) / c
    r = torch.sqrt(torch.clamp(x_p * denom, min=0.0))
    if cs_prune:
        ok = torch.sqrt(local_max_l2sq) * torch.sqrt(q_l2sq) >= best_ip
        r = torch.where(ok, r, torch.full_like(r, -1.0))
    return (gap <= r) & (r >= 0.0)


def scan_blocks_ref(x, ids, q, order, init_scores, init_rows, c_half, *,
                    k: int, page_rows: int, budget: int, n_sel=None,
                    block_gap=None, block_max_l2sq=None, q_l2sq=None,
                    c: float = 1.0, x_p: float = 0.0, cs_prune: bool = False):
    """The block walk of the scan and progressive searches: the step loop of
    the JAX bodies (`src/repro/core/search_device.py:441,611`) in torch,
    vectorized over the batch.

    x (n_pad, d) f32; ids (n_pad,) i32 (-1 = padding); q (B, d); order
    (B, NB) int, each query's block order; init_scores / init_rows (B, k)
    the carried top-k; c_half (B,) the Condition-A thresholds. Step t visits
    block order[b, t]; it is live when Condition A has not stopped the walk
    and, in scan mode (``n_sel`` (B,) given), t < n_sel[b], or in
    progressive mode (``block_gap`` (B, NB), ``block_max_l2sq`` (NB,),
    ``q_l2sq`` (B,) given) the block qualifies (`scan_qualify`) under the
    running k-th score. A live step scores the block's rows, merges the
    valid ones into the top-k (ties to the carried entry, then to the lower
    row), counts a page and its valid rows, and updates Condition A. The
    walk is ``budget`` steps (at most NB); steps after every query stopped
    are no-ops and are skipped. The scores are one GEMM up front.

    Returns (top_s (B, k) f32, top_r (B, k) i32, pages (B,) i32,
    cand (B,) i32, done_a (B,) bool).
    """
    progressive = block_gap is not None
    b, nb = order.shape
    dev = q.device
    scores = (x.float() @ q.float().T).T.reshape(b, nb, page_rows)
    valid = (ids >= 0).view(nb, page_rows)
    top_s = init_scores.float().clone()
    top_r = init_rows.int().clone()
    pages = torch.zeros(b, dtype=torch.int32, device=dev)
    cand = torch.zeros(b, dtype=torch.int32, device=dev)
    done = top_s[:, k - 1] >= c_half
    if progressive:
        steps = min(budget, nb)
    else:
        steps = min(budget, int(n_sel.max())) if b else 0
    ar = torch.arange(b, device=dev)
    offs = torch.arange(page_rows, device=dev, dtype=torch.int32)
    for t in range(steps):
        blk = order[:, t].long()
        if progressive:
            live = scan_qualify(block_gap[ar, blk], block_max_l2sq[blk],
                                top_s[:, k - 1], q_l2sq, c, x_p, cs_prune)
        else:
            live = t < n_sel
        live = live & ~done
        v = valid[blk] & live[:, None]                           # (B, p)
        s = torch.where(v, scores[ar, blk], torch.full_like(scores[:, 0], NEG_INF))
        r = torch.where(v, (blk.int() * page_rows)[:, None] + offs,
                        torch.full_like(v, -1, dtype=torch.int32))
        cat_s = torch.cat([top_s, s], dim=1)
        srt, idx = torch.sort(cat_s, dim=1, descending=True, stable=True)
        new_r = torch.cat([top_r, r], dim=1).gather(1, idx[:, :k])
        top_s = torch.where(live[:, None], srt[:, :k], top_s)
        top_r = torch.where(live[:, None], new_r, top_r)
        pages += live.int()
        cand += v.sum(dim=1, dtype=torch.int32)
        done = done | (top_s[:, k - 1] >= c_half)
        if t % 64 == 63 and bool(done.all()):
            break
    return top_s.contiguous(), top_r.contiguous(), pages, cand, done


_U32 = 0xFFFFFFFF


def merge_key(scores: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The `block_mips` kernel's 64-bit merge key, larger = better: the
    score's bits in an unsigned order (-0 counted as +0), then the position
    inverted, so the lower position wins a tie. Returned as int64 with the
    key's top bit flipped, which keeps the order."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores.float())
    bits = s.contiguous().view(torch.int32).long() & _U32
    u = torch.where(bits >= 2 ** 31, _U32 - bits, bits | 2 ** 31)
    return (u - 2 ** 31) * 2 ** 32 + (_U32 - pos.long())


def key_score(key: torch.Tensor) -> torch.Tensor:
    """The score of a merge key (a -0 comes back as +0)."""
    u = (key >> 32) + 2 ** 31
    bits = torch.where(u >= 2 ** 31, u & 0x7FFFFFFF, _U32 - u)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.int().view(torch.float32)


def key_pos(key: torch.Tensor) -> torch.Tensor:
    """The position of a merge key."""
    return _U32 - (key & _U32)


def block_mips_stages_ref(x, valid, q, slots, sel, init_scores, init_rows,
                          c_half, *, k: int, page_rows: int):
    """`block_mips_ref` computed the way the CUDA kernel decomposes it, for
    the tests: (1) the row scores of each selected (query, slot) pair, once,
    -inf on invalid rows, and cnt; (2) one cut per query from the prefix
    counts: a query's live slots are its selected slots before the first
    one at which n0 + the exclusive prefix of cnt reaches k; (3) one top-k
    of the carried keys and the live finite stored keys under `merge_key`
    (carried entries at positions 0..k-1, tile row t at k + t), read back
    through its inverse: carried entries keep their own bits."""
    b, n_slots = sel.shape
    d = x.shape[1]
    sl = slots.long()
    sel = sel.bool()
    xt = x.view(-1, page_rows, d)[sl].reshape(-1, d)             # (R, d)
    rvalid = valid.view(-1, page_rows)[sl].bool()                # (NS, p)
    s = (xt.float() @ q.float().T).T.reshape(b, n_slots, page_rows)
    scr = torch.where(sel[:, :, None] & rvalid[None], s,
                      torch.full_like(s, NEG_INF))               # (B, NS, p)
    cnt = ((scr >= c_half[:, None, None]).sum(dim=2) * sel).int()

    n0 = (init_scores >= c_half[:, None]).sum(dim=1)
    excl = torch.cumsum(cnt.long(), dim=1) - cnt
    stop = sel & (n0[:, None] + excl >= k)
    slot_idx = torch.arange(n_slots, device=x.device)
    cut = torch.where(stop, slot_idx, torch.full_like(slot_idx, n_slots)
                      ).amin(dim=1)                              # (B,)
    live = sel & (slot_idx[None, :] < cut[:, None])
    pages = live.sum(dim=1).int()
    cand = (live.long() * rvalid.sum(dim=1)[None, :]).sum(dim=1).int()

    pos_tile = k + torch.arange(n_slots * page_rows, device=x.device)
    tile_s = scr.reshape(b, -1)
    tile_ok = live.repeat_interleave(page_rows, dim=1) & (tile_s > NEG_INF)
    carried = merge_key(init_scores, torch.arange(k, device=x.device)[None])
    tile = torch.where(tile_ok, merge_key(tile_s, pos_tile[None]),
                       torch.full_like(tile_ok, -2 ** 63, dtype=torch.long))
    top = torch.topk(torch.cat([carried, tile], dim=1), k, dim=1).values
    pos = key_pos(top)
    from_init = pos < k
    t = (pos - k).clamp(min=0)
    rows = sl[t // page_rows] * page_rows + t % page_rows
    pi = pos.clamp(max=k - 1)
    top_s = torch.where(from_init, init_scores.gather(1, pi), key_score(top))
    top_r = torch.where(from_init, init_rows.long().gather(1, pi), rows).int()
    return top_s, top_r, cnt, pages, cand


def sketch_scores_ref(q: torch.Tensor, sk_mu: torch.Tensor) -> torch.Tensor:
    """Estimated block scores from the DECODED sketch centroids:
    q (B, d), sk_mu (NB, d) -> (B, NB). One GEMM; the kernel sums the same
    subspace products through a LUT in another order, so the two agree to
    float tolerance, not bitwise."""
    return q.float() @ sk_mu.float().T


def sketch_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(B, M, K) table lut[b, s, j] = <q_b[s], codebook_s[j]>, in plain
    torch (the JAX package builds it outside its grid too); the sketch
    kernel sums its entries."""
    b = q.shape[0]
    m, _, sub_d = codebooks.shape
    return torch.einsum("bms,mks->bmk", q.view(b, m, sub_d),
                        codebooks).contiguous()


def sketch_scores_lut_ref(q, codebooks, codes):
    """The sketch kernel's own arithmetic, for tests: est[b, n] = sum over
    s = 0..M-1, in that order, of sketch_lut(q, codebooks)[b, s, codes[n, s]]
    in f32 from 0. q (B, d), codebooks (M, K, d/M), codes (NB, M) ->
    (B, NB). The kernel gives these bits exactly; the GEMM
    `sketch_scores_ref` agrees to float tolerance."""
    lut = sketch_lut(q, codebooks)
    codes = codes.long()
    est = torch.zeros((q.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=q.device)
    for s in range(codes.shape[1]):
        est = est + lut[:, s, codes[:, s]]
    return est


def binary_probe_lb_ref(codes, q_code, q_proj):
    """Theorem-3 group lower bounds for a query batch:
    lb[b, g] = sum_i bit_i(codes[g] ^ q_code[b]) |q_proj[b, i]| / sqrt(m).
    codes (G,) int64, q_code (B,) int64, q_proj (B, m) f32 -> (B, G) f32.
    One (B, G, m) x (B, m) product over the unpacked bits; the kernel sums
    the same terms in bit order, so the two agree to float tolerance."""
    m = q_proj.shape[-1]
    shifts = torch.arange(m, dtype=torch.int64, device=q_proj.device)
    bits = (((codes[None, :] ^ q_code[:, None])[..., None] >> shifts) & 1
            ).to(torch.float32)                                  # (B, G, m)
    sqrt_m = torch.sqrt(torch.full((), float(m), dtype=torch.float32,
                                   device=q_proj.device))
    return torch.einsum("bgm,bm->bg", bits, q_proj.abs()) / sqrt_m


def quick_probe_select_ref(code, min_l1, count, rep_proj, rep_row, q_proj,
                           q_l1, c: float, x_p: float):
    """Batched Quick-Probe (Algorithm 2) over a group table of G groups:
    code (G,) int64, min_l1 (G,) f32, count (G,) i32 (0 marks padding),
    rep_proj (G, m) f32, rep_row (G,) i32; q_proj (B, m) f32, q_l1 (B,) f32.

    The Theorem-3 bounds of `binary_probe_lb_ref`; Test A: LB^2 >= x_p * c *
    (min_l1 + ||q||_1)^2. Among passing groups the smallest LB wins
    (`torch.argmin` returns the first minimum, as `jnp` does); with none
    passing, the largest tested value. Returns (rep_row (B,), radius (B,),
    test_a_passed (B,)): the chosen group's representative row, the distance
    from its projection to the query's (its squares summed in index order),
    and whether any group passed."""
    m = q_proj.shape[-1]
    weights = torch.ones((), dtype=torch.int64, device=q_proj.device) << torch.arange(
        m, dtype=torch.int64, device=q_proj.device)
    q_code = ((q_proj >= 0.0).to(torch.int64) * weights).sum(dim=-1)   # (B,)
    lb = binary_probe_lb_ref(code, q_code, q_proj)                    # (B, G)
    valid = count > 0
    denom = c * (min_l1[None, :] + q_l1[:, None]) ** 2
    val = lb * lb / torch.clamp(denom, min=1e-30)
    passes = (val >= x_p) & valid[None, :]

    any_pass = passes.any(dim=1)
    inf = torch.full_like(lb, float("inf"))   # no host copy: capturable
    first_pass = torch.argmin(torch.where(passes, lb, inf), dim=1)
    best_val = torch.argmax(torch.where(valid[None, :], val, -inf), dim=1)
    chosen = torch.where(any_pass, first_pass, best_val)            # (B,)

    diff = rep_proj[chosen] - q_proj                                # (B, m)
    # the m squares summed in index order, each step rounded, and a
    # correctly rounded root (through f64, exact for an f32 argument): the
    # JAX package's order on the CPU and the kernel's, so the radius is
    # bit-identical to both. A torch reduction may order the sum otherwise
    # and torch's CPU sqrt may miss by an ulp, which can move a round-1
    # block whose sub-partition sits exactly at its sphere cut.
    r2 = torch.zeros(q_proj.shape[0], dtype=torch.float32,
                     device=q_proj.device)
    for i in range(m):
        r2 = r2 + diff[:, i] * diff[:, i]
    return rep_row[chosen], torch.sqrt(r2.double()).float(), any_pass


def decode_attention_ref(q, k, v, cache_len, block: int = 1024,
                         return_lse: bool = False):
    """One-token GQA attention against a KV cache, the arithmetic of the
    JAX package's `models/attention.py::flash_decode`: q scaled by
    1/sqrt(dh) before the dot, online softmax over blocks of ``block``
    positions, positions at or past ``cache_len[b]`` masked with -1e30.

    q (B, KH, G, dh); k, v (B, S, KH, dh); cache_len (B,) -> (B, KH, G, dh)
    in q's dtype (computed in f32, as the JAX function); with ``return_lse``
    the output in f32 (the pieces of a split sequence are merged before
    it is rounded) and the (B, KH, G) f32 log-sum-exp of each row's scaled
    scores, m + log(l) of the online softmax, -inf where cache_len <= 0
    (the kernel's: such a row weighs nothing in a merge). The cache has S
    positions and no more: with cache_len = 0 every score is -1e30 and the
    result is the mean of V over S, as
    `repro.kernels.ref.decode_attention_ref` gives (`flash_decode` pads S to
    its block and would divide by the padded length instead)."""
    b, kh, g, dh = q.shape
    s = k.shape[1]
    qg = q.float() * dh ** -0.5
    lens = cache_len.to(device=q.device)
    m = torch.full((b, kh, g), MASKED, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, dh), dtype=torch.float32, device=q.device)
    for t0 in range(0, s, block):
        kb = k[:, t0:t0 + block].float()
        vb = v[:, t0:t0 + block].float()
        pos = torch.arange(t0, t0 + kb.shape[1], device=q.device)
        scores = torch.einsum("bkgd,btkd->bkgt", qg, kb)
        mask = pos[None, :] < lens[:, None]
        scores = torch.where(mask[:, None, None, :], scores,
                             torch.full_like(scores, MASKED))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    if not return_lse:
        return out.to(q.dtype)
    empty = (lens <= 0)[:, None, None]
    lse = torch.where(empty, torch.full_like(m, -torch.inf), m + torch.log(l))
    return out, lse
