"""The CUDA `block_mips` kernel's decomposition, modelled in plain PyTorch
on the CPU (`ref.block_mips_stages_ref`): each selected pair scored once,
one live cut per query from the prefix counts, and one top-k under the
64-bit `merge_key` and its inverse.

Held bit for bit against `ref.block_mips_ref` (the same products, so float
data too), and against the JAX oracle `repro.kernels.ref.block_mips_ref`:
rows, counts, pages and candidates equal, scores within 1e-5 relative to
||q|| ||x|| (the frameworks sum their GEMMs in other orders; integer data
is exact in both). The key order is held directly against (score desc,
position asc) on +-0, -inf and equal scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref

REL = 1e-5
_jax_block_mips_ref = jax.jit(jax_ref.block_mips_ref,
                              static_argnames=("k", "page_rows", "dense"))


def _round(seed, nb, p, d, b, k, ns, integer, hit_q=0.95, valid_frac=0.85,
           empty_init=False):
    """Seeded round inputs: padding slots, invalid rows, duplicate rows
    (integer data), a carried top-k with hits and (-inf, -1) tails; c_half
    at the ``hit_q`` quantile of each query's scores."""
    rng = np.random.RandomState(seed)
    n = nb * p
    if integer:
        x = rng.randint(-3, 4, (n, d)).astype(np.float32)
        q = rng.randint(-3, 4, (b, d)).astype(np.float32)
        dup = rng.choice(n, n // 6, replace=False)
        x[dup] = x[rng.choice(n, len(dup))]                  # exact ties
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
    valid = rng.rand(n) < valid_frac
    blocks = np.sort(rng.choice(nb, ns - 2, replace=False))
    slots = np.concatenate([blocks, [0, 0]]).astype(np.int32)
    sel = rng.rand(b, ns) > 0.4
    sel[:, ns - 2:] = False                                  # padding slots
    s = q.astype(np.float64) @ x.T.astype(np.float64)
    c_half = np.quantile(s, hit_q, axis=1).astype(np.float32)
    if integer:
        c_half += 0.5
    lo, hi = np.quantile(s, 0.5), s.max()
    init = rng.randint(int(lo), int(hi) + 1, (b, k)) if integer else \
        rng.uniform(lo, hi, (b, k))
    init_s = np.sort(init.astype(np.float32), axis=1)[:, ::-1].copy()
    init_r = rng.randint(0, n, (b, k)).astype(np.int32)
    tail = rng.randint(0, k + 1, b)
    for i in range(b):
        init_s[i, k - tail[i]:] = -np.inf
        init_r[i, k - tail[i]:] = -1
    if empty_init:
        init_s[:] = -np.inf
        init_r[:] = -1
    return x, valid, q, slots, sel, init_s, init_r, c_half


CASES = {  # name: (seed, nb, p, d, b, k, ns, integer, extra)
    "B1-k1-float": (0, 12, 8, 32, 1, 1, 8, False, {}),
    "B5-k10-p21-float": (1, 20, 21, 48, 5, 10, 12, False, {}),
    "B16-k32-float": (2, 16, 32, 32, 16, 32, 10, False, {}),
    "B5-k10-p21-integer-ties": (1, 20, 21, 48, 5, 10, 12, True, {}),
    "B16-k32-integer-ties": (2, 16, 32, 32, 16, 32, 10, True, {}),
    "stop-inside-the-slots": (3, 60, 8, 32, 6, 10, 50, True, {"hit_q": 0.5}),
    "k1025-above-the-old-merge": (4, 300, 8, 32, 4, 1025, 200, True, {}),
    "k4096-p16": (5, 300, 16, 32, 3, 4096, 260, True, {}),
    "fewer-valid-rows-than-k": (7, 6, 8, 32, 3, 32, 4, False,
                                {"valid_frac": 0.4, "empty_init": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stages_equal_plain_and_jax_oracle(name):
    seed, nb, p, d, b, k, ns, integer, extra = CASES[name]
    args = _round(seed, nb, p, d, b, k, ns, integer, **extra)
    t_args = [torch.from_numpy(a) for a in args]
    got = ref.block_mips_stages_ref(*t_args, k=k, page_rows=p)
    plain = ref.block_mips_ref(*t_args, k=k, page_rows=p)
    for label, g, w in zip(("top_s", "top_r", "cnt", "pages", "cand"), got,
                           plain):
        assert g.dtype == w.dtype, label
        assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w
                           ), label
    want = _jax_block_mips_ref(*[jnp.asarray(a) for a in args], k=k,
                               page_rows=p)
    x, q = args[0], args[2]
    scale = np.linalg.norm(q, axis=1).max() * np.linalg.norm(x, axis=1).max()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=REL,
                               atol=REL * scale)
    for label, g, w in zip(("top_r", "cnt", "pages", "cand"), got[1:],
                           want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=label)
    if extra.get("hit_q", 1.0) < 0.9:
        assert bool((got[3] < t_args[4].sum(dim=1)).any()), "no stop fired"
    if extra.get("empty_init"):
        assert bool((got[1] == -1).any())


def test_merge_key_orders_by_score_then_position():
    scores = torch.tensor([0.0, -0.0, float("-inf"), 1.5, 1.5, -2.0, -0.0,
                           float("inf"), 3e-38, -3e-38])
    pos = torch.tensor([4, 1, 0, 7, 2, 3, 9, 5, 6, 8])
    keys = ref.merge_key(scores, pos)
    assert len(set(keys.tolist())) == len(keys)             # keys are unique
    order = torch.argsort(keys, descending=True).tolist()
    want = sorted(range(len(scores)), key=lambda i: (-float(scores[i]),
                                                     int(pos[i])))
    assert order == want
    # -0 and +0 tie on the score: the lower position first
    assert int(keys[1]) > int(keys[0]) > int(keys[6])


def test_merge_key_inverse():
    rng = np.random.RandomState(0)
    scores = torch.from_numpy(np.concatenate([
        rng.standard_normal(200).astype(np.float32) * 1e3,
        np.float32([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45])]))
    pos = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, len(scores)))
    keys = ref.merge_key(scores, pos)
    back = ref.key_score(keys)
    same = scores.clone()
    same[same == 0] = 0.0                                   # -0 reads as +0
    assert torch.equal(back.view(torch.int32), same.view(torch.int32))
    assert torch.equal(ref.key_pos(keys), pos.long())
