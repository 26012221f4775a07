"""The port's fused Quick-Probe (`ref.quick_probe_select_ref`, the plain
version of the `quick_probe_select` kernel, on the CPU) against the JAX
package's `core.quick_probe.quick_probe_batch` on the same group tables.

Held: the chosen representative row and the Test-A flag equal, the radius
within 1e-6 relative (the sum over m runs in another order in the two
frameworks). The tables are made with numpy from a seed, in cases that
reach each rule of the choice: exact ties among the bounds (integer
projections, where every sum is exact and the first index must win),
padding groups (count 0) that would win if they counted, no group passing
Test A (the largest tested value wins), m = 1, m = 30, and G not a multiple
of the kernel's 256-thread block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quick_probe import GroupTable as JaxGroupTable
from repro.core.quick_probe import quick_probe_batch as jax_quick_probe
from repro_torch.core.quick_probe import GroupTable, quick_probe_batch
from repro_torch.kernels import ops, ref

C = 0.9
RTOL = 1e-6


def _table(rng, g, m, b, flavor):
    """(numpy group table, q_proj, q_l1, x_p) for one case."""
    if 2 ** m <= 4 * g:
        codes = rng.choice(2 ** m, g, replace=False)
    else:                            # g distinct codes of a large space
        codes = rng.permutation(np.unique(rng.randint(0, 2 ** m, 2 * g)))[:g]
    codes = np.sort(codes).astype(np.uint32)
    if flavor == "ties":
        q_proj = rng.choice([-2.0, 2.0], (b, m)).astype(np.float32)
        min_l1 = np.full(g, 3.0, np.float32)
        rep_proj = rng.randint(-3, 4, (g, m)).astype(np.float32)
        q_l1 = np.full(b, 4.0, np.float32)
    else:
        q_proj = rng.standard_normal((b, m)).astype(np.float32)
        min_l1 = rng.uniform(0.5, 4.0, g).astype(np.float32)
        rep_proj = rng.standard_normal((g, m)).astype(np.float32)
        q_l1 = np.abs(q_proj).sum(axis=1).astype(np.float32)
    count = rng.randint(1, 50, g).astype(np.int32)
    if flavor == "padding":
        pad = rng.rand(g) < 0.3
        count[pad] = 0
        min_l1[pad] = 1e-3           # a padding group would win both rules
    rep_row = rng.permutation(10 * g)[:g].astype(np.int32)
    # x_p at a middle quantile of the tested values, so some groups pass
    lb = ((((codes[None, :] ^ _codes(q_proj)[:, None])[..., None]
            >> np.arange(m)) & 1) * np.abs(q_proj)[:, None, :]).sum(-1) / np.sqrt(m)
    val = lb ** 2 / (C * (min_l1[None, :] + q_l1[:, None]) ** 2)
    x_p = 1e9 if flavor == "none pass" else float(np.quantile(val, 0.7))
    table = dict(code=codes, min_l1=min_l1, rep_proj=rep_proj, rep_row=rep_row,
                 count=count)
    return table, q_proj, q_l1, x_p


def _codes(q_proj):
    m = q_proj.shape[1]
    return ((q_proj >= 0) * (1 << np.arange(m))).sum(axis=1).astype(np.uint32)


CASES = {   # name: (seed, G, m, B, flavor)
    "ties among bounds": (0, 200, 8, 6, "ties"),
    "padding groups": (1, 300, 12, 8, "padding"),
    "no group passes": (2, 100, 10, 5, "none pass"),
    "m=1": (3, 2, 1, 4, "float"),
    "m=30": (4, 1000, 30, 4, "float"),
    "G=4493, not a multiple of 256": (5, 4493, 16, 64, "float"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_quick_probe_select_ref_matches_jax(name):
    seed, g, m, b, flavor = CASES[name]
    table, q_proj, q_l1, x_p = _table(np.random.RandomState(seed), g, m, b,
                                      flavor)
    t = {key: torch.from_numpy(v.astype(np.int64) if key == "code" else v)
         for key, v in table.items()}
    rep, radius, passed = ref.quick_probe_select_ref(
        t["code"], t["min_l1"], t["count"], t["rep_proj"], t["rep_row"],
        torch.from_numpy(q_proj), torch.from_numpy(q_l1), C, x_p)
    jtable = JaxGroupTable(**{key: jnp.asarray(v) for key, v in table.items()})
    jrep, jradius, jpassed = jax_quick_probe(jtable, jnp.asarray(q_proj),
                                             jnp.asarray(q_l1), C, x_p)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(passed.numpy(), np.asarray(jpassed))
    np.testing.assert_allclose(radius.numpy(), np.asarray(jradius), rtol=RTOL)
    # the entry the search calls takes the same plain version on the CPU
    got = quick_probe_batch(GroupTable(**t), torch.from_numpy(q_proj),
                            torch.from_numpy(q_l1), C, x_p)
    for a, w in zip(got, (rep, radius, passed)):
        assert torch.equal(a, w)

    # the case reaches the rule it is named for
    pos = {int(r): i for i, r in enumerate(table["rep_row"])}
    chosen = np.array([pos[int(r)] for r in rep])
    if flavor == "none pass":
        assert not passed.any()
    else:
        assert passed.any()
    if flavor == "padding":
        assert (table["count"][chosen] > 0).all()
        counted = ref.quick_probe_select_ref(
            t["code"], t["min_l1"], torch.ones_like(t["count"]), t["rep_proj"],
            t["rep_row"], torch.from_numpy(q_proj), torch.from_numpy(q_l1), C,
            x_p)[0]
        assert (table["count"][[pos[int(r)] for r in counted]] == 0).any(), \
            "no padding group would have won"
    if flavor == "ties":
        q_code = torch.from_numpy(_codes(q_proj).astype(np.int64))
        lb = ref.binary_probe_lb_ref(t["code"], q_code,
                                     torch.from_numpy(q_proj)).numpy()
        tied = [(lb[i] == lb[i, chosen[i]]).sum() > 1 for i in range(b)]
        assert any(tied), "no query chose among tied bounds"


def test_quick_probe_select_dispatches_by_device():
    """On CPU tensors `ops.quick_probe_select` is the plain version, and
    asking for the kernel there raises."""
    table, q_proj, q_l1, x_p = _table(np.random.RandomState(6), 64, 6, 3,
                                      "float")
    t = [torch.from_numpy(table[key].astype(np.int64) if key == "code"
                          else table[key])
         for key in ("code", "min_l1", "count", "rep_proj", "rep_row")]
    args = (*t, torch.from_numpy(q_proj), torch.from_numpy(q_l1), C, x_p)
    for a, w in zip(ops.quick_probe_select(*args),
                    ref.quick_probe_select_ref(*args)):
        assert torch.equal(a, w)
    with pytest.raises(ValueError, match="use_kernels=True needs CUDA"):
        ops.quick_probe_select(*args, use_kernels=True)
