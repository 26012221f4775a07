"""The analytic roofline of the port (`repro_torch.launch.roofline`), the one
source of the bounds that `chip_smoke.py` prints.

Held: each kernel count reproduces the bound column of `PERF.md` §6 at the
shapes it states (H100 SXM, 3.35 TB/s and 67 TFLOP/s fp32); each stage
count equals a hand-worked small case; every record carries
``static_upper_bound: False`` and JAX's record keys.
"""
import numpy as np
import pytest

from repro_torch.launch import roofline as rl

KEYS = {"flops", "bytes", "t_compute_s", "t_memory_s", "roofline_s", "bound",
        "static_upper_bound"}


def _ms(rec):
    return rec["roofline_s"] * 1e3


def test_constants_are_the_h100s():
    assert rl.HBM_BW == 3.35e12 and rl.PEAK_FP32 == 67e12


@pytest.mark.parametrize("rec,ms,bound", [
    # mips_score at the serve tile: R 32,000, B 4, d 2,048
    (rl.mips_score(32_000, 4, 2048), 0.078, "memory"),
    # sketch_scores at n=1M: B 64, NB 125,000, M 16, K 256 (d 128)
    (rl.sketch_scores(64, 128, 125_000, 16, 256, 8), 0.012, "memory"),
    # binary_probe_lb at n=1M: B 64, G 4,493, m 16
    (rl.binary_probe_lb(64, 4493, 16), 0.00036, "memory"),
    # decode_attention at the serve shape: B 4, lens 1/37/300/512
    (rl.decode_attention(4, 4, 8, 64, 1 + 37 + 300 + 512), 0.0005, "memory"),
    # decode_32k at B 8 with chip_smoke.py's lengths
    (rl.decode_attention(4 * 2, 4, 8, 64, 32768 + 1 + 20000 + 4097 + 64
                         + 31000 + 12345 + 27000), 0.0778, "memory"),
    # decode_32k at B 128 with RandomState(16) lengths
    (rl.decode_attention(128, 4, 8, 64, int(np.random.RandomState(16).randint(
        1, 32769, 128).sum())), 1.2275, "memory"),
    # long_500k: B 1, S 524,288
    (rl.decode_attention(1, 4, 8, 64, 524_288), 0.3205, "memory"),
    # quick_probe_select at n=1M: operations bound
    (rl.quick_probe_select(64, 4493, 16), 0.00018, "compute"),
])
def test_kernel_counts_reproduce_the_perf_table(rec, ms, bound):
    assert set(rec) == KEYS and rec["static_upper_bound"] is False
    # to the decimals the table states
    assert round(_ms(rec), len(repr(ms).split(".")[1])) == ms
    assert rec["bound"] == bound


def test_block_mips_and_scan_blocks_by_hand():
    # B 2, d 4, k 3, page_rows 2, 4 slots, 3 pages read, 5 pairs
    rec = rl.block_mips(2, 4, 3, 2, 4, 3, 5)
    nbytes = (3 * 2 * (4 * 4 + 1) + 2 * 4 * 4 + 4 * 4 + 2 * 4 + 2 * 2 * 3 * 8
              + 2 * 4 + 2 * 4 * 4 + 2 * 8)
    assert rec["bytes"] == nbytes and rec["flops"] == 2 * 4 * 2 * 5
    rec = rl.scan_blocks(2, 4, 3, 2, 3, 7)
    assert rec["bytes"] == (3 * 2 * (16 + 4) + 7 * 4 + 2 * 4 * 4 + 4 * 2 * 3 * 8
                            + 2 * 13)
    assert rec["flops"] == 2 * 4 * 2 * 7
    # n=1M round-1 tile (PERF.md §6): 32,768 slots, 71,807 pairs
    assert rl.block_mips(64, 128, 10, 8, 32768, 23_000, 71_807)["bound"] == "memory"


def test_stage_counts_by_hand():
    # frontend: B 2, d 4, m 3, G 5, S 6, NB 7, KMAX 2
    rec = rl.select_frontend(2, 4, 3, 5, 6, 7, 2)
    probe_bytes = 5 * 16 + 2 * (3 * 4 + 4) * 2 + 2 * 9
    own_bytes = (2 * 4 * 4 + 4 * 3 * 4 + 6 * 3 * 4 + 6 * 4 + 6 * 4 + 7 * 2 * 4
                 + 2 * 3 * 4 + 2 * 2 * 4 + 2 * 6 * 4 + 2 * 4 + 2 + 2 * 4
                 + 2 * 7)
    assert rec["bytes"] == probe_bytes + own_bytes
    assert rec["flops"] == (2 * 5 * (2 * 3 + 10) + 2 * 2 * 4 * 3 + 4 * 2 * 4
                            + 2 * 2 * 6 * 3 + 5 * 2 * 6 + 2 * 7 * 2)
    # prefilter: B 2, d 4, NB 3, M 2, K 4, sub_d 2, page_rows 5
    rec = rl.prefilter_round1(2, 4, 3, 2, 4, 2, 5)
    sk = 3 * 2 * 4 + 2 * 4 * 2 * 4 + 2 * 4 * 4 + 2 * 3 * 4
    assert rec["bytes"] == sk + 3 * 4 + 3 * 5 * 4 + 2 * 3 + 2 * 3 + 2 * 3 * 4
    assert rec["flops"] == 2 * 2 * 2 * 4 * 2 + 2 * 3 * 2 + 5 * 2 * 3
    # one tile is its block_mips round
    assert rl.fused_verify_tile(2, 4, 3, 2, 4, 3, 5) == rl.block_mips(
        2, 4, 3, 2, 4, 3, 5)
    # rescore: B 2, k 3, d 4
    rec = rl.topk_rescore(2, 3, 4)
    assert rec["bytes"] == 2 * 3 * 4 * 4 + 2 * 3 * 4 + 2 * 4 * 4 + 2 * 3 * 4
    assert rec["flops"] == 2 * 2 * 3 * 4
    for r in (rec, rl.select_frontend(2, 4, 3, 5, 6, 7, 2)):
        assert set(r) == KEYS and r["static_upper_bound"] is False
        assert r["roofline_s"] == max(r["t_compute_s"], r["t_memory_s"])
        assert r["t_memory_s"] == r["bytes"] / rl.HBM_BW
        assert r["t_compute_s"] == r["flops"] / rl.PEAK_FP32


def test_add_sums_work_in_sequence():
    a, b = rl.cost(67e6, 0.0), rl.cost(0.0, 3.35e6)
    both = rl.add(a, b)
    assert both["flops"] == 67e6 and both["bytes"] == 3.35e6
    assert both["roofline_s"] == pytest.approx(1e-6)
    assert both["static_upper_bound"] is False
