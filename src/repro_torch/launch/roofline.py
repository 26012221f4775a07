"""Analytic roofline of the port's kernels and search stages on one H100.

The counterpart of the JAX package's `repro.launch.roofline.kernel_cost`,
which reads XLA's compile-time ``cost_analysis``. PyTorch has nothing like
it, so every count here is computed from shapes (and, where the work depends
on the data, from the counts this run's data needs: the pages a tile reads,
the (query, page) pairs it scores, the rows a decode reads). Each count is
the LEAST work the function must do: every input byte read once, every
output byte written once, every arithmetic operation of the function once,
whatever a kernel reads again or computes twice. The records therefore carry
``static_upper_bound: False``: they are a floor on the time, where XLA's
figures sum every branch of a switch and are an upper bound on the traffic.

Each function returns JAX's record keys: ``flops``, ``bytes``,
``t_compute_s`` (flops over the fp32 rate outside the tensor cores),
``t_memory_s`` (bytes over the HBM rate), ``roofline_s`` (the larger) and
``bound`` (``"compute"`` or ``"memory"``).

Constants: NVIDIA's data sheet for the H100 SXM at its 700 W limit. A card
set to a lower power limit runs below them under load.
"""
from __future__ import annotations

HBM_BW = 3.35e12       # bytes/s
PEAK_FP32 = 67e12      # FLOP/s, fp32 outside the tensor cores


def cost(flops: float, nbytes: float) -> dict:
    """The roofline record of ``flops`` operations moving ``nbytes``."""
    t_comp = float(flops) / PEAK_FP32
    t_mem = float(nbytes) / HBM_BW
    return {"flops": float(flops), "bytes": float(nbytes),
            "t_compute_s": t_comp, "t_memory_s": t_mem,
            "roofline_s": max(t_comp, t_mem),
            "bound": "compute" if t_comp >= t_mem else "memory",
            "static_upper_bound": False}


def add(*records: dict) -> dict:
    """One record for work done in sequence: flops and bytes summed."""
    return cost(sum(r["flops"] for r in records),
                sum(r["bytes"] for r in records))


# ---------------------------------------------------------------- kernels

def block_mips(b: int, d: int, k: int, page_rows: int, n_slots: int,
               pages_read: int, pairs: int) -> dict:
    """One fused verification round (`kernels/csrc/block_mips.cu`): the
    ``pages_read`` pages selected by any query (rows and validity flags),
    the queries, the slot table and the (B, NS) selection, the carried top-k
    in and out, c_half and the (B, NS) counts, pages and candidates out;
    2 d flops per row of each of the ``pairs`` selected (query, page)
    pairs."""
    nbytes = (pages_read * page_rows * (d * 4 + 1) + b * d * 4 + n_slots * 4
              + b * n_slots + 2 * b * k * 8 + b * 4 + b * n_slots * 4 + b * 8)
    return cost(2.0 * d * page_rows * pairs, nbytes)


def mips_score(r: int, b: int, d: int) -> dict:
    """The (R, B) score matrix (`mips_score.cu`): rows, queries and the row
    flags read once, the scores written once; 2 R B d flops."""
    return cost(2.0 * r * b * d, r * d * 4 + b * d * 4 + r + r * b * 4)


def sketch_scores(b: int, d: int, nb: int, m: int, kcw: int,
                  sub_d: int) -> dict:
    """The prefilter estimates (`sketch_scores.cu`): the (NB, M) codes, the
    codebooks and the queries read once, the (B, NB) estimates written; the
    per-query LUT (2 B M K sub_d flops) and M additions per estimate."""
    nbytes = nb * m * 4 + m * kcw * sub_d * 4 + b * d * 4 + b * nb * 4
    return cost(2.0 * b * m * kcw * sub_d + float(b) * nb * m, nbytes)


def binary_probe_lb(b: int, g: int, m: int) -> dict:
    """The Theorem-3 bounds alone (`binary_probe.cu` `binary_probe_lb`):
    codes (int64), query codes and projections read once, the (B, G) bounds
    written; one multiply-add per bit and the scale."""
    return cost(float(b) * g * (2 * m + 1),
                g * 8 + b * 8 + b * m * 4 + b * g * 4)


def quick_probe_select(b: int, g: int, m: int) -> dict:
    """The whole Quick-Probe (`binary_probe.cu` `quick_probe_select`): the
    group table's codes (int64), min-l1 values and counts and the batch's
    projections and l1 norms read once, the chosen representative read once
    a query, three outputs a query; one multiply-add per bit and about ten
    operations of Test A per (query, group)."""
    nbytes = g * (8 + 4 + 4) + b * (m * 4 + 4) + b * (m * 4 + 4) + b * 9
    return cost(float(b) * g * (2 * m + 10), nbytes)


def decode_attention(b: int, kh: int, g: int, dh: int, rows: int,
                     elem_bytes: int = 4) -> dict:
    """One-token GQA attention (`decode_attention.cuh`) over ``rows`` cached
    positions in all (the sum over the batch of each sequence's length):
    K and V of those rows read once, q read and the output written once, at
    ``elem_bytes`` an element (4 for f32, 2 for bf16); 2 dh flops for the
    score and 2 dh for P.V per (position, query row), in f32."""
    nbytes = (2 * rows * kh * dh * elem_bytes + 2 * b * kh * g * dh * elem_bytes
              + b * 4)
    return cost(float(rows) * kh * g * 4 * dh, nbytes)


def scan_blocks(b: int, d: int, k: int, page_rows: int, union_pages: int,
                pages_walked: int) -> dict:
    """A block walk (`scan_blocks.cu`): the ``union_pages`` distinct pages
    any query walked (rows and ids) read once, the ``pages_walked`` order
    entries, the queries, the top-k in and out; 2 d flops per row of each
    walked (query, page)."""
    nbytes = (union_pages * page_rows * (d * 4 + 4) + pages_walked * 4
              + b * d * 4 + 4 * b * k * 8 + b * 13)
    return cost(2.0 * d * page_rows * pages_walked, nbytes)


# ---------------------------------------------------------------- stages

def select_frontend(b: int, d: int, m: int, g: int, s: int, nb: int,
                    kmax: int) -> dict:
    """`core/search_device.py` `select_frontend` for a (B, d) batch over an
    index of G groups, S sub-partitions and NB blocks of at most KMAX
    sub-partitions: the projection (B d in, d m of A, 2 B d m flops), the
    l1 and squared-l2 norms (2 B d flops each), `quick_probe_select`, the
    (B, S) distances to the sub-partition centers (the (S, m) centers and
    the radii read, 2 B S m flops and 3 B S for the norms and the root), the
    sphere test (2 B S), and the (B, NB) mask from the (NB, KMAX) table
    (B NB KMAX ors). Written: the projection, the norms, the distances, the
    radius, Test A, c_half and the mask (one byte an entry)."""
    probe = quick_probe_select(b, g, m)
    nbytes = (b * d * 4 + d * m * 4 + s * m * 4 + s * 4 + s * 4 + nb * kmax * 4
              + b * m * 4 + 2 * b * 4 + b * s * 4 + b * 4 + b + b * 4 + b * nb)
    flops = (2.0 * b * d * m + 4.0 * b * d + 2.0 * b * s * m + 5.0 * b * s
             + float(b) * nb * kmax)
    return add(probe, cost(flops, nbytes))


def prefilter_round1(b: int, d: int, nb: int, m: int, kcw: int, sub_d: int,
                     page_rows: int) -> dict:
    """`prefilter_round1`: `sketch_scores`, then the error band (the (NB,)
    errors read, a multiply a (query, block)), the block validity from the
    (NB page_rows,) ids, and the survivor cut (the (B, NB) mask in and out,
    a subtraction, an addition and two compares a (query, block)); the
    estimates and the band are written for round 2."""
    sk = sketch_scores(b, d, nb, m, kcw, sub_d)
    nbytes = nb * 4 + nb * page_rows * 4 + b * nb + b * nb + b * nb * 4
    return add(sk, cost(5.0 * b * nb, nbytes))


# one planned tile of the fused verification is one `block_mips` round
fused_verify_tile = block_mips


def topk_rescore(b: int, k: int, d: int) -> dict:
    """`runtime._rescore`: the B k returned rows and the queries read once,
    the (B, k) scores written; 2 d flops a row."""
    return cost(2.0 * b * k * d, b * k * d * 4 + b * k * 4 + b * d * 4
                + b * k * 4)




# ---------------------------------------------------------------- cells
#
# The roofline of a whole (arch x shape) cell on the production mesh:
# counterpart of the JAX `analyse_cell` / `main`. JAX reads XLA's
# cost_analysis of unrolled compiles; the port counts one rank of the split
# program on `meta` (`launch.dryrun.measure`: its FLOPs, unfused bytes and
# collective bytes, each a per-device quantity).
#
# Every term is counted at one precision, the cell's structs' (bf16
# parameters and activations, f32 where the code casts: `dryrun.PRECISION`,
# recorded as ``precision``): the counted run's unfused and collective
# bytes, `fused_memory_bytes` and the compute term at the bf16 rate. (The
# port trains in f32 today; its program moves about twice these bytes and
# computes at `PEAK_FP32` with TF32 off.)
#
# Constants for the cell terms: the H100 SXM data sheet at 700 W. The
# compute term is bf16 dense tensor-core FLOP/s. NVLink 4: 900 GB/s a GPU, 450 GB/s a direction, among the 8 GPUs
# of a node (DGX H100 / HGX H100). The 16 x 16 mesh is 32 such nodes; a
# rank's index is row-major in (data, model), so the 16 ranks of a
# ``model`` group are two nodes (a ring over them crosses the node
# boundary) and a ``data`` or ``pod`` group has one rank a node: every
# axis's collectives are bound by the InfiniBand link, ConnectX-7 at
# 400 Gb/s, 50 GB/s a GPU a direction (the DGX H100 data sheet: eight
# 400 Gb/s ports, one a GPU). A ``model`` axis that fits in one node would
# run at the NVLink rate (`link_bw`).

PEAK_BF16 = 989e12     # FLOP/s, dense bf16 tensor cores
NVLINK_BW = 450e9      # bytes/s a direction, a GPU, inside a node
IB_BW = 50e9           # bytes/s a direction, a GPU, between nodes
NODE_GPUS = 8
RING_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def link_bw(mesh, axes) -> float:
    """The per-direction rate a ring over ``axes`` gets: NVLink where the
    group's ranks lie in one node of `NODE_GPUS` consecutive ranks, else
    InfiniBand."""
    sizes = list(mesh.shape.values())
    names = list(mesh.axis_names)
    stride = 1
    span = 1
    for name, size in zip(reversed(names), reversed(sizes)):
        if name in axes:
            span = max(span, stride * size)
        stride *= size
    return NVLINK_BW if span <= NODE_GPUS else IB_BW


def fused_memory_bytes(cfg, shape, mesh, microbatches):
    """Analytic per-device HBM traffic assuming production kernel fusion:
    a copy of the JAX `fused_memory_bytes` (bf16 weights and activations,
    f32 optimizer state): parameters (re-read per microbatch), optimizer
    state, saved activations (remat=full saves layer inputs), logits,
    embeddings and KV caches. ``hlo_bytes`` (the unfused count) is the
    upper bound beside it."""
    from ..distributed import sharding as shard_lib
    chips = mesh.size
    model_sz = shard_lib.axis_size(mesh, "model")
    dp = shard_lib.axis_size(mesh, shard_lib.dp_axes(mesh))
    n_params = cfg.param_count()
    p_loc = 2.0 * n_params / model_sz
    d = cfg.d_model
    kh, dh = cfg.n_kv_heads, cfg.head_dim_
    v_loc = cfg.vocab_padded * 2.0 / model_sz

    if shape.kind == "train":
        tokens_loc = shape.global_batch * shape.seq_len / dp
        mb_tokens = tokens_loc / microbatches
        act = 2.0 * mb_tokens * d
        per_mb = (2.0 * p_loc + cfg.n_layers * act * 2
                  + cfg.n_layers * act * 8 + mb_tokens * v_loc * 3)
        opt = (4.0 * n_params / chips) * 6
        return microbatches * per_mb + opt + 2.0 * p_loc
    if shape.kind == "prefill":
        tokens_loc = shape.global_batch * shape.seq_len / dp
        cache = 2.0 * 2 * cfg.n_layers * tokens_loc * kh * dh / max(
            model_sz if kh % model_sz == 0 or dh % model_sz == 0 else 1, 1)
        return (p_loc + tokens_loc * d * 2 * 10 + cache
                + tokens_loc / shape.seq_len * v_loc)
    b_loc = max(shape.global_batch / dp, 1)
    kv_len = min(shape.seq_len, cfg.window) if cfg.attn == "swa" else shape.seq_len
    n_kv_layers = {"attn": cfg.n_layers, "encdec": cfg.n_layers,
                   "zamba2": max(cfg.n_layers // cfg.shared_attn_every, 1),
                   "xlstm_7_1": 0}[cfg.block_pattern]
    cache = 2.0 * 2 * n_kv_layers * b_loc * kv_len * kh * dh / model_sz
    state = 0.0
    if cfg.block_pattern == "zamba2":
        inner = cfg.ssm.expand * d
        state = 4.0 * 2 * cfg.n_layers * b_loc * inner * cfg.ssm.state_dim / model_sz
    if cfg.block_pattern == "xlstm_7_1":
        p = d // cfg.n_heads
        state = 4.0 * 2 * cfg.n_layers * b_loc * d * p / model_sz
    return p_loc + cache + state + b_loc * v_loc


def slstm_correction(cfg, shape):
    """Analytic FLOPs of the sLSTM time recurrence, a copy of the JAX
    function: per step per layer the recurrent einsum 2 d 4p and about 24
    elementwise ops on (h, p), times the tokens. JAX adds it because XLA's
    cost analysis counts a while body once. The port's count runs the
    loop step by step, so its recurrent einsums are in ``hlo_flops``
    already: `analyse_cell` does not add this (it would count them twice)
    and reports it as ``slstm_correction_flops`` for comparison."""
    if cfg.block_pattern != "xlstm_7_1":
        return 0.0
    d = cfg.d_model
    p = d // cfg.n_heads
    n_slstm = cfg.n_layers // 8
    per_tok = 2 * d * 4 * p + 24 * d
    if shape.kind == "train":
        return 3.0 * per_tok * shape.global_batch * shape.seq_len * n_slstm
    if shape.kind == "prefill":
        return float(per_tok * shape.global_batch * shape.seq_len * n_slstm)
    return float(per_tok * shape.global_batch * n_slstm)


def model_flops(cfg, shape) -> float:
    """6 N D (train), 2 N D (prefill), 2 N B (decode): N the active
    parameters, D the tokens (JAX's formula)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def analyse_cell(arch_id, shape_name, mesh, *, cfg=None, shape=None):
    """The roofline record of one cell on ``mesh`` (a `mesh.RecordingMesh`
    playing one rank; ``cfg`` / ``shape`` override the registry's), with
    the JAX record's keys. Per device: ``hlo_flops_per_chip`` (the counted
    matrix-product FLOPs of the split program), ``hlo_bytes_per_chip`` (its
    unfused bytes), ``collective_bytes_per_chip`` (result bytes by op),
    ``wire_bytes_per_chip`` (times the ring factor), ``fused_bytes_per_chip``
    (`fused_memory_bytes`). The terms: FLOPs over `PEAK_BF16`, fused bytes
    over `HBM_BW` (the unfused over it as ``t_memory_hlo_upper_s``), each
    axis's wire bytes over its link (`link_bw`). A decode cell is one step
    of the split decode (`dryrun.measure`), its fused bytes the decode
    branch of `fused_memory_bytes` (the parameters' and the cache's pieces
    read once, the recurrent states read and written, the logits)."""
    from ..configs import SHAPES_BY_NAME, get_config
    from . import dryrun, specs as specs_lib
    cfg = get_config(arch_id) if cfg is None else cfg
    shape = SHAPES_BY_NAME[shape_name] if shape is None else shape
    ok, reason = specs_lib.cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "status": reason}
    chips = mesh.size
    mb = (specs_lib.choose_microbatches(cfg, shape, mesh)
          if shape.kind == "train" else 1)
    total, notes = dryrun.measure(cfg, shape, mesh, mb)
    fused_bytes = fused_memory_bytes(cfg, shape, mesh, mb)
    t_comp = total["flops"] / PEAK_BF16
    t_mem_hlo = total["bytes"] / HBM_BW
    t_mem = fused_bytes / HBM_BW
    wire = sum(RING_FACTOR.get(op, 1.0) * b for op, b in total["coll"].items())
    t_coll = sum(RING_FACTOR.get(op, 1.0) * b / link_bw(mesh, axes)
                 for (op, axes), b in total["coll_axes"].items())
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    bound = max(t_comp, t_mem, t_coll)
    return {
        "arch": arch_id, "shape": shape_name, "status": "ok",
        "kind": shape.kind, "chips": chips, "precision": dryrun.PRECISION,
        "hlo_flops_per_chip": total["flops"],
        "hlo_bytes_per_chip": total["bytes"],
        "collective_bytes_per_chip": {k: round(v) for k, v in total["coll"].items()},
        "wire_bytes_per_chip": round(wire),
        "fused_bytes_per_chip": round(fused_bytes),
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_memory_hlo_upper_s": t_mem_hlo, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_frac": (mf / (total["flops"] * chips)
                              if total["flops"] else 0),
        "bound_mfu": (mf / (chips * PEAK_BF16)) / bound if bound else 0,
        "roofline_time_s": bound,
        "slstm_correction_flops": slstm_correction(cfg, shape) / chips,
        **notes,
    }


def main(argv=None):
    """``python -m repro_torch.launch.roofline --all``: every cell's record
    as ``{out}/{arch}__{shape}.json`` on the single-pod mesh (rank 0), the
    JAX CLI's layout under ``results/torch_roofline``: the JAX package's
    ``results/roofline`` stays its own."""
    import argparse
    import json
    import os
    import time
    import traceback

    from ..configs import ARCH_IDS, SHAPES
    from .dryrun import production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_roofline")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    mesh = production_mesh(multi_pod=False)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in SHAPES] if (args.all or not args.shape)
              else [args.shape])
    os.makedirs(args.out, exist_ok=True)
    records = []
    for a in archs:
        for s in shapes:
            path = os.path.join(args.out, f"{a}__{s}.json")
            if os.path.exists(path) and not args.force:
                print(f"[skip] {a}/{s}")
                continue
            t0 = time.time()
            try:
                rec = analyse_cell(a, s, mesh)
            except Exception as e:
                rec = {"arch": a, "shape": s, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            records.append(rec)
            if rec["status"] == "ok":
                print(f"[ok  ] {a}/{s} ({time.time() - t0:.0f}s) "
                      f"dom={rec['dominant']} t=({rec['t_compute_s']:.4f},"
                      f"{rec['t_memory_s']:.4f},{rec['t_collective_s']:.4f})s "
                      f"bound_mfu={rec['bound_mfu']:.3f}", flush=True)
            else:
                print(f"[{rec['status'][:7]}] {a}/{s} {rec.get('error', '')}",
                      flush=True)
    return records



__all__ = ["HBM_BW", "IB_BW", "NVLINK_BW", "PEAK_BF16", "PEAK_FP32", "cost",
           "add", "analyse_cell", "block_mips", "mips_score", "sketch_scores",
           "binary_probe_lb", "quick_probe_select", "decode_attention",
           "scan_blocks", "select_frontend", "prefilter_round1",
           "fused_memory_bytes", "fused_verify_tile", "link_bw", "main",
           "model_flops", "slstm_correction", "topk_rescore"]

if __name__ == "__main__":
    main()
