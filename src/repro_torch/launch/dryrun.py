"""Dry run of every (arch x shape x mesh) cell: one device of the split
program, counted on the ``meta`` device; counterpart of
`repro.launch.dryrun`.

The JAX dry run lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory analysis, cost analysis and collective
schedule. The port has no compiler to ask. It plays rank 0 of the
production mesh with a `mesh.RecordingMesh` (every rank does the same
work; the tests count others): the cell's
function from `specs.build_cell` runs on ``meta`` tensors of that rank's
pieces, under `torch.utils.flop_counter.FlopCounterMode` and a dispatch
mode that adds up every aten op's operand and result bytes, while the
recording mesh tallies each collective's result bytes. Nothing is
allocated.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k

Cells are cached as JSON (one file a cell, ``{out}/{pod_16x16 |
multipod_2x16x16}/{arch}/{shape}.json``, ``--out`` by default
``results/torch_dryrun``) and skipped when present (the sweep is
resumable); ``--force`` reruns them. The JAX package's
``results/dryrun`` stays its own: its records would be overwritten, and
its acceptance test (`tests/test_system.py`) holds every record there to
JAX's.

The record keeps JAX's keys; what each counts in the port:

- ``argument_size_in_bytes`` / ``output_size_in_bytes``: the per-device
  bytes of the cell's inputs and outputs, from `sharding.shard_shape` of
  each struct under its spec (for the train cell's outputs, the state and
  the three f32 metrics ``loss``, ``grad_norm``, ``lr``; a prefill's
  arguments without the labels it never reads, which JAX's jit drops). There is no
  ``temp_size_in_bytes``: ``meta`` has no allocator (``temp_size_note``).
- ``hlo_flops``: the FLOPs FlopCounterMode counts: matrix products only
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...). A weight GEMM under
  remat full counts four times: its forward, the recompute and the
  backward's two products (three where its input needs no gradient). XLA
  also counts elementwise work and the optimizer.
  ``whole_on_every_rank`` names the FLOPs in it that every rank of a
  ``model`` group computes in full (the router GEMM, the frontend
  projection, Mamba2's C B^T scores, the recurrences or attention that run
  whole where heads do not split; at decode the sLSTM's recurrent product,
  whose state is gathered whole), each with its count.
- ``hlo_bytes``: the unfused byte count, each aten op's operand and result
  bytes (views excluded): the counterpart of XLA's "bytes accessed".
- ``collective_bytes`` / ``collective_counts``: the recording mesh's
  tallies under JAX's op names (result bytes, as `parse_collectives`).
- ``hlo_lines``: the aten ops dispatched.
- ``lower_s``: seconds to build the cell's function and pieces;
  ``compile_s``: seconds of the counted ``meta`` run.

Every count is affine in the depth and in the microbatches, so the run is
shortened and the record says how (``extrapolated``), as JAX's roofline
extrapolates its compiles: the cell runs at two and three layers (groups
of 8 for the xLSTM, hybrid groups and one with the tail for zamba2, the
encoder and decoder apart for whisper), a train cell at two and three
microbatches of its microbatch's rows, and the counts are combined
exactly (`_depths`; checked against direct runs of the reduced configs).
The xLSTM's train or prefill cell at a sequence past 2,048 runs at 256
(one mLSTM chunk) and scales every count by ``S / 256``: every term of its blocks is linear in
the chunks and the sLSTM's steps (JAX's roofline runs at 512 and
scales). Where a microbatch's rows do not divide over the data axes
(qwen3-32b and moonshot at ``train_4k``: 8 rows over 16), the rank runs
its ceil(rows / data) rows, as GSPMD pads an uneven split
(``padded_rows``).

One precision throughout (``precision``): the cell's structs' own,
bf16 parameters and activations (`specs.model_dtype`, JAX's program) with
f32 where the code casts as the JAX package does (the norms, the softmax
and its statistics, the recurrences' states, the router, the loss, the
gradient accumulator and the optimizer state). The argument bytes, the
unfused bytes and the collective bytes all describe that program, and
`roofline.analyse_cell` takes its compute term at the bf16 rate. (The
port trains in f32 today: a program with f32 parameters moves about twice
these bytes.)

A decode cell (``decode_32k``, ``long_500k``) runs one step of
`specs.build_cell`'s split decode on this rank's pieces of the
parameters, of the cache in `cache_specs`' layout and of the tokens; its
record names the cache's K/V cut (``kv_layout``, `sharding.KVLayout`).
Its attention is the plain version of `decode_attention` on ``meta`` (the
kernel's arithmetic, an online softmax over blocks of 1,024 positions),
so its unfused bytes count every block's scores.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from .. import tree as tree_lib
from ..configs import ARCH_IDS, SHAPES, SHAPES_BY_NAME, ShapeCfg, get_config
from ..distributed import sharding as shard_lib
from . import specs as specs_lib
from .mesh import RecordingMesh

META = torch.device("meta")
TEMP_NOTE = ("not counted: the meta device has no allocator, so the peak of "
             "temporaries is unknown")
PRECISION = ("bf16 parameters and activations, f32 where the code casts "
             "(norms, softmax, recurrent states, router, loss, gradient "
             "accumulator, optimizer state)")
WHOLE_NOTE = "whole on every rank (heads do not split); not counted apart"
SEQ_RUN = 256          # the xLSTM's sequence for a long cell: one chunk
LONG = 2048
# aten ops that make a view: they move no bytes
_VIEWS = {"view", "unsafe_view", "reshape", "expand", "permute", "t",
          "transpose", "unsqueeze", "squeeze", "slice", "select", "as_strided",
          "detach", "alias", "unbind", "split", "split_with_sizes", "unfold",
          "diagonal", "narrow", "reshape_alias"}


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor operands and results (a
    view moves none): the unfused traffic, XLA's "bytes accessed"."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.lstrip("_") not in _VIEWS:
            self.ops += 1
            for t in tree_flatten((args, kwargs or {}, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def production_mesh(multi_pod: bool, rank: int = 0) -> RecordingMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RecordingMesh(shape, axes, rank)


def _flat(tree) -> list:
    """The leaves of a tree of dicts and tuples (a `P` is a leaf; None has
    none), in `sharding.tree_map_with_path`'s order."""
    out = []
    shard_lib.tree_map_with_path(
        lambda path, leaf: out.append(leaf) if leaf is not None else None, tree)
    return out


def tree_bytes(structs, spec_tree, mesh) -> int:
    """Per-device bytes of ``structs`` (tensors) under ``spec_tree``."""
    return sum(math.prod(shard_lib.shard_shape(spec, t.shape, mesh))
               * t.element_size()
               for t, spec in zip(_flat(structs), _flat(spec_tree)))


def _pieces(structs, spec_tree, mesh):
    """This rank's pieces of ``structs`` on ``meta``, in the structs' dtypes
    (`PRECISION`). A tree of dicts and plain tuples (a cache: the sLSTM's
    state is a tuple) goes by paths; the train state by `tree_lib`."""
    if isinstance(structs, dict):
        specs = iter(_flat(spec_tree))
        return shard_lib.tree_map_with_path(lambda path, t: torch.empty(
            shard_lib.shard_shape(next(specs), t.shape, mesh), device=META,
            dtype=t.dtype), structs)
    if isinstance(structs, torch.Tensor):
        return torch.empty(shard_lib.shard_shape(spec_tree, structs.shape, mesh),
                           device=META, dtype=structs.dtype)
    return tree_lib.map(lambda t, s: torch.empty(
        shard_lib.shard_shape(s, t.shape, mesh), device=META, dtype=t.dtype),
        structs, spec_tree)


def _count(fn, args) -> dict:
    """Run ``fn(*args)`` on ``meta`` under the counters."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes": float(nbytes.bytes),
            "ops": nbytes.ops}


def _mb_rows(cfg, shape, mesh, mb) -> tuple:
    """(rows a microbatch gives this rank's data group, padded or not)."""
    rows = shape.global_batch // mb
    dp = shard_lib.axis_size(mesh, shard_lib.dp_axes(mesh))
    bdim = shard_lib.batch_specs(cfg, shape, mesh)["tokens"][0]
    if bdim is None or rows % dp == 0:
        return rows, False
    return -(-rows // dp) * dp, True


def _depths(cfg) -> list:
    """[(config, weight)]: shallow configs whose counts, weighted, give
    ``cfg``'s (every count is affine in the layers of a kind from two
    layers on; a stack of one layer moves other bytes): two and three
    attention layers; two and three groups of 8 xLSTM layers; two and three
    hybrid groups and two groups with the tail; the encoder and the decoder
    of an encoder-decoder apart. Weights of 0 are dropped; a config at
    most that deep runs as it is."""
    rep = lambda **kw: dataclasses.replace(cfg, **kw)
    if cfg.block_pattern == "encdec":
        e, n = cfg.enc_layers, cfg.n_layers
        if e <= 2 and n <= 2:
            return [(cfg, 1)]
        out = [(rep(enc_layers=2, n_layers=2), 5 - e - n),
               (rep(enc_layers=3, n_layers=2), e - 2),
               (rep(enc_layers=2, n_layers=3), n - 2)]
    elif cfg.block_pattern == "xlstm_7_1":
        g = cfg.n_layers // 8
        if g <= 2:
            return [(cfg, 1)]
        out = [(rep(n_layers=16), 3 - g), (rep(n_layers=24), g - 2)]
    elif cfg.block_pattern == "zamba2":
        every = cfg.shared_attn_every
        g, tail = divmod(cfg.n_layers, every)
        if g <= 2:
            return [(cfg, 1)]
        out = [(rep(n_layers=2 * every), (2 - g) if tail else (3 - g)),
               (rep(n_layers=3 * every), g - 2)]
        if tail:
            out.append((rep(n_layers=2 * every + tail), 1))
    else:
        if cfg.n_layers <= 3:
            return [(cfg, 1)]
        out = [(rep(n_layers=2), 3 - cfg.n_layers),
               (rep(n_layers=3), cfg.n_layers - 2)]
    return [(c, w) for c, w in out if w]


_TALLIES = ("coll", "coll_counts", "coll_axes")


def _combine(parts) -> dict:
    """The sum of ``weight * counts`` over ``parts``."""
    out = {"flops": 0.0, "bytes": 0.0, "ops": 0.0}
    out.update({key: {} for key in _TALLIES})
    for counts, w in parts:
        for k in ("flops", "bytes", "ops"):
            out[k] += w * counts[k]
        for key in _TALLIES:
            for kind, v in counts[key].items():
                out[key][kind] = out[key].get(kind, 0) + w * v
    return out


def _count_with_mesh(mesh, fn, args) -> dict:
    mesh.reset()
    counts = _count(fn, args)
    counts["coll"] = dict(mesh.bytes)
    counts["coll_counts"] = dict(mesh.counts)
    counts["coll_axes"] = dict(mesh.axis_bytes)
    return counts


def _run(cfg, shape, mesh, n_mb: int = 1) -> dict:
    """One counted run of the cell's function on this rank's pieces (a
    train cell with ``n_mb`` microbatches)."""
    fn, args, in_specs, _ = specs_lib.build_cell(
        cfg, shape, mesh, microbatch_override=n_mb if shape.kind == "train"
        else None)
    state = _pieces(args[0], in_specs[0], mesh)
    if shape.kind == "train":
        return _count_with_mesh(mesh, fn, (state, args[1]))
    rest = [_pieces(a, s, mesh) for a, s in zip(args[1:], in_specs[1:])]
    with torch.no_grad():
        return _count_with_mesh(mesh, fn, (state, *rest))


def measure(cfg, shape, mesh, mb: int) -> tuple:
    """(counts, notes) of one rank's run of a cell: the shallow depths of
    `_depths`, a train cell at 1 and 2 microbatches of its microbatch's
    rows, the xLSTM's train or prefill cell past 2,048 tokens at
    `SEQ_RUN`."""
    notes = {"extrapolated": []}
    factor = 1.0
    if cfg.block_pattern == "xlstm_7_1" and shape.seq_len > LONG and \
            shape.kind != "decode":
        factor = shape.seq_len / SEQ_RUN
        shape = dataclasses.replace(shape, seq_len=SEQ_RUN)
        notes["extrapolated"].append(f"sequence: run at {SEQ_RUN}, every "
                                     f"count scaled by {factor:g}")
    runs = []
    depths = _depths(cfg)
    notes["extrapolated"].append(
        "depth: " + " + ".join(f"{w:g} x ({_depth_name(c)})" for c, w in depths))
    if shape.kind == "train":
        rows, padded = _mb_rows(cfg, shape, mesh, mb)
        if padded:
            notes["padded_rows"] = (f"{shape.global_batch // mb} rows a "
                                    f"microbatch padded to {rows} over the "
                                    f"data axes")
        # from two microbatches on each adds the same work (the first
        # copies its gradient, the others add theirs)
        mbs = [(2, 3 - mb), (3, mb - 2)] if mb > 3 else [(mb, 1)]
        notes["extrapolated"].append(
            f"microbatches: {mb} from runs of 2 and 3 microbatches of {rows} "
            f"rows" if mb > 3 else f"microbatches: {mb} of {rows} rows")
        for c, w in depths:
            for n, wm in mbs:
                if wm:
                    sub = dataclasses.replace(shape, global_batch=rows * n)
                    runs.append((_run(c, sub, mesh, n), w * wm))
    else:
        runs = [(_run(c, shape, mesh), w) for c, w in depths]
    return _combine([(c, w * factor) for c, w in runs]), notes


def _depth_name(cfg) -> str:
    if cfg.block_pattern == "encdec":
        return f"{cfg.enc_layers} + {cfg.n_layers} layers"
    return f"{cfg.n_layers} layers"


def whole_on_every_rank(cfg, shape, mesh, mb: int) -> dict:
    """The FLOPs that every rank of a ``model`` group computes in full, by
    component (their sum is in ``hlo_flops`` once a rank): see the module's
    docstring. A train cell counts each under its remat passes (full:
    forward, recompute and the backward's products)."""
    model = shard_lib.axis_size(mesh, "model")
    if model == 1:
        return {}
    split = shard_lib.batch_specs(cfg, shape, mesh)["tokens"][0] is not None
    dp = shard_lib.axis_size(mesh, shard_lib.dp_axes(mesh)) if split else 1
    if shape.kind == "decode":
        return _whole_at_decode(cfg, shape.global_batch // dp, model)
    train = shape.kind == "train"
    rows = _mb_rows(cfg, shape, mesh, mb)[0] if train else shape.global_batch
    b_rank = rows // dp * (mb if train else 1)
    s, d = shape.seq_len, cfg.d_model
    out = {}
    if cfg.moe is not None:
        # x.float() @ router: forward (and the recompute), dx and drouter
        passes = 4 if train else 1
        out["moe_router"] = cfg.n_layers * passes * 2.0 * b_rank * s * d * \
            cfg.moe.n_experts
    if cfg.frontend != "none":
        # patches / frames @ frontend_proj: forward and dW (no remat)
        passes = 2 if train else 1
        out["frontend_proj"] = passes * 2.0 * b_rank * cfg.frontend_len * d * d
    if cfg.block_pattern == "zamba2":
        inner = cfg.ssm.expand * d
        heads = inner // cfg.ssm.head_dim
        if heads % model == 0:
            # C_c B_c^T of every chunk: (B, L, N) x (B, N, L)
            chunk, n = 256, cfg.ssm.state_dim
            nchunk = -(-s // chunk)
            per_layer = nchunk * 2.0 * b_rank * chunk * chunk * n
            groups = cfg.n_layers // cfg.shared_attn_every
            in_groups = groups * cfg.shared_attn_every
            tail = cfg.n_layers - in_groups
            if train:
                out["mamba_cb_scores"] = per_layer * (4 * in_groups + 3 * tail)
            else:
                out["mamba_cb_scores"] = per_layer * cfg.n_layers
        else:
            out["mamba_ssd"] = WHOLE_NOTE
    if cfg.block_pattern == "xlstm_7_1":
        p = d // cfg.n_heads
        if (d // model) % p:
            out["mlstm_recurrence"] = WHOLE_NOTE
            out["slstm_recurrence"] = WHOLE_NOTE
        if (2 * cfg.n_heads) % model:
            passes = 4 if train else 1
            out["mlstm_gates"] = (cfg.n_layers - cfg.n_layers // 8) * passes * \
                2.0 * b_rank * s * d * 2 * cfg.n_heads
    if cfg.block_pattern in ("attn", "encdec", "zamba2") and \
            (cfg.n_heads * cfg.head_dim_ // model) % cfg.head_dim_:
        out["attention_core"] = WHOLE_NOTE
    return out


def _whole_at_decode(cfg, b_rank: int, model: int) -> dict:
    """`whole_on_every_rank` of a decode step of ``b_rank`` rows a rank:
    the router GEMM (every rank routes every token), the mLSTM's gate GEMM
    where its 2 H columns do not split, the sLSTM's recurrent product
    (its state is gathered whole, `xlstm.slstm_step`), and the recurrences
    that run whole where their state does not split (`cache_specs`)."""
    d = cfg.d_model
    out = {}
    if cfg.moe is not None:
        out["moe_router"] = cfg.n_layers * 2.0 * b_rank * d * cfg.moe.n_experts
    if cfg.block_pattern == "zamba2":
        heads = cfg.ssm.expand * d // cfg.ssm.head_dim
        if heads % model:
            out["mamba_ssd"] = WHOLE_NOTE
    if cfg.block_pattern == "xlstm_7_1":
        h = cfg.n_heads
        p = d // h
        groups = cfg.n_layers // 8
        if p % model:
            out["mlstm_recurrence"] = WHOLE_NOTE
        if (2 * h) % model:
            out["mlstm_gates"] = 7 * groups * 2.0 * b_rank * d * 2 * h
        out["slstm_recurrence"] = groups * 2.0 * b_rank * h * p * 4 * p
    return out


def output_bytes(cfg, shape, mesh, args, out_specs) -> int:
    if shape.kind == "train":
        return tree_bytes(args[0], out_specs[0], mesh) + 3 * 4
    cache = specs_lib.cache_structs(cfg, shape)
    logits = torch.empty((shape.global_batch, cfg.vocab_padded),
                         dtype=torch.float32, device=META)
    if shape.kind == "prefill":
        return (tree_bytes(cache, out_specs[0], mesh)
                + tree_bytes(logits, out_specs[1], mesh))
    return (tree_bytes(logits, out_specs[0], mesh)
            + tree_bytes(cache, out_specs[1], mesh))


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool, mesh=None,
             cfg=None, shape=None):
    """The record of one cell (``cfg`` / ``shape`` override the registry's,
    for reduced cells)."""
    cfg = get_config(arch_id) if cfg is None else cfg
    shape = SHAPES_BY_NAME[shape_name] if shape is None else shape
    ok, reason = specs_lib.cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
                "status": reason}
    mesh = production_mesh(multi_pod) if mesh is None else mesh
    t0 = time.perf_counter()
    fn, args, in_specs, out_specs = specs_lib.build_cell(cfg, shape, mesh)
    mb = (specs_lib.choose_microbatches(cfg, shape, mesh)
          if shape.kind == "train" else 1)
    if shape.kind == "prefill":
        # the prefill never reads the labels: JAX's jit drops them
        args = (args[0], {k: v for k, v in args[1].items() if k != "labels"})
        in_specs = (in_specs[0], {k: v for k, v in in_specs[1].items()
                                  if k != "labels"})
    rec = {
        "arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "kind": shape.kind, "n_devices": mesh.size,
        "rank": mesh.rank, "microbatches": mb, "precision": PRECISION,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "argument_size_in_bytes": tree_bytes(args, in_specs, mesh),
        "output_size_in_bytes": output_bytes(cfg, shape, mesh, args, out_specs),
        "temp_size_note": TEMP_NOTE,
    }
    rec["lower_s"] = round(time.perf_counter() - t0, 2)
    if shape.kind == "decode":
        layout = shard_lib.kv_layout(cfg, shape, mesh)
        rec["kv_layout"] = layout.name if layout is not None else None
    t0 = time.perf_counter()
    counts, notes = measure(cfg, shape, mesh, mb)
    rec["compile_s"] = round(time.perf_counter() - t0, 2)
    rec.update(notes)
    rec["hlo_flops"] = counts["flops"]
    rec["hlo_bytes"] = counts["bytes"]
    rec["cost_raw"] = {"flops": counts["flops"], "bytes accessed": counts["bytes"]}
    rec["whole_on_every_rank"] = whole_on_every_rank(cfg, shape, mesh, mb)
    rec["collective_bytes"] = {k: round(v) for k, v in counts["coll"].items()}
    rec["collective_counts"] = {k: round(v) for k, v in
                                counts["coll_counts"].items()}
    rec["collective_bytes_by_axes"] = {
        f"{kind} over {'+'.join(axes)}": round(v)
        for (kind, axes), v in counts["coll_axes"].items()}
    rec["hlo_lines"] = round(counts["ops"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in SHAPES] if (args.all or not args.shape)
              else [args.shape])
    records = []
    for mp in meshes:
        mesh_dir = "multipod_2x16x16" if mp else "pod_16x16"
        for arch_id in archs:
            for shape_name in shapes:
                out_dir = os.path.join(args.out, mesh_dir, arch_id)
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"{shape_name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {mesh_dir}/{arch_id}/{shape_name} (cached)")
                    continue
                print(f"[run ] {mesh_dir}/{arch_id}/{shape_name} ...", flush=True)
                try:
                    rec = run_cell(arch_id, shape_name, multi_pod=mp)
                except Exception as e:
                    rec = {"arch": arch_id, "shape": shape_name, "multi_pod": mp,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                records.append(rec)
                print(f"       -> {rec.get('status')} (build "
                      f"{rec.get('lower_s', '-')}s, count "
                      f"{rec.get('compile_s', '-')}s, flops "
                      f"{rec.get('hlo_flops', '-')})", flush=True)
    return records


if __name__ == "__main__":
    main()
