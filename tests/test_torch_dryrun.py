"""The port's dry run (`repro_torch.launch.dryrun`) and cell roofline
(`launch.roofline.analyse_cell`) against the JAX package's.

One JAX child process with four host devices compiles reduced cells on a
2 x 2 mesh (`repro.launch.specs.build_cell`, jitted with its shardings):
tinyllama-1.1b ``train`` (8 x 64) and qwen2-moe-a2.7b ``prefill`` (8 x 64),
and the ``decode`` cells of tinyllama-1.1b and xlstm-1.3b (8 rows, a
cache of 64) and zamba2-1.2b (1 row: the context-parallel layout), and
writes their ``memory_analysis`` and ``cost_analysis``. Beside it this
process counts the same cells on `mesh.RecordingMesh` ranks.

Held:
- the per-device argument bytes equal JAX's ``argument_size_in_bytes``
  exactly;
- for the dense attention configs, the FLOPs counted on every rank of a
  2 x 2 mesh add up exactly to the one-process count of the same cell; for
  the other families the excess is what the record names as whole on
  every rank, ``(data x (model - 1))`` times it; the same for a decode
  cell, on the 2 x 2 mesh and on 1 x 4 (where the reduced dense configs'
  cache splits its head_dim, and h2o-danube's with head_dim 30 its
  sequence);
- a production decode cell (tinyllama-1.1b ``decode_32k``, whose cache
  splits head_dim over ``model``): its scores' all-reduce and the
  collective bound that follows from it; no committed record of
  ``results/torch_dryrun`` or ``results/torch_roofline`` is pending;
- the record's keys are JAX's (the dry run's and `analyse_cell`'s, read
  from the JAX source), and ``model_flops`` follows JAX's formula;
- one production cell (tinyllama-1.1b ``train_4k`` on 16 x 16) through the
  dry-run CLI, cached on its second call.

Recorded, not held: JAX's ``cost_analysis`` FLOPs a device beside the
port's counted FLOPs for the reduced cells (XLA also counts elementwise
work and the optimizer, the port matrix products only).
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ShapeCfg, get_config
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.mesh import RecordingMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TRAIN = ShapeCfg("train", 64, 8, "train")
PREFILL = ShapeCfg("prefill", 64, 8, "prefill")
DECODE = ShapeCfg("decode", 64, 8, "decode")
DECODE_B1 = ShapeCfg("decode_b1", 64, 1, "decode")
JAX_CELLS = [("tinyllama-1.1b", TRAIN), ("qwen2-moe-a2.7b", PREFILL),
             ("tinyllama-1.1b", DECODE), ("zamba2-1.2b", DECODE_B1),
             ("xlstm-1.3b", DECODE)]
JAX_IDS = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "tinyllama-1.1b-decode",
           "zamba2-1.2b-decode-b1", "xlstm-1.3b-decode"]
# the FLOP sums run every family at half that sequence
SUM_CELLS = (ShapeCfg("train", 32, 8, "train"),
             ShapeCfg("prefill", 32, 8, "prefill"))
# the FLOPs each family computes whole on every rank of a model group at
# the reduced widths on model 2 (the xLSTM's 4 heads split: none)
WHOLE = {"tinyllama-1.1b": set(), "qwen3-32b": set(), "h2o-danube-3-4b": set(),
         "xlstm-1.3b": set(), "qwen2-moe-a2.7b": {"moe_router"},
         "whisper-base": {"frontend_proj"}, "internvl2-2b": {"frontend_proj"},
         "zamba2-1.2b": {"mamba_cb_scores"}}
# at decode: every rank routes every token; the sLSTM steps whole
WHOLE_DECODE = {"qwen2-moe-a2.7b": {"moe_router"},
                "xlstm-1.3b": {"slstm_recurrence"}}
SUM_DECODE = ShapeCfg("decode", 32, 8, "decode")

JAX_CHILD = r'''
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ShapeCfg, get_config
from repro.launch import specs
out, cells = sys.argv[1], json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rec = {}
for arch, shape in cells:
    cfg = get_config(arch).reduced()
    shape = ShapeCfg(*shape)
    fn, args, in_sh, out_sh = specs.build_cell(cfg, shape, mesh)
    compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(
        *args).compile()
    mem = compiled.memory_analysis()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    rec[f"{arch}/{shape.name}"] = {
        "argument_size_in_bytes": int(mem.argument_size_in_bytes),
        "output_size_in_bytes": int(mem.output_size_in_bytes),
        "flops": float(cost.get("flops", -1))}
with open(out, "w") as f:
    json.dump(rec, f)
'''


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "jax.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    cells = json.dumps([(a, dataclasses.astuple(s)) for a, s in JAX_CELLS])
    child = subprocess.Popen([sys.executable, "-c", JAX_CHILD, out, cells],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    yield child, out
    if child.poll() is None:
        child.kill()
        child.wait()


def _jax_records(jax_cells):
    child, out = jax_cells
    log, _ = child.communicate(timeout=300)
    assert child.returncode == 0, log[-4000:]
    with open(out) as f:
        return json.load(f)


def _mesh(rank=0, shape=(2, 2)):
    return RecordingMesh(shape, ("data", "model"), rank)


def _record(arch, shape, mesh):
    return dryrun.run_cell(arch, shape.name, multi_pod=False, mesh=mesh,
                           cfg=get_config(arch).reduced(), shape=shape)


@pytest.mark.parametrize("arch,shape", JAX_CELLS, ids=JAX_IDS)
def test_argument_bytes_equal_jax_memory_analysis(jax_cells, arch, shape):
    rec = _record(arch, shape, _mesh())
    want = _jax_records(jax_cells)[f"{arch}/{shape.name}"]
    assert rec["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    ratio = rec["hlo_flops"] / want["flops"]
    print(f"{arch} {shape.name}: JAX cost_analysis {want['flops']:.0f} FLOPs "
          f"a device, the port's counted {rec['hlo_flops']:.0f} (ratio "
          f"{ratio:.3f}); output bytes JAX {want['output_size_in_bytes']}, "
          f"port {rec['output_size_in_bytes']}")
    assert rec["hlo_flops"] > 0 and want["flops"] > 0


def _flops(arch, shape, mesh, mb):
    cfg = get_config(arch).reduced()
    return dryrun.measure(cfg, shape, mesh, mb)[0]["flops"]


@pytest.mark.parametrize("arch", list(WHOLE))
def test_rank_flops_add_up_to_the_one_process_count(arch):
    """Every rank of the 2 x 2 mesh counts the same FLOPs (ranks 0 and 3
    differ in both coordinates); the four add up to the one-process count
    of the cell plus, where the family has them, the named FLOPs that
    every rank of a model group computes in full."""
    cfg = get_config(arch).reduced()
    for shape in SUM_CELLS:
        mb = specs.choose_microbatches(cfg, shape, _mesh()) \
            if shape.kind == "train" else 1
        ranks = [_flops(arch, shape, _mesh(r), mb) for r in (0, 3)]
        assert ranks[0] == ranks[1], (shape.name, ranks)
        one = _flops(arch, shape, _mesh(0, (1, 1)), mb)
        whole = dryrun.whole_on_every_rank(cfg, shape, _mesh(), mb)
        assert set(whole) == WHOLE[arch], whole
        named = sum(whole.values())
        assert 4 * ranks[0] - one == 2 * (2 - 1) * named, (shape.name, whole)


@pytest.mark.parametrize("arch", list(WHOLE) + ["h2o-danube-3-4b-d30"])
def test_rank_decode_flops_add_up_to_the_one_process_count(arch):
    """A decode step's FLOPs on every rank of a 2 x 2 and of a 1 x 4 mesh
    add up to the one-process count, plus ``data x (model - 1)`` times what
    the record names as whole on every rank (`WHOLE_DECODE`); the ranks
    count the same. h2o-danube with head_dim 30 splits its sequence over
    ``model`` at 1 x 4."""
    cfg = get_config(arch.replace("-d30", "")).reduced()
    if arch.endswith("-d30"):
        cfg = dataclasses.replace(cfg, head_dim=30)
    one = dryrun.measure(cfg, SUM_DECODE, _mesh(0, (1, 1)), 1)[0]["flops"]
    for shape in ((2, 2), (1, 4)):
        ranks = [dryrun.measure(cfg, SUM_DECODE, _mesh(r, shape), 1)[0]["flops"]
                 for r in (0, 3)]
        assert ranks[0] == ranks[1], (shape, ranks)
        whole = dryrun.whole_on_every_rank(cfg, SUM_DECODE, _mesh(0, shape), 1)
        assert set(whole) == WHOLE_DECODE.get(arch, set()), whole
        named = sum(whole.values())
        assert 4 * ranks[0] - one == shape[0] * (shape[1] - 1) * named, \
            (shape, whole)


def test_production_decode_cell_is_bound_by_its_scores_all_reduce():
    """tinyllama-1.1b ``decode_32k`` on 16 x 16: KH 4 does not split 16
    ways, so the cache splits head_dim (64 / 16) and every layer's scores,
    (8 rows x 32 heads x 32,768 positions) f32 a rank, are all-reduced over
    ``model``: 22 x 33.6 MB = 738 MB a step at least. The roofline bounds
    the cell by its collectives, at least 100 times its memory term; the
    cache piece read a step is 22 x 2 x 8 x 32,768 x 4 x 4 bf16 bytes."""
    mesh = dryrun.production_mesh(False)
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", multi_pod=False,
                          mesh=mesh)
    assert rec["status"] == "ok" and rec["kv_layout"] == "head_dim"
    scores = 22 * 8 * 32 * 32768 * 4
    assert rec["collective_bytes_by_axes"]["all-reduce over model"] >= scores
    roof = roofline.analyse_cell("tinyllama-1.1b", "decode_32k", mesh)
    assert roof["dominant"] == "collective"
    assert roof["t_collective_s"] >= 100 * roof["t_memory_s"]
    cache = 22 * 2 * 8 * 32768 * 4 * 4 * 2
    assert roof["fused_bytes_per_chip"] >= cache


def test_committed_records_have_no_pending_cell():
    """Every committed dry-run and roofline record is ``ok`` or a
    full-attention skip, decode cells with their FLOPs and bytes."""
    n = 0
    for sub in ("torch_dryrun", "torch_roofline"):
        for base, _, files in os.walk(os.path.join(ROOT, "results", sub)):
            for name in files:
                with open(os.path.join(base, name)) as f:
                    rec = json.load(f)
                n += 1
                assert rec["status"] in ("ok", "skipped(full-attention)"), \
                    (base, name, rec["status"])
                if rec["status"] == "ok":
                    flops = rec.get("hlo_flops", rec.get("hlo_flops_per_chip"))
                    assert flops > 0, (base, name)
    assert n == 3 * 10 * 4, n


def _returned_keys(path, func):
    """The keys of the dict literals ``func`` in ``path`` builds: its
    ``return {...}`` and its ``rec = {...}`` / ``rec[...] =`` entries."""
    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        built = None
        if isinstance(node, ast.Return):
            built = node.value
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "rec" for t in node.targets):
            built = node.value
        if isinstance(built, ast.Dict):
            keys.update(k.value for k in built.keys
                        if isinstance(k, ast.Constant))
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.value, ast.Name) and node.value.id == "rec" \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def test_records_keep_the_jax_keys():
    """`analyse_cell`'s record has every key of JAX's (plus the port's
    notes); the dry run's record every key of JAX's ``run_cell`` but the
    allocator's (``temp_size_in_bytes``, ``generated_code_size_in_bytes``)
    and the error keys; ``model_flops`` follows JAX's formula."""
    jax_roof = _returned_keys(os.path.join(SRC, "repro/launch/roofline.py"),
                              "analyse_cell") - {"error", "traceback"}
    cfg = get_config("tinyllama-1.1b").reduced()
    rec = roofline.analyse_cell("tinyllama-1.1b", "train", _mesh(), cfg=cfg,
                                shape=TRAIN)
    assert jax_roof <= set(rec), jax_roof - set(rec)
    n = cfg.active_param_count()
    assert rec["model_flops"] == 6.0 * n * TRAIN.global_batch * TRAIN.seq_len
    assert roofline.model_flops(cfg, PREFILL) == 2.0 * n * 8 * 64
    jax_dry = _returned_keys(os.path.join(SRC, "repro/launch/dryrun.py"),
                             "run_cell")
    port = set(_record("tinyllama-1.1b", TRAIN, _mesh()))
    missing = jax_dry - port
    assert missing <= {"temp_size_in_bytes", "generated_code_size_in_bytes",
                       "memory_analysis_error", "cost_analysis_error",
                       "collective_error"}, missing


def test_production_cell_through_the_cli(tmp_path, capsys):
    """tinyllama-1.1b ``train_4k`` on 16 x 16: the record written by the
    CLI, its arguments' bytes those of the cell's specs, the split step's
    collectives on both axes; a second call skips the cached cell."""
    out = str(tmp_path)
    argv = ["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--out", out]
    recs = dryrun.main(argv)
    assert len(recs) == 1
    with open(os.path.join(out, "pod_16x16", "tinyllama-1.1b",
                           "train_4k.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg = get_config("tinyllama-1.1b")
    mesh = dryrun.production_mesh(False)
    _, args, in_specs, _ = specs.build_cell(
        cfg, dryrun.SHAPES_BY_NAME["train_4k"], mesh)
    assert rec["argument_size_in_bytes"] == dryrun.tree_bytes(args, in_specs,
                                                              mesh)
    axes = {k.split(" over ")[1] for k in rec["collective_bytes_by_axes"]}
    assert {"model", "data"} <= axes, axes
    assert rec["hlo_flops"] > 0 and rec["whole_on_every_rank"] == {}
    assert dryrun.main(argv) == []
    assert "[skip]" in capsys.readouterr().out
