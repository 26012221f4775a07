"""The split of the compute over the mesh's ``model`` axis
(`repro_torch.distributed.tensor_parallel`) against the one-process whole
compute.

One launch of four gloo ranks on the CPU (their children started
together, `tests/test_torch_distributed.py`'s helpers) takes every reduced
family in turn at mesh (data 1, model 4) and (2, 2): tinyllama-1.1b,
qwen3-32b (q/k norms, untied vocab-split unembed), h2o-danube-3-4b (SWA,
a prompt past its window), qwen2-moe-a2.7b (experts split over model),
whisper-base, internvl2-2b, zamba2-1.2b and xlstm-1.3b, and three variants
that reach the other branches: tinyllama and xlstm with 2 heads (q heads,
and the recurrence, whole on every rank at model 4) and qwen2-moe with 6
experts (d_ff split inside each expert at model 4). Each rank runs
`loss_fn` on its pieces (`sharding.param_specs`) and its batch rows
(`batch_specs`) under the mesh context, gathers every gradient leaf from
its piece, and runs `specs.build_cell`'s prefill function. The loss and
gradients held are the means over the data ranks, as the train step takes
them (the MoE load-balance loss is over the whole batch,
`tensor_parallel.data_mean`). Then, at mesh
(4, 1), `build_cell`'s train step against the gathering step the split
replaced (the parameters gathered whole before a one-process `loss_fn`),
written out here. This process computes the one-process references meanwhile.

Tolerances:
- the loss and each gradient leaf within `train.parity.GRAD_TOL` of the
  leaf's largest (the split adds partial sums in another order); the
  xLSTM's leaves, which amplify f32 rounding past it, within twice the
  one-process gradient's own spread (its embedding scaled by 1 + 2^-23)
  plus 1e-6 where that is larger: `train.parity`'s rule for the
  recurrent models (`tests/test_torch_recurrent_train.py`, `chip_smoke.py`
  phase 12a);
- the prefill logits within 1e-5, each cache piece within 1e-5 of the
  whole cache's slice under `cache_shardings` (bit for bit where no sum
  changed order: the zero caches);
- at mesh (4, 1), every leaf of the state bit for bit.

Against the JAX package: two JAX children, started beside the ranks, restore
the same initial state (a checkpoint the port writes, `distributed.checkpoint`)
for the families whose split reaches its own code (qwen3-32b,
qwen2-moe-a2.7b and its 6-expert variant at mesh (1, 4), whisper-base,
zamba2-1.2b, xlstm-1.3b) and runs `specs.build_cell`'s train step (one
step, 2 microbatches) and prefill, jitted on a host mesh of the same shape:
GSPMD's partition of the JAX step (zamba2's with `masked_mamba_chunked`,
the JAX block whose gradient is finite, `tests/test_torch_recurrent_train.py`).
The ranks run the port's `build_cell`
step from that state. Tolerances:
- the step: `train.parity.compare_states` with `adam_allowance`, every
  part within GRAD_TOL of its leaf's largest (the loss and grad norm too);
  zamba2 and the xLSTM, which amplify f32 rounding, within `train.parity`'s
  recurrent rule instead: per part and leaf the larger of GRAD_TOL (twice
  it for nu) and twice the spread of JAX's own step with the embedding
  scaled by 1 + 2^-23, plus 1e-6;
- the prefill: the logits and each cache piece within 1e-5 of JAX's slice
  (the xLSTM's logits within 5e-5, `tests/test_torch_recurrent.py`'s
  XLSTM_RTOL for the port's xLSTM against JAX's).

On the recording mesh (no process), `build_cell`'s train step at mesh
(1, 4) moves no whole parameter through a collective.

The split decode (`DECODE`): the same rank processes run `build_cell`'s
prefill into a cache of the decode cell's length and DECODE_STEPS steps of
its decode function, fed fixed tokens drawn from a seed, and gather the
logits and the cache whole; the cells reach every K/V layout of
`cache_specs` (`sharding.kv_layout`): tinyllama-1.1b's KV heads (2 x 2)
and head_dim (1 x 4), h2o-danube with head_dim 30 (its sequence over
``model``, SWA wrapping), zamba2-1.2b at B 1 on 2 x 2 (context
parallelism with the KV heads, and with head_dim where one KV head does
not split), the xLSTM's states split on P, qwen2-moe-a2.7b's experts and
whisper-base's cross attention. The JAX children run `build_cell`'s
prefill and decode jitted on host meshes of the same shapes from the same
parameters and inputs. Held: the logits and every cache leaf within 1e-5
of their largest value against the one-process prefill and `decode_step`
and against JAX's (the xLSTM's within 5e-5, XLSTM_RTOL: its JAX model
amplifies f32 rounding past 1e-5).

`build_cell` at the JAX cells' model dtype (`BF16`): the same rank processes
run its train step (one step, 2 microbatches), its prefill and two steps of
its decode function on bf16 parameters (qwen3-32b on 2 x 2: the KV heads
split; h2o-danube with head_dim 30 on 1 x 4: its sequence over ``model``),
and this process the same one-process steps in bf16, in f32 on the same
bf16 weights and in bf16 with the embedding moved by one bf16 ulp. Held:
the parameters stay bf16, the moments f32, the logits f32 and the K/V
cache bf16, and the loss, the grad norm, every leaf of the state, the
logits and the cache lie within twice the one-process bf16 compute's own
error (its larger distance from the other two) plus 1e-6 of it
(`tests/test_torch_bf16.py`'s rule: the split adds its partial sums in
bf16, as GSPMD's partition of the JAX program does).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import ShapeCfg, get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed import sharding as S
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, RecordingMesh
from repro_torch.models import transformer as T
from repro_torch.train import loop, parity

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_distributed import SRC, _npz_leaves, _start, _wait  # noqa: E402

TRAIN = ShapeCfg("tp_train", 40, 4, "train")
PREFILL = ShapeCfg("tp_prefill", 40, 4, "prefill")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# (name, arch, overrides of the reduced config)
FAMILIES = [
    ("tinyllama-1.1b", "tinyllama-1.1b", {}),
    ("qwen3-32b", "qwen3-32b", {}),
    ("h2o-danube-3-4b", "h2o-danube-3-4b", {}),
    ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", {}),
    ("whisper-base", "whisper-base", {}),
    ("internvl2-2b", "internvl2-2b", {}),
    ("zamba2-1.2b", "zamba2-1.2b", {}),
    ("xlstm-1.3b", "xlstm-1.3b", {}),
    ("tinyllama-h2", "tinyllama-1.1b", {"n_heads": 2, "n_kv_heads": 2}),
    ("xlstm-h2", "xlstm-1.3b", {"n_heads": 2}),
    ("qwen2-moe-e6", "qwen2-moe-a2.7b", {"moe": [6, 2, 1]}),
]
PREFILL_TOL = 1e-5
# the families whose split step and prefill are held against JAX's sharded
# ones, each at one mesh (tinyllama's step: tests/test_torch_distributed.py)
JAX_CELLS = [("qwen3-32b", "2x2"), ("qwen2-moe-a2.7b", "2x2"),
             ("qwen2-moe-e6", "1x4"), ("whisper-base", "2x2"),
             ("zamba2-1.2b", "2x2"), ("xlstm-1.3b", "2x2")]
# the split decode: (name, arch, overrides, mesh, batch, cache length,
# prompt, the K/V layout `sharding.kv_layout` names; None: no K/V cache)
DECODE = [
    ("tinyllama-heads", "tinyllama-1.1b", {}, "2x2", 4, 40, 12, "heads"),
    ("tinyllama-head-dim", "tinyllama-1.1b", {}, "1x4", 4, 40, 12, "head_dim"),
    # SWA: the window of 32 wraps in the second step, the written position
    # on the fourth rank's piece, then the first's
    ("h2o-d30-sequence", "h2o-danube-3-4b", {"head_dim": 30}, "1x4", 4, 40,
     30, "sequence"),
    ("zamba2-b1-context", "zamba2-1.2b", {}, "2x2", 1, 40, 12,
     "context+heads"),
    ("zamba2-kh1-b1-context", "zamba2-1.2b", {"n_kv_heads": 1}, "2x2", 1, 40,
     12, "context+head_dim"),
    ("xlstm-p-split", "xlstm-1.3b", {}, "1x4", 4, 40, 12, None),
    ("qwen2-moe-experts", "qwen2-moe-a2.7b", {}, "1x4", 4, 40, 12, "heads"),
    ("whisper-cross", "whisper-base", {}, "2x2", 4, 40, 4, "heads"),
]
DECODE_STEPS = 3
# build_cell at bf16: (name, arch, overrides, mesh, batch, cache length)
BF16 = [("qwen3-bf16", "qwen3-32b", {}, "2x2", 4, 40),
        ("danube-bf16-sequence", "h2o-danube-3-4b", {"head_dim": 30}, "1x4",
         4, 40)]
BF16_STEPS = 2
BF16_MOVE = 1 + 2.0 ** -7      # one bf16 ulp at 1: the embedding moved by it
DECODE_TOL = {"xlstm_7_1": 5e-5}   # test_torch_recurrent.XLSTM_RTOL
RECURRENT_RULE = ("zamba2", "xlstm_7_1")     # `train.parity`'s recurrent rule
JAX_PREFILL_TOL = {"xlstm_7_1": 5e-5}        # test_torch_recurrent.XLSTM_RTOL
STEP_KW = dict(microbatches=2, remat="full")

JAX_CHILD = r'''
import dataclasses, json, os, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import MoECfg, ShapeCfg, get_config
from repro.data.synthetic import lm_batch
from repro.distributed import checkpoint as ckpt, sharding as S
from repro.launch import specs

out, cells, f64 = sys.argv[1], json.loads(sys.argv[2]), sys.argv[4] == "f64"
decode = json.loads(sys.argv[5])
if f64:
    import jax.numpy as jnp
    jnp.float32 = jnp.float64         # the JAX package's f32 casts read as f64
# zamba2's reference: the JAX Mamba2 block with its causal mask inside the
# exp, whose gradient is finite (tests/test_torch_recurrent_train.py)
sys.path.insert(0, sys.argv[3])
from repro.models import ssm as jax_ssm
from test_torch_recurrent_train import masked_mamba_chunked
jax_ssm.mamba_chunked = masked_mamba_chunked
devs = np.array(jax.devices())
train = ShapeCfg("tp_train", 40, 4, "train")
prefill = ShapeCfg("tp_prefill", 40, 4, "prefill")
for name, arch, over, shape in cells:
    over = dict(over)
    if "moe" in over:
        over["moe"] = MoECfg(*over["moe"])
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    mesh = Mesh(devs[:4].reshape(shape), ("data", "model"))
    fn, _, in_sh, out_sh = specs.build_cell(cfg, train, mesh,
                                            microbatch_override=2)
    tcfg = dataclasses.replace(specs.train_cfg_for(cfg, train, mesh),
                               microbatches=2)
    state = ckpt.restore(os.path.join(out, "init_" + name), 0,
                         specs.state_structs(cfg, tcfg))
    step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    batch = lm_batch(cfg, train)
    if f64:
        state = jax.tree.map(lambda a: np.asarray(a, np.float64)
                             if a.dtype == np.float32 else a, state)
        new, _ = step(state, batch)
        np.savez(os.path.join(out, f"jax64_{name}.npz"), *[
            np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(new)])
        continue
    scaled = state._replace(params=dict(
        state.params, embed=state.params["embed"] * (1 + 2.0 ** -23)))
    arrays = {}
    for key, start in (("s", state), ("p", scaled)):
        new, m = step(start, batch)
        for j, leaf in enumerate(jax.tree_util.tree_leaves(new)):
            arrays[f"{key}_{j}"] = np.asarray(leaf)
        for k in ("loss", "grad_norm", "lr"):
            arrays[f"{key}_{k}"] = np.asarray(m[k])
    fn, _, in_sh, out_sh = specs.build_cell(cfg, prefill, mesh)
    cache, logits = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        state.params, lm_batch(cfg, prefill))
    arrays["logits"] = np.asarray(logits)
    jax.tree_util.tree_map_with_path(lambda path, t: arrays.__setitem__(
        "cache/" + S._path_str(path), np.asarray(t)), cache)
    np.savez(os.path.join(out, f"jax_{name}.npz"), **arrays)
# the decode cells: build_cell's prefill into a cache of the decode cell's
# length, then its decode step, both jitted on the host mesh
for name, arch, over, shape, b, max_len in decode:
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    mesh = Mesh(devs[:4].reshape(shape), ("data", "model"))
    tcfg = dataclasses.replace(specs.train_cfg_for(cfg, train, mesh),
                               microbatches=2)
    params = ckpt.restore(os.path.join(out, "init_" + name), 0,
                          specs.state_structs(cfg, tcfg)).params
    inp = dict(np.load(os.path.join(out, f"dec_in_{name}.npz")))
    fn, _, in_sh, out_sh = specs.build_cell(
        cfg, ShapeCfg("tp_dprefill", max_len, b, "prefill"), mesh)
    batch = {k: inp[k] for k in in_sh[1] if k in inp}
    batch["labels"] = np.zeros_like(inp["tokens"])
    cache, _ = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(params,
                                                                     batch)
    fn, _, in_sh, out_sh = specs.build_cell(
        cfg, ShapeCfg("tp_decode", max_len, b, "decode"), mesh)
    step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    arrays = {}
    for i, tok in enumerate(inp["steps"]):
        logits, cache = step(params, cache, tok)
        arrays[f"logits{i}"] = np.asarray(logits)
    jax.tree_util.tree_map_with_path(lambda path, t: arrays.__setitem__(
        "cache/" + S._path_str(path), np.asarray(t)), cache)
    np.savez(os.path.join(out, f"jaxdec_{name}.npz"), **arrays)
'''

CHILD = r'''
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import tree as tree_lib
from repro_torch.configs import MoECfg, ShapeCfg, get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed import sharding as S, tensor_parallel as tpl
from repro_torch.launch import specs, train as launch_train
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import transformer as T
from repro_torch.train import loop

out, store, families = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
jax_cells, decode = json.loads(sys.argv[4]), json.loads(sys.argv[5])
bf16_cells = json.loads(sys.argv[6])
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=4, timeout=launch_train.TIMEOUT)
train = ShapeCfg("tp_train", 40, 4, "train")
prefill = ShapeCfg("tp_prefill", 40, 4, "prefill")

def config(arch, over):
    over = dict(over)
    if "moe" in over:
        over["moe"] = MoECfg(*over["moe"])
    return dataclasses.replace(get_config(arch).reduced(), **over)

def params_of(cfg):
    return T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")

for mname, shape in (("1x4", (1, 4)), ("2x2", (2, 2))):
    mesh = make_mesh_compat(shape, ("data", "model"))
    tp = tpl.context(mesh)
    for name, arch, over in families:
        cfg = config(arch, over)
        params = params_of(cfg)
        ps = S.param_specs(params, mesh)
        pieces = S.shard_tree(params, ps, mesh)
        bs = S.batch_specs(cfg, train, mesh)
        batch = {k: S.shard(torch.from_numpy(np.asarray(v)), bs[k], mesh)
                 for k, v in lm_batch(cfg, train).items()}
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(pieces)]
        loss, _ = T.loss_fn(tree_lib.unflatten(pieces, leaves), cfg, batch,
                            remat="full", tp=tp)
        grads = torch.autograd.grad(loss, leaves)
        whole = [S.gather(g, s, mesh) for g, s in zip(grads, tree_lib.leaves(ps))]
        fn, _, (p_specs, b_specs), (c_specs, l_spec) = specs.build_cell(
            cfg, prefill, mesh)
        pbatch = {k: S.shard(torch.from_numpy(np.asarray(v)), b_specs[k], mesh)
                  for k, v in lm_batch(cfg, prefill).items()}
        with torch.no_grad():
            cache, logits = fn(pieces, pbatch)
        arrays = {"loss": loss.detach().numpy(), "logits": logits.numpy()}
        arrays.update({f"g{i}": g.numpy() for i, g in enumerate(whole)})
        S.tree_map_with_path(lambda path, t: arrays.__setitem__(
            "cache/" + S._path_str(path), t.numpy()), cache)
        np.savez(os.path.join(out, f"{mname}_{name}_{rank}.npz"), **arrays)

# build_cell's train step from the state the JAX child restores
for name, arch, over, shape in jax_cells:
    cfg = config(arch, over)
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    fn, _, (st_specs, _), _ = specs.build_cell(cfg, train, mesh,
                                               microbatch_override=2)
    tcfg = dataclasses.replace(specs.train_cfg_for(cfg, train, mesh),
                               microbatches=2)
    state = S.shard_tree(loop.init_state(params_of(cfg), tcfg), st_specs, mesh)
    new, m = fn(state, lm_batch(cfg, train))
    whole = tree_lib.leaves(S.gather_tree(new, st_specs, mesh))
    if rank == 0:
        np.savez(os.path.join(out, f"step_{name}.npz"),
                 *[t.numpy() for t in whole],
                 **{k: float(m[k]) for k in ("loss", "grad_norm", "lr")})

# build_cell's split decode: its prefill into a cache of the decode cell's
# length, DECODE_STEPS steps of its decode function, the logits and the cache
# gathered whole
def at(tree, path):
    for key in path:
        tree = tree[key]
    return tree

for name, arch, over, shape, b, max_len in decode:
    cfg = config(arch, over)
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    pieces = S.shard_tree(params_of(cfg), S.param_specs(params_of(cfg), mesh),
                          mesh)
    inp = dict(np.load(os.path.join(out, f"dec_in_{name}.npz")))
    pfn, _, (_, b_specs), _ = specs.build_cell(
        cfg, ShapeCfg("tp_dprefill", max_len, b, "prefill"), mesh)
    dfn, _, (_, c_specs, t_spec), (l_spec, _) = specs.build_cell(
        cfg, ShapeCfg("tp_decode", max_len, b, "decode"), mesh)
    arrays = {}
    with torch.no_grad():
        cache, _ = pfn(pieces, {k: S.shard(torch.from_numpy(inp[k]), spec, mesh)
                                for k, spec in b_specs.items() if k in inp})
        for i, tok in enumerate(inp["steps"]):
            logits, cache = dfn(pieces, cache,
                                S.shard(torch.from_numpy(tok), t_spec, mesh))
            arrays[f"logits{i}"] = S.gather(
                logits, S.P(t_spec[0], *l_spec[1:]), mesh).numpy()
    S.tree_map_with_path(lambda path, t: arrays.__setitem__(
        "cache/" + S._path_str(path), S.gather(t, at(c_specs, path),
                                               mesh).numpy()), cache)
    if rank == 0:
        np.savez(os.path.join(out, f"dec_{name}.npz"), **arrays)

# build_cell at bf16: one train step, the prefill and BF16_STEPS decode
# steps on bf16 parameters, gathered whole
for name, arch, over, shape, b, max_len in bf16_cells:
    cfg = config(arch, over)
    mesh = make_mesh_compat(tuple(shape), ("data", "model"))
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.bfloat16)
    fn, _, (st_specs, _), _ = specs.build_cell(cfg, train, mesh,
                                               microbatch_override=2)
    tcfg = dataclasses.replace(specs.train_cfg_for(cfg, train, mesh),
                               microbatches=2)
    state = S.shard_tree(loop.init_state(params, tcfg), st_specs, mesh)
    new, m = fn(state, lm_batch(cfg, train))
    arrays = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    dtypes = {}
    for i, t in enumerate(tree_lib.leaves(S.gather_tree(new, st_specs, mesh))):
        arrays[f"state{i}"] = t.float().numpy()
        dtypes[f"state{i}"] = str(t.dtype)
    pieces = S.shard_tree(params, S.param_specs(params, mesh), mesh)
    inp = dict(np.load(os.path.join(out, f"bf16_in_{name}.npz")))
    pfn, _, (_, b_specs), (pc_specs, pl_spec) = specs.build_cell(
        cfg, ShapeCfg("tp_dprefill", max_len, b, "prefill"), mesh)
    dfn, _, (_, c_specs, t_spec), (l_spec, _) = specs.build_cell(
        cfg, ShapeCfg("tp_decode", max_len, b, "decode"), mesh)
    with torch.no_grad():
        cache, logits = pfn(pieces, {k: S.shard(torch.from_numpy(inp[k]), spec,
                                                mesh)
                                     for k, spec in b_specs.items() if k in inp})
        arrays["prefill"] = S.gather(logits, S.P(b_specs["tokens"][0],
                                                 *pl_spec[1:]), mesh).numpy()
        for i, tok in enumerate(inp["steps"]):
            logits, cache = dfn(pieces, cache,
                                S.shard(torch.from_numpy(tok), t_spec, mesh))
            arrays[f"logits{i}"] = S.gather(
                logits, S.P(t_spec[0], *l_spec[1:]), mesh).numpy()
            dtypes[f"logits{i}"] = str(logits.dtype)

    def keep(path, t):
        key = "cache/" + S._path_str(path)
        arrays[key] = S.gather(t, at(c_specs, path), mesh).float().numpy()
        dtypes[key] = str(t.dtype)

    S.tree_map_with_path(keep, cache)
    if rank == 0:
        np.savez(os.path.join(out, f"bf16_{name}.npz"), **arrays)
        with open(os.path.join(out, f"bf16_{name}.json"), "w") as f:
            json.dump(dtypes, f)

# mesh (4, 1): build_cell's step against the gathering step
mesh = make_mesh_compat((4, 1), ("data", "model"))
cfg = get_config("tinyllama-1.1b").reduced()
step_shape = ShapeCfg("tp_step", 40, 8, "train")
fn, args, (st_specs, _), _ = specs.build_cell(cfg, step_shape, mesh,
                                              microbatch_override=2)
tcfg = dataclasses.replace(specs.train_cfg_for(cfg, step_shape, mesh),
                           microbatches=2)
state = S.shard_tree(loop.init_state(params_of(cfg), tcfg), st_specs, mesh)
batch = lm_batch(cfg, step_shape)
new, m = fn(state, batch)

def gathering_step(state, batch):
    p_specs = tree_lib.leaves(st_specs.params)
    a_specs = tree_lib.leaves(st_specs.opt.mu)
    whole = S.gather_tree(state.params, st_specs.params, mesh)
    acc = None
    for i in range(2):
        rows = {k: torch.as_tensor(np.asarray(v))[i * 4:(i + 1) * 4]
                for k, v in batch.items()}
        rows = {k: S.shard(v, S.P("data"), mesh) for k, v in rows.items()}
        leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(whole)]
        loss, _ = T.loss_fn(tree_lib.unflatten(whole, leaves), cfg, rows,
                            remat="full")
        g = [x.float() for x in torch.autograd.grad(loss, leaves)]
        now = [bool(set(loop._split_axes(a, mesh)) & {"data"}) for a in a_specs]
        members = mesh.members("data")
        chunks = [torch.cat([S.shard(gi, a, mesh, coords=c).reshape(-1)
                             for c in members])
                  for gi, a, r in zip(g, a_specs, now) if r]
        sums = iter(mesh.reduce_scatter_many(chunks, "data"))
        pieces = [next(sums).view(S.shard_shape(a, gi.shape, mesh)).div_(4)
                  if r else S.shard(gi, a, mesh).clone()
                  for gi, a, r in zip(g, a_specs, now)]
        acc = pieces if acc is None else [x.add_(y) for x, y in zip(acc, pieces)]
    loop._mean_over(mesh, [a for a, r in zip(acc, now) if not r], "data")
    acc = [a.div_(2) for a in acc]
    grads = tree_lib.unflatten(state.params, acc)
    leaf_axes = [loop._split_axes(a, mesh) for a in a_specs]
    params_in = tree_lib.unflatten(state.params, [
        S.reshard(p, ps, a, mesh) for p, ps, a in
        zip(tree_lib.leaves(state.params), p_specs, a_specs)])
    lr = loop.cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    new_p, opt, _ = loop.adamw_update(
        grads, state.opt, params_in, lr=lr, weight_decay=tcfg.weight_decay,
        max_grad_norm=tcfg.max_grad_norm,
        reduce_sq=loop._scalar_reducer(mesh, leaf_axes, "sum"))
    out = [S.reshard(x, a, ps, mesh) for x, ps, a in
           zip(tree_lib.leaves(new_p), p_specs, a_specs)]
    return loop.TrainState(tree_lib.unflatten(state.params, out), opt, None,
                           state.step + 1)

old = gathering_step(state, batch)
equal = all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(new),
                                               tree_lib.leaves(old)))
with open(os.path.join(out, f"four_one_{rank}.json"), "w") as f:
    json.dump({"equal": equal, "tp_sync_s": m["tp_sync_s"]}, f)
dist.destroy_process_group()
'''


def _config(arch, over):
    from repro_torch.configs import MoECfg
    import dataclasses
    over = dict(over)
    if "moe" in over:
        over["moe"] = MoECfg(*over["moe"])
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    loss, _ = T.loss_fn(tree_lib.unflatten(params, leaves), cfg, batch,
                        remat="full")
    return float(loss.detach()), [g.numpy() for g in
                                  torch.autograd.grad(loss, leaves)]


def _one_process(cfg, rows):
    """The loss and gradient leaves of the whole parameters on ``rows`` of
    the train batch, and each leaf's tolerance."""
    params = _params(cfg)
    batch = {k: torch.from_numpy(np.asarray(v))[rows]
             for k, v in lm_batch(cfg, TRAIN).items()}
    loss, grads = _grads(cfg, params, batch)
    tols = [parity.GRAD_TOL] * len(grads)
    if cfg.block_pattern == "xlstm_7_1":
        scaled = dict(params, embed=params["embed"] * (1 + 2.0 ** -23))
        _, spread = _grads(cfg, scaled, batch)
        tols = [max(parity.GRAD_TOL, 2 * parity.rel(a, b) + 1e-6)
                for a, b in zip(spread, grads)]
    return loss, grads, tols


def _prefill_one(cfg):
    params = _params(cfg)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in lm_batch(cfg, PREFILL).items()}
    with torch.no_grad():
        return T.prefill(params, cfg, batch, PREFILL.seq_len)


def _params(cfg):
    return T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")


def _decode_cells():
    """[name, arch, overrides, mesh shape, batch, cache length] of each
    DECODE entry."""
    return [[name, arch, over, list(MESHES[mesh]), b, max_len]
            for name, arch, over, mesh, b, max_len, _, _ in DECODE]


def _decode_inputs(cfg, name, b):
    """A decode cell's inputs, made from a seed: the prompt (and the
    frontend's input), and the token each step feeds (fixed, not greedy, so
    that a near-tie cannot fork the runs)."""
    prompt = {d[0]: d[6] for d in DECODE}[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    inp = {"tokens": rng.integers(0, cfg.vocab, (b, prompt)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (DECODE_STEPS, b, 1)).astype(
               np.int32)}
    key = T.frontend_key(cfg)
    if key is not None:
        inp[key] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return inp


def _decode_one(cfg, out, name, max_len):
    """The one-process prefill and decode steps of a decode cell: (the
    logits of each step, the cache)."""
    params = _params(cfg)
    inp = dict(np.load(os.path.join(out, f"dec_in_{name}.npz")))
    batch = {k: torch.from_numpy(v) for k, v in inp.items() if k != "steps"}
    logits = []
    with torch.no_grad():
        cache, _ = T.prefill(params, cfg, batch, max_len)
        for tok in inp["steps"]:
            lg, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
            logits.append(lg.numpy())
    return logits, cache


def _bf16_cells():
    """[name, arch, overrides, mesh shape, batch, cache length] of each
    BF16 entry."""
    return [[name, arch, over, list(MESHES[mesh]), b, max_len]
            for name, arch, over, mesh, b, max_len in BF16]


def _bf16_one(cfg, out, name, max_len):
    """A bf16 cell's one-process results, the same arrays the ranks save
    (the state after one train step, the prefill's logits, each decode
    step's logits, the cache), in bf16 and, to measure its own error, in
    f32 on the same bf16 weights and with the embedding moved by one bf16
    ulp: {"bf16" | "f32" | "moved": arrays}."""
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.bfloat16)
    runs = {"bf16": params,
            "f32": tree_lib.map(lambda t: t.float(), params),
            "moved": dict(params, embed=params["embed"] * BF16_MOVE)}
    inp = dict(np.load(os.path.join(out, f"bf16_in_{name}.npz")))
    # build_cell's (`specs.train_cfg_for`) with 2 microbatches
    tcfg = loop.TrainCfg(microbatches=2, remat="full")
    step = loop.make_train_step(cfg, tcfg)
    refs = {}
    for key, p in runs.items():
        new, m = step(loop.init_state(p, tcfg), lm_batch(cfg, TRAIN))
        arrays = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        arrays.update({f"state{i}": t.float().numpy()
                       for i, t in enumerate(tree_lib.leaves(new))})
        with torch.no_grad():
            cache, logits = T.prefill(p, cfg, {"tokens": torch.from_numpy(
                inp["tokens"])}, max_len)
            arrays["prefill"] = logits.numpy()
            for i, tok in enumerate(inp["steps"]):
                logits, cache = T.decode_step(p, cfg, cache,
                                              torch.from_numpy(tok))
                arrays[f"logits{i}"] = logits.numpy()
        S.tree_map_with_path(lambda path, t: arrays.__setitem__(
            "cache/" + S._path_str(path), t.float().numpy()), cache)
        refs[key] = arrays
    return refs


def _jax_cells():
    """[name, arch, overrides, mesh shape] of each JAX_CELLS entry."""
    fams = {f[0]: f for f in FAMILIES}
    return [[*fams[name], list(MESHES[mesh])] for name, mesh in JAX_CELLS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE="4", OMP_NUM_THREADS="1")
    cells = _jax_cells()
    for name, arch, over, _ in cells:
        ckpt_lib.save(os.path.join(out, "init_" + name), 0, loop.init_state(
            _params(_config(arch, over)), loop.TrainCfg(**STEP_KW)))
    decode = _decode_cells()
    for name, arch, over, _, b, max_len in decode:
        cfg = _config(arch, over)
        ckpt_lib.save(os.path.join(out, "init_" + name), 0, loop.init_state(
            _params(cfg), loop.TrainCfg(**STEP_KW)))
        np.savez(os.path.join(out, f"dec_in_{name}.npz"),
                 **_decode_inputs(cfg, name, b))
    for name, arch, over, _, b, _ in BF16:
        cfg = _config(arch, over)
        rng = np.random.default_rng(sum(map(ord, name)))
        np.savez(os.path.join(out, f"bf16_in_{name}.npz"),
                 tokens=rng.integers(0, cfg.vocab, (b, 12)).astype(np.int32),
                 steps=rng.integers(0, cfg.vocab, (BF16_STEPS, b, 1)).astype(
                     np.int32))
    store = os.path.join(out, "store")
    jax_env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                             "--xla_cpu_multi_thread_eigen=false "
                             "intra_op_parallelism_threads=1")
    tests = os.path.dirname(os.path.abspath(__file__))
    recurrent = [c for c in cells if _config(*c[1:3]).block_pattern
                 in RECURRENT_RULE]
    children = [_start(JAX_CHILD, [out, json.dumps(cells[i::2]), tests, "f32",
                                   json.dumps(decode[i::2])], jax_env)
                for i in (0, 1)]
    children.append(_start(JAX_CHILD, [out, json.dumps(recurrent), tests, "f64",
                                       "[]"],
                           dict(jax_env, JAX_ENABLE_X64="1")))
    children += [
        _start(CHILD, [out, store, json.dumps(FAMILIES), json.dumps(cells),
                       json.dumps(decode), json.dumps(_bf16_cells())],
               dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {}
        for name, arch, over in FAMILIES:
            cfg = _config(arch, over)
            refs[name] = {"all": _one_process(cfg, slice(0, 4)),
                          "prefill": _prefill_one(cfg)}
        for name, arch, over, _, _, max_len in decode:
            refs[name] = _decode_one(_config(arch, over), out, name, max_len)
        for name, arch, over, _, _, max_len in _bf16_cells():
            refs[name] = _bf16_one(_config(arch, over), out, name, max_len)
    finally:
        torch.set_num_threads(threads)
        _wait(children)
    return out, refs


def _load(out, name):
    with np.load(os.path.join(out, name)) as f:
        return dict(f)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,arch,over", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_split_loss_and_gradients_match_the_whole_compute(ranks, mesh_name,
                                                          name, arch, over):
    out, refs = ranks
    data, model = MESHES[mesh_name]
    cfg = _config(arch, over)
    names = parity.leaf_names(specs.abstract_params(cfg))
    want_loss, want, tols = refs[name]["all"]
    for m in range(model):
        # the train step's mean over the data ranks (their rows)
        got = [_load(out, f"{mesh_name}_{name}_{d * model + m}.npz")
               for d in range(data)]
        loss = sum(g["loss"] for g in got) / data
        assert parity.rel(loss, want_loss) <= parity.GRAD_TOL, m
        for i, (w, tol) in enumerate(zip(want, tols)):
            err = parity.rel(sum(g[f"g{i}"] for g in got) / data, w)
            assert err <= tol, (m, names[i], err, tol)


def _check_prefill(out, mesh_name, name, cfg, cache, logits, tol,
                   whole=lambda path, leaf: leaf):
    """Each rank's prefill output against the whole ``logits`` and cache:
    the logits as this rank's vocab piece, the cache in `cache_shardings`'
    layout, each piece the whole cache's slice. ``cache`` is the
    one-process cache (its paths); ``whole(path, leaf)`` the whole leaf
    held at ``path``."""
    shape = MESHES[mesh_name]
    mesh = Mesh(shape, ("data", "model"), rank=None)
    c_specs = specs.cache_shardings(cfg, PREFILL, mesh)
    l_spec = S.logits_spec(cfg, mesh)
    logits = torch.as_tensor(np.asarray(logits))
    for rank in range(4):
        got = _load(out, f"{mesh_name}_{name}_{rank}.npz")
        coords = {"data": rank // shape[1], "model": rank % shape[1]}
        rows = S.shard(logits, S.P(S.dp_axes(mesh)), mesh, coords=coords)
        want = S.shard(rows, l_spec, mesh, coords=coords).numpy()
        assert got["logits"].shape == want.shape
        assert parity.rel(got["logits"], want) <= tol, rank

        def check(path, leaf, spec):
            key = "cache/" + S._path_str(path)
            leaf = torch.as_tensor(np.asarray(whole(path, leaf)))
            piece = S.shard(leaf, spec, mesh, coords=coords).numpy()
            assert got[key].shape == piece.shape, (key, got[key].shape)
            if not np.isfinite(piece).all() or np.abs(piece).max() == 0:
                np.testing.assert_array_equal(got[key], piece)
            else:
                assert parity.rel(got[key], piece) <= tol, key
        S.tree_map_with_path(
            lambda path, leaf: check(path, leaf, _at(c_specs, path)), cache)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,arch,over", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_split_prefill_matches_the_whole_compute(ranks, mesh_name, name, arch,
                                                 over):
    """The logits as this rank's vocab piece, the cache in
    `cache_shardings`' layout: each piece the whole cache's slice."""
    out, refs = ranks
    cache, logits = refs[name]["prefill"]
    _check_prefill(out, mesh_name, name, _config(arch, over), cache, logits,
                   PREFILL_TOL)


def _jax_ref(out, name):
    return _load(out, f"jax_{name}.npz")


@pytest.mark.parametrize("name,mesh_name", JAX_CELLS,
                         ids=[f"{n}-{m}" for n, m in JAX_CELLS])
def test_split_prefill_within_parity_of_the_jax_sharded_prefill(
        ranks, name, mesh_name):
    """The port's split prefill against `build_cell`'s prefill jitted on a
    JAX host mesh of the same shape, from the same parameters."""
    out, refs = ranks
    fam = {f[0]: f for f in FAMILIES}[name]
    cfg = _config(*fam[1:])
    ref = _jax_ref(out, name)
    _check_prefill(out, mesh_name, name, cfg, refs[name]["prefill"][0],
                   ref["logits"], JAX_PREFILL_TOL.get(cfg.block_pattern,
                                                      PREFILL_TOL),
                   whole=lambda path, _: ref["cache/" + S._path_str(path)])


@pytest.mark.parametrize("name,mesh_name", JAX_CELLS,
                         ids=[f"{n}-{m}" for n, m in JAX_CELLS])
def test_split_step_within_parity_of_the_jax_sharded_step(ranks, name,
                                                          mesh_name):
    """`build_cell`'s train step under the split, one step from the state
    the JAX child restored, against the JAX `build_cell` step jitted on a
    host mesh of the same shape (`train.parity`, the recurrent rule for
    zamba2 and the xLSTM)."""
    out, _ = ranks
    fam = {f[0]: f for f in FAMILIES}[name]
    cfg = _config(*fam[1:])
    ref = _jax_ref(out, name)
    tmpl = loop.init_state(_params(cfg), loop.TrainCfg(**STEP_KW))
    n = len(tree_lib.leaves(tmpl))
    state = lambda key: tree_lib.unflatten(tmpl, [
        torch.from_numpy(ref[f"{key}_{j}"]) for j in range(n)])
    want, moved = state("s"), state("p")
    leaves, extra = _npz_leaves(os.path.join(out, f"step_{name}.npz"))
    got = tree_lib.unflatten(tmpl, [torch.from_numpy(a) for a in leaves])
    n_params = len(tree_lib.leaves(want.params))
    tols = {part: [parity.GRAD_TOL] * n_params for part in PARTS}
    gaps = {k: parity.rel(extra[k], ref[f"s_{k}"]) for k in ("loss", "grad_norm")}
    bounds = {k: parity.GRAD_TOL for k in gaps}
    if cfg.block_pattern in RECURRENT_RULE:
        leaves64, _ = _npz_leaves(os.path.join(out, f"jax64_{name}.npz"))
        exact = tree_lib.unflatten(tmpl, [torch.from_numpy(a) for a in leaves64])
        tols = {part: [max((2 if part == "nu" else 1) * parity.GRAD_TOL,
                           2 * max(parity.rel(b, a), parity.rel(a, e)) + 1e-6)
                       for a, b, e in zip(_part(want, part), _part(moved, part),
                                          _part(exact, part))]
                for part in PARTS}
        bounds = {k: max(parity.GRAD_TOL,
                         2 * parity.rel(ref[f"p_{k}"], ref[f"s_{k}"]) + 1e-6)
                  for k in gaps}
    allowance = parity.adam_allowance(None, want, float(ref["s_lr"]),
                                      grad_tol=tols["mu"])
    r = parity.compare_states(got, want, allowance=allowance, grad_tol=tols)
    print(f"{name} at {mesh_name}: {r}; loss / grad norm gaps {gaps} "
          f"(bounds {bounds})")
    assert float(extra["lr"]) == pytest.approx(float(ref["s_lr"]), rel=1e-6)
    for key, gap in gaps.items():
        assert gap <= bounds[key], (key, gap, bounds[key])
    assert r["excess"] <= 1.0, r
    assert int(got.step) == int(want.step) == 1


def _check_decode(got, logits, cache, tol):
    """A split decode cell's gathered logits and cache (``got``) against
    ``logits`` (one array a step) and ``cache`` (one array a path): each
    within ``tol`` of its largest value, bit for bit where zero or not
    finite (the lengths, an untouched state, a stabiliser at -inf)."""
    worst = {}
    for i, want in enumerate(logits):
        worst[f"logits{i}"] = parity.rel(got[f"logits{i}"], want)
    for key, want in cache.items():
        assert got[key].shape == want.shape, (key, got[key].shape, want.shape)
        if not np.isfinite(want).all() or np.abs(want).max() == 0:
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        else:
            worst[key] = parity.rel(got[key], want)
    print({k: f"{v:.2e}" for k, v in worst.items()})
    for key, err in worst.items():
        assert err <= tol, (key, err, tol)


def _cache_arrays(cache):
    arrays = {}
    S.tree_map_with_path(lambda path, t: arrays.__setitem__(
        "cache/" + S._path_str(path), t.numpy()), cache)
    return arrays


@pytest.mark.parametrize("cell", DECODE, ids=[d[0] for d in DECODE])
def test_split_decode_layout(cell):
    """Each decode cell reaches the K/V layout it is there for."""
    name, arch, over, mesh_name, b, max_len, _, layout = cell
    cfg = _config(arch, over)
    mesh = Mesh(MESHES[mesh_name], ("data", "model"), rank=None)
    got = S.kv_layout(cfg, ShapeCfg("tp_decode", max_len, b, "decode"), mesh)
    assert (got.name if got is not None else None) == layout


@pytest.mark.parametrize("cell", DECODE, ids=[d[0] for d in DECODE])
def test_split_decode_matches_the_whole_compute(ranks, cell):
    """`build_cell`'s decode function on four gloo ranks (its prefill's
    cache, then DECODE_STEPS steps) against the one-process prefill and
    `decode_step`: the logits and every cache leaf gathered whole within
    1e-5 of their largest value (the xLSTM's within 5e-5, as against
    JAX)."""
    out, refs = ranks
    name, arch, over = cell[:3]
    cfg = _config(arch, over)
    logits, cache = refs[name]
    _check_decode(_load(out, f"dec_{name}.npz"), logits, _cache_arrays(cache),
                  DECODE_TOL.get(cfg.block_pattern, PREFILL_TOL))


@pytest.mark.parametrize("cell", DECODE, ids=[d[0] for d in DECODE])
def test_split_decode_within_parity_of_the_jax_sharded_decode(ranks, cell):
    """The port's split decode against `build_cell`'s decode jitted on a JAX
    host mesh of the same shape (GSPMD's partition of the JAX
    `decode_step`), from the same parameters and inputs, each from its own
    package's split prefill: the logits and every cache leaf within 1e-5 of
    their largest value (the xLSTM's within 5e-5,
    `test_torch_recurrent.XLSTM_RTOL`: the JAX model amplifies f32
    rounding past 1e-5)."""
    out, refs = ranks
    name, arch, over = cell[:3]
    cfg = _config(arch, over)
    ref = _load(out, f"jaxdec_{name}.npz")
    _check_decode(_load(out, f"dec_{name}.npz"),
                  [ref[f"logits{i}"] for i in range(DECODE_STEPS)],
                  {k: v for k, v in ref.items() if k.startswith("cache/")},
                  DECODE_TOL.get(cfg.block_pattern, PREFILL_TOL))


PARTS = ("params", "mu", "nu")


def _part(state, part):
    return tree_lib.leaves(state.params if part == "params"
                           else getattr(state.opt, part))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_model_one_step_equals_the_gathering_step_bit_for_bit(ranks):
    """At mesh (4, 1) the split step is the gathering step, bit for bit;
    it spends no time in a ``model`` collective."""
    out, _ = ranks
    for rank in range(4):
        with open(os.path.join(out, f"four_one_{rank}.json")) as f:
            r = json.load(f)
        assert r["equal"] and r["tp_sync_s"] == 0.0, (rank, r)


def test_split_step_moves_no_whole_parameter():
    """`build_cell`'s train step at mesh (1, 4), played by rank 0 of a
    recording mesh on ``meta``: no collective result has the shape of a
    parameter split over ``model`` (whole or one layer of it), and the
    ``model``-axis traffic is activations."""
    cfg = get_config("tinyllama-1.1b").reduced()
    mesh = RecordingMesh((1, 4), ("data", "model"), rank=0)
    fn, args, in_specs, _ = specs.build_cell(cfg, TRAIN, mesh,
                                             microbatch_override=2)
    state = tree_lib.map(lambda t, s: torch.empty(
        S.shard_shape(s, t.shape, mesh), dtype=torch.float32
        if t.is_floating_point() else t.dtype, device="meta"),
        args[0], in_specs[0])
    fn(state, {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
               for k, v in args[1].items()})
    whole = set()
    for leaf, spec in zip(tree_lib.leaves(args[0].params),
                          tree_lib.leaves(in_specs[0].params)):
        if "model" in [e for e in spec]:
            whole.update({tuple(leaf.shape), tuple(leaf.shape[1:])})
    moved = [e for e in mesh.events if e[1] in whole]
    assert not moved, moved
    assert mesh.counts["all-reduce"] > 0, mesh.counts


@pytest.mark.parametrize("cell", BF16, ids=[c[0] for c in BF16])
def test_build_cell_runs_in_bf16_on_the_ranks(ranks, cell):
    """`build_cell`'s train, prefill and decode functions at bf16 on the
    four ranks against the one-process bf16 compute, by
    `tests/test_torch_bf16.py`'s rule (the module's docstring)."""
    out, refs = ranks
    name, arch, over = cell[:3]
    got = _load(out, f"bf16_{name}.npz")
    with open(os.path.join(out, f"bf16_{name}.json")) as f:
        dtypes = json.load(f)
    ref = refs[name]
    want = tree_lib.leaves(loop.init_state(T.init_params(
        _config(arch, over), generator=torch.Generator().manual_seed(0),
        device="cpu", dtype=torch.bfloat16), loop.TrainCfg()))
    for i, t in enumerate(want):
        assert dtypes[f"state{i}"] == str(t.dtype), i
    assert any(dtypes[f"state{i}"] == "torch.bfloat16" for i in range(len(want)))
    for key, dtype in dtypes.items():
        if key.startswith("logits"):
            assert dtype == "torch.float32", key
        if key.startswith("cache/") and key.split("/")[-1] in ("k", "v"):
            assert dtype == "torch.bfloat16", key
    worst = {}
    for key, mine in got.items():
        own = max(parity.rel(ref[alt][key], ref["bf16"][key])
                  for alt in ("f32", "moved"))
        err = parity.rel(mine, ref["bf16"][key])
        worst[key] = (err, 2 * own + 1e-6)
    print({k: f"{e:.2e}/{t:.2e}" for k, (e, t) in worst.items()})
    for key, (err, tol) in worst.items():
        assert err <= tol, (key, err, tol)
