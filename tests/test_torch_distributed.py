"""The port's sharded trainer (`torch.distributed` gloo ranks on the CPU)
against the JAX package's multi-device trainer.

One JAX child process with 256 host devices (``XLA_FLAGS``) writes every
reference: the sharding rules and their per-device shapes
(``NamedSharding.shard_shape``) for every config x shape on a 2x2 mesh of
its first four devices and on the 16x16 production mesh, `int8_psum`
under ``shard_map`` on four devices, and three steps of `build_cell`'s
train function jitted on the 2x2 mesh (reduced tinyllama-1.1b, batch 8 x
32 tokens in 2 microbatches) from ``init_state(init_params(PRNGKey(0)))``.
Beside it, four port ranks (one gloo group through a ``file://`` store)
run `int8_psum`, the same three steps of the port's `build_cell` train
function from the same state (restored from its JAX checkpoint into the
ZeRO-1 pieces), one step with error-feedback compression, a sharded save,
and `launch.train.main` for 8 steps with checkpoints at 4 and 8, while
this process runs the same 8 steps in one process. Then two ranks restore
the 4-rank save into their pieces and resume `launch.train.main` to step
12, while this process resumes a copy of the same checkpoint; then they
run `launch.train.main` 6 steps with rank 1 asleep through one of them,
which must change both ranks' checkpoint cadence.

Tolerances:
- the rules and the per-device shapes, `int8_psum`, the 4 -> 2 rank
  restore and the JAX `checkpoint.restore` of the 4-rank save: equal;
- the ZeRO step against JAX: loss, grad norm and lr within 1e-5 and every
  leaf within `train.parity` (1e-5 of the leaf's largest, the parameters
  beyond Adam's allowance): a data-parallel mean adds per-rank means;
- the compressed step against the port's one-process step: the same, the
  int8 flips within `parity.FLIP_MARGIN` of their boundary;
- the 4-rank launcher's losses against one process's, and the resumed
  losses against the one-process resume: 1e-5.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import checkpoint as jax_ckpt
from repro.models import transformer as JT
from repro.train import loop as jax_loop
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCfg, get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.train import loop, parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCH = "tinyllama-1.1b"
CELL = ShapeCfg("train_small", 32, 8, "train")
MICROBATCHES = 2
STEPS = 3
RTOL = 1e-5
WAVE_S = 300       # each wave of child processes must end within this
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}

ELASTIC = ["--arch", ARCH, "--reduced", "--batch", "4", "--seq", "64",
           "--log-every", "0", "--device", "cpu"]

JAX_CHILD = r'''
import dataclasses, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCH_IDS, SHAPES, ShapeCfg, get_config
from repro.data.synthetic import TokenStream
from repro.distributed import sharding as S
from repro.distributed.compression import int8_psum
from repro.launch import specs
from repro.models import transformer as JT
from repro.train import loop

out = sys.argv[1]
devs = np.array(jax.devices())
meshes = {"2x2": Mesh(devs[:4].reshape(2, 2), ("data", "model")),
          "16x16": Mesh(devs.reshape(16, 16), ("data", "model"))}

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

def leaves(spec_tree, shape_tree, mesh):
    rec = {}
    def one(path, leaf, spec):
        rec[S._path_str(path)] = [enc(spec), list(
            NamedSharding(mesh, spec).shard_shape(leaf.shape))]
    jax.tree_util.tree_map_with_path(one, shape_tree, spec_tree)
    return rec

rules = {}
for mname, mesh in meshes.items():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ps = specs.abstract_params(cfg)
        r = {"params": leaves(S.param_specs(ps, mesh), ps, mesh),
             "zero1": leaves(S.zero1_specs(ps, mesh), ps, mesh),
             "logits": enc(S.logits_spec(cfg, mesh)), "shapes": {}}
        for shape in SHAPES:
            b = specs.batch_structs(cfg, shape)
            cs = specs.cache_structs(cfg, shape)
            csh = specs.cache_shardings(cfg, shape, mesh)
            r["shapes"][shape.name] = {
                "batch": leaves(S.batch_specs(cfg, shape, mesh), b, mesh),
                "cache": leaves(jax.tree.map(lambda s: s.spec, csh), cs, mesh),
                "token": leaves(S.decode_token_spec(cfg, shape, mesh),
                                jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32),
                                mesh),
                "applicable": list(specs.cell_applicable(cfg, shape)),
                "microbatches": specs.choose_microbatches(cfg, shape, mesh)}
        rules[f"{mname}/{arch}"] = r
with open(os.path.join(out, "rules.json"), "w") as f:
    json.dump(rules, f)

m4 = Mesh(devs[:4], ("data",))
x = jnp.arange(8 * 16, dtype=jnp.float32).reshape(8, 16) / 40.0
f = shard_map(lambda s: int8_psum(s, "data"), mesh=m4, in_specs=P("data"),
              out_specs=P("data"), check_rep=False)
arrays = {"int8_psum": np.asarray(f(x))}

cfg = get_config("tinyllama-1.1b").reduced()
cell = ShapeCfg("train_small", 32, 8, "train")
mesh = meshes["2x2"]
fn, args, in_sh, out_sh = specs.build_cell(cfg, cell, mesh, microbatch_override=2)
tcfg = dataclasses.replace(specs.train_cfg_for(cfg, cell, mesh), microbatches=2)
state = loop.init_state(JT.init_params(jax.random.PRNGKey(0), cfg), tcfg)
step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
stream = TokenStream(vocab=cfg.vocab, batch=8, seq=32)
for i in range(3):
    state, m = step(state, stream.batch_at(i))
    for j, leaf in enumerate(jax.tree_util.tree_leaves(state)):
        arrays[f"step{i}_{j}"] = np.asarray(leaf)
    for key in ("loss", "grad_norm", "lr"):
        arrays[f"step{i}_{key}"] = np.asarray(m[key])
np.savez(os.path.join(out, "jax.npz"), **arrays)
'''

RANK_CHILD = r'''
import dataclasses, os, sys, time
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import tree as tree_lib
from repro_torch.configs import ShapeCfg, get_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed import checkpoint as ckpt_lib
from repro_torch.distributed.compression import int8_psum
from repro_torch.distributed.sharding import (P, gather, gather_tree, shard,
                                              shard_tree)
from repro_torch.launch import specs, train as launch_train
from repro_torch.launch.mesh import make_host_mesh, make_mesh_compat
from repro_torch.models import transformer as T
from repro_torch.train import loop

phase, out, store = sys.argv[1:4]
rank = int(os.environ["RANK"])

def join():
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=launch_train.TIMEOUT)

cfg = get_config("tinyllama-1.1b").reduced()
cell = ShapeCfg("train_small", 32, 8, "train")

def save_tree(name, tree, **extra):
    if rank == 0:
        np.savez(os.path.join(out, name), *[t.numpy() for t in tree_lib.leaves(tree)],
                 **extra)

def template(mesh, st_specs, tcfg):
    full = loop.init_state(T.init_params(cfg, device="cpu"), tcfg)
    return shard_tree(full, st_specs, mesh)

if phase == "four":
    join()
    m1 = make_mesh_compat((4,), ("data",))
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16) / 40.0
    got = int8_psum({"x": shard(x, P("data"), m1)}, "data", m1)["x"]
    if rank == 0:
        np.save(os.path.join(out, "int8_psum.npy"),
                gather(got, P("data"), m1).numpy())
    else:
        gather(got, P("data"), m1)

    mesh = make_host_mesh(2)
    assert mesh.shape == {"data": 2, "model": 2}, mesh
    fn, args, in_specs, out_specs = specs.build_cell(cfg, cell, mesh,
                                                     microbatch_override=2)
    st_specs = in_specs[0]
    tcfg = dataclasses.replace(specs.train_cfg_for(cfg, cell, mesh), microbatches=2)
    init = os.path.join(out, "init")
    assert ckpt_lib.latest_step(init, mesh) == 0
    state0 = ckpt_lib.restore(init, 0, template(mesh, st_specs, tcfg), "cpu",
                              specs=st_specs, mesh=mesh)
    stream = TokenStream(vocab=cfg.vocab, batch=8, seq=32)
    state = state0
    for i in range(3):
        state, m = fn(state, stream.batch_at(i))
        save_tree(f"zero_step{i}.npz", gather_tree(state, st_specs, mesh),
                  loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                  lr=float(m["lr"]))
    pending = ckpt_lib.save(os.path.join(out, "ckpt4"), 3, state, blocking=False,
                            specs=st_specs, mesh=mesh)
    pending.join()

    # one step with error-feedback compression, the ZeRO-1 residual
    tc = dataclasses.replace(tcfg, compress_grads=True)
    c_specs = specs.state_shardings(cfg, tc, mesh)
    zspec = c_specs.ef.residual
    step_c = loop.make_train_step(
        cfg, tc, mesh=mesh, acc_specs=zspec, param_specs=c_specs.params,
        mb_specs={k: P(None, *s) for k, s in in_specs[1].items()})
    full = loop.init_state(T.init_params(cfg, device="cpu"), tc)
    full = full._replace(params=gather_tree(state0.params, st_specs.params, mesh))
    new, m = step_c(shard_tree(full, c_specs, mesh), stream.batch_at(0))
    save_tree("compress_step.npz", gather_tree(new, c_specs, mesh),
              loss=float(m["loss"]))

    losses = launch_train.main(["--steps", "8", "--ckpt-every", "4",
                                "--ckpt-dir", os.path.join(out, "elastic")]
                               + sys.argv[4:])
    if rank == 0:
        np.save(os.path.join(out, "elastic_first.npy"), np.array(losses))
else:
    # the launcher joins and leaves its own group (--init-method)
    losses = launch_train.main(["--steps", "12", "--ckpt-dir",
                                os.path.join(out, "elastic"), "--init-method",
                                f"file://{store}_launch"] + sys.argv[4:])
    assert not dist.is_initialized()
    if rank == 0:
        np.save(os.path.join(out, "elastic_resumed.npy"), np.array(losses))
    join()
    mesh = make_host_mesh(2)
    assert mesh.shape == {"data": 1, "model": 2}, mesh
    tcfg = dataclasses.replace(specs.train_cfg_for(cfg, cell, mesh), microbatches=2)
    st_specs = specs.state_shardings(cfg, tcfg, mesh)
    ckpt4 = os.path.join(out, "ckpt4")
    assert ckpt_lib.latest_step(ckpt4, mesh) == 3
    state = ckpt_lib.restore(ckpt4, 3, template(mesh, st_specs, tcfg), "cpu",
                             specs=st_specs, mesh=mesh)
    save_tree("restored2.npz", gather_tree(state, st_specs, mesh))

    # rank 1 sleeps through its fourth step (inside the monitor's window,
    # past the step's collectives): only its own clock sees the spike
    class Lagging(launch_train.StragglerMonitor):
        flags = []

        def stop(self):
            if rank == 1 and len(Lagging.flags) == 3:
                time.sleep(3.0 * self.ewma)
            Lagging.flags.append(super().stop())
            return Lagging.flags[-1]

    launch_train.StragglerMonitor = Lagging
    losses = launch_train.main(["--steps", "6", "--ckpt-every", "4",
                                "--ckpt-dir", os.path.join(out, "straggler")]
                               + sys.argv[4:])
    np.savez(os.path.join(out, f"straggler{rank}.npz"), losses=np.array(losses),
             flags=np.array(Lagging.flags))
dist.destroy_process_group()
'''


def _start(code, args, env):
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def _wait(children):
    """Join every child within WAVE_S; on a failure or a timeout kill the
    rest (a rank that died leaves the others blocked in a collective)."""
    outs, failed = [], None
    try:
        for child in children:
            out, _ = child.communicate(timeout=WAVE_S)
            outs.append(out)
            if child.returncode != 0 and failed is None:
                failed = out
    except subprocess.TimeoutExpired:
        failed = "timed out"
    finally:
        for child in children:
            if child.poll() is None:
                os.killpg(child.pid, 9)
                child.wait()
    assert failed is None, failed[-6000:]
    return outs


def _ranks(world, phase, out, store, extra=()):
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    return [_start(RANK_CHILD, [phase, out, store, *extra],
                   dict(env, RANK=str(r), LOCAL_RANK=str(r)))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    jcfg = jax_get_config(ARCH).reduced()
    tcfg = jax_loop.TrainCfg(microbatches=MICROBATCHES, remat="full")
    jstate = jax_loop.init_state(JT.init_params(jax.random.PRNGKey(0), jcfg), tcfg)
    jax_ckpt.save(os.path.join(out, "init"), 0, jstate)

    # every child on one thread: the suite runs beside other test workers
    jax_env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=256 "
                             "--xla_cpu_multi_thread_eigen=false "
                             "intra_op_parallelism_threads=1")
    children = ([_start(JAX_CHILD, [out], jax_env)]
                + _ranks(4, "four", out, os.path.join(out, "store4"), ELASTIC))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        try:
            first_one = launch_train.main(["--steps", "8"] + ELASTIC)
        finally:
            _wait(children)
        elastic = os.path.join(out, "elastic")
        shutil.copytree(elastic, os.path.join(out, "elastic_one"))
        children = _ranks(2, "two", out, os.path.join(out, "store2"), ELASTIC)
        try:
            one = launch_train.main(["--steps", "12", "--ckpt-dir",
                                     os.path.join(out, "elastic_one")] + ELASTIC)
        finally:
            _wait(children)
    finally:
        torch.set_num_threads(threads)
    with open(os.path.join(out, "rules.json")) as f:
        rules = json.load(f)
    with np.load(os.path.join(out, "jax.npz")) as f:
        ref = dict(f)
    return {"out": out, "jstate": jstate, "one": one, "first_one": first_one,
            "rules": rules, "jax": ref}


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree):
    """{path string: leaf} of a tree of dicts and tuples."""
    out = {}
    S.tree_map_with_path(
        lambda path, leaf: out.__setitem__(S._path_str(path), leaf), tree)
    return out


def _records(spec_tree, shape_tree, mesh):
    """{path: [spec, per-device shape]}, as the JAX child writes them."""
    shapes = _flat(shape_tree)
    return {path: [_enc(spec), list(S.shard_shape(spec, shapes[path].shape,
                                                  mesh))]
            for path, spec in _flat(spec_tree).items()}


def _port_state(arrays):
    """A port `TrainState` (reduced tinyllama, no residual) from leaves in
    flatten order."""
    cfg = get_config(ARCH).reduced()
    tmpl = loop.init_state(T.init_params(cfg, device="cpu"),
                           loop.TrainCfg(microbatches=MICROBATCHES))
    return tree_lib.unflatten(tmpl, [torch.from_numpy(np.asarray(a))
                                     for a in arrays])


def _npz_leaves(path):
    """A rank's saved leaves (``arr_<i>``, flatten order) and its other
    entries."""
    with np.load(path) as f:
        n = sum(name.startswith("arr_") for name in f.files)
        return [f[f"arr_{i}"] for i in range(n)], dict(f)


# ---------------------------------------------------------------- the rules


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_shard_shapes_equal_jax(runs, arch, mesh_name):
    """param / zero1 / batch / cache / decode-token / logits specs as
    tuples, and every per-device shape, for every shape cell."""
    want = runs["rules"][f"{mesh_name}/{arch}"]
    mesh = M.Mesh(MESHES[mesh_name], ("data", "model"), rank=None)
    cfg = get_config(arch)
    ps = specs.abstract_params(cfg)
    assert _records(S.param_specs(ps, mesh), ps, mesh) == want["params"]
    assert _records(S.zero1_specs(ps, mesh), ps, mesh) == want["zero1"]
    assert _enc(S.logits_spec(cfg, mesh)) == want["logits"]
    for shape in SHAPES:
        w = want["shapes"][shape.name]
        b = specs.batch_structs(cfg, shape)
        assert _records(S.batch_specs(cfg, shape, mesh), b, mesh) == w["batch"]
        cache = specs.cache_structs(cfg, shape)
        assert _records(specs.cache_shardings(cfg, shape, mesh), cache,
                        mesh) == w["cache"], shape.name
        token = torch.empty((shape.global_batch, 1), device="meta")
        assert _records({"": S.decode_token_spec(cfg, shape, mesh)},
                        {"": token}, mesh)[""] == w["token"][""]
        assert list(specs.cell_applicable(cfg, shape)) == w["applicable"]
        assert specs.choose_microbatches(cfg, shape, mesh) == w["microbatches"]


def test_meshes_and_pieces():
    """The production meshes are abstract; a one-process host mesh is
    (1, 1) and its collectives return their input; every rank's piece of
    an array under a spec, joined in rank order, is the array."""
    pm = M.make_production_mesh(multi_pod=True)
    assert pm.shape == {"pod": 2, "data": 16, "model": 16} and pm.rank is None
    assert S.dp_axes(pm) == ("pod", "data")
    host = M.make_host_mesh(2)
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    x = torch.arange(24.0).reshape(4, 6)
    assert host.all_reduce(x, "data") is x
    assert S.gather(S.shard(x, S.P("data", "model"), host), S.P("data", "model"),
                    host) is x
    spec = S.P(("model", "data"), None)
    m = M.Mesh((2, 2), ("data", "model"), rank=None)
    pieces = {}
    for coords in ({"data": d, "model": k} for d in range(2) for k in range(2)):
        piece = S.shard(x, spec, m, coords=coords)
        pieces[m.index(("model", "data"), coords)] = piece
        assert tuple(piece.shape) == S.shard_shape(spec, x.shape, m) == (1, 6)
    assert torch.equal(torch.cat([pieces[i] for i in range(4)]), x)
    with pytest.raises(ValueError, match="does not split"):
        S.shard_shape(S.P("model"), (3,), pm)
    assert S.P(("data",), None) == S.P("data", None)


# ---------------------------------------------------------------- collectives


def test_int8_psum_four_ranks_equal_jax_bit_for_bit(runs):
    got = np.load(os.path.join(runs["out"], "int8_psum.npy"))
    np.testing.assert_array_equal(got, runs["jax"]["int8_psum"])


# ---------------------------------------------------------------- the step


def test_zero_step_four_ranks_within_parity_of_jax(runs):
    """`build_cell`'s train step on mesh (2, 2): three steps from the JAX
    state against the JAX `build_cell` step jitted on a 2x2 host mesh."""
    ref = runs["jax"]
    allowance = None
    for i in range(STEPS):
        keys = sorted((k for k in ref if k.startswith(f"step{i}_")
                       and k.split("_")[1].isdigit()),
                      key=lambda k: int(k.split("_")[1]))
        want = _port_state([ref[k] for k in keys])
        leaves, extra = _npz_leaves(os.path.join(runs["out"], f"zero_step{i}.npz"))
        got = _port_state(leaves)
        for key in ("loss", "grad_norm", "lr"):
            assert parity.rel(float(extra[key]), ref[f"step{i}_{key}"]) <= RTOL, key
        allowance = parity.adam_allowance(allowance, want, float(ref[f"step{i}_lr"]))
        r = parity.compare_states(got, want, allowance=allowance)
        print(f"step {i}: {r}")
        for part in ("params", "mu", "nu"):
            assert r[part] <= RTOL, (i, part, r)
        assert int(got.step) == int(want.step) == i + 1


def test_compressed_zero_step_within_parity_of_one_process(runs):
    """Error feedback under the ZeRO-1 layout: each leaf's int8 scale is the
    whole leaf's (a max-reduce over its pieces)."""
    cfg = get_config(ARCH).reduced()
    tcfg = loop.TrainCfg(microbatches=MICROBATCHES, remat="full",
                         compress_grads=True)
    params = train_state_from_jax(runs["jstate"], cfg, "cpu").params
    state = loop.init_state(params, tcfg)
    batch = TokenStream(vocab=cfg.vocab, batch=8, seq=32).batch_at(0)
    want, wm = loop.make_train_step(cfg, tcfg)(state, batch)
    leaves, extra = _npz_leaves(os.path.join(runs["out"], "compress_step.npz"))
    got = tree_lib.unflatten(want, [torch.from_numpy(a) for a in leaves])
    assert parity.rel(float(extra["loss"]), wm["loss"]) <= RTOL
    r = parity.compare_states(got, want)
    print(r)
    assert r["flip_margin"] <= parity.FLIP_MARGIN, r
    for part in ("params", "mu", "nu", "ef"):
        assert r[part] <= RTOL, (part, r)


# ---------------------------------------------------------------- checkpoints


def test_save_under_four_ranks_restores_under_two_and_in_jax(runs):
    """The 4-rank save holds the whole arrays once: 2 ranks restore their
    pieces of it, gathered equal to the 4 ranks' gathered state, and the
    JAX `checkpoint.restore` reads the same bits."""
    out = runs["out"]
    four, _ = _npz_leaves(os.path.join(out, "zero_step2.npz"))
    two, _ = _npz_leaves(os.path.join(out, "restored2.npz"))
    assert len(four) == len(two) > 10
    for a, b in zip(four, two):
        np.testing.assert_array_equal(a, b)
    jrestored = jax_ckpt.restore(os.path.join(out, "ckpt4"), 3, runs["jstate"])
    for a, b in zip(four, jax.tree_util.tree_leaves(jrestored)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_launch_train_elastic_four_to_two_ranks(runs):
    """`launch.train.main` under 4 ranks (8 steps, checkpoints at 4 and 8;
    the batch split over data 2) within 1e-5 of one process's 8 steps,
    resumed under 2 to step 12: exactly 4 losses, within 1e-5 of a
    one-process resume from the same checkpoint."""
    out = runs["out"]
    first = np.load(os.path.join(out, "elastic_first.npy"))
    resumed = np.load(os.path.join(out, "elastic_resumed.npy"))
    assert len(first) == 8 == len(runs["first_one"])
    for a, b in zip(first, runs["first_one"]):
        assert parity.rel(float(a), b) <= RTOL, (first, runs["first_one"])
    assert len(resumed) == 4 == len(runs["one"])
    for a, b in zip(resumed, runs["one"]):
        assert parity.rel(float(a), b) <= RTOL, (resumed, runs["one"])
    assert sorted(os.listdir(os.path.join(out, "elastic"))) == [
        "step_12", "step_4", "step_8"]


def test_straggler_on_one_rank_changes_every_ranks_cadence(runs):
    """Rank 1 alone sees a latency spike at step 3 (it sleeps through the
    step); the cadence goes from 4 to 10 on both ranks, so neither saves at
    step 4 (a save is collective: a rank alone in it would wait in its
    gathers while the other ran the next step) and both write step 6."""
    out = runs["out"]
    ranks = [np.load(os.path.join(out, f"straggler{r}.npz")) for r in (0, 1)]
    assert bool(ranks[1]["flags"][3])
    assert len(ranks[0]["losses"]) == len(ranks[1]["losses"]) == 6
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    assert sorted(os.listdir(os.path.join(out, "straggler"))) == ["step_6"]


def test_one_process_launcher_has_no_mesh(tmp_path, capsys):
    """Without a distributed environment the launcher runs one process and
    reports `--model-parallel` as unused, as before the ranks."""
    assert "WORLD_SIZE" not in os.environ
    losses = launch_train.main(["--steps", "2", "--log-every", "0",
                                "--ckpt-dir", str(tmp_path)] + ELASTIC)
    assert len(losses) == 2
    assert "not used on one device" in capsys.readouterr().out
