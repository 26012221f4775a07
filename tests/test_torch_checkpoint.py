"""The port's checkpoints (`repro_torch.distributed.checkpoint`) against the
JAX package's (`repro.distributed.checkpoint`), on the reduced qwen3-32b
`TrainState` (q/k norms, an untied unembed) with and without the
error-feedback residuals. Each package restores the other's checkpoints
bit for bit; the manifest's tree string is the one JAX writes; an
incomplete or ``.tmp`` step is ignored; an async save is joined.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import checkpoint as jax_ckpt
from repro.models import transformer as JT
from repro.train import loop as jax_loop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models import transformer as T
from repro_torch.train import loop

NAME = "qwen3-32b"


def _jax_state(compress: bool, seed: int):
    """A JAX TrainState with every leaf distinct: random params and
    moments, count and step 3."""
    jcfg = jax_get_config(NAME).reduced()
    state = jax_loop.init_state(JT.init_params(jax.random.PRNGKey(seed), jcfg),
                                jax_loop.TrainCfg(compress_grads=compress))
    rng = np.random.RandomState(seed)

    def noise(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))

    opt = state.opt._replace(mu=jax.tree.map(noise, state.opt.mu),
                             nu=jax.tree.map(lambda x: noise(x) ** 2, state.opt.nu),
                             count=jnp.int32(3))
    ef = None if state.ef is None else state.ef._replace(
        residual=jax.tree.map(noise, state.ef.residual))
    return state._replace(opt=opt, ef=ef, step=jnp.int32(3))


def _assert_same(port_state, jax_state):
    got, want = tree_lib.leaves(port_state), jax.tree_util.tree_leaves(jax_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert str(a.dtype).replace("torch.", "") == str(np.asarray(b).dtype)
        np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b))


@pytest.mark.parametrize("compress", [False, True])
def test_port_save_jax_restore(tmp_path, compress):
    cfg = get_config(NAME).reduced()
    jstate = _jax_state(compress, seed=1)
    state = train_state_from_jax(jstate, cfg, "cpu")
    ckpt.save(str(tmp_path), 3, state)
    target = _jax_state(compress, seed=2)            # other values, same tree
    restored = jax_ckpt.restore(str(tmp_path), 3, target)
    _assert_same(state, restored)
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(jstate))
    assert manifest["n_leaves"] == len(jax.tree_util.tree_leaves(jstate))
    assert manifest["dtypes"][-1] == "int32" and manifest["shapes"][-1] == []


@pytest.mark.parametrize("compress", [False, True])
def test_jax_save_port_restore(tmp_path, compress):
    cfg = get_config(NAME).reduced()
    jstate = _jax_state(compress, seed=3)
    jax_ckpt.save(str(tmp_path), 7, jstate)
    target = loop.init_state(T.init_params(cfg, device="cpu"),
                             loop.TrainCfg(compress_grads=compress))
    restored = ckpt.restore(str(tmp_path), 7, target, device="cpu")
    assert isinstance(restored, loop.TrainState)
    assert (restored.ef is None) == (not compress)
    _assert_same(restored, jstate)
    # the port's own save of the same state is byte-compatible: same manifest
    ckpt.save(str(tmp_path / "port"), 7, restored)
    for name in ("manifest.json",):
        with open(tmp_path / "step_7" / name) as a, \
                open(tmp_path / "port" / "step_7" / name) as b:
            assert json.load(a) == json.load(b)


def test_restore_checks_the_target(tmp_path):
    cfg = get_config(NAME).reduced()
    jstate = _jax_state(True, seed=4)
    jax_ckpt.save(str(tmp_path), 1, jstate)
    plain = loop.init_state(T.init_params(cfg, device="cpu"), loop.TrainCfg())
    with pytest.raises(ValueError, match="leaves"):       # no ef in the target
        ckpt.restore(str(tmp_path), 1, plain, device="cpu")
    other = loop.init_state(T.init_params(get_config("tinyllama-1.1b").reduced(),
                                          device="cpu"),
                            loop.TrainCfg(compress_grads=True))
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, other, device="cpu")


def test_incomplete_and_tmp_steps_are_ignored(tmp_path):
    cfg = get_config(NAME).reduced()
    state = train_state_from_jax(_jax_state(False, seed=5), cfg, "cpu")
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None and ckpt.latest_step(d + "/none") is None
    ckpt.save(d, 2, state)
    ckpt.save(d, 4, state)
    # a later step torn before its marker, and a leftover .tmp of a still later one
    shutil.copytree(tmp_path / "step_4", tmp_path / "step_6")
    os.remove(tmp_path / "step_6" / ".complete")
    shutil.copytree(tmp_path / "step_4", tmp_path / "step_8.tmp")
    assert ckpt.latest_step(d) == jax_ckpt.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, 6, state, device="cpu")
    # a save over a leftover .tmp of the same step replaces it
    shutil.copytree(tmp_path / "step_2", tmp_path / "step_10.tmp")
    ckpt.save(d, 10, state)
    assert ckpt.latest_step(d) == 10 and not os.path.exists(tmp_path / "step_10.tmp")


def test_async_save_is_joined_and_complete(tmp_path):
    cfg = get_config(NAME).reduced()
    state = train_state_from_jax(_jax_state(True, seed=6), cfg, "cpu")
    thread = ckpt.save(str(tmp_path), 5, state, blocking=False)
    assert thread is not None
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 5
    # the host copy was taken before the save returned: a later in-place
    # change of the state does not reach the checkpoint
    before = state.params["embed"].clone()
    thread = ckpt.save(str(tmp_path), 6, state, blocking=False)
    state.params["embed"].add_(1.0)
    thread.join(timeout=60)
    assert not thread.is_alive()
    restored = ckpt.restore(str(tmp_path), 6, state, device="cpu")
    assert torch.equal(restored.params["embed"], before)


def test_treedef_string_matches_jax_for_every_shape_of_state():
    for compress in (False, True):
        jstate = _jax_state(compress, seed=0)
        state = train_state_from_jax(jstate, get_config(NAME).reduced(), "cpu")
        assert tree_lib.treedef_str(state) == str(
            jax.tree_util.tree_structure(jstate))
