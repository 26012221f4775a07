"""The port stands apart from the JAX package and defaults to the card.

- `repro_torch` imports neither `jax` nor any `repro` module (checked in a
  fresh interpreter, and by reading the sources and `chip_smoke.py`);
- its entry points (search, stream, `api.build`, the model and the serve
  engine) run on the card by default and raise without one instead of
  falling back to the CPU;
- asking for the kernels on CPU tensors raises;
- what is not ported yet (the MoE configs) raises, naming its ROADMAP
  item; the runtime's modes and the registry's backends are all taken;
- `save` / `load`, `recover`, `sharded_search` and the ``sharded`` backend
  also run on the card unless ``device="cpu"`` is passed.
"""
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.configs import MoECfg, get_config
from repro_torch.convert import stream_from_state
from repro_torch.core.promips import ProMIPS
from repro_torch.core.runtime import RuntimeConfig, search
from repro_torch.core.sharded import (MutableShardedProMIPS, build_sharded,
                                      device_put_sharded_index,
                                      sharded_search)
from repro_torch.data.synthetic import mf_factors
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.robust import recover
from repro_torch.serve import DecodeEngine
from repro_torch.stream import MutableProMIPS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _modules():
    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(_modules()) >= 40


def test_sources_do_not_name_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b|"
                         r"from\s+repro[.\s])", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


@pytest.fixture
def no_card(monkeypatch):
    """This box has no card; the fixture makes sure of it on any box."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_it(no_card):
    x = mf_factors(600, 32, 8, seed=0)
    q = mf_factors(4, 32, 8, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProMIPS.build(x, m=6, seed=0)
    pm = ProMIPS.build(x, m=6, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        search(pm.arrays, pm.meta, q)
    ids, scores, stats = search(pm.arrays, pm.meta, q, device="cpu")
    assert ids.shape == (4, 10) and ids.device.type == "cpu"
    assert torch.isfinite(scores).all()
    ids2, _, _ = pm.search(q)
    assert torch.equal(ids, ids2)
    ids3, _, st3 = pm.search_progressive(q)
    assert ids3.device.type == "cpu" and st3.pages.shape == (4,)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build(x)                                  # the default: promips
    for backend in ("exact", "h2alsh", "pq", "rangelsh"):
        with pytest.raises(RuntimeError, match="CUDA"):
            api.build(x, backend=backend)
    s = api.build(x, device="cpu", m=6)
    assert s.name == "promips" and s.search(q, k=3).ids.shape == (4, 3)
    assert api.build(x, backend="exact", device="cpu").search(q).ids.shape == (4, 10)


def test_stream_entry_points_default_to_the_card_and_raise_without_it(no_card):
    x = mf_factors(600, 32, 8, seed=0)
    q = mf_factors(4, 32, 8, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        MutableProMIPS(x, m=6, seed=0)
    st = MutableProMIPS(x, m=6, seed=0, device="cpu")
    st.insert([1000], x[:1] * 2)
    state = st.state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        MutableProMIPS.from_state(*state)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_from_state(*state)
    ids, scores, stats = stream_from_state(*state, device="cpu").search(q)
    assert ids.shape == (4, 10) and ids.device.type == "cpu"
    assert torch.equal(ids, st.search(q)[0])
    assert st.snapshot().delta_x.device.type == "cpu"


def test_durability_and_sharded_entry_points_default_to_the_card(no_card,
                                                                  tmp_path):
    x = mf_factors(600, 32, 8, seed=0)
    q = mf_factors(4, 32, 8, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build(x, backend="sharded", n_shards=2, m=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        MutableShardedProMIPS(x, 2, m=6)
    sh = build_sharded(x, 2, m=6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_put_sharded_index(sh)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_search(sh, q, 5)
    assert sharded_search(sh, q, 5, device="cpu")[0].device.type == "cpu"
    wd = str(tmp_path / "wal")
    s = api.build(x, backend="promips-stream", m=6, device="cpu", wal_dir=wd)
    s.insert([900], x[:1])
    path = str(tmp_path / "snapshot")
    s.save(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.get_backend("promips-stream").load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        recover(wd)
    loaded = api.load(path, device="cpu")
    assert loaded.inner.snapshot().delta_x.device.type == "cpu"
    assert recover(wd, device="cpu").n == s.n


def test_serve_entry_points_default_to_the_card_and_raise_without_it(no_card):
    cfg = get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg)
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(params, cfg)
    with pytest.raises(ValueError, match="use_kernels"):
        DecodeEngine(params, cfg, device="cpu", use_kernels=True)
    x = mf_factors(600, 32, 8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build(x, backend="promips-stream")
    s = api.build(x, backend="promips-stream", device="cpu", m=6)
    assert s.search(x[:2], k=3).ids.shape == (2, 3)
    eng = DecodeEngine(params, cfg, device="cpu", batch_slots=2, max_len=16)
    eng.submit(np.arange(1, 5), max_new_tokens=2)
    eng.run()
    assert eng.cache["k"].device.type == "cpu" and eng.steps == 2


def test_unported_configs_and_backends_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("qwen3-32b")
    # every backend is ported: ``sharded`` builds and searches
    assert "sharded" in api.backends()
    s = api.build(mf_factors(100, 8, 4, seed=0), backend="sharded",
                  device="cpu", m=4, n_shards=2)
    assert s.search(mf_factors(2, 8, 4, seed=1), k=3).ids.shape == (2, 3)
    moe = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              moe=MoECfg(4, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(moe, device="cpu")


def test_runtime_config_rejects_what_is_not_ported():
    """Every mode and backend of the JAX runtime is ported now: they are
    accepted, and only unknown values raise."""
    assert RuntimeConfig(verification="batched").verification == "batched"
    assert RuntimeConfig(mode="progressive").mode == "progressive"
    assert RuntimeConfig(verification="scan").verification == "scan"
    assert RuntimeConfig(obs=True).obs is True    # the span tracer is ported
    with pytest.raises(ValueError):
        RuntimeConfig(verification="nope")
    with pytest.raises(ValueError):
        RuntimeConfig(mode="nope")
    with pytest.raises(ValueError):
        RuntimeConfig(prefilter_eps=0.0)


def test_use_kernels_true_on_cpu_tensors_raises():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    valid = torch.ones(16, dtype=torch.bool)
    slots = torch.arange(2, dtype=torch.int32)
    sel = torch.ones((2, 2), dtype=torch.bool)
    init_s = torch.full((2, 3), float("-inf"))
    init_r = torch.full((2, 3), -1, dtype=torch.int32)
    c_half = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.block_mips(x, valid, q, slots, sel, init_s, init_r, c_half, k=3,
                       page_rows=8, use_kernels=True)
    codebooks = torch.zeros((2, 4, 4))
    codes = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.sketch_scores(q, x[:2], codebooks, codes, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.mips_score(x, q, valid, use_kernels=True)
    codes = torch.arange(4, dtype=torch.int64)
    q_code = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.binary_probe_lb(codes, q_code, q[:, :2], use_kernels=True)
    kv = torch.zeros((2, 5, 1, 32))
    lens = torch.tensor([1, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(torch.zeros((2, 1, 2, 32)), kv, kv, lens,
                             use_kernels=True)
    order = torch.arange(2, dtype=torch.int32).repeat(2, 1)
    ids = torch.arange(16, dtype=torch.int32)
    n_sel = torch.full((2,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.scan_blocks(x, ids, q, order, init_s, init_r, c_half, k=3,
                        page_rows=8, budget=2, n_sel=n_sel, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.mips_topk(x, q, valid, 3, use_kernels=True)
    before = dict(ops.LAUNCHES)
    ops.scan_blocks(x, ids, q, order, init_s, init_r, c_half, k=3,
                    page_rows=8, budget=2, n_sel=n_sel)
    ops.mips_topk(x, q, valid, 3)
    ops.block_mips(x, valid, q, slots, sel, init_s, init_r, c_half, k=3,
                   page_rows=8)                       # CPU: plain, no launch
    ops.mips_score(x, q, valid)
    ops.binary_probe_lb(codes, q_code, q[:, :2])
    ops.decode_attention(torch.zeros((2, 1, 2, 32)), kv, kv, lens)
    assert ops.LAUNCHES == before
