"""The port's host index build and index loading against the JAX package.

The build is numpy on both sides, so the same rows and seed must give the
same arrays bit for bit; `convert` must carry a JAX-built index (in memory
or from an ``api`` save directory) into the port unchanged.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api
from repro.core.index import build_index as jax_build_index
from repro.data.synthetic import mf_factors as jax_mf_factors
from repro_torch.convert import index_from_dir, index_from_numpy
from repro_torch.core.index import IndexArrays, build_index, to_device
from repro_torch.data.synthetic import mf_factors

CONFIGS = [
    dict(n=3000, d=48, rank=12, build=dict(m=8, norm_strata=4, k_p=5, k_sp=8)),
    dict(n=2000, d=32, rank=8, build=dict(norm_strata=1)),
]


def _corpus(cfg):
    x = mf_factors(cfg["n"], cfg["d"], cfg["rank"], decay=0.5, norm_tail=0.6,
                   seed=0)
    ref = jax_mf_factors(cfg["n"], cfg["d"], cfg["rank"], decay=0.5,
                         norm_tail=0.6, seed=0)
    assert x.dtype == ref.dtype and np.array_equal(x, ref)
    return x


def _assert_port_arrays_equal(port: IndexArrays, ref_arrays, device="cpu"):
    """Tensors equal the numpy arrays value for value, with the port's
    dtypes: float32, int32, and int64 group codes."""
    for name in IndexArrays._fields:
        t = getattr(port, name)
        a = np.asarray(getattr(ref_arrays, name) if not isinstance(ref_arrays, dict)
                       else ref_arrays[name])
        assert t.device.type == device, name
        want_dtype = (torch.int64 if name == "g_code" else
                      torch.float32 if a.dtype.kind == "f" else torch.int32)
        assert t.dtype == want_dtype, (name, t.dtype)
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(t.numpy(), a.astype(t.numpy().dtype),
                                      err_msg=name)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["d48-strata4", "d32-strata1"])
def test_build_index_bitwise_equal_to_jax(cfg):
    x = _corpus(cfg)
    ours = build_index(x, seed=0, **cfg["build"])
    ref = jax_build_index(x, seed=0, **cfg["build"])
    for name in IndexArrays._fields:
        a, b = np.asarray(getattr(ours.arrays, name)), np.asarray(getattr(ref.arrays, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dataclasses.asdict(ours.meta) == dataclasses.asdict(ref.meta)
    for name in ("perm", "sp_start", "keys", "sp_key", "sp_part"):
        np.testing.assert_array_equal(getattr(ours.layout, name),
                                      getattr(ref.layout, name), err_msg=name)
    assert ours.meta.page_rows == 4096 // (4 * cfg["d"])   # 21 and 32: not 8


def test_index_from_numpy_round_trips_a_jax_index():
    cfg = CONFIGS[0]
    ref = jax_build_index(_corpus(cfg), seed=0, **cfg["build"])
    arrays = {f: np.asarray(getattr(ref.arrays, f)) for f in IndexArrays._fields}
    port, meta = index_from_numpy(arrays, dataclasses.asdict(ref.meta),
                                  device="cpu")
    _assert_port_arrays_equal(port, ref.arrays)
    assert dataclasses.asdict(meta) == dataclasses.asdict(ref.meta)
    with pytest.raises(KeyError):
        index_from_numpy({k: v for k, v in arrays.items() if k != "sk_err"},
                         dataclasses.asdict(ref.meta), device="cpu")


def test_index_from_dir_reads_an_api_save(tmp_path):
    x = _corpus(CONFIGS[1])
    saved = api.build(x, backend="promips", seed=0)
    path = saved.save(str(tmp_path / "idx"))
    port, meta = index_from_dir(path, device="cpu")
    arrays, backend_meta = saved.state()
    _assert_port_arrays_equal(port, arrays)
    assert dataclasses.asdict(meta) == backend_meta["meta"]


def test_to_device_rejects_sketch_codes_outside_the_codebooks():
    ref = build_index(_corpus(CONFIGS[1]), seed=0)
    codes = np.asarray(ref.arrays.sk_codes).copy()
    codes[0, 0] = ref.meta.sk_codewords
    with pytest.raises(ValueError):
        to_device(ref.arrays._replace(sk_codes=codes), "cpu")
