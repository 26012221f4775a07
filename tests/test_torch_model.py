"""The port's dense transformer and `decode_attention` (plain versions, on
the CPU) against the JAX package, at the reduced tinyllama config (4 layers,
d_model 128, vocab 512), f32, with the JAX parameters of
`init_params(PRNGKey(0), cfg)` carried across by `convert.params_from_jax`.

Tolerances: `decode_attention`'s plain version within 1e-5 absolute of
`repro.kernels.ref.decode_attention_ref` and of the Pallas kernel in
interpret mode (the three sum the softmax in other orders; outputs are
O(1)); `prefill` logits and caches and eight `decode_step`s (logits and
the hidden state of ``return_hidden``) within 1e-4 absolute of the JAX
model (GEMMs and RoPE angles sum in other orders in the two frameworks);
`params_from_jax` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.models import attention as jax_attention
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import attention, layers
from repro_torch.models import transformer as T

ATOL_ATTN = 1e-5
ATOL_MODEL = 1e-4


@pytest.fixture(scope="module")
def model():
    cfg = get_config("tinyllama-1.1b").reduced()
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, tree=tree,
                params=params_from_jax(tree, cfg, device="cpu"))


def _attention_inputs(b, kh, g, dh, s, lens, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, kh, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, dh)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.parametrize("b,kh,g,dh,s,lens", [
    (3, 2, 4, 32, 700, [1, 350, 700]),     # S a multiple of neither block
    (2, 4, 8, 64, 512, [0, 300]),          # cache_len 0, S = the Pallas block
    (2, 1, 1, 16, 37, [37, 0]),            # G = 1, cache_len 0, S < a block
    (2, 2, 2, 32, 2100, [2100, 1500]),     # over two of the port's blocks
])
def test_decode_attention_plain_matches_jax_ref_and_pallas(b, kh, g, dh, s,
                                                           lens):
    q, k, v, cache_len = _attention_inputs(b, kh, g, dh, s, lens, seed=s + g)
    ours = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, cache_len)))
    assert ours.dtype == torch.float32 and ours.shape == (b, kh, g, dh)
    jargs = [jnp.asarray(a) for a in (q, k, v, cache_len)]
    want_ref = np.asarray(jax_ref.decode_attention_ref(*jargs))
    want_pallas = np.asarray(pallas_decode(*jargs, interpret=True))
    np.testing.assert_allclose(ours.numpy(), want_ref, rtol=0, atol=ATOL_ATTN)
    np.testing.assert_allclose(ours.numpy(), want_pallas, rtol=0, atol=ATOL_ATTN)
    for i, n in enumerate(lens):
        if n == 0:                        # every position masked alike
            mean = np.broadcast_to(v[i].mean(axis=0)[:, None, :], (kh, g, dh))
            np.testing.assert_allclose(ours[i].numpy(), mean, rtol=0,
                                       atol=ATOL_ATTN)


def test_flash_decode_matches_jax(model):
    """The model's decode attention (`flash_decode`, q (B, H, dh)) against
    the JAX `flash_decode` it mirrors, on a cache of ragged lengths >= 1."""
    q, k, v, cache_len = _attention_inputs(3, 2, 2, 32, 1500, [1, 1024, 1500],
                                           seed=5)
    q = q.reshape(3, 4, 32)
    ours = attention.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, cache_len)))
    want = jax_attention.flash_decode(*(jnp.asarray(a) for a in (q, k, v, cache_len)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_ATTN)


def test_params_from_jax_is_bit_identical(model):
    tree, params = model["tree"], model["params"]

    def walk(t, p, path):
        assert set(t) == set(p), path
        for key in t:
            if isinstance(t[key], dict):
                walk(t[key], p[key], f"{path}/{key}")
            else:
                assert p[key].dtype == torch.float32
                np.testing.assert_array_equal(p[key].numpy(), t[key],
                                              err_msg=f"{path}/{key}")
    walk(tree, params, "")
    broken = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                if k != "ln2"})
    with pytest.raises(ValueError, match="ln2"):
        params_from_jax(broken, model["cfg"], device="cpu")


def test_prefill_and_decode_steps_match_jax(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    params, jparams = model["params"], model["jparams"]
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, cfg.vocab, (3, 9)).astype(np.int32)
    jcache, jlogits = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 32)
    cache, logits = T.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL_MODEL)
    np.testing.assert_array_equal(cache["len"].numpy(), np.asarray(jcache["len"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=0, atol=ATOL_MODEL, err_msg=name)
    tok = np.asarray(jnp.argmax(jlogits[:, :cfg.vocab], -1)).astype(np.int32)[:, None]
    for step in range(8):
        if step % 2:        # return_hidden on every other step
            jh, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                        return_hidden=True)
            h, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok),
                                     return_hidden=True)
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                                       atol=ATOL_MODEL, err_msg=f"step {step}")
            jlg = JT._logits(jparams, jcfg, jh)
        else:
            jlg, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
            lg, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                       atol=ATOL_MODEL, err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), rtol=0,
                                       atol=ATOL_MODEL, err_msg=name)
        np.testing.assert_array_equal(cache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        tok = np.asarray(jnp.argmax(jlg[:, :cfg.vocab], -1)).astype(np.int32)[:, None]


def test_decode_past_the_cache_clamps_like_jax(model):
    """A slot whose length runs past max_len (an idle slot of the engine
    keeps stepping) writes its last row, as `dynamic_update_slice` clamps."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    params, jparams = model["params"], model["jparams"]
    tokens = np.arange(1, 7, dtype=np.int32)[None, :].repeat(2, 0)
    jcache, _ = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 8)
    cache, _ = T.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, 8)
    tok = np.full((2, 1), 3, np.int32)
    for _ in range(4):                     # lengths 7, 8, 9, 10 > max_len 8
        jlg, jcache = JT.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        lg, cache = T.decode_step(params, cfg, cache, torch.from_numpy(tok))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0, atol=ATOL_MODEL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=ATOL_MODEL)


def test_layers_match_jax():
    from repro.models import layers as jax_layers
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rng.randint(0, 500, (2, 5)).astype(np.int32)
    w = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=0, atol=1e-6)
    init = layers.dense_init((4000, 50), generator=torch.Generator().manual_seed(0),
                             device="cpu")
    assert float(init.abs().max()) <= 2.0 * 4000 ** -0.5 + 1e-7
    assert abs(float(init.std()) * 4000 ** 0.5 - 0.88) < 0.02   # std of N cut at 2


def test_init_helpers_take_the_device_they_are_given():
    cfg = get_config("tinyllama-1.1b").reduced()
    g = torch.Generator().manual_seed(0)
    assert layers.dense_init((8, 4), generator=g, device="cpu").device.type == "cpu"
    mlp = layers.init_mlp(16, 32, generator=g, device="cpu")
    attn = attention.init_attention(cfg, generator=g, device="cpu")
    assert all(t.device.type == "cpu" for t in [*mlp.values(), *attn.values()])


@pytest.mark.parametrize("helper", ["dense_init", "init_mlp", "init_attention"])
def test_init_helpers_have_no_default_device(helper):
    cfg = get_config("tinyllama-1.1b").reduced()
    call = {"dense_init": lambda: layers.dense_init((8, 4)),
            "init_mlp": lambda: layers.init_mlp(16, 32),
            "init_attention": lambda: attention.init_attention(cfg)}[helper]
    with pytest.raises(TypeError):
        call()
