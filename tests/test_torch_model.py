"""The PyTorch port's model against the JAX package's on the CPU.

Both run ``reduced(gemma-2b, vocab_size=260, num_layers=2, pad_heads_to=8)``:
padded heads (4 real of 8) and a padded vocab (260 of 512). The JAX weights
are bridged into the port; the comparisons run in fp32 at 2e-5, with the
JAX package on its reference kernel path (its CPU default).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.models import get_model, layers, lm

TOL = dict(atol=2e-5, rtol=2e-5)
SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8)


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jax_reduced(jax_get_config("gemma-2b"), **SMOKE)
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    assert cfg.padded_heads == 8 > cfg.num_heads and cfg.padded_vocab == 512
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_params(cfgs):
    return jax.tree.map(np.asarray, jlm.init(cfgs[0], jax.random.PRNGKey(0)))


def fp32_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else jnp.asarray(a), tree)


def test_bridge_round_trips_bit_for_bit(cfgs, jax_params):
    params = bridge.from_jax(jax_params)
    assert len(params["blocks"]) == cfgs[1].num_layers
    assert params["embed"].dtype == torch.bfloat16
    assert params["blocks"][1]["attn"]["w_q"].shape == (64, 8 * 16)
    back = bridge.to_jax(params)
    flat_a, tree_a = jax.tree.flatten(jax_params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bridge_fp32_cast_keeps_layer_order(jax_params):
    params = bridge.from_jax(jax_params, dtype=torch.float32)
    for i in range(2):
        got = params["blocks"][i]["mlp"]["w_gate"]
        assert got.dtype == torch.float32
        want = np.asarray(jax_params["blocks"][0]["mlp"]["w_gate"][i], np.float32)
        np.testing.assert_array_equal(got.numpy(), want)


def test_embed_scale_is_a_bf16_scalar_as_in_jax(cfgs, jax_params):
    """bf16 embeddings are scaled by sqrt(d_model) rounded to bf16, bit for
    bit as ``lm.embed_tokens`` does."""
    jcfg, cfg = cfgs
    tokens = np.array([[3, 100, 259], [0, 1, 2]], np.int32)
    want = jlm.embed_tokens(jcfg, jax_params, jnp.asarray(tokens))
    got = lm.embed_tokens(cfg, bridge.from_jax(jax_params), torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_rope_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_geglu_and_qkv_proj_with_padded_heads_match(cfgs, jax_params):
    jcfg, cfg = cfgs
    jp = fp32_tree(jax.tree.map(lambda a: a[0], jax_params["blocks"][0]))
    tp = bridge.from_jax(jax_params, dtype=torch.float32)["blocks"][0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(layers.apply_mlp(cfg, tp["mlp"], xt).numpy(),
                               np.asarray(jlayers.apply_mlp(jcfg, jp["mlp"], jnp.asarray(x))),
                               **TOL)
    pos = np.arange(5, dtype=np.int32)[None, :]
    want = jlayers.qkv_proj(jcfg, jp["attn"], jnp.asarray(x), jnp.asarray(pos))
    got = layers.qkv_proj(cfg, tp["attn"], xt, torch.from_numpy(pos))
    assert got[0].shape == (2, 5, 8, 16) and got[1].shape == (2, 5, 1, 16)
    assert float(got[0][:, :, cfg.num_heads:].abs().max()) == 0.0  # padded heads
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_prefill_and_teacher_forced_decode_logits_match(cfgs, jax_params):
    jcfg, cfg = cfgs
    jp = fp32_tree(jax_params)
    model = get_model(cfg)
    tp = bridge.from_jax(jax_params, dtype=torch.float32)
    rng = np.random.default_rng(2)
    prompt = rng.integers(3, 259, (3, 7)).astype(np.int32)
    forced = rng.integers(3, 259, (3, 3)).astype(np.int32)
    smax = 7 + 3

    logits_j, caches_j, len_j = jlm.prefill(jcfg, jp, jnp.asarray(prompt), smax=smax)
    with torch.inference_mode():
        logits_t, caches_t, len_t = model.prefill(tp, torch.from_numpy(prompt), smax=smax)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert float(logits_t[:, cfg.vocab_size:].max()) < -1e29  # padded vocab masked

    for j in range(forced.shape[1]):
        logits_j, caches_j, len_j = jlm.decode_step(jcfg, jp, jnp.asarray(forced[:, j]),
                                                    caches_j, len_j)
        with torch.inference_mode():
            logits_t, caches_t, len_t = model.decode_step(
                tp, torch.from_numpy(forced[:, j]), caches_t, len_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    # the in-place cache holds what the JAX cache holds
    np.testing.assert_allclose(caches_t[1]["k"].numpy(),
                               np.asarray(caches_j[0]["k"][1]), **TOL)


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(reduced(get_config("mixtral-8x7b")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(reduced(get_config("mamba2-2.7b")))
