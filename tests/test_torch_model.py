"""The PyTorch port's model against the JAX package's on the CPU.

Both run ``reduced(gemma-2b, vocab_size=260, num_layers=2, pad_heads_to=8)``:
padded heads (4 real of 8) and a padded vocab (260 of 512). The JAX weights
are bridged into the port; the comparisons run in fp32 at 2e-5, with the
JAX package on its reference kernel path (its CPU default). The untied
archs (qwen2.5-7b and deepseek-67b: GQA, SwiGLU, an ``lm_head`` of its own)
are held the same way in reduced form, and the fused sampler on their
(d, Vp) head layout against the Pallas kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.sampling import fused_sample as fs_pallas
from repro.models import get_model as jax_get_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.rl.rollout import generate as jax_generate
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref, sampling
from repro_torch.models import get_model, layers, lm
from repro_torch.rl.rollout import generate

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

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
    params = bridge.from_jax(jax_params, device="cpu")
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
    params = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)
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
    got = lm.embed_tokens(cfg, bridge.from_jax(jax_params, device="cpu"),
                          torch.from_numpy(tokens))
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
    tp = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)["blocks"][0]
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
    model = get_model(cfg, device="cpu")
    tp = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)
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


def test_model_and_bridge_have_no_cpu_default(jax_params):
    """``get_model(cfg)`` means the card: without CUDA it raises instead of
    running on the CPU, and the bridge takes its device only by name."""
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(cfg)
    with pytest.raises(TypeError):
        bridge.from_jax(jax_params)
    assert get_model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kv_quant,dtype", [(False, "bf16"), (False, "fp32"), (True, "fp32")],
                         ids=["bf16_cache", "fp32_cache", "int8_cache"])
def test_decode_at_a_full_cache_writes_nothing_and_matches_jax(jax_params, kv_quant, dtype):
    """Prefill 8 tokens into a cache of 8, then one decode step: the row at
    ``cache_len == smax`` writes nothing (the JAX masked select matches no
    slot), attends the full cache plus nothing, and gives the JAX step's
    logits and ``cache_len``. bf16 weights are held at the bf16 tolerance,
    fp32 ones at 2e-5 (unquantized) or 2e-2 (int8, as test_torch_kv_quant)."""
    kw = dict(SMOKE, kv_quant=kv_quant)
    jcfg = jax_reduced(jax_get_config("gemma-2b"), **kw)
    cfg = reduced(get_config("gemma-2b"), **kw)
    if dtype == "fp32":
        jp, tp = fp32_tree(jax_params), bridge.from_jax(jax_params, device="cpu",
                                                        dtype=torch.float32)
    else:
        jp, tp = jax_params, bridge.from_jax(jax_params, device="cpu")
    tol = dict(atol=2e-2, rtol=2e-2) if (kv_quant or dtype == "bf16") else TOL
    rng = np.random.default_rng(21)
    prompt = rng.integers(3, 259, (3, 8)).astype(np.int32)
    token = rng.integers(3, 259, (3,)).astype(np.int32)
    model = get_model(cfg, device="cpu")
    _, caches_j, len_j = jlm.prefill(jcfg, jp, jnp.asarray(prompt), smax=8)
    with torch.inference_mode():
        _, caches_t, len_t = model.prefill(tp, torch.from_numpy(prompt), smax=8)
        before = [{n: leaf.clone() for n, leaf in c.items()} for c in caches_t]
        logits_t, caches_t, len_t = model.decode_step(tp, torch.from_numpy(token),
                                                      caches_t, len_t)
    logits_j, caches_j2, len_j = jlm.decode_step(jcfg, jp, jnp.asarray(token), caches_j, len_j)
    assert np.isfinite(logits_t.numpy()).all()
    np.testing.assert_allclose(logits_t.float().numpy(), np.asarray(logits_j, np.float32), **tol)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert (len_t == 9).all()
    for c, b in zip(caches_t, before):
        assert all(torch.equal(c[n], b[n]) for n in b)
    for name in caches_j[0]:  # the JAX step wrote nothing either
        np.testing.assert_array_equal(np.asarray(caches_j2[0][name]),
                                      np.asarray(caches_j[0][name]))


# --------------------------------------------------------------------------- #
# the untied archs: an lm_head of their own, stored (d, Vp) as in JAX
# --------------------------------------------------------------------------- #
UNTIED = ("qwen2.5-7b", "deepseek-67b")


@pytest.fixture(scope="module", params=UNTIED)
def untied(request):
    """(JAX config, port config, JAX fp32 params, port fp32 params) of a
    reduced untied arch (2 layers, vocab 260)."""
    kw = dict(vocab_size=260, num_layers=2)
    jcfg = jax_reduced(jax_get_config(request.param), **kw)
    cfg = reduced(get_config(request.param), **kw)
    assert not cfg.tie_embeddings and cfg.num_kv_heads < cfg.num_heads
    params = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(1)))
    tp = bridge.from_jax(params, device="cpu", dtype=torch.float32)
    assert tp["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)
    assert sampling.head_layout(lm._head_matrix(cfg, tp)) is True  # (d, Vp) as it lies
    return jcfg, cfg, fp32_tree(params), tp


def test_untied_prefill_decode_and_logprobs_match(untied):
    """Prefill, three teacher-forced decode steps and the training engine's
    logprobs and entropy, at 2e-5 in fp32."""
    jcfg, cfg, jp, tp = untied
    model = get_model(cfg, device="cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, 259, (3, 7)).astype(np.int32)
    forced = rng.integers(3, 259, (3, 3)).astype(np.int32)
    logits_j, caches_j, len_j = jlm.prefill(jcfg, jp, jnp.asarray(prompt), smax=10)
    with torch.inference_mode():
        logits_t, caches_t, len_t = model.prefill(tp, torch.from_numpy(prompt), smax=10)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    for j in range(forced.shape[1]):
        logits_j, caches_j, len_j = jlm.decode_step(jcfg, jp, jnp.asarray(forced[:, j]),
                                                    caches_j, len_j)
        with torch.inference_mode():
            logits_t, caches_t, len_t = model.decode_step(
                tp, torch.from_numpy(forced[:, j]), caches_t, len_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    tokens = np.concatenate([prompt, forced], axis=1)
    lp_j, ent_j = jlm.logprobs_fn(jcfg, jp, jnp.asarray(tokens))
    with torch.no_grad():
        lp_t, ent_t = model.logprobs(tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **TOL)
    np.testing.assert_allclose(ent_t.numpy(), np.asarray(ent_j), **TOL)


def test_untied_greedy_generate_matches_jax(untied):
    """Lockstep greedy generate through the fused sampler on the (d, Vp)
    head: tokens and masks equal, behaviour logprobs at 2e-5."""
    jcfg, cfg, jp, tp = untied
    prompt = np.random.default_rng(6).integers(3, 259, (4, 5)).astype(np.int32)
    want = jax_generate(jax_get_model(jcfg), jp, jnp.asarray(prompt), jax.random.PRNGKey(0),
                        max_new=6, temperature=0.0, eos_id=2, pad_id=0)
    got = generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(0), max_new=6, temperature=0.0, eos_id=2,
                   pad_id=0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob), **TOL)


@pytest.mark.parametrize("layout", ["cols", "rows"])
def test_fused_sample_on_both_head_layouts_matches_pallas(layout):
    """The sampler on an untied head (d, Vp) as it lies ("cols", vocab
    contiguous) and on the transpose of a contiguous (Vp, d) matrix
    ("rows", the tied ``embed.T``): ``sampling.head_layout`` tells them
    apart, and ``ref.fused_sample`` and the CUDA kernel's decomposition
    ``ref.fused_sample_partials`` (tiles of 128 rows, blocks of 3 tiles)
    give the Pallas kernel's tokens (interpret mode) bit for bit and its
    logprobs at 1e-5, greedy and sampled rows mixed, on reduced qwen2.5-7b's
    head width with a vocab ending mid-tile."""
    rng = np.random.default_rng(8)
    B, d, Vp, vocab = 6, 64, 512, 260
    h = rng.standard_normal((B, d)).astype(np.float32)
    w = rng.standard_normal((d, Vp)).astype(np.float32)
    seeds = rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32)
    inv_t = np.array([0.0, 1 / 0.7, 2.5, 0.0, 1.0, 1 / 0.7], np.float32)
    head = (torch.from_numpy(w) if layout == "cols"
            else torch.from_numpy(np.ascontiguousarray(w.T)).t())
    assert sampling.head_layout(head) is (layout == "cols")
    assert sampling.head_layout(torch.from_numpy(w)[:, ::2]) is None  # neither: the kernel raises
    args = (torch.from_numpy(h), head, torch.from_numpy(seeds), torch.from_numpy(inv_t))
    tok_p, lp_p = fs_pallas(*(jnp.asarray(a) for a in (h, w, seeds, inv_t)), vocab_size=vocab,
                            block_v=128, interpret=True)
    for tok, lp in (ref.fused_sample(*args, vocab_size=vocab),
                    ref.fused_sample_partials(*args, vocab_size=vocab, tile=128,
                                              tiles_per_block=3)):
        assert bool((tok < vocab).all())
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_p))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lp_p), atol=1e-5, rtol=1e-5)
