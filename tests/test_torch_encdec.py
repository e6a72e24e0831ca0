"""The PyTorch port's encoder-decoder (``models/encdec.py``, seamless-m4t)
against the JAX package's ``repro.models.encdec`` on the CPU.

Reduced seamless-m4t-medium: 2 encoder and 2 decoder layers, d_model 64,
layernorm, biases, the GELU MLP, a memory of 32 frames, vocab 260 padded to
512. JAX's weights are bridged into the port, every fp32 leaf (norm weights
and biases, linear biases) drawn at random first. fp32 at 2e-5 (grads at
1e-4 of each leaf's largest |grad|), bf16 at 2e-2; JAX runs its reference
kernel path, unrolled (``unroll=True``) on fp32 weights: its scan over the
encoder needs a carry of one dtype, and the bf16 frames meet fp32 weights
there. The refusals (no fused sampler, no paged decode, no chunked
prefill, no continuous engine, no ``generate``) are held to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import encdec as jencdec
from repro.models import get_model as jax_get_model
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.models import encdec, get_model
from repro_torch.rl import trainer
from repro_torch.rl.rollout import generate
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine
from torch_grads import assert_grads_match

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
SMOKE = dict(vocab_size=260, num_layers=2)
B, S_DEC = 2, 10


@pytest.fixture(scope="module")
def seamless():
    """(JAX cfg, port cfg, JAX numpy params, JAX fp32 params, port fp32
    params, frames as numpy)."""
    jcfg = jax_reduced(jax_get_config("seamless-m4t-medium"), **SMOKE)
    cfg = reduced(get_config("seamless-m4t-medium"), **SMOKE)
    assert cfg.is_encoder_decoder and cfg.use_bias and cfg.norm_type == "layernorm"
    assert cfg.num_encoder_layers == 2 and cfg.encoder_len == 32
    rng = np.random.default_rng(1)
    jp = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
                      if a.dtype == np.float32 else a,
                      jax.tree.map(np.asarray, jax.jit(lambda k: jencdec.init(jcfg, k))(
                          jax.random.PRNGKey(0))))
    jpf = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    frames = np.random.default_rng(2).standard_normal(
        (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, jpf, bridge.from_jax(jp, device="cpu", dtype=torch.float32), frames


def tokens_and_labels(seed=3):
    tokens = np.random.default_rng(seed).integers(3, 259, (B, S_DEC)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    return tokens, labels


def test_bridge_round_trips_bit_for_bit(seamless):
    """The encoder and decoder stacks, (L, ...) in JAX, are lists of layers
    here; the round trip is bit for bit, and the port's own init has JAX's
    layout."""
    _, cfg, jp, _, _, _ = seamless
    params = bridge.from_jax(jp, device="cpu")
    assert len(params["encoder"]) == 2 and len(params["decoder"]) == 2
    assert set(params["decoder"][0]) == {"norm1", "self_attn", "norm_x", "cross_attn",
                                         "norm2", "mlp"}
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(bridge.to_jax(params))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    mine = bridge.to_jax(get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    flat_c, tree_c = jax.tree.flatten(mine)
    assert tree_c == tree_a
    assert [(a.dtype, a.shape) for a in flat_a] == [(c.dtype, c.shape) for c in flat_c]


def test_encode_matches_jax(seamless):
    """The bidirectional encoder over bf16-cast frames, fp32 at 2e-5; a
    frame sees later frames (not causal)."""
    jcfg, cfg, _, jpf, tp, frames = seamless
    want = np.asarray(jencdec.encode(jcfg, jpf, jnp.asarray(frames), unroll=True))
    with torch.no_grad():
        got = encdec.encode(cfg, tp, torch.from_numpy(frames))
        later = frames.copy()
        later[:, -1] += 1.0
        moved = encdec.encode(cfg, tp, torch.from_numpy(later))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-5


def test_loss_logprobs_and_grads_match_jax(seamless):
    """``Model.loss`` (remat on, as the trainer takes it), its grads
    against ``jax.grad`` leaf by leaf (``torch_grads.assert_grads_match``),
    and ``Model.logprobs``."""
    jcfg, cfg, _, jpf, tp, frames = seamless
    tokens, labels = tokens_and_labels()
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jencdec.loss_fn(jcfg, p, jb, unroll=True), has_aux=True))(jpf)
    model = get_model(cfg, device="cpu")
    (lt, mt), gt = trainer.value_and_grad(lambda p: model.loss(p, tb), tp)
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL, err_msg=k)
    # the frames arrive in bf16, so the first encoder layer's norm1 output
    # is bf16 in both packages
    assert_grads_match(gt, gj, bf16_first_layer=("['encoder']['norm1']['w']",
                                                 "['encoder']['norm1']['b']"))
    # jencdec.logprobs_fn's body, unrolled
    memory = jencdec.encode(jcfg, jpf, jnp.asarray(frames), unroll=True)
    h = jencdec.decode_full(jcfg, jpf, jnp.asarray(tokens), memory, unroll=True)
    lpj, entj, _ = jlm.token_stats(jcfg, jpf, h[:, :-1], jnp.asarray(tokens[:, 1:]))
    with torch.no_grad():
        lpt, entt = model.logprobs(tp, torch.from_numpy(tokens),
                                   frames=torch.from_numpy(frames))
    assert not lpt[:, 0].any() and not entt[:, 0].any()
    np.testing.assert_allclose(lpt[:, 1:].numpy(), np.asarray(lpj), **TOL)
    np.testing.assert_allclose(entt[:, 1:].numpy(), np.asarray(entj), **TOL)


def test_prefill_decode_and_caches_match_jax(seamless):
    """``Model.prefill`` over a 6-token prompt into a cache of 10, then 4
    teacher-forced ``decode_step`` calls: fp32 logits at 2e-5 each, and
    every cache leaf (self-attention ``k``/``v``, memory ``mk``/``mv``)
    equal to JAX's at its layer."""
    jcfg, cfg, _, jpf, tp, frames = seamless
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, 259, (B, 6)).astype(np.int32)
    forced = rng.integers(3, 259, (B, 4)).astype(np.int32)
    smax = 10
    model = get_model(cfg, device="cpu")
    lj, cj, nj = jax.jit(lambda p, t, f: jencdec.prefill(jcfg, p, t, f, smax=smax, unroll=True))(
        jpf, jnp.asarray(prompt), jnp.asarray(frames))
    jdecode = jax.jit(lambda p, t, c, n: jencdec.decode_step(jcfg, p, t, c, n, unroll=True))
    with torch.inference_mode():
        lt, ct, nt = model.prefill(tp, torch.from_numpy(prompt), smax=smax,
                                   frames=torch.from_numpy(frames))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert float(lt[:, cfg.vocab_size:].max()) < -1e29  # the padded vocab masked
    for j in range(forced.shape[1]):
        lj, cj, nj = jdecode(jpf, jnp.asarray(forced[:, j]), cj, nj)
        with torch.inference_mode():
            lt, ct, nt = model.decode_step(tp, torch.from_numpy(forced[:, j]), ct, nt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert len(ct) == cfg.num_layers
    for i, c in enumerate(ct):
        assert sorted(c) == ["k", "mk", "mv", "v"]
        for leaf, t in c.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(cj[leaf][i]), **TOL)


def test_init_caches_and_a_bf16_step_match_jax(seamless):
    """``init_caches``: one dict a decoder layer, JAX's shapes and bf16; a
    bf16 prefill and decode step on bf16 weights at 2e-2 of the largest
    |logit|."""
    jcfg, cfg, jp, _, _, frames = seamless
    model = get_model(cfg, device="cpu")
    want = jencdec.init_caches(jcfg, 3, 12)
    got = model.init_caches(3, 12)
    for i, c in enumerate(got):
        for leaf, t in c.items():
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == want[leaf].shape[1:]
            assert not bool(t.any())
    tp = bridge.from_jax(jp, device="cpu")
    jpp = jax.tree.map(jnp.asarray, jp)
    prompt = np.random.default_rng(5).integers(3, 259, (B, 6)).astype(np.int32)
    jmodel = jax_get_model(jcfg)
    lj, cj, nj = jmodel.prefill(jpp, jnp.asarray(prompt), smax=8, frames=jnp.asarray(frames))
    lj, _, _ = jmodel.decode_step(jpp, jnp.argmax(lj, -1), cj, nj)
    with torch.inference_mode():
        lt, ct, nt = model.prefill(tp, torch.from_numpy(prompt), smax=8,
                                   frames=torch.from_numpy(frames))
        lt, _, _ = model.decode_step(tp, torch.argmax(lt, -1), ct, nt)
    want = np.asarray(lj)[:, :cfg.vocab_size]
    assert np.abs(lt.numpy()[:, :cfg.vocab_size] - want).max() <= 2e-2 * np.abs(want).max()


def _calls(model, params, frames):
    """Each refusal of the enc-dec facade, as a thunk."""
    tok = np.zeros((B,), np.int32)
    return {
        "decode_step_sample": lambda: model.decode_step_sample(params, tok, None, None, None,
                                                               0.0),
        "decode_step_paged": lambda: model.decode_step_paged(params, tok, None, None, None),
        "decode_step_paged_sample": lambda: model.decode_step_paged_sample(
            params, tok, None, None, None, None, None),
        "prefill_chunk": lambda: model.prefill_chunk(params, tok, None, offset=0),
    }


@pytest.mark.parametrize("call", ["decode_step_sample", "decode_step_paged",
                                  "decode_step_paged_sample", "prefill_chunk"])
def test_decoder_only_calls_raise_as_jax(seamless, call):
    """The decoder-only entry points raise JAX's ``NotImplementedError``
    with JAX's message."""
    jcfg, cfg, _, jpf, tp, frames = seamless
    with pytest.raises(NotImplementedError) as want:
        _calls(jax_get_model(jcfg), jpf, frames)[call]()
    with pytest.raises(NotImplementedError) as got:
        _calls(get_model(cfg, device="cpu"), tp, frames)[call]()
    assert str(got.value) == str(want.value)


def test_generate_and_the_engine_refuse_as_jax(seamless):
    """``generate`` raises JAX's "fused sampling is decoder-only" (JAX at
    its first decode step, the port before its prefill); the continuous
    engine refuses the model with a ValueError, as JAX's does."""
    jcfg, cfg, jp, _, tp, frames = seamless
    prompt = np.full((B, 4), 5, np.int32)
    from repro.rl.rollout import generate as jax_generate
    from repro.rl.rollout_engine import ContinuousRolloutEngine as JaxEngine

    with pytest.raises(NotImplementedError) as want:
        jax_generate(jax_get_model(jcfg), jax.tree.map(jnp.asarray, jp), jnp.asarray(prompt),
                     jax.random.PRNGKey(0),
                     max_new=4, frames=jnp.asarray(frames))
    with pytest.raises(NotImplementedError) as got:
        generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                 torch.Generator().manual_seed(0), max_new=4, frames=torch.from_numpy(frames))
    assert str(got.value) == str(want.value) == "fused sampling is decoder-only"
    with pytest.raises(ValueError):
        JaxEngine(jax_get_model(jcfg), max_new=4)
    with pytest.raises(ValueError, match="text decoder-only archs"):
        ContinuousRolloutEngine(get_model(cfg, device="cpu"), max_new=4)
