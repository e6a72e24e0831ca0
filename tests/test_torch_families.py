"""The PyTorch port's remaining decoder families against the JAX package on
the CPU: layernorm, biased attention and MLP, squared ReLU, the plain GELU
MLP, parallel blocks, prefix embeddings ahead of the tokens, and nucleus
(``top_p``) sampling.

Each family is a reduced config (2 layers, d_model 64, vocab 260 padded to
512) built in both packages from the same fields; JAX's weights are bridged
into the port. Every fp32 leaf of the JAX init (norm weights and biases,
the linear biases, all zeros there) is replaced by random values first, so
that a bias or a norm shift the port dropped would show. Comparisons run in
fp32 at 2e-5 (grads at 1e-4 of each leaf's largest |grad|, as
``tests/test_torch_train.py``), bf16 at 2e-2; JAX runs its reference kernel
path (its CPU default).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.models import get_model as jax_get_model
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.rl.rollout import generate as jax_generate
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import get_model, layers
from repro_torch.rl import trainer
from repro_torch.rl.rollout import generate, sample_token
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine
from torch_arena import fp32_arena
from torch_grads import assert_grads_match

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
SMOKE = dict(vocab_size=260, num_layers=2)
FAMILIES = {
    # layernorm, squared ReLU, GQA, an untied head
    "nemotron": ("nemotron-4-15b", {}),
    # parallel blocks (one shared norm, no norm2), layernorm, SwiGLU
    "command_r": ("command-r-plus-104b", {}),
    # biased attention and MLP, layernorm, the plain GELU MLP, on a tied head
    "biased_gelu": ("gemma-2b", dict(use_bias=True, norm_type="layernorm", mlp_type="gelu")),
    # prefix embeddings ahead of the tokens (8 in reduced form)
    "llava": ("llava-next-34b", {}),
}
PREFIX = 8


def configs(name):
    arch, over = FAMILIES[name]
    j, t = jax_reduced(jax_get_config(arch), **SMOKE), reduced(get_config(arch), **SMOKE)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def randomized(params, seed):
    """JAX params (numpy) with every fp32 leaf drawn at random."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
                        if a.dtype == np.float32 else a, params)


def fp32_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else jnp.asarray(a), tree)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, JAX cfg, port cfg, JAX numpy params, JAX fp32 params, port
    fp32 params)."""
    jcfg, cfg = configs(request.param)
    jp = randomized(jax.tree.map(np.asarray, jax.jit(lambda k: jlm.init(jcfg, k))(
        jax.random.PRNGKey(0))), 1)
    return (request.param, jcfg, cfg, jp, fp32_tree(jp),
            bridge.from_jax(jp, device="cpu", dtype=torch.float32))


def prefix_of(cfg, B, seed=3):
    """Prefix embeddings (B, P, d) for a prefix config, else None."""
    if cfg.num_prefix_embeds <= 1:
        return None
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, cfg.num_prefix_embeds, cfg.d_model))).astype(
        np.float32)


def lm_batch(cfg, B=2, S=12, seed=7):
    """tokens and labels (IGNORE over the prefix and at the end) as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 259, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    pre = prefix_of(cfg, B)
    if pre is not None:
        batch["prefix_embeds"] = pre
        batch["labels"] = np.concatenate([np.full((B, pre.shape[1]), -1, np.int32), labels], 1)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_config_reaches_its_family(family):
    name, _, cfg, jp, _, tp = family
    block = tp["blocks"][0]
    assert ("b" in block["norm1"]) == (cfg.norm_type == "layernorm")
    assert ("norm2" in block) == (not cfg.parallel_block)
    assert ("b_q" in block["attn"] and "b_in" in block["mlp"]) == cfg.use_bias
    assert {"nemotron": cfg.mlp_type == "relu2", "command_r": cfg.parallel_block,
            "biased_gelu": cfg.mlp_type == "gelu" and cfg.use_bias,
            "llava": cfg.num_prefix_embeds == PREFIX}[name]


def test_bridge_round_trips_bit_for_bit(family):
    _, _, cfg, jp, _, _ = family
    params = bridge.from_jax(jp, device="cpu")
    back = bridge.to_jax(params)
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port's own init has the JAX layout, biases and norm shifts included
    mine = bridge.to_jax(get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    flat_c, tree_c = jax.tree.flatten(mine)
    assert tree_c == tree_a
    assert [(a.dtype, a.shape) for a in flat_a] == [(c.dtype, c.shape) for c in flat_c]


def test_loss_and_logprobs_match_jax(family):
    """``loss_fn`` (with the prefix's labels ignored) and ``logprobs_fn``
    (scoring the tokens after the prefix), fp32 at 2e-5."""
    _, jcfg, cfg, _, jpf, tp = family
    batch = lm_batch(cfg)
    lj, mj = jlm.loss_fn(jcfg, jpf, to_jax(batch))
    model = get_model(cfg, device="cpu")
    with torch.no_grad():
        lt, mt = model.loss(tp, to_torch(batch))
        pre = batch.get("prefix_embeds")
        lpt, entt = model.logprobs(tp, torch.from_numpy(batch["tokens"]),
                                   prefix_embeds=None if pre is None else torch.from_numpy(pre))
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL, err_msg=k)
    lpj, entj = jlm.logprobs_fn(jcfg, jpf, jnp.asarray(batch["tokens"]),
                                prefix_embeds=None if pre is None else jnp.asarray(pre))
    assert lpt.shape == batch["tokens"].shape
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), **TOL)
    np.testing.assert_allclose(entt.numpy(), np.asarray(entj), **TOL)


def test_grads_match_jax_grad(family):
    """``jax.grad`` of the loss against the port's autograd, every leaf
    (norm shifts and biases included) at 1e-4 of its largest |grad|
    (``torch_grads.assert_grads_match``)."""
    _, jcfg, cfg, _, jpf, tp = family
    batch = lm_batch(cfg, seed=9)
    (lj, _), gj = jax.jit(jax.value_and_grad(lambda p: jlm.loss_fn(jcfg, p, to_jax(batch)),
                                             has_aux=True))(jpf)
    model = get_model(cfg, device="cpu")
    (lt, _), gt = trainer.value_and_grad(lambda p: model.loss(p, to_torch(batch)), tp)
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    assert_grads_match(gt, gj)


def test_prefill_and_decode_match_jax(family):
    """Prefill (after the prefix, where there is one) and 4 teacher-forced
    decode steps, fp32 logits at 2e-5 and the caches equal JAX's."""
    _, jcfg, cfg, _, jpf, tp = family
    rng = np.random.default_rng(8)
    prompt = rng.integers(3, 259, (2, 6)).astype(np.int32)
    forced = rng.integers(3, 259, (2, 4)).astype(np.int32)
    pre = prefix_of(cfg, 2)
    P = 0 if pre is None else pre.shape[1]
    smax = P + prompt.shape[1] + forced.shape[1]
    model = get_model(cfg, device="cpu")
    kj = {} if pre is None else {"prefix_embeds": jnp.asarray(pre)}
    kt = {} if pre is None else {"prefix_embeds": torch.from_numpy(pre)}
    lj, cj, nj = jlm.prefill(jcfg, jpf, jnp.asarray(prompt), smax=smax, **kj)
    with torch.inference_mode():
        lt, ct, nt = model.prefill(tp, torch.from_numpy(prompt), smax=smax, **kt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt[0]) == P + prompt.shape[1]
    for j in range(forced.shape[1]):
        lj, cj, nj = jlm.decode_step(jcfg, jpf, jnp.asarray(forced[:, j]), cj, nj)
        with torch.inference_mode():
            lt, ct, nt = model.decode_step(tp, torch.from_numpy(forced[:, j]), ct, nt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for i, c in enumerate(ct):
        for leaf, t in c.items():
            np.testing.assert_allclose(t.float().numpy(), np.asarray(cj[0][leaf][i]), **TOL)


def test_bf16_logits_match_jax(family):
    """On the bf16 weights themselves (the card's dtype): the prefill
    logits at 2e-2 of their largest |logit|. A parallel block's residual
    sums run in JAX's order, ``(h + mix) + mlp``."""
    _, jcfg, cfg, jp, _, _ = family
    tp = bridge.from_jax(jp, device="cpu")
    prompt = np.random.default_rng(4).integers(3, 259, (2, 10)).astype(np.int32)
    pre = prefix_of(cfg, 2)
    kj = {} if pre is None else {"prefix_embeds": jnp.asarray(pre, jnp.bfloat16)}
    kt = {} if pre is None else {"prefix_embeds": torch.from_numpy(pre).bfloat16()}
    lj, _, _ = jlm.prefill(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(prompt),
                           smax=32, **kj)
    with torch.inference_mode():
        lt, _, _ = get_model(cfg, device="cpu").prefill(tp, torch.from_numpy(prompt),
                                                          smax=32, **kt)
    want = np.asarray(lj)[:, :cfg.vocab_size]
    got = lt.numpy()[:, :cfg.vocab_size]
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# --------------------------------------------------------------------------- #
# the layers one at a time
# --------------------------------------------------------------------------- #
LAYER_CASES = {
    "layernorm": dict(norm_type="layernorm"),
    "biased_gelu": dict(use_bias=True, mlp_type="gelu"),
    "relu2": dict(mlp_type="relu2"),
    "biased_swiglu": dict(use_bias=True, mlp_type="swiglu"),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layers_match_jax(case, dtype):
    """``apply_norm``, ``qkv_proj`` + ``out_proj``, ``apply_mlp``,
    ``memory_kv`` and ``cross_attention`` on one random layer: fp32 at 2e-5,
    bf16 at 2e-2 of the largest |output|."""
    over = dict(LAYER_CASES[case], norm_type=LAYER_CASES[case].get("norm_type", "layernorm"))
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("gemma-2b"), **SMOKE), **over)
    cfg = dataclasses.replace(reduced(get_config("gemma-2b"), **SMOKE), **over)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    jp = randomized(jax.tree.map(np.asarray, {
        "norm": jlayers.init_norm(jcfg), "attn": jlayers.init_attention(jcfg, keys[0]),
        "mlp": jlayers.init_mlp(jcfg, keys[1])}), 2)
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    td = torch.float32 if dtype == "fp32" else torch.bfloat16
    jpp = jax.tree.map(lambda a: jnp.asarray(a, jd) if a.dtype != np.float32 else jnp.asarray(a),
                       jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        td if a.dtype != np.float32 else torch.float32), jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    mj, mt = jnp.asarray(mem, jd), torch.from_numpy(mem).to(td)
    pos = np.arange(5)[None, :]

    def check(got, want):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()

    with torch.no_grad():
        check(layers.apply_norm(cfg, tp["norm"], xt),
              jlayers.apply_norm(jcfg, jpp["norm"], xj))
        check(layers.apply_mlp(cfg, tp["mlp"], xt), jlayers.apply_mlp(jcfg, jpp["mlp"], xj))
        check(layers.self_attention(cfg, tp["attn"], xt, torch.from_numpy(pos)),
              jlayers.self_attention(jcfg, jpp["attn"], xj, jnp.asarray(pos)))
        check(layers.self_attention(cfg, tp["attn"], xt, torch.from_numpy(pos), causal=False),
              jlayers.self_attention(jcfg, jpp["attn"], xj, jnp.asarray(pos), causal=False))
        kv_t = layers.memory_kv(cfg, tp["attn"], mt)
        kv_j = jlayers.memory_kv(jcfg, jpp["attn"], mj)
        for a, b in zip(kv_t, kv_j):
            check(a, b)
        check(layers.cross_attention(cfg, tp["attn"], xt, kv_t),
              jlayers.cross_attention(jcfg, jpp["attn"], xj, kv_j))


# --------------------------------------------------------------------------- #
# nucleus sampling
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("top_p", [1e-6, 0.3, 0.9, 0.999])
def test_top_p_filter_keeps_jax_keep_set(top_p):
    """The same kept positions as JAX's ``top_p_filter``, on rows with tied
    logits (a stable sort keeps equal logits in index order in both) and on
    a row whose top logits are all equal."""
    rng = np.random.default_rng(int(top_p * 1e6))
    logits = np.round(rng.standard_normal((6, 300)) * 2, 1).astype(np.float32)  # many ties
    logits[1] = 0.0
    logits[2, :5] = 9.0
    logits[3, 200:] = -1e30  # a masked tail, as the padded vocab
    want = np.asarray(jref.top_p_filter(jnp.asarray(logits), top_p))
    got = ref.top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got > -1e29, want > -1e29)
    np.testing.assert_array_equal(got, want)
    assert (got > -1e29).sum(axis=1).min() >= 1  # the top token always survives
    assert ref.top_p_filter(torch.from_numpy(logits), 1.0) is not None


def test_top_p_draws_lie_in_the_nucleus_with_untempered_logprobs():
    """The plain sampler with ``top_p < 1`` (the route ``ops.fused_sample``
    takes on every device): every draw inside its row's nucleus of the
    tempered logits, the logprob that of the untempered, unfiltered
    distribution, greedy rows the argmax; and at ``top_p = 1`` bit for bit
    the unfiltered sampler."""
    gen = torch.Generator().manual_seed(0)
    B, d, V, vocab = 64, 32, 300, 290
    h = torch.randn((B, d), generator=gen)
    w = torch.randn((d, V), generator=gen) * 0.5
    seeds = torch.randint(-2**31, 2**31, (B,), generator=gen, dtype=torch.int64).to(torch.int32)
    inv_t = torch.full((B,), 1 / 0.8)
    inv_t[:4] = 0.0  # greedy rows
    tok, lp = ops.fused_sample(h, w, seeds, inv_t, vocab_size=vocab, top_p=0.7)
    z = h @ w
    z[:, vocab:] = -1e30
    keep = ref.top_p_filter(z * inv_t[:, None], 0.7)[4:] > -1e29
    assert bool(keep.gather(1, tok[4:, None].long()).all())
    assert bool((tok[:4] == z[:4].argmax(dim=-1)).all())
    np.testing.assert_allclose(lp.numpy(), torch.log_softmax(z, -1).gather(
        1, tok[:, None].long())[:, 0].numpy(), **TOL)
    assert int((keep.sum(1) < vocab).sum()) == B - 4  # the filter binds on every row
    for a, b in zip(ops.fused_sample(h, w, seeds, inv_t, vocab_size=vocab, top_p=1.0),
                    ref.fused_sample(h, w, seeds, inv_t, vocab_size=vocab)):
        assert torch.equal(a, b)
    # sample_token (a prefill's first token) applies the same filter
    t0 = sample_token(z, seeds, 0.8, 0.7)
    assert bool(keep.gather(1, t0[4:, None].long()).all())


# a row seed whose hash at position 7 has 24 one bits: u rounds to 1.0 in
# fp32 and the Gumbel noise there is +inf (JAX's Pallas kernel draws alike)
SATURATED_SEED, SATURATED_POS = -1385840568, 7


def test_a_saturated_gumbel_draw_stays_outside_the_nucleus():
    """Where the hash uniform rounds to 1.0 the noise is +inf, and that
    position wins an unfiltered draw whatever its logit (the reference's
    sampler, kept for parity). With ``top_p < 1`` the nucleus mask is
    applied after the noise, so a position outside the nucleus is never
    drawn, by ``ops.fused_sample``'s plain route nor by ``sample_token``."""
    seeds = torch.tensor([SATURATED_SEED], dtype=torch.int32)
    u = ref.uniform_01(seeds[:, None], torch.tensor([[SATURATED_POS]]))
    assert float(u) == 1.0
    z = torch.linspace(4.0, -4.0, 64)[None, :]  # position 7 far from the top
    w = torch.eye(64)
    inv_t = torch.ones(1)
    tok, _ = ops.fused_sample(z, w, seeds, inv_t)
    assert int(tok) == SATURATED_POS  # the unfiltered draw, as the reference's
    assert not bool(ref.nucleus(z, 0.2)[0, SATURATED_POS])
    tok, lp = ops.fused_sample(z, w, seeds, inv_t, top_p=0.2)
    assert bool(ref.nucleus(z, 0.2)[0, int(tok)])
    np.testing.assert_allclose(float(lp), float(torch.log_softmax(z, -1)[0, int(tok)]), **TOL)
    assert int(sample_token(z, seeds, 1.0)) == SATURATED_POS
    assert bool(ref.nucleus(z, 0.2)[0, int(sample_token(z, seeds, 1.0, 0.2))])


@pytest.fixture(scope="module")
def nemotron():
    return next(_load("nemotron"))


def _load(name):
    jcfg, cfg = configs(name)
    jp = randomized(jax.tree.map(np.asarray, jax.jit(lambda k: jlm.init(jcfg, k))(
        jax.random.PRNGKey(0))), 1)
    yield jcfg, cfg, fp32_tree(jp), bridge.from_jax(jp, device="cpu", dtype=torch.float32)


def test_tiny_top_p_streams_equal_jax_greedy(nemotron):
    """At ``top_p = 1e-6`` only each row's top token survives the filter,
    so sampled streams (temperature 0.8) equal JAX's greedy stream bit for
    bit; the logprobs stay the untempered ones, JAX's greedy logprobs."""
    jcfg, cfg, jpf, tp = nemotron
    prompt = np.random.default_rng(2).integers(3, 259, (3, 6)).astype(np.int32)
    want = jax_generate(jax_get_model(jcfg), jpf, jnp.asarray(prompt), jax.random.PRNGKey(0),
                        max_new=8, temperature=0.0)
    got = generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(3), max_new=8, temperature=0.8, top_p=1e-6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob), **TOL)


def test_engine_with_top_p_equals_lockstep(nemotron):
    """The continuous engine with ``top_p`` at refill and at every decode
    step: under a fixed schedule (a slot a prompt, one bucket) it draws
    lockstep's seeds on the same shapes, so its tokens, masks and logprobs
    are lockstep ``generate``'s bit for bit (an fp32 arena holds the fp32
    weights' caches, as ``tests/torch_arena.py`` explains); at ``top_p =
    1e-6`` they are JAX's greedy tokens."""
    jcfg, cfg, jpf, tp = nemotron
    model = get_model(cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(3, 259, (4, 6)).astype(np.int32))
    for top_p in (0.6, 1e-6):
        want = generate(model, tp, prompt, torch.Generator().manual_seed(9), max_new=6,
                        temperature=0.9, top_p=top_p)
        eng = ContinuousRolloutEngine(fp32_arena(model), max_new=6, temperature=0.9,
                                      top_p=top_p, num_slots=4)
        got = eng(tp, prompt, torch.Generator().manual_seed(9))
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b)
    greedy = jax_generate(jax_get_model(jcfg), jpf, jnp.asarray(prompt.numpy()),
                          jax.random.PRNGKey(0), max_new=6, temperature=0.0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(greedy.tokens))


# --------------------------------------------------------------------------- #
# prefix embeddings through generate: the reference's cache fault
# --------------------------------------------------------------------------- #
def test_prefix_generate_keeps_every_position_where_jax_loses_them():
    """Reduced llava, P = 8 prefix embeddings, a 6-token prompt and 12
    greedy tokens. JAX's ``generate`` sizes its cache ``Lp + max_new`` = 18
    while the prefix and prompt already take 14 positions, so its decode
    writes past slot 17 are lost and its tokens leave JAX's own step-by-step
    greedy (a full forward a step). The port's ``generate``
    sizes the cache ``P + Lp + max_new`` and equals that step-by-step
    greedy token for token."""
    jcfg, cfg, jpf, tp = next(_load("llava"))
    B, Lp, T = 2, 6, 12
    prompt = np.random.default_rng(11).integers(3, 259, (B, Lp)).astype(np.int32)
    pre = prefix_of(cfg, B, seed=12)

    @jax.jit
    def logits_at(seq, pos):  # JAX's full forward over prefix + seq, at pos
        h = jlm.assemble_input(jcfg, jpf, seq, jnp.asarray(pre))
        h, _, _ = jlm.backbone(jcfg, jpf, h, jnp.arange(h.shape[1])[None, :], mode="full")
        return jlm.mask_padded_vocab(jcfg, h[:, pos] @ jlm._head_matrix(jcfg, jpf))

    # JAX's step-by-step greedy: one full forward a token; the zero tail past
    # the current length is causally invisible to the position read
    stepwise = np.concatenate([prompt, np.zeros((B, T), np.int32)], axis=1)
    for t in range(T):
        nxt = jnp.argmax(logits_at(jnp.asarray(stepwise), PREFIX + Lp + t - 1), -1)
        stepwise[:, Lp + t] = np.asarray(nxt)
    jax_res = jax_generate(jax_get_model(jcfg), jpf, jnp.asarray(prompt), jax.random.PRNGKey(0),
                           max_new=T, temperature=0.0, prefix_embeds=jnp.asarray(pre))
    assert not np.array_equal(np.asarray(jax_res.tokens), stepwise)  # the fault
    got = generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(0), max_new=T, temperature=0.0,
                   prefix_embeds=torch.from_numpy(pre))
    np.testing.assert_array_equal(got.tokens.numpy(), stepwise)
    # the logprobs the sampler returned are the model's own scores of them
    lp, _ = get_model(cfg, device="cpu").logprobs(tp, got.tokens,
                                                  prefix_embeds=torch.from_numpy(pre))
    np.testing.assert_allclose(got.old_logprob[:, Lp:].numpy(), lp[:, Lp:].detach().numpy(),
                               atol=1e-4, rtol=1e-4)
