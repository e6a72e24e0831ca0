"""The port's MoE family and sliding-window rings against the JAX package on
the CPU.

The MoE layer (``repro_torch.models.moe``): both dispatches against JAX's on
the same numpy inputs, in fp32 at 2e-5 and in bf16 at 2e-2, with the aux
loss; a zero router, where every expert ties (the port breaks ties to the
lower expert, as ``jax.lax.top_k``); the gradients of ``torch.autograd``
against ``jax.grad`` in fp32 at 2e-5.

The dense dispatch rounds its output to bf16 in both packages (JAX's
``preferred_element_type``), so "fp32" is not fp32 there: two fp32 sums of
another order that straddle a bf16 rounding boundary round one bf16 step
(2^-8 of the value) apart, and later layers carry that step. The layer
tests hold the rounded output within one step of JAX's and bit-equal in
all but 1% of the elements; every fp32 comparison at 2e-5 runs with the
rounding off in both packages (the ``unrounded`` fixture: the port's
``moe.OUT_DTYPE`` None, JAX's einsum without ``preferred_element_type``).
The bf16 comparisons keep it, and are held as ``chip_smoke.py`` holds the
card: the logits within 2e-2 of their largest magnitude.

The models, on the JAX package's initial weights bridged into the port:
reduced granite-moe-3b (8 experts top-4, padded heads), reduced mixtral-8x7b
(a window of 16) and reduced jamba (its period-8 pattern of attention, SSD,
dense and MoE layers). ``full`` (logprobs and the loss with its
``moe_aux``), ``prefill`` and teacher-forced ``decode`` in fp32 at 2e-5;
bf16 weights and the int8 cache at 2e-2; mixtral's prompts shorter and
longer than its window, decoded across the ring's wrap; greedy tokens equal
to JAX's. The window matters (the same weights without it differ past
position 16), the ring decode equals windowed full attention, the cache is
bounded at the window, and the continuous engine equals lockstep on
reduced mixtral under a fixed schedule, bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.rl.rollout import generate as jax_generate
from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve, train
from repro_torch.models import get_model, lm, moe
from repro_torch.rl.rollout import generate
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
WINDOW = 16
ARCHS = {
    "granite": ("granite-moe-3b-a800m", dict(vocab_size=260, num_layers=2, pad_heads_to=8,
                                             num_experts=8, num_experts_per_tok=4)),
    "mixtral": ("mixtral-8x7b", dict(vocab_size=260, num_layers=2)),
    "jamba": ("jamba-v0.1-52b", dict(vocab_size=260, num_layers=8, attn_layer_period=8,
                                     attn_layer_offset=4)),
}


def configs(name, **kw):
    arch, over = ARCHS[name]
    over = {**over, **kw}
    return jax_reduced(jax_get_config(arch), **over), reduced(get_config(arch), **over)


def jax_init(jcfg, seed):
    """JAX's ``lm.init`` (jitted: the same draws) as numpy."""
    return jax.tree.map(np.asarray,
                        jax.jit(functools.partial(jlm.init, jcfg))(jax.random.PRNGKey(seed)))


def fp32_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else jnp.asarray(a), tree)


def as_np(t):
    return t.detach().float().numpy()


class _UnroundedJnp:
    """``jax.numpy`` whose einsum drops ``preferred_element_type``."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(*args, preferred_element_type=None, **kw):
        return jnp.einsum(*args, **kw)


@pytest.fixture
def unrounded(monkeypatch):
    """The dense dispatch's output in the products' dtype, in both
    packages."""
    monkeypatch.setattr(jmoe, "jnp", _UnroundedJnp())
    monkeypatch.setattr(moe, "OUT_DTYPE", None)


def assert_one_bf16_step(got, want):
    """bf16 ``got`` within one bf16 step of ``want`` (at most 2^-7 of the
    value) and bit-equal in all but 1% of the elements."""
    g, w = as_np(got), np.asarray(want, np.float32)
    step = np.abs(w) * 2.0**-7
    assert np.all(np.abs(g - w) <= step), float(np.max(np.abs(g - w) / step))
    assert np.mean(g != w) <= 0.01, float(np.mean(g != w))


def assert_bf16_logits(got, want):
    """The card's bf16 agreement (``chip_smoke.py``): the real vocab's
    logits within 2e-2 of their largest magnitude."""
    g, w = as_np(got)[:, :256], np.asarray(want, np.float32)[:, :256]
    assert float(np.max(np.abs(g - w))) <= 2e-2 * float(np.max(np.abs(w)))


# --------------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------------- #
LAYER = dict(d_model=32, d_ff=16, num_experts=8, num_experts_per_tok=3)


@pytest.fixture(scope="module")
def layer():
    """(JAX config, port config, JAX layer params as numpy)."""
    jcfg, cfg = configs("granite", **LAYER)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jp


def layer_inputs(jp, dtype, seed=1, shape=(2, 8, 32)):
    """(JAX params, JAX x, port params, port x) in ``dtype`` ("fp32" or
    "bf16"; the router stays f32, as it is stored)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jparams = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt) for k, v in jp.items()}
    tparams = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else tdt) for k, v in jp.items()}
    return jparams, jnp.asarray(x, jdt), tparams, torch.from_numpy(x).to(tdt)


def test_init_moe_has_the_jax_layout(layer):
    jcfg, cfg, jp = layer
    got = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(jp) == ["router", "w_gate", "w_in", "w_out"]
    for k, v in got.items():
        assert tuple(v.shape) == jp[k].shape and str(v.dtype).split(".")[-1] == str(jp[k].dtype)
    assert got["router"].dtype == torch.float32 and got["w_in"].shape == (8, 32, 16)


def _dispatch(name):
    return ((jmoe.apply_moe, moe.apply_moe) if name == "dense"
            else (jmoe.apply_moe_topk_sparse, moe.apply_moe_topk_sparse))


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_layer_matches_jax(layer, dispatch, dtype):
    """Each dispatch against the same JAX dispatch: bf16 at 2e-2, fp32 at
    2e-5 (the dense dispatch's bf16 output within one bf16 step); the aux
    loss at 2e-5 in both (fp32 router logits)."""
    jcfg, cfg, jp = layer
    jparams, jx, tparams, tx = layer_inputs(jp, dtype)
    jfn, tfn = _dispatch(dispatch)
    yj, aj = jfn(jcfg, jparams, jx)
    yt, at = tfn(cfg, tparams, tx)
    assert str(yt.dtype).split(".")[-1] == str(yj.dtype)
    if dtype == "bf16":
        np.testing.assert_allclose(as_np(yt), np.asarray(yj, np.float32), **BF16_TOL)
    elif dispatch == "dense":
        assert yt.dtype == torch.bfloat16
        assert_one_bf16_step(yt, yj)
    else:
        np.testing.assert_allclose(as_np(yt), np.asarray(yj, np.float32), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def test_dense_dispatch_unrounded_matches_jax_at_fp32(layer, unrounded):
    """The dense dispatch's fp32 sums, before the bf16 rounding, at 2e-5."""
    jcfg, cfg, jp = layer
    jparams, jx, tparams, tx = layer_inputs(jp, "fp32")
    yj, _ = jmoe.apply_moe(jcfg, jparams, jx)
    yt, _ = moe.apply_moe(cfg, tparams, tx)
    assert yt.dtype == torch.float32 and str(yj.dtype) == "float32"
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_and_sparse_dispatch_agree(layer, dtype):
    """The twin of the JAX ``test_moe_dense_equals_sparse_dispatch``."""
    _, cfg, jp = layer
    _, _, tparams, tx = layer_inputs(jp, dtype, seed=3)
    y1, a1 = moe.apply_moe(cfg, tparams, tx)
    y2, a2 = moe.apply_moe_topk_sparse(cfg, tparams, tx)
    np.testing.assert_allclose(as_np(y1), as_np(y2), **BF16_TOL)
    assert float(a1) == pytest.approx(float(a2), abs=1e-5)


@pytest.mark.parametrize("e,k", [(4, 1), (8, 3), (40, 8)])
def test_zero_router_ties_to_the_lower_expert(e, k):
    """An all-zero router ties every expert: the port routes each token to
    experts 0..k-1 with gates 1/k, as ``jax.lax.top_k`` does, and its
    output and aux equal JAX's."""
    jcfg, cfg = configs("granite", d_model=32, d_ff=16, num_experts=e, num_experts_per_tok=k)
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jcfg, jax.random.PRNGKey(2)))
    jp["router"] = np.zeros_like(jp["router"])
    jparams, jx, tparams, tx = layer_inputs(jp, "fp32", seed=4, shape=(1, 64, 32))
    _, gates, idx = moe.route(cfg, tparams["router"], tx.reshape(64, 32))
    assert torch.equal(idx, torch.arange(k).expand(64, k))
    assert torch.allclose(gates, torch.full((64, k), 1.0 / k))
    for name in ("dense", "sparse"):
        jfn, tfn = _dispatch(name)
        yj, aj = jfn(jcfg, jparams, jx)
        yt, at = tfn(cfg, tparams, tx)
        if name == "dense":
            assert_one_bf16_step(yt, yj)
        else:
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        assert float(at) == pytest.approx(float(aj), rel=2e-5)
    assert float(at) == pytest.approx(k, abs=1e-5)  # E * sum_e (1/E) * density_e


def test_moe_layer_grads_match_jax(layer, unrounded):
    """``torch.autograd`` through the dense dispatch against ``jax.grad``,
    fp32, for sum(out * w) + aux: the grads of x, the router and the three
    expert stacks at 2e-5 (the router's through the gates and the aux)."""
    jcfg, cfg, jp = layer
    jparams, jx, tparams, tx = layer_inputs(jp, "fp32", seed=5)
    w = np.random.default_rng(6).standard_normal((2, 8, 32)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.apply_moe(jcfg, p, x)
        return jnp.sum(y.astype(jnp.float32) * w) + aux

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jparams, jx)
    tparams = {k: v.requires_grad_() for k, v in tparams.items()}
    tx.requires_grad_()
    y, aux = moe.apply_moe(cfg, tparams, tx)
    (torch.sum(y.float() * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    for k, v in tparams.items():
        assert float(v.grad.abs().max()) > 0, k
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(gp[k]), **TOL, err_msg=k)


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def load(name):
    """(name, JAX config, port config, JAX params as numpy, fp32 JAX params,
    the port's fp32 params bridged from them)."""
    jcfg, cfg = configs(name)
    jp = jax_init(jcfg, 0)
    return (name, jcfg, cfg, jp, fp32_tree(jp),
            bridge.from_jax(jp, device="cpu", dtype=torch.float32))


@pytest.fixture(params=sorted(ARCHS))
def family(request):
    return load(request.param)


# (arch, prompt length, decode steps): mixtral's short prompt wraps its ring
# of 16 at step 8, its long one fills the ring from its last 16 tokens
DECODE_CASES = {"granite": ("granite", 8, 4), "jamba": ("jamba", 8, 4),
                "mixtral_short": ("mixtral", 8, 12), "mixtral_long": ("mixtral", 24, 12)}


def test_bridge_round_trips_bit_for_bit(family):
    """The ``moe`` leaves cross both ways: the router in f32, the stacks
    split per layer in bf16; jamba's period-8 pattern stacks back into its
    8 positions."""
    name, jcfg, cfg, jp, _, _ = family
    params = bridge.from_jax(jp, device="cpu")
    kinds = cfg.layer_kinds()
    for block, kind in zip(params["blocks"], kinds):
        assert ("moe" in block) == (kind[1] == "moe") and ("mlp" in block) == (kind[1] == "dense")
    m = next(b["moe"] for b in params["blocks"] if "moe" in b)
    assert m["router"].dtype == torch.float32 and m["w_out"].dtype == torch.bfloat16
    assert m["w_in"].shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
    back = bridge.to_jax(params)
    assert len(back["blocks"]) == lm.pattern_length(cfg) == jlm.pattern_length(jcfg)
    if name == "jamba":
        assert lm.pattern_length(cfg) == 8 and {k[1] for k in kinds} == {"dense", "moe"}
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_init_has_the_jax_layout(family):
    _, _, cfg, jp, _, _ = family
    params = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    flat_a, tree_a = jax.tree.flatten(jp)
    flat_b, tree_b = jax.tree.flatten(bridge.to_jax(params))
    assert tree_a == tree_b
    assert [(a.dtype, a.shape) for a in flat_a] == [(b.dtype, b.shape) for b in flat_b]


def test_loss_and_logprobs_match_jax(family, unrounded):
    """``full`` mode: ``loss_fn`` (its ce, entropy and ``moe_aux``, the loss
    with 0.01 x aux) and ``logprobs_fn``, fp32 at 2e-5."""
    _, jcfg, cfg, _, jpf, tp = family
    rng = np.random.default_rng(7)
    tokens = rng.integers(3, 259, (2, 24)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)], axis=1)
    lj, mj = jlm.loss_fn(jcfg, jpf, {"tokens": jnp.asarray(tokens),
                                     "labels": jnp.asarray(labels)})
    model = get_model(cfg, device="cpu")
    with torch.no_grad():
        lt, mt = model.loss(tp, {"tokens": torch.from_numpy(tokens),
                                 "labels": torch.from_numpy(labels)})
        lpt, entt = model.logprobs(tp, torch.from_numpy(tokens))
    assert sorted(mt) == sorted(mj) == ["ce", "entropy", "moe_aux"]
    assert float(mt["moe_aux"]) > 0
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    np.testing.assert_allclose(float(lt), float(mt["ce"] + 0.01 * mt["moe_aux"]), **TOL)
    lpj, entj = jlm.logprobs_fn(jcfg, jpf, jnp.asarray(tokens))
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), **TOL)
    np.testing.assert_allclose(entt.numpy(), np.asarray(entj), **TOL)


def fp32_check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prefill_decode(jcfg, cfg, jparams, tparams, prompt, forced, check):
    """Prefill both packages on ``prompt`` into a cache of prompt +
    len(forced), then teacher-force ``forced``: ``check(port logits, JAX
    logits)`` after every step. Returns both packages' caches."""
    smax = prompt.shape[1] + forced.shape[1]
    model = get_model(cfg, device="cpu")
    jprefill = jax.jit(lambda p, t: jlm.prefill(jcfg, p, t, smax=smax))
    jdecode = jax.jit(lambda p, t, c, n: jlm.decode_step(jcfg, p, t, c, n))
    logits_j, caches_j, len_j = jprefill(jparams, jnp.asarray(prompt))
    with torch.inference_mode():
        logits_t, caches_t, len_t = model.prefill(tparams, torch.from_numpy(prompt), smax=smax)
    check(logits_t, logits_j)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    for j in range(forced.shape[1]):
        logits_j, caches_j, len_j = jdecode(jparams, jnp.asarray(forced[:, j]), caches_j,
                                            len_j)
        with torch.inference_mode():
            logits_t, caches_t, len_t = model.decode_step(
                tparams, torch.from_numpy(forced[:, j]), caches_t, len_t)
        check(logits_t, logits_j)
    return caches_t, caches_j


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_prefill_and_decode_match_jax(case, unrounded):
    """fp32 at 2e-5, through the cases of ``DECODE_CASES``; the caches equal
    JAX's."""
    arch, prompt_len, steps = DECODE_CASES[case]
    name, jcfg, cfg, _, jpf, tp = load(arch)
    rng = np.random.default_rng(8)
    prompt = rng.integers(3, 259, (2, prompt_len)).astype(np.int32)
    forced = rng.integers(3, 259, (2, steps)).astype(np.int32)
    caches_t, caches_j = _prefill_decode(jcfg, cfg, jpf, tp, prompt, forced, fp32_check)
    P = lm.pattern_length(cfg)
    for i, c in enumerate(caches_t):
        for leaf, t in c.items():
            np.testing.assert_allclose(as_np(t), np.asarray(caches_j[i % P][leaf][i // P],
                                                            np.float32), **TOL)
    if name == "mixtral":
        assert caches_t[0]["k"].shape[1] == WINDOW


@pytest.mark.parametrize("prompt_len", [8, 24], ids=["short", "long"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_rings_in_bf16_and_int8_match_jax(cache, prompt_len):
    """Reduced mixtral on bf16 weights with its bf16 ring, and on fp32
    weights with the int8 ring (``kv_quant``), across the wrap, with the
    dispatch's bf16 rounding: the logits within 2e-2 of their largest
    magnitude (the int8 cache: a decoded row's scale moves by an ulp when
    its K/V sum in another order).

    On bf16 weights the router is zero, so every token takes experts 0 and
    1 in both packages: a top-k over router logits that carry bf16 noise
    picks another expert wherever the k-th and (k+1)-th logits lie that
    close, a step of the whole layer's output (on this prompt a logit 17%
    of the largest off). The fp32 tests hold the routing itself."""
    jcfg, cfg = configs("mixtral", kv_quant=cache == "int8")
    jp = jax_init(jcfg, 1)
    if cache == "bf16":
        for block in jp["blocks"]:
            block["moe"]["router"] = np.zeros_like(block["moe"]["router"])
        jparams, tparams = jax.tree.map(jnp.asarray, jp), bridge.from_jax(jp, device="cpu")
    else:
        jparams, tparams = fp32_tree(jp), bridge.from_jax(jp, device="cpu",
                                                          dtype=torch.float32)
    rng = np.random.default_rng(9)
    prompt = rng.integers(3, 259, (2, prompt_len)).astype(np.int32)
    forced = rng.integers(3, 259, (2, 10)).astype(np.int32)
    caches_t, _ = _prefill_decode(jcfg, cfg, jparams, tparams, prompt, forced,
                                  assert_bf16_logits)
    assert caches_t[0]["k"].shape[1] == WINDOW
    assert caches_t[0]["k"].dtype == (torch.int8 if cache == "int8" else torch.bfloat16)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_greedy_generate_matches_jax(case, unrounded):
    """Greedy tokens, masks and logprobs of ``generate`` on fp32 weights
    equal JAX's, across mixtral's wrap."""
    arch, prompt_len, steps = DECODE_CASES[case]
    _, jcfg, cfg, _, jpf, tp = load(arch)
    prompt = np.random.default_rng(10).integers(3, 259, (3, prompt_len)).astype(np.int32)
    want = jax_generate(jax_get_model(jcfg), jpf, jnp.asarray(prompt), jax.random.PRNGKey(0),
                        max_new=steps, temperature=0.0)
    got = generate(get_model(cfg, device="cpu"), tp, torch.from_numpy(prompt),
                   torch.Generator().manual_seed(0), max_new=steps, temperature=0.0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob), **TOL)


@pytest.fixture(scope="module")
def mixtral():
    """(port config, its fp32 params, its bf16 params) on JAX's weights."""
    jcfg, cfg = configs("mixtral")
    jp = jax_init(jcfg, 3)
    return (cfg, bridge.from_jax(jp, device="cpu", dtype=torch.float32),
            bridge.from_jax(jp, device="cpu"))


def test_the_window_matters(mixtral, unrounded):
    """The same weights decoded without the window: logits equal up to
    position 15 and different from position 16 on."""
    cfg, tp, _ = mixtral
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(3, 259, (2, 4)).astype(np.int32))
    forced = torch.from_numpy(rng.integers(3, 259, (2, 20)).astype(np.int32))
    runs = []
    for c in (cfg, dataclasses.replace(cfg, sliding_window=None)):
        model = get_model(c, device="cpu")
        with torch.inference_mode():
            _, caches, n = model.prefill(tp, prompt, smax=24)
            steps = []
            for j in range(forced.shape[1]):
                logits, caches, n = model.decode_step(tp, forced[:, j], caches, n)
                steps.append(logits)
        runs.append(steps)
    for j, (a, b) in enumerate(zip(*runs)):
        pos = 4 + j  # the query's position
        if pos < WINDOW:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        else:
            assert float((a - b).abs().max()) > 1e-3, f"position {pos}"


@pytest.mark.parametrize("prompt_len", [8, 24], ids=["short", "long"])
def test_ring_decode_equals_windowed_full_attention(mixtral, prompt_len, unrounded):
    """The sampler's logprobs, from the ring across its wrap, equal
    ``logprobs_fn`` over the whole sequence (windowed full attention) at
    2e-5 on fp32 weights."""
    cfg, tp, _ = mixtral
    model = get_model(cfg, device="cpu")
    prompt = np.random.default_rng(12).integers(3, 259, (2, prompt_len)).astype(np.int32)
    res = generate(model, tp, torch.from_numpy(prompt), torch.Generator().manual_seed(1),
                   max_new=14, temperature=1.0)
    with torch.inference_mode():
        lp, _ = model.logprobs(tp, res.tokens)
    assert res.tokens.shape[1] == prompt_len + 14 > WINDOW
    np.testing.assert_allclose(lp[:, prompt_len:].numpy(),
                               res.old_logprob[:, prompt_len:].numpy(), **TOL)


def test_ring_cache_width():
    """The twin of ``test_ring_cache_width``: mixtral's cache is bounded at
    its window of 4,096, deepseek-67b's keeps smax."""
    caches = lm.init_caches(get_config("mixtral-8x7b"), 1, 524_288, device="meta")
    assert caches[0]["k"].shape == (1, 4096, 8, 128) and len(caches) == 32
    caches2 = lm.init_caches(get_config("deepseek-67b"), 1, 8192, device="meta")
    assert caches2[0]["k"].shape[1] == 8192
    assert lm.ring_width(get_config("mixtral-8x7b"), 100) == 100


def test_ring_write_wraps_and_a_full_cache_drops():
    """A ring writes slot ``cache_len % W`` and attends min(cache_len + 1,
    W) slots without a window; a cache that is not a ring writes nothing at
    ``cache_len >= W`` and attends under the window."""
    cfg = reduced(get_config("mixtral-8x7b"))
    lens = torch.tensor([3, 16, 37], dtype=torch.int32)
    _, slot, inside, kv_len, window = lm._write_slot(cfg, lens, WINDOW)
    assert slot.tolist() == [3, 0, 5] and inside is None and window is None
    assert kv_len.tolist() == [4, 16, 16]
    _, slot, inside, kv_len, window = lm._write_slot(cfg, lens, 40)  # wider than the window
    assert slot.tolist() == [3, 16, 37] and inside.tolist() == [True] * 3 and window == WINDOW
    full = dataclasses.replace(cfg, sliding_window=None)
    _, slot, inside, kv_len, window = lm._write_slot(full, lens, WINDOW)
    assert slot.tolist() == [3, 15, 15] and inside.tolist() == [True, False, False]
    assert kv_len.tolist() == [4, 17, 38] and window is None


def test_paged_decode_refuses_a_window(mixtral):
    cfg, tp, _ = mixtral
    model = get_model(cfg, device="cpu")
    pool = model.init_caches(5, 4)
    with pytest.raises(ValueError, match="sliding-window"):
        model.decode_step_paged(tp, torch.zeros(1, dtype=torch.int32), pool,
                                torch.zeros(1, dtype=torch.int32),
                                torch.zeros((1, 2), dtype=torch.int32))


@pytest.mark.parametrize("temperature", [2.0, 0.0], ids=["sampled", "greedy"])
def test_engine_equals_lockstep_on_mixtral(mixtral, temperature):
    """The continuous engine with a slot a prompt and one bucket is lockstep
    ``generate`` bit for bit on reduced mixtral's bf16 weights, across the
    ring's wrap (prompt 12, 10 new, window 16)."""
    cfg, _, params = mixtral
    model = get_model(cfg, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(13).integers(4, 200, (4, 12))
                              .astype(np.int32))
    want = generate(model, params, prompt, torch.Generator().manual_seed(6), max_new=10,
                    temperature=temperature, pad_id=0)
    eng = ContinuousRolloutEngine(model, max_new=10, temperature=temperature, pad_id=0,
                                  num_slots=4)
    got = eng(params, prompt, torch.Generator().manual_seed(6))
    for field in ("tokens", "response_mask", "lengths", "old_logprob"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert eng.last_stats["refills"] == 1 and eng.prefill_chunk == 0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_entry_points_run_moe_archs_on_cpu(arch, capsys):
    """``serve --lockstep`` and GRPO through ``launch.train`` take the MoE
    archs with ``--smoke``, as ``--arch mamba2-2.7b``."""
    stats = serve.main(["--arch", arch, "--smoke", "--lockstep", "--device", "cpu",
                        "--batch", "2", "--max-new", "4", "--requests", "1",
                        "--prompt-len", "9"])
    assert stats["results"][0].tokens.shape == (2, 13) and stats["tokens"] > 0
    assert "tok/s on cpu" in capsys.readouterr().out
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--iters", "1",
                      "--prompts-per-iter", "1", "--group-size", "2", "--max-new-tokens", "4"])
    m = out["history"][-1]
    assert out["experiment"].model.num_experts > 0
    assert all(np.isfinite(v) for v in m.values())
