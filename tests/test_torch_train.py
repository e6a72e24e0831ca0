"""The port's training forward, its autograd Functions and AdamW against the
JAX package on the CPU.

The model is ``reduced(gemma-2b, vocab_size=260, num_layers=2,
pad_heads_to=8)``, as in ``tests/test_torch_model.py``: padded heads (4 real
of 8) and a padded vocab (260 of 512), JAX weights bridged into the port,
inputs from numpy seeds. The SSD family trains too: reduced mamba2 and a
reduced jamba without experts (as in ``tests/test_torch_ssm.py``), whose
scan goes through ``SSDFn`` under autograd. The JAX package runs on its reference kernel path
(its CPU default), so ``jax.grad`` differentiates the same plain versions
that the port's backward takes the VJP of. Tolerances:

- loss, logprobs, entropy in fp32: 2e-5 (the repository's fp32 tolerance);
- actor grads against ``jax.grad``: 1e-4 of each leaf's largest |grad| (fp32
  sums over the batch and vocab in another order);
- the autograd Functions against autograd of the plain version: 1e-6 in
  fp32 (the same operations, the backward recomputed); ``gradcheck`` in
  float64 at its own defaults;
- AdamW: fp32 moments at 1e-6 relative; bf16 params equal bit for bit
  (the same fp32 arithmetic before the one rounding to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import lm as jlm
from repro.models.api import Model as JaxModel
from repro.optim import adamw as jadamw
from repro.rl import trainer as jtrainer
from repro_torch import bridge, tree
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.rmsnorm import RMSNormFn
from repro_torch.kernels.ssd import SSDFn
from repro_torch.models import get_model, lm
from repro_torch.optim import adamw
from repro_torch.rl import trainer

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8)
SSM_FAMILIES = {
    "mamba2": ("mamba2-2.7b", dict(vocab_size=260, num_layers=2)),
    # attention at layers 1 and 5 of 8, SSD elsewhere, dense MLPs
    "jamba": ("jamba-v0.1-52b", dict(vocab_size=260, num_layers=8, num_experts=0)),
}


@pytest.fixture(scope="module")
def cfgs():
    jcfg = jax_reduced(jax_get_config("gemma-2b"), **SMOKE)
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    assert cfg.padded_heads == 8 > cfg.num_heads and cfg.padded_vocab == 512
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_params(cfgs):
    return jax.tree.map(np.asarray, jlm.init(cfgs[0], jax.random.PRNGKey(0)))


def fp32_tree(tree_):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree_)


@pytest.fixture(scope="module", params=sorted(SSM_FAMILIES))
def ssm_family(request):
    """(JAX config, port config, JAX fp32 weights, the same bridged into the
    port in fp32) of a reduced SSD-family model."""
    arch, kw = SSM_FAMILIES[request.param]
    jcfg, cfg = jax_reduced(jax_get_config(arch), **kw), reduced(get_config(arch), **kw)
    assert cfg.ssm_state and any(k[0] == "ssm" for k in cfg.layer_kinds())
    jp = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(1)))
    return jcfg, cfg, fp32_tree(jp), bridge.from_jax(jp, device="cpu", dtype=torch.float32)


def grpo_batch(rng, B=4, prompt=3, new=5, vocab=259):
    """A GRPO actor batch: tokens, a response mask with ragged lengths,
    behaviour and reference logprobs near a random policy's, and advantages
    from seeded per-sequence rewards (never all equal in a group)."""
    S = prompt + new
    tokens = rng.integers(3, vocab, (B, S)).astype(np.int32)
    lens = rng.integers(2, new + 1, B)
    lens[0] = new
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(lens):
        mask[b, prompt:prompt + n] = True
    old = (rng.standard_normal((B, S)) * 0.1 - 6.0).astype(np.float32) * mask
    ref_lp = (rng.standard_normal((B, S)) * 0.1 - 6.0).astype(np.float32) * mask
    rewards = rng.random(B).astype(np.float32)
    adv = ((rewards - rewards.mean()) / (rewards.std() + 1e-6))[:, None] * mask
    return {"tokens": tokens, "response_mask": mask, "old_logprob": old,
            "ref_logprob": ref_lp, "advantages": adv.astype(np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# the training forward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", [False, True])
def test_logprobs_and_loss_match_jax(cfgs, jax_params, remat):
    jcfg, cfg = cfgs
    jp = fp32_tree(jax_params)
    tp = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(10)
    tokens = rng.integers(3, 259, (3, 9)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :3] = jlm.IGNORE
    labels[1, -2:] = jlm.IGNORE
    lp_j, ent_j = jlm.logprobs_fn(jcfg, jp, jnp.asarray(tokens), remat=remat)
    with torch.no_grad():
        lp_t, ent_t = lm.logprobs_fn(cfg, tp, torch.from_numpy(tokens), remat=remat)
    assert lp_t.shape == (3, 9) and float(lp_t[:, 0].abs().max()) == 0.0
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **TOL)
    np.testing.assert_allclose(ent_t.numpy(), np.asarray(ent_j), **TOL)
    batch = {"tokens": tokens, "labels": labels}
    loss_j, m_j = jlm.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()},
                              remat=remat)
    loss_t, m_t = get_model(cfg, device="cpu").loss(tp, to_torch(batch), remat=remat)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(float(m_t["entropy"]), float(m_j["entropy"]), **TOL)


def test_token_stats_with_a_chunk_smaller_than_the_sequence(cfgs, jax_params):
    """Chunks of 3 over 7 positions (one padded chunk) with IGNORE labels,
    and the padded vocab at -1e30 in both."""
    jcfg, cfg = cfgs
    jp = fp32_tree(jax_params)
    tp = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, 260, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 6] = jlm.IGNORE
    want = jlm.token_stats(jcfg, jp, jnp.asarray(h), jnp.asarray(labels), chunk=3)
    got = lm.token_stats(cfg, tp, torch.from_numpy(h), torch.from_numpy(labels), chunk=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert not bool(got[2][0, 2]) and not bool(got[2][1, 6])


def test_ssm_logprobs_and_loss_match_jax(ssm_family):
    """``full`` mode through SSD layers (and jamba's attention layers)."""
    jcfg, cfg, jp, tp = ssm_family
    rng = np.random.default_rng(20)
    tokens = rng.integers(3, 259, (3, 9)).astype(np.int32)
    labels = tokens.copy()
    labels[:, :3] = jlm.IGNORE
    lp_j, ent_j = jlm.logprobs_fn(jcfg, jp, jnp.asarray(tokens))
    with torch.no_grad():
        lp_t, ent_t = lm.logprobs_fn(cfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **TOL)
    np.testing.assert_allclose(ent_t.numpy(), np.asarray(ent_j), **TOL)
    batch = {"tokens": tokens, "labels": labels}
    loss_j, _ = jlm.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, _ = get_model(cfg, device="cpu").loss(tp, to_torch(batch))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)


def test_ssm_full_mode_raises_off_the_chunk_as_jax_asserts():
    """A sequence past one chunk (128) that is not a multiple of it: the
    JAX plain scan asserts, the port raises ValueError; nothing is padded."""
    arch, kw = SSM_FAMILIES["mamba2"]
    jcfg, cfg = jax_reduced(jax_get_config(arch), **kw), reduced(get_config(arch), **kw)
    tokens = np.full((1, 130), 5, np.int32)
    with pytest.raises(AssertionError, match="not divisible"):
        jlm.logprobs_fn(jcfg, jlm.init(jcfg, jax.random.PRNGKey(0)), jnp.asarray(tokens))
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        lm.logprobs_fn(cfg, params, torch.from_numpy(tokens))
    lp, _ = lm.logprobs_fn(cfg, params, torch.from_numpy(tokens[:, :128]))  # one chunk
    assert lp.shape == (1, 128)


# --------------------------------------------------------------------------- #
# gradients
# --------------------------------------------------------------------------- #
def test_actor_grads_match_jax_grad(cfgs, jax_params):
    """GRPO ``actor_loss_fn`` grads against ``jax.grad`` per leaf, on fp32
    weights. The padded heads' ``w_o`` rows get a nonzero gradient in both:
    a zero query attends uniformly, so a padded head outputs the mean of V."""
    jcfg, cfg = cfgs
    jp = fp32_tree(jax_params)
    tp = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)
    batch = grpo_batch(np.random.default_rng(12))
    rl_j, rl_t = jtrainer.RLConfig(), trainer.RLConfig()
    (loss_j, _), g_j = jax.value_and_grad(
        lambda p: jtrainer.actor_loss_fn(JaxModel(jcfg), rl_j, p,
                                         {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    (loss_t, _), g_t = trainer.value_and_grad(
        lambda p: trainer.actor_loss_fn(get_model(cfg, device="cpu"), rl_t, p, to_torch(batch)),
        tp)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    assert_grads_match(g_t, g_j)
    pad = slice(cfg.num_heads * cfg.head_dim, None)
    for layer in range(cfg.num_layers):
        jw = np.asarray(g_j["blocks"][0]["attn"]["w_o"][layer])[pad]
        tw = g_t["blocks"][layer]["attn"]["w_o"][pad].numpy()
        assert np.abs(jw).max() > 0 and np.abs(tw).max() > 0
        np.testing.assert_allclose(tw, jw, atol=1e-4 * np.abs(jw).max(), rtol=0)


def assert_grads_match(g_t, g_j):
    """The port's grad tree (bridged to the JAX layout) against JAX's, each
    leaf at 1e-4 of its largest |grad|, every leaf nonzero."""
    flat_j, tree_j = jax.tree.flatten(g_j)
    flat_t, tree_t = jax.tree.flatten(bridge.to_jax(g_t))
    assert tree_j == tree_t
    for a, b in zip(flat_t, flat_j):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=0)


def test_ssm_actor_grads_match_jax_grad(ssm_family):
    """GRPO ``actor_loss_fn`` grads through the SSD mixers (the scan's
    ``SSDFn``, the convs, the gated norm, ``A = -exp(A_log)``) against
    ``jax.grad``, per leaf."""
    jcfg, cfg, jp, tp = ssm_family
    batch = grpo_batch(np.random.default_rng(21))
    rl_j, rl_t = jtrainer.RLConfig(), trainer.RLConfig()
    (loss_j, _), g_j = jax.value_and_grad(
        lambda p: jtrainer.actor_loss_fn(JaxModel(jcfg), rl_j, p,
                                         {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    (loss_t, _), g_t = trainer.value_and_grad(
        lambda p: trainer.actor_loss_fn(get_model(cfg, device="cpu"), rl_t, p, to_torch(batch)),
        tp)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    assert_grads_match(g_t, g_j)
    assert float(g_t["blocks"][0]["ssm"]["A_log"].abs().max()) > 0


def test_ssm_remat_gives_the_same_grads(ssm_family):
    _, cfg, _, tp = ssm_family
    tokens = torch.from_numpy(np.random.default_rng(22).integers(3, 259, (2, 6)).astype(np.int32))
    grads = []
    for remat in (False, True):
        _, g = trainer.value_and_grad(
            lambda p: (lm.logprobs_fn(cfg, p, tokens, remat=remat)[0].sum(), {}), tp)
        grads.append(tree.leaves(g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_remat_gives_the_same_grads(cfgs, jax_params):
    _, cfg = cfgs
    tp = bridge.from_jax(jax_params, device="cpu", dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(3, 259, (2, 6)).astype(np.int32))
    grads = []
    for remat in (False, True):
        _, g = trainer.value_and_grad(
            lambda p: (lm.logprobs_fn(cfg, p, tokens, remat=remat)[0].sum(), {}), tp)
        grads.append(tree.leaves(g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


FLASH_CASES = [
    dict(),  # causal MQA, the gemma training shape in miniature
    dict(causal=False),
    dict(window=3),
    dict(q_offset=2),
]


@pytest.mark.parametrize("case", ["rmsnorm", *[f"flash{i}" for i in range(len(FLASH_CASES))]])
def test_autograd_function_grads_equal_plain_autograd(case):
    """The Functions' backward (the plain VJP recomputed from saved inputs)
    against autograd straight through the plain version; on the CPU the
    forward is the plain version itself."""
    rng = np.random.default_rng(14)
    if case == "rmsnorm":
        x, w = _rand(rng, 5, 16).requires_grad_(), (_rand(rng, 16) * 0.1).requires_grad_()
        out_fn, out_plain = RMSNormFn.apply(x, w, 1e-6), ref.rmsnorm(x, w)
        ins = (x, w)
    else:
        kw = FLASH_CASES[int(case[5:])]
        Sk = 7 + kw.get("q_offset", 0)
        q = _rand(rng, 2, 7, 4, 8).requires_grad_()
        k, v = _rand(rng, 2, Sk, 2, 8).requires_grad_(), _rand(rng, 2, Sk, 2, 8).requires_grad_()
        full = {"causal": True, "window": None, "q_offset": 0, **kw}
        out_fn = FlashAttentionFn.apply(q, k, v, full["causal"], full["window"], None,
                                        full["q_offset"])
        out_plain = ref.flash_attention(q, k, v, **kw)
        ins = (q, k, v)
    assert out_fn.grad_fn is not None and "Fn" in type(out_fn.grad_fn).__name__
    cot = _rand(rng, *out_fn.shape)
    g_fn = torch.autograd.grad(out_fn, ins, cot)
    g_plain = torch.autograd.grad(out_plain, ins, cot)
    torch.testing.assert_close(out_fn, out_plain, atol=0, rtol=0)
    for a, b in zip(g_fn, g_plain):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def ssd_case(rng, s, nh, g, dtype=torch.float32, n=4, p=8):
    """Inputs of one SSD call that all require grad: x, dt > 0, A < 0, Bm,
    Cm, D."""
    def r(*shape):
        return _rand(rng, *shape, dtype=dtype)

    return (r(2, s, nh, p).requires_grad_(),
            torch.nn.functional.softplus(r(2, s, nh)).detach().requires_grad_(),
            (-torch.exp(r(nh))).detach().requires_grad_(),
            r(2, s, g, n).requires_grad_(), r(2, s, g, n).requires_grad_(),
            r(nh).requires_grad_())


SSD_CASES = {"one_chunk": (8, 2, 1, 8), "three_chunks": (12, 2, 1, 4),
             "grouped_heads": (12, 4, 2, 4)}  # (S, NH, G, chunk)


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_function_grads_equal_plain_autograd(case):
    """``SSDFn``'s backward (the plain VJP at the same chunk) against
    autograd straight through ``ref.ssd_chunked``, with cotangents on y and
    on the final state, and on y alone (training's case)."""
    s, nh, g, chunk = SSD_CASES[case]
    ins = ssd_case(np.random.default_rng(23), s, nh, g)
    y_fn, h_fn = SSDFn.apply(*ins, chunk)
    y_plain, h_plain = ref.ssd_chunked(*ins, chunk=chunk, return_state=True)
    assert type(y_fn.grad_fn).__name__ == "SSDFnBackward"
    torch.testing.assert_close(y_fn, y_plain, atol=0, rtol=0)
    torch.testing.assert_close(h_fn, h_plain, atol=0, rtol=0)
    rng = np.random.default_rng(24)
    gy, gh = _rand(rng, *y_fn.shape), _rand(rng, *h_fn.shape)
    for outs_fn, outs_plain, cots in (((y_fn, h_fn), (y_plain, h_plain), (gy, gh)),
                                      ((y_fn,), (y_plain,), (gy,))):
        g_fn = torch.autograd.grad(outs_fn, ins, cots, retain_graph=True)
        g_plain = torch.autograd.grad(outs_plain, ins, cots, retain_graph=True)
        for a, b in zip(g_fn, g_plain):
            assert float(b.abs().max()) > 0
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["rmsnorm", "flash_attention", "ssd"])
def test_autograd_functions_pass_gradcheck_in_float64(which):
    rng = np.random.default_rng(15)
    if which == "rmsnorm":
        args = (_rand(rng, 3, 6, dtype=torch.float64).requires_grad_(),
                (_rand(rng, 6, dtype=torch.float64) * 0.1).requires_grad_(), 1e-6)
        fn = RMSNormFn.apply
    elif which == "flash_attention":
        args = (_rand(rng, 1, 4, 2, 4, dtype=torch.float64).requires_grad_(),
                _rand(rng, 1, 4, 1, 4, dtype=torch.float64).requires_grad_(),
                _rand(rng, 1, 4, 1, 4, dtype=torch.float64).requires_grad_(),
                True, None, None, 0)
        fn = FlashAttentionFn.apply
    else:  # two chunks of 3 in two groups: the carried state and the group map
        args = (*ssd_case(rng, 6, 2, 2, dtype=torch.float64, n=2, p=2), 3)
        fn = SSDFn.apply
    assert torch.autograd.gradcheck(fn, args)


def test_ops_take_the_functions_only_when_a_gradient_is_wanted():
    rng = np.random.default_rng(16)
    x, w = _rand(rng, 4, 8), _rand(rng, 8)
    assert ops.rmsnorm(x, w).grad_fn is None
    xg = x.clone().requires_grad_()
    assert type(ops.rmsnorm(xg, w).grad_fn).__name__ == "RMSNormFnBackward"
    with torch.no_grad():
        assert ops.rmsnorm(xg, w).grad_fn is None
    q = _rand(rng, 1, 3, 2, 4).requires_grad_()
    kv = _rand(rng, 1, 3, 1, 4)
    assert type(ops.flash_attention(q, kv, kv).grad_fn).__name__ == "FlashAttentionFnBackward"
    ops.set_mode("ref")
    try:  # ref mode: autograd straight through the plain versions
        assert "Fn" not in type(ops.rmsnorm(xg, w).grad_fn).__name__
    finally:
        ops.set_mode(None)


def test_ops_ssd_takes_its_function_only_when_a_gradient_is_wanted():
    ins = ssd_case(np.random.default_rng(25), 8, 2, 1)
    plain = [t.detach() for t in ins]
    assert ops.ssd(*plain).grad_fn is None
    y, h = ops.ssd(*ins, chunk=4, return_state=True)
    assert type(y.grad_fn).__name__ == type(h.grad_fn).__name__ == "SSDFnBackward"
    with torch.no_grad():
        assert ops.ssd(*ins).grad_fn is None
    with torch.inference_mode():
        assert ops.ssd(*ins).grad_fn is None
    # one input that requires grad is enough: A alone (A_log's path)
    assert type(ops.ssd(*plain[:2], ins[2], *plain[3:]).grad_fn).__name__ == "SSDFnBackward"
    ops.set_mode("ref")
    try:  # ref mode: autograd straight through the plain version
        assert "SSDFn" not in type(ops.ssd(*ins).grad_fn).__name__
    finally:
        ops.set_mode(None)


def test_a_kernel_without_backward_refuses_an_input_that_requires_grad():
    """The check every CUDA wrapper without a backward makes before its
    launch (decode, paged, int8 decode, sampler; ``ssd`` for its direct
    callers, ``ops.ssd`` takes ``SSDFn`` instead)."""
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        _build.require_no_grad("decode_attention", torch.zeros(3), t)
    with torch.no_grad():
        _build.require_no_grad("decode_attention", t)
    _build.require_no_grad("decode_attention", t.detach())


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def test_adamw_three_steps_with_decay_clip_and_schedule_match_jax():
    rng = np.random.default_rng(17)
    shapes = {"a": (4, 6), "b": [(5,), (3, 2)]}
    params_np = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
                 "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]]}
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params_np)
    tp = tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params_np)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        g_np = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3).astype(np.float32),
                            params_np)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g_np)
        tg = tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), g_np)
        jg, jn = jadamw.clip_by_global_norm(jg, 1.0)
        tg, tn = adamw.clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tree.leaves(tg), jax.tree.leaves(jg)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        lr_j = jadamw.cosine_schedule(js.step, base_lr=1e-2, warmup=1, total=4)
        lr_t = adamw.cosine_schedule(ts.step, base_lr=1e-2, warmup=1, total=4)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-7)
        jp, js = jadamw.update(jg, js, jp, lr=lr_j + 1e-3, weight_decay=0.1)
        tp, ts = adamw.update(tg, ts, tp, lr=lr_t + 1e-3, weight_decay=0.1)
        assert int(ts.step) == int(js.step) == step + 1
        for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        for a, b in zip(tree.leaves(ts.m) + tree.leaves(ts.v),
                        jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)


def test_tree_map_clones_a_train_state_that_steps_like_the_original():
    """``tree.map`` rebuilds NamedTuples (``TrainState``, ``AdamWState``), so
    cloning a state before an in-place AdamW step keeps a second start."""
    rng = np.random.default_rng(19)
    params = {"a": torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(5).astype(np.float32))]}
    params = tree.map(lambda a: a.to(torch.bfloat16), params)
    start = tree.map(torch.clone, params)
    state = trainer.init_state(params)
    copy = tree.map(torch.clone, state)
    assert type(copy) is trainer.TrainState and type(copy.opt) is adamw.AdamWState
    assert all(a is not b and a.data_ptr() != b.data_ptr()
               for a, b in zip(tree.leaves(copy), tree.leaves(state)))
    grads = tree.map(lambda a: torch.full_like(a, 0.5), params)
    apply = trainer.make_actor_apply_fn(trainer.RLConfig(lr=1e-2, weight_decay=0.1))
    (after, _), (after_copy, _) = apply(state, grads), apply(copy, grads)
    for a, b in zip(tree.leaves(after), tree.leaves(after_copy)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(after.params["a"], start["a"])
    assert int(after.opt.step) == int(after_copy.opt.step) == 1


def test_value_and_grad_marks_the_end_of_the_forward_once():
    """``on_loss`` runs once, after the forward and before the backward."""
    events = []

    def f(p):
        y = p["w"] * p["w"]
        y.register_hook(lambda g: events.append("backward"))
        events.append("forward")
        return y.sum(), {}

    w = torch.arange(3.0)
    (loss, _), g = trainer.value_and_grad(f, {"w": w}, on_loss=lambda: events.append("mark"))
    assert events == ["forward", "mark", "backward"]
    torch.testing.assert_close(g["w"], 2 * w)
    assert float(loss) == 5.0


@pytest.mark.parametrize("step", [0, 3, 10, 57, 100, 250])
def test_cosine_schedule_matches_jax(step):
    kw = dict(base_lr=3e-4, warmup=10, total=200)
    np.testing.assert_allclose(float(adamw.cosine_schedule(step, **kw)),
                               float(jadamw.cosine_schedule(jnp.asarray(step), **kw)),
                               rtol=1e-6)
