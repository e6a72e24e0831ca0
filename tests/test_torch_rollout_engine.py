"""The port's continuous rollout engine (``repro_torch.rl.rollout_engine``)
against the port's lockstep ``generate`` and the JAX package's
``ContinuousRolloutEngine`` on the CPU, mirroring
``tests/test_rollout_engine.py``.

The model is reduced qwen2.5-7b (untied head, GQA, SwiGLU; 2 layers, vocab
260) on the JAX package's initial weights bridged as fp32, with the EOS
column of the head scaled by ``EOS_SCALE`` in both packages so that early
EOS happens by construction (each test that needs it asserts it).

Tolerances: under a fixed slot schedule the engine equals lockstep
``generate`` bit for bit (tokens, masks, lengths and logprobs, sampled and
greedy) on the bf16 weights the card runs. The engine's cache arena is bf16
(``init_caches``, as in JAX), so on fp32 weights it would hold lockstep's
fp32 prefill caches rounded. The fp32 tests therefore give both packages'
engines an fp32 arena (``tests/torch_arena.py``): the JAX engine cannot run fp32
weights on its bf16 arena at all, since its decode writes turn the
``while_loop`` carry's caches fp32. Against the JAX engine, greedy tokens, masks, lengths and the slot
schedule's counts are equal, and the behaviour logprobs agree within 2e-5
(fp32). Sampled parity with JAX holds in distribution only (hash seeds
against threefry keys), so the sampled tests compare with the port's
lockstep path or check invariants.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import get_model as jax_get_model
from repro.rl import rollout_engine as jengine
from repro_torch import bridge, tree
from repro_torch.configs import get_config, reduced
from repro_torch.models import get_model
from repro_torch.rl.rollout import generate
from repro_torch.rl.rollout_engine import (
    ContinuousRolloutEngine,
    PromptQueue,
    lockstep_waste,
)
from torch_arena import fp32_arena, jax_fp32_arena

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

ARCH = "qwen2.5-7b"
SMOKE = dict(vocab_size=260, num_layers=2)
EOS_ID, EOS_SCALE = 3, 4.0
TOL = 2e-5


@pytest.fixture(scope="module")
def qwen():
    """(JAX model, JAX fp32 params, port model, port fp32 params, port bf16
    params), the EOS column of the untied head scaled in all."""
    jmodel = jax_get_model(jax_reduced(jax_get_config(ARCH), **SMOKE))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jmodel.init(jax.random.PRNGKey(0)))
    assert "lm_head" in params  # the untied head, (d, Vp)
    params["lm_head"][:, EOS_ID] *= EOS_SCALE
    model = get_model(reduced(get_config(ARCH), **SMOKE), device="cpu")
    tparams = bridge.from_jax(params, device="cpu", dtype=torch.float32)
    assert not model.cfg.tie_embeddings and not tparams["lm_head"].t().is_contiguous()
    bf16 = bridge.from_jax(params, device="cpu", dtype=torch.bfloat16)
    return jmodel, jax.tree.map(jnp.asarray, params), model, tparams, bf16


def _prompts(B, Lp, seed=1, ragged=False):
    """(B, Lp) int32 prompts of tokens 4..199 from numpy; ``ragged`` right-pads
    each row to a true length drawn from 2..Lp."""
    rng = np.random.default_rng(seed)
    out = rng.integers(4, 200, (B, Lp)).astype(np.int32)
    if ragged:
        for i in range(B):
            out[i, int(rng.integers(2, Lp + 1)):] = 0
    return out


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _assert_same(got, want, *, lp_tol=None):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.response_mask.numpy(), np.asarray(want.response_mask))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    if lp_tol is None:
        np.testing.assert_array_equal(got.old_logprob.numpy(), np.asarray(want.old_logprob))
    else:
        np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob),
                                   atol=lp_tol, rtol=lp_tol)


# --------------------------------------------------------------------------- #
# the seed contract: a fixed schedule is lockstep generate, bit for bit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("temperature", [2.0, 0.0], ids=["sampled", "greedy"])
def test_fixed_schedule_equals_lockstep_bit_for_bit(qwen, temperature):
    """num_slots >= B and one bucket: the engine consumes lockstep's seed
    stream (one row_seeds(gen, B) for the prefill sample, one per decode
    step) on the same shapes, so tokens, masks, lengths and logprobs are
    lockstep's bits; and it runs only as many decode steps as the slowest
    row needs."""
    _, _, model, _, params = qwen
    B, Lp, T = 8, 6, 12
    prompt = torch.from_numpy(_prompts(B, Lp))
    want = generate(model, params, prompt, _gen(6), max_new=T, temperature=temperature,
                    eos_id=EOS_ID, pad_id=0)
    lens = want.lengths.numpy()
    assert lens.min() < T, "want some early EOS"
    eng = ContinuousRolloutEngine(model, max_new=T, temperature=temperature, eos_id=EOS_ID,
                                  pad_id=0, num_slots=B + 3)
    got = eng(params, prompt, _gen(6))
    _assert_same(got, want)
    s = eng.last_stats
    assert s["decode_steps"] == lens.max() - 1 and s["refills"] == 1 and s["num_slots"] == B
    assert s["tokens"] == float(lens.sum())


def test_budgets_equal_lockstep(qwen):
    """Per-sequence response budgets: lockstep and the engine cap alike,
    token for token, under the fixed schedule (sampled, no EOS id)."""
    _, _, model, _, params = qwen
    B, Lp, T = 8, 6, 10
    prompt = torch.from_numpy(_prompts(B, Lp, seed=4))
    budgets = torch.tensor([1, 3, 10, 5, 2, 10, 7, 4], dtype=torch.int32)
    want = generate(model, params, prompt, _gen(12), max_new=T, temperature=1.0, pad_id=0,
                    budgets=budgets)
    np.testing.assert_array_equal(want.lengths.numpy(), budgets.numpy())  # caps bind
    eng = ContinuousRolloutEngine(model, max_new=T, temperature=1.0, pad_id=0)
    _assert_same(eng(params, prompt, _gen(12), budgets=budgets), want)


# --------------------------------------------------------------------------- #
# greedy against the JAX engine: refill, budgets (LPT order), buckets, chunks
# --------------------------------------------------------------------------- #
JAX_CASES = {
    # 16 prompts over 4 slots: refills and bursts that exit on a newly done slot
    "refill": dict(B=16, Lp=6, T=12, engine=dict(num_slots=4)),
    # budgets with a queue: longest-first slot packing
    "budgets": dict(B=12, Lp=6, T=16, engine=dict(num_slots=4),
                    budgets=[1, 16, 2, 1, 7, 16, 3, 1, 5, 2, 16, 4]),
    # ragged prompts in buckets of 4, refill batches of mixed widths
    "bucketed": dict(B=8, Lp=12, T=8, ragged=True, engine=dict(num_slots=4, prefill_bucket=4)),
    # a fixed schedule prefilled in chunks of 4 (flash attention at q_offset)
    "chunked": dict(B=4, Lp=8, T=6, engine=dict(prefill_chunk=4)),
    # two newly done slots before a refill
    "threshold": dict(B=12, Lp=6, T=10, engine=dict(num_slots=4, refill_threshold=2)),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_greedy_engine_matches_jax(qwen, case):
    jmodel, jparams, model, params, _ = qwen
    c = JAX_CASES[case]
    prompts = _prompts(c["B"], c["Lp"], seed=3, ragged=c.get("ragged", False))
    budgets = None if "budgets" not in c else np.asarray(c["budgets"], np.int32)
    kw = dict(max_new=c["T"], temperature=0.0, eos_id=EOS_ID, pad_id=0, **c["engine"])
    jeng = jengine.ContinuousRolloutEngine(jax_fp32_arena(jmodel), **kw)
    want = jeng(jparams, jnp.asarray(prompts), jax.random.PRNGKey(0), budgets=budgets)
    eng = ContinuousRolloutEngine(fp32_arena(model), **kw)
    assert eng.prefill_chunk == jeng.prefill_chunk
    got = eng(params, torch.from_numpy(prompts), _gen(0),
              budgets=None if budgets is None else torch.from_numpy(budgets))
    _assert_same(got, want, lp_tol=TOL)
    lens = got.lengths.numpy()
    assert lens.min() < c["T"] and (budgets is not None or lens.max() > 1), lens
    # the same slot schedule: every count of the stats is JAX's
    js, s = jeng.last_stats, eng.last_stats
    assert set(s) == set(js)
    for k in s:
        if k not in ("wall_s", "tokens_per_s"):
            assert s[k] == pytest.approx(js[k], abs=1e-12), k
    if eng.num_slots and eng.num_slots < c["B"]:
        assert s["refills"] > 1


# --------------------------------------------------------------------------- #
# slot refill / early exit
# --------------------------------------------------------------------------- #
def test_slot_refill_completes_all_sequences(qwen):
    """4 slots over 16 prompts, sampled, on an fp32 arena: every sequence
    completes, the behaviour logprobs are the model's on the emitted tokens
    (each slot decodes at its own cache offsets), and the queue refilled."""
    _, _, model, params, _ = qwen
    B, Lp, T = 16, 6, 12
    prompt = torch.from_numpy(_prompts(B, Lp))
    eng = ContinuousRolloutEngine(fp32_arena(model), max_new=T, temperature=2.0,
                                  eos_id=EOS_ID, pad_id=0, num_slots=4)
    got = eng(params, prompt, _gen(7))
    lens = got.lengths.numpy()
    assert np.all(lens >= 1) and np.all(lens <= T) and lens.min() < T
    np.testing.assert_array_equal(got.tokens[:, :Lp].numpy(), prompt.numpy())
    with torch.no_grad():
        lp, _ = model.logprobs(params, got.tokens)
    m = got.response_mask.numpy()
    np.testing.assert_allclose(got.old_logprob.numpy()[m], lp.numpy()[m], atol=1e-4)
    s = eng.last_stats
    assert s["refills"] > 1, "16 prompts over 4 slots must refill"
    assert s["num_slots"] == 4
    assert 0.0 < s["slot_occupancy"] <= 1.0
    assert s["tokens"] == float(lens.sum())


def test_early_exit_all_eos_at_step_0(qwen):
    """Zeroed weights make every logit equal: greedy takes token 0, which is
    the EOS id here, so every sequence ends at its first token and the
    engine takes no decode step (lockstep would take max_new - 1)."""
    _, _, model, params, _ = qwen
    zeroed = tree.map(torch.zeros_like, params)
    eng = ContinuousRolloutEngine(model, max_new=16, temperature=0.0, eos_id=0, pad_id=0)
    got = eng(zeroed, torch.from_numpy(_prompts(4, 6)), _gen(0))
    assert np.all(got.lengths.numpy() == 1)
    assert eng.last_stats["decode_steps"] == 0.0
    assert eng.last_stats["padding_waste"] == 0.0


def test_refill_mixed_budgets_no_starvation(qwen):
    """The queue drains mid-refill under mixed budgets: every sequence runs
    to exactly its budget, and the active lane-steps equal the tokens the
    decode steps produced (each sequence's first token is its prefill's)."""
    _, _, model, params, _ = qwen
    B, Lp, T, S = 12, 6, 16, 4
    budgets = np.array([1, 16, 2, 1, 7, 16, 3, 1, 5, 2, 16, 4], np.int32)
    eng = ContinuousRolloutEngine(model, max_new=T, temperature=1.0, pad_id=0, num_slots=S)
    got = eng(params, torch.from_numpy(_prompts(B, Lp, seed=21)), _gen(17),
              budgets=torch.from_numpy(budgets))
    np.testing.assert_array_equal(got.lengths.numpy(), budgets)
    s = eng.last_stats
    assert s["refills"] >= 2
    active = s["slot_occupancy"] * s["num_slots"] * s["decode_steps"]
    assert active == pytest.approx(int((budgets - 1).sum()))
    assert 0.0 < s["slot_occupancy"] <= 1.0


# --------------------------------------------------------------------------- #
# the prompt queue
# --------------------------------------------------------------------------- #
def test_prompt_queue_buckets_and_fifo():
    prompts = np.zeros((6, 8), np.int32)
    for i, n in enumerate([3, 8, 2, 8, 5, 1]):
        prompts[i, :n] = 7
    q = PromptQueue(prompts, pad_id=0, bucket=4)
    assert len(q) == 6
    np.testing.assert_array_equal(q.bucket_len, [4, 8, 4, 8, 8, 4])
    lb, idxs = q.pop(2)
    assert lb in (4, 8) and len(idxs) == 2 and idxs == sorted(idxs)
    total = len(idxs)
    while len(q):
        total += len(q.pop(3)[1])
    assert total == 6


def test_prompt_queue_single_bucket_is_lockstep_schedule():
    q = PromptQueue(np.full((4, 6), 9, np.int32), pad_id=0, bucket=0)
    assert q.pop(4) == (6, [0, 1, 2, 3])


def test_prompt_queue_no_fresh_starvation_under_continuation_pressure():
    """Continuations re-queued as fast as they are popped cannot defer fresh
    prompts past STARVATION_LIMIT pops."""
    q = PromptQueue(np.full((4, 8), 7, np.int32), pad_id=0, bucket=4)
    q.push(SimpleNamespace(feed=np.array([5, 6])))
    served_fresh_at = None
    for i in range(2 * PromptQueue.STARVATION_LIMIT + 2):
        kind, _, items = q.pop_work(2)
        if kind == "prefill":
            served_fresh_at = i
            break
        for c in items:
            q.push(SimpleNamespace(feed=c.feed))
    assert served_fresh_at is not None and served_fresh_at <= PromptQueue.STARVATION_LIMIT


def test_prompt_queue_small_bucket_not_deferred_indefinitely():
    prompts = np.zeros((12, 16), np.int32)
    prompts[0, :2] = 7
    prompts[1:, :14] = 7
    q = PromptQueue(prompts, pad_id=0, bucket=4)
    popped = []
    while len(q) and 0 not in popped:
        popped.extend(q.pop(1)[1])
    assert popped.index(0) <= PromptQueue.STARVATION_LIMIT
    big = [r for r in popped if r != 0]
    assert big == sorted(big)


@pytest.mark.parametrize("bucket", [0, 3, 4])
def test_prompt_queue_pops_as_the_jax_queue(bucket):
    """A script of pops, pushes and ordered queues on ragged prompts gives
    the JAX queue's work items in the JAX queue's order."""
    rng = np.random.default_rng(bucket)
    prompts = _prompts(24, 12, seed=bucket, ragged=True)
    order = rng.permutation(24)
    q, jq = (cls(prompts, pad_id=0, bucket=bucket, order=order)
             for cls in (PromptQueue, jengine.PromptQueue))
    np.testing.assert_array_equal(q.bucket_len, jq.bucket_len)
    np.testing.assert_array_equal(q.true_len, jq.true_len)
    while len(jq):
        n = int(rng.integers(1, 6))
        if rng.random() < 0.3:
            feed = rng.integers(1, 9, int(rng.integers(1, 4)))
            q.push(SimpleNamespace(feed=feed))
            jq.push(jengine._Continuation(0, feed, None, 0))
        kind, width, items = q.pop_work(n)
        jkind, jwidth, jitems = jq.pop_work(n)
        assert (kind, width) == (jkind, jwidth)
        if kind == "prefill":
            assert items == jitems
        else:
            assert [list(c.feed) for c in items] == [list(c.feed) for c in jitems]
        assert len(q) == len(jq)


# --------------------------------------------------------------------------- #
# gates and helpers
# --------------------------------------------------------------------------- #
def test_chunked_prefill_gated_for_ssm_and_quant():
    """Chunked prefill runs attention-only stacks without an int8 cache; the
    gate falls back to whole-prompt prefill elsewhere, as the JAX gate does."""
    mamba = get_model(reduced(get_config("mamba2-2.7b"), vocab_size=260), device="cpu")
    assert ContinuousRolloutEngine(mamba, max_new=4, prefill_chunk=2).prefill_chunk == 0
    qcfg = dataclasses.replace(reduced(get_config(ARCH), vocab_size=260), kv_quant=True)
    eng = ContinuousRolloutEngine(get_model(qcfg, device="cpu"), max_new=4, prefill_chunk=2)
    assert eng.prefill_chunk == 0
    plain = get_model(reduced(get_config(ARCH), vocab_size=260), device="cpu")
    assert ContinuousRolloutEngine(plain, max_new=4, prefill_chunk=2).prefill_chunk == 2


def test_ssm_engine_refills_and_completes():
    """Reduced mamba2 through the engine with refill: the SSD state rows are
    scattered over the arena at each refill, and every sequence completes
    with the model's own logprobs on its tokens."""
    model = get_model(reduced(get_config("mamba2-2.7b"), vocab_size=260, num_layers=2),
                      device="cpu")
    params = tree.map(lambda t: t.float() if t.is_floating_point() else t, model.init(_gen(0)))
    prompt = torch.from_numpy(_prompts(6, 5))
    budgets = torch.tensor([2, 5, 1, 4, 3, 5], dtype=torch.int32)
    eng = ContinuousRolloutEngine(fp32_arena(model), max_new=5, temperature=1.0, pad_id=0,
                                  num_slots=2)
    got = eng(params, prompt, _gen(1), budgets=budgets)
    np.testing.assert_array_equal(got.lengths.numpy(), budgets.numpy())
    with torch.no_grad():
        lp, _ = model.logprobs(params, got.tokens)
    m = got.response_mask.numpy()
    np.testing.assert_allclose(got.old_logprob.numpy()[m], lp.numpy()[m], atol=1e-4)
    assert eng.last_stats["refills"] > 1


@pytest.mark.parametrize("seed", range(3))
def test_lockstep_waste_equals_jax(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(2, 40))
    lengths = rng.integers(1, T + 1, int(rng.integers(1, 33)))
    assert lockstep_waste(lengths, T) == jengine.lockstep_waste(lengths, T)
    assert lockstep_waste(np.array([1, 8]), 8) == pytest.approx(0.5)


def test_env_and_prefix_models_are_refused():
    """Enc-dec and prefix-modality models are refused (ValueError), as the
    JAX engine refuses them; environments run in the episode loop
    (``tests/test_torch_envs.py``)."""
    for arch in ("seamless-m4t-medium", "llava-next-34b"):
        model = get_model(reduced(get_config(arch)), device="cpu")
        with pytest.raises(ValueError, match="text decoder-only archs"):
            ContinuousRolloutEngine(model, max_new=4)
