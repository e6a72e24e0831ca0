"""The port's RL layer against the JAX package on the CPU: losses,
advantages, the math reward, the algorithm registry and its DAGs, and the
actor, critic and accumulated update steps.

The model is the reduced gemma-2b of ``tests/test_torch_train.py`` (padded
heads and vocab), JAX weights bridged in as fp32, batches from numpy seeds.
Tolerances:

- losses and advantages: 1e-6 (fp32 elementwise arithmetic and small sums);
- prompts and rewards: equal;
- two actor or critic steps: the loss, KL and ratio metrics at 2e-5 (the
  repository's fp32 tolerance); each leaf's update (params after the step
  minus before) at a relative L2 error of 1e-3, and every element within
  half the learning rate, a quarter of what one update of the wrong sign
  would give. Adam divides each grad by its own magnitude: where a grad is
  the small remainder of a cancellation, fp32's last-bit differences in it
  become a different step of up to the learning rate, so no per-element
  tolerance much below it holds;
- the accumulated step against the whole-batch step: the loss and the grad
  norm at 1e-5 (the same math, the batch sums split in two), the updates
  as in the steps against JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import lm as jlm
from repro.models.api import Model as JaxModel
from repro.rl import advantage as jadv
from repro.rl import algorithms as jalgos
from repro.rl import critic as jcritic
from repro.rl import loss as jloss
from repro.rl import reward as jreward
from repro.rl import trainer as jtrainer
from repro_torch import bridge, tree
from repro_torch.configs import get_config, reduced
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_model
from repro_torch.rl import advantage, algorithms, critic, loss, reward, trainer
from repro_torch.rl.rollout import generate

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8)
LR = 1e-3  # large enough that two steps move the params well past fp32 noise


@pytest.fixture(scope="module")
def cfgs():
    return (jax_reduced(jax_get_config("gemma-2b"), **SMOKE),
            reduced(get_config("gemma-2b"), **SMOKE))


@pytest.fixture(scope="module")
def jax_params(cfgs):
    return jax.tree.map(np.asarray, jlm.init(cfgs[0], jax.random.PRNGKey(0)))


def fp32_tree(t):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)


def pair(*arrays):
    """(jax arrays, torch tensors) of the same numpy arrays."""
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.asarray(a)) for a in arrays]


def close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], tol)
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# --------------------------------------------------------------------------- #
# losses and advantages
# --------------------------------------------------------------------------- #
def _token_data(seed, B=6, T=7):
    rng = np.random.default_rng(seed)
    lp = (rng.standard_normal((B, T)) * 0.3 - 2.0).astype(np.float32)
    old = (lp + rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    ref_lp = (lp + rng.standard_normal((B, T)) * 0.2).astype(np.float32)
    adv = rng.standard_normal((B, T)).astype(np.float32)
    mask = rng.random((B, T)) > 0.3
    values = rng.standard_normal((B, T)).astype(np.float32)
    old_values = (values + rng.standard_normal((B, T)) * 0.3).astype(np.float32)
    returns = rng.standard_normal((B, T)).astype(np.float32)
    rewards = rng.random(B).astype(np.float32)
    tok_rewards = (rng.standard_normal((B, T)) * mask).astype(np.float32)
    return dict(lp=lp, old=old, ref=ref_lp, adv=adv, mask=mask, values=values,
                old_values=old_values, returns=returns, rewards=rewards,
                tok_rewards=tok_rewards)


LOSS_CASES = {
    "ppo": lambda m, d: m.ppo_policy_loss(d["lp"], d["old"], d["adv"], d["mask"], clip_eps=0.2),
    "kl_k1": lambda m, d: m.kl_penalty(d["lp"], d["ref"], d["mask"], kind="k1"),
    "kl_k2": lambda m, d: m.kl_penalty(d["lp"], d["ref"], d["mask"], kind="k2"),
    "kl_k3": lambda m, d: m.kl_penalty(d["lp"], d["ref"], d["mask"], kind="k3"),
    "grpo": lambda m, d: m.grpo_loss(d["lp"], d["old"], d["ref"], d["adv"], d["mask"],
                                     clip_eps=0.2, kl_coef=0.05),
    "truncated_is": lambda m, d: m.truncated_is_weights(d["lp"], d["old"], d["mask"],
                                                        rho_max=1.2),
    "value": lambda m, d: m.value_loss(d["values"], d["old_values"], d["returns"], d["mask"],
                                       clip_eps=0.2),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(case):
    d = _token_data(0)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    close(LOSS_CASES[case](loss, td), LOSS_CASES[case](jloss, jd), 1e-6)


ADV_CASES = {
    "gae": lambda m, d: m.gae(d["tok_rewards"], d["values"], d["mask"], gamma=0.99, lam=0.9),
    "grpo": lambda m, d: m.grpo(d["rewards"], d["mask"], group_size=3),
    "rloo": lambda m, d: m.rloo(d["rewards"], d["mask"], group_size=3),
    "reinforce_pp": lambda m, d: m.reinforce_pp(d["rewards"], d["mask"]),
    "whiten": lambda m, d: m.whiten(d["adv"], d["mask"]),
}


@pytest.mark.parametrize("case", sorted(ADV_CASES))
def test_advantages_match_jax(case):
    d = _token_data(1)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    close(ADV_CASES[case](advantage, td), ADV_CASES[case](jadv, jd), 1e-6)


# --------------------------------------------------------------------------- #
# the math task
# --------------------------------------------------------------------------- #
def test_math_prompts_and_rewards_equal_jax():
    tok, jtok = ByteTokenizer(), JaxByteTokenizer()
    ids, answers = reward.make_math_prompts(np.random.default_rng(3), 64, tok)
    jids, janswers = jreward.make_math_prompts(np.random.default_rng(3), 64, jtok)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(answers, janswers)
    # responses: exact answers + EOS, answers without EOS, leading digits
    # only, wrong digits and random bytes, each after the prompt
    rng = np.random.default_rng(4)
    B, Lp, T = 64, ids.shape[1], 6
    resp = rng.integers(3, 259, (B, T)).astype(np.int32)
    texts = []
    for b in range(B):
        want = str(int(answers[b]))
        kind = b % 5
        text = {0: want, 1: want, 2: want[:-1] or "x", 3: "9" + want, 4: ""}[kind]
        enc = list(tok.encode(text)) + ([tok.eos_id] if kind in (0, 2) else [])
        resp[b, :len(enc)] = enc[:T]
        texts.append(tok.decode(resp[b]))
    tokens = np.concatenate([ids, resp], axis=1)
    mask = np.zeros_like(tokens, dtype=bool)
    mask[:, Lp:] = True
    np.testing.assert_array_equal(reward.math_reward(texts, answers),
                                  jreward.math_reward(texts, janswers))
    (jt, jm, ja), (tt, tm, ta) = pair(tokens, mask, answers)
    want = np.asarray(jreward.math_reward_tokens(jt, jm, ja, jtok))
    got = reward.math_reward_tokens(tt, tm, ta, tok).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 1.0).sum() >= 10 and ((want > 0) & (want < 1)).any()


# --------------------------------------------------------------------------- #
# the registry and its DAGs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["grpo", "ppo", "rloo", "reinforce_pp"])
def test_builtin_specs_and_dags_match_jax(name):
    spec, jspec = algorithms.get_algorithm(name), jalgos.get_algorithm(name)
    assert spec.dag_factory().to_spec() == jspec.dag_factory().to_spec()
    for f in ("advantage_inputs", "advantage_outputs", "grouped_rollouts",
              "needs_reference", "is_correction", "uses_critic"):
        assert getattr(spec, f) == getattr(jspec, f), f
    assert {r.value for r in spec.required_roles} == {r.value for r in jspec.required_roles}
    spec.validate_dag(spec.dag_factory())
    assert name in algorithms.list_algorithms()
    with pytest.raises(KeyError, match="did you mean"):
        algorithms.get_algorithm(name + "x")


# --------------------------------------------------------------------------- #
# update steps
# --------------------------------------------------------------------------- #
def _actor_batch(seed, algo, B=6, prompt=3, new=5, ragged=True):
    """A batch for ``algo``'s actor step, with its advantages from the
    algorithm's own engine (JAX's, held against the port's) on seeded
    rewards: tokens, response mask, behaviour / reference logprobs near the
    model's, advantages (and returns for ppo)."""
    rng = np.random.default_rng(seed)
    S = prompt + new
    tokens = rng.integers(3, 259, (B, S)).astype(np.int32)
    lens = rng.integers(2, new + 1, B) if ragged else np.full(B, new)
    mask = np.zeros((B, S), bool)
    for b, n in enumerate(lens):
        mask[b, prompt:prompt + n] = True
    old = ((rng.standard_normal((B, S)) * 0.05 - 6.2) * mask).astype(np.float32)
    ref_lp = ((rng.standard_normal((B, S)) * 0.05 - 6.2) * mask).astype(np.float32)
    rewards = rng.random(B).astype(np.float32)
    batch = {"tokens": tokens, "response_mask": mask, "old_logprob": old,
             "ref_logprob": ref_lp}
    rl_j, rl_t = jtrainer.RLConfig(algorithm=algo, group_size=3, lr=LR), \
        trainer.RLConfig(algorithm=algo, group_size=3, lr=LR)
    extra = []
    if algo == "ppo":
        batch["old_values"] = rng.standard_normal((B, S)).astype(np.float32)
        extra = [batch[k] for k in ("old_logprob", "ref_logprob", "old_values")]
    (jr, jm, *jx), (tr, tm, *tx) = pair(rewards, mask, *extra)
    want = jalgos.get_algorithm(algo).make_advantage(rl_j)(jr, jm, *jx)
    got = algorithms.get_algorithm(algo).make_advantage(rl_t)(tr, tm, *tx)
    close(got, want, 1e-6)
    if algo == "ppo":
        batch["advantages"], batch["returns"] = (np.asarray(w) for w in want)
    else:
        batch["advantages"] = np.asarray(want)
    return batch, rl_j, rl_t


def _updates_close(tp, jp, before, lr):
    """Each leaf's update, port against JAX (see the module docstring)."""
    _leaf_updates_close(jax.tree.leaves(bridge.to_jax(tp)), jax.tree.leaves(jp), before, lr)


def _leaf_updates_close(flat_t, flat_j, before, lr):
    assert len(flat_j) == len(flat_t) == len(before)
    for a, b, b0 in zip(flat_t, flat_j, before):
        a, b, b0 = (np.asarray(t) for t in (a, b, b0))
        da, db = a - b0, b - b0
        assert np.linalg.norm(da - db) <= 1e-3 * np.linalg.norm(db)
        np.testing.assert_allclose(a, np.asarray(b), atol=0.5 * lr, rtol=0)


@pytest.mark.parametrize("algo", ["grpo", "ppo", "rloo", "reinforce_pp"])
def test_two_actor_steps_match_jax(cfgs, jax_params, algo):
    jcfg, cfg = cfgs
    batch, rl_j, rl_t = _actor_batch(5, algo)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    js = jtrainer.init_state(fp32_tree(jax_params))
    ts = trainer.init_state(bridge.from_jax(jax_params, device="cpu", dtype=torch.float32))
    jstep = jax.jit(jtrainer.make_actor_step(JaxModel(jcfg), rl_j))
    tstep = trainer.make_actor_step(get_model(cfg, device="cpu"), rl_t)
    for _ in range(2):
        before = [np.asarray(a) for a in jax.tree.leaves(js.params)]
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert set(tm) == set(jm)
        for k in ("loss", "ratio_mean", "clipfrac", "approx_kl", "entropy", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-5, rtol=2e-5)
        if "kl" in jm:
            np.testing.assert_allclose(float(tm["kl"]), float(jm["kl"]), atol=2e-5, rtol=2e-5)
        _updates_close(ts.params, js.params, before, LR)
    pad = slice(cfg.num_heads * cfg.head_dim, None)
    for layer in range(cfg.num_layers):  # the padded w_o rows, zero at init, moved in both
        jw = np.asarray(js.params["blocks"][0]["attn"]["w_o"][layer])[pad]
        tw = ts.params["blocks"][layer]["attn"]["w_o"][pad].numpy()
        assert np.abs(jw).max() > LR and np.abs(tw).max() > LR
        assert np.linalg.norm(tw - jw) <= 1e-3 * np.linalg.norm(jw)


def test_critic_steps_match_jax(cfgs):
    jcfg, cfg = cfgs
    jparams = jax.tree.map(np.asarray, jcritic.init(jcfg, jax.random.PRNGKey(1)))
    batch, rl_j, rl_t = _actor_batch(6, "ppo")
    batch = {k: batch[k] for k in ("tokens", "response_mask", "old_values", "returns")}
    js = jtrainer.init_state(fp32_tree(jparams))
    ts = trainer.init_state(bridge.from_jax(jparams, device="cpu", dtype=torch.float32))
    v_j = jcritic.values_fn(jcfg, js.params, jnp.asarray(batch["tokens"]))
    with torch.no_grad():
        v_t = critic.values_fn(cfg, ts.params, torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=2e-5, rtol=2e-5)
    jstep = jax.jit(jtrainer.make_critic_step(jcfg, rl_j))
    tstep = trainer.make_critic_step(cfg, rl_t)
    for _ in range(2):
        before = [np.asarray(a) for a in jax.tree.leaves(js.params)]
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.tensor(v) for k, v in batch.items()})
        for k in ("loss", "value_err", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=2e-5, rtol=2e-5)
        _updates_close(ts.params, js.params, before, rl_t.critic_lr)
    back = bridge.to_jax(ts.params)
    assert set(back) == {"backbone", "v_head"} and back["v_head"].shape == (cfg.d_model, 1)


def test_critic_init_shapes_and_lm_train_step(cfgs):
    _, cfg = cfgs
    params = critic.init(cfg, torch.Generator().manual_seed(0))
    assert "lm_head" not in params["backbone"] and params["v_head"].dtype == torch.float32
    model = get_model(cfg, device="cpu")
    lm_params = model.init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(3, 259, (2, 6)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], 1)}
    state = trainer.init_state(lm_params)
    losses = []
    for _ in range(3):
        state, m = trainer.make_lm_train_step(model, lr=1e-2)(state, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[0] and int(state.opt.step) == 3


def test_accumulated_step_equals_the_whole_batch_step(cfgs, jax_params):
    """Two microbatches with the same number of response tokens each: the
    mean of their masked-mean losses is the whole batch's."""
    _, cfg = cfgs
    batch, _, rl_t = _actor_batch(7, "grpo", ragged=False)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    model = get_model(cfg, device="cpu")
    states = [trainer.init_state(bridge.from_jax(jax_params, device="cpu", dtype=torch.float32))
              for _ in range(2)]
    before = [t.clone() for t in tree.leaves(states[0].params)]
    whole = trainer.make_actor_step(model, rl_t)
    acc = trainer.make_actor_step_accumulated(model, rl_t, num_microbatches=2)
    s1, m1 = whole(states[0], tb)
    s2, m2 = acc(states[1], tb)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    _leaf_updates_close(tree.leaves(s2.params), tree.leaves(s1.params), before, LR)


def test_is_correction_with_behavior_logprob_matches_jax():
    d = _token_data(2)
    batch = {"old_logprob": d["old"], "behavior_logprob": d["lp"], "advantages": d["adv"],
             "response_mask": d["mask"]}
    jspec = dataclasses.replace(jalgos.get_algorithm("grpo"), is_correction="truncated")
    tspec = dataclasses.replace(algorithms.get_algorithm("grpo"), is_correction="truncated")
    rl_j, rl_t = jtrainer.RLConfig(is_rho_max=1.3), trainer.RLConfig(is_rho_max=1.3)
    jb, jm = jtrainer.apply_is_correction(rl_j, jspec, {k: jnp.asarray(v) for k, v in batch.items()})
    tb, tm = trainer.apply_is_correction(rl_t, tspec,
                                         {k: torch.tensor(v) for k, v in batch.items()})
    close(tm, jm, 1e-6)
    close(tb["advantages"], jb["advantages"], 1e-6)
    assert float(tm["rho_clipfrac"]) > 0
    # an on-policy batch (no behaviour logprobs) or a spec that did not opt in
    # passes through untouched
    plain = {k: v for k, v in batch.items() if k != "behavior_logprob"}
    assert trainer.apply_is_correction(rl_t, tspec, plain) == (plain, {})
    assert trainer.apply_is_correction(rl_t, algorithms.get_algorithm("grpo"), batch)[1] == {}


def test_generate_then_actor_step_on_the_cpu(cfgs, jax_params):
    """One GRPO iteration in the DAG's order on the CPU: generate, reference
    logprobs, the math reward, GRPO advantages, an actor step. Rollouts come
    out of inference mode; handed on as they are, the actor step refuses
    them (autograd cannot save inference tensors for the backward), so the
    stage boundary clones them, as a databuffer put would."""
    _, cfg = cfgs
    tok = ByteTokenizer()
    model = get_model(cfg, device="cpu")
    params = bridge.from_jax(jax_params, device="cpu")
    ref_params = tree.map(torch.clone, params)
    ids, answers = reward.make_math_prompts(np.random.default_rng(9), 2, tok)
    rl = trainer.RLConfig(group_size=4, lr=1e-3, max_new_tokens=4)
    prompts = torch.from_numpy(np.repeat(ids, rl.group_size, axis=0))
    res = generate(model, params, prompts, torch.Generator().manual_seed(0),
                   max_new=rl.max_new_tokens, temperature=rl.temperature, eos_id=tok.eos_id)
    assert res.tokens.is_inference()
    spec = algorithms.get_algorithm("grpo")
    state = trainer.init_state(params)
    step = trainer.make_actor_step(model, rl)

    def batch_of(r, clone):
        t = (lambda x: x.clone()) if clone else (lambda x: x)
        b = {"tokens": t(r.tokens), "response_mask": t(r.response_mask),
             "old_logprob": t(r.old_logprob)}
        with torch.no_grad():
            b["ref_logprob"] = model.logprobs(ref_params, b["tokens"])[0]
        rewards = reward.math_reward_tokens(b["tokens"], b["response_mask"],
                                            torch.from_numpy(np.repeat(answers, rl.group_size)),
                                            tok)
        rewards = rewards + torch.arange(8) * 0.01  # groups that are not all equal
        b["advantages"] = spec.make_advantage(rl)(rewards, b["response_mask"])
        return b

    with pytest.raises(RuntimeError, match="[Ii]nference tensors"):
        step(trainer.init_state(tree.map(torch.clone, params)), batch_of(res, clone=False))
    before = tree.map(torch.clone, params)
    state, metrics = step(state, batch_of(res, clone=True))
    for k in ("loss", "grad_norm", "entropy", "kl", "clipfrac", "ratio_mean"):
        assert torch.isfinite(metrics[k]), k
    assert abs(float(metrics["ratio_mean"]) - 1.0) < 1e-2
    changed = [not torch.equal(a, b) for a, b in zip(tree.leaves(state.params),
                                                     tree.leaves(before))]
    assert all(changed)
