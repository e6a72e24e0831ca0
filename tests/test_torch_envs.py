"""The port's environment subsystem (``repro_torch.rl.envs``) and the
continuous engine's multi-turn episode loop against the JAX package's on the
CPU, mirroring ``tests/test_envs.py``.

The engine comparisons run reduced qwen2.5-7b (untied head, 2 layers, vocab
260) on the JAX model's initial weights bridged as fp32, greedy, with the
EOS column of the head scaled by ``EOS_SCALE`` and a digit's by
``DIGIT_SCALE`` in both packages, so that some turns end early, some
calculator episodes answer, and episodes go out of step. Both engines get an fp32 cache
arena (``tests/torch_arena.py``): the JAX engine's arena is bf16 and cannot
carry fp32 decode writes.

Tolerances: tokens, ``role_mask``, ``response_mask``, lengths, env rewards,
turns and every count of ``last_stats`` are equal; behaviour logprobs agree
within 2e-5 (fp32). The built-in envs' ``reset``/``step`` outputs are equal
to JAX's on the same token inputs. An episode's recorded behaviour logprobs
equal the model's own logprobs of the assembled sequence within 1e-4 (fp32):
a continuation that wrote its K/V at a wrong offset would break that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxExperimentSpec
from repro.configs import EnvConfig as JaxEnvConfig
from repro.configs import RolloutEngineConfig as JaxRolloutEngineConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from repro.models import get_model as jax_get_model
from repro.rl import algorithms as jalgorithms
from repro.rl import envs as jenvs
from repro.rl import rollout_engine as jengine
from repro_torch import bridge
from repro_torch.api import ExperimentSpec
from repro_torch.configs import EnvConfig, RolloutEngineConfig, get_config, reduced
from repro_torch.core import build_pipeline
from repro_torch.core.dag import NodeType, Role
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_model
from repro_torch.rl import RLConfig, algorithms, envs
from repro_torch.rl.reward import make_math_prompts, math_reward
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine
from test_torch_pipeline import assert_continuous_iterations_match, bridged_pair, fp32_arenas
from torch_arena import fp32_arena, jax_fp32_arena

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

TOK, JTOK = ByteTokenizer(), JaxByteTokenizer()
ARCH = "qwen2.5-7b"
SMOKE = dict(vocab_size=260, num_layers=2)
EOS_SCALE = 3.0
# a digit's column scaled too, so that some greedy calculator turns answer
# (a digit-leading turn ends the episode) and others re-ask
DIGIT, DIGIT_SCALE = int(ByteTokenizer().encode("7")[0]), 2.0
TOL = 2e-5
CLOCK_KEYS = {"wall_s", "tokens_per_s"}


def _runtime(name, **kw):
    return envs.EnvRuntime(envs.get_env(name), EnvConfig(name=name, **kw), TOK)


def _jax_runtime(name, **kw):
    return jenvs.EnvRuntime(jenvs.get_env(name), JaxEnvConfig(name=name, **kw), JTOK)


def _math_prompts(n, seed=0):
    prompts, answers = make_math_prompts(np.random.default_rng(seed), n, TOK)
    return prompts, answers


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def qwen():
    """(JAX model, JAX fp32 params, port model, port fp32 params), the EOS
    and a digit's columns of the untied head scaled in both."""
    jmodel = jax_get_model(jax_reduced(jax_get_config(ARCH), **SMOKE))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jmodel.init(jax.random.PRNGKey(0)))
    params["lm_head"][:, TOK.eos_id] *= EOS_SCALE
    params["lm_head"][:, DIGIT] *= DIGIT_SCALE
    model = get_model(reduced(get_config(ARCH), **SMOKE), device="cpu")
    return (jmodel, jax.tree.map(jnp.asarray, params), model,
            bridge.from_jax(params, device="cpu", dtype=torch.float32))


# --------------------------------------------------------------------------- #
# registries
# --------------------------------------------------------------------------- #
def test_env_registry_contents_match_jax():
    assert envs.list_envs() == jenvs.list_envs()
    assert envs.list_rewards() == jenvs.list_rewards()
    for name in ("function_reward", "calculator", "dialog"):
        spec = envs.get_env(name)
        assert spec.name == name and spec.multi_turn == jenvs.get_env(name).multi_turn
        assert spec.description == jenvs.get_env(name).description
    assert not envs.get_env("function_reward").multi_turn
    assert envs.get_reward("math").host_fn is math_reward


@pytest.mark.parametrize("call,match", [
    (lambda: envs.get_env("calculater"), "did you mean 'calculator'"),
    (lambda: envs.get_env("no_such_env"), "Registered"),
    (lambda: envs.get_reward("matth"), "did you mean 'math'"),
    (lambda: envs.register_env(envs.get_env("calculator")), "already registered"),
    (lambda: envs.register_reward(envs.get_reward("math")), "already registered"),
])
def test_registry_errors(call, match):
    with pytest.raises(KeyError, match=match):
        call()


def test_register_override_is_idempotent():
    spec = envs.get_env("calculator")
    assert envs.register_env(spec, override=True) is spec and envs.get_env("calculator") is spec


def test_runtime_refuses_multi_turn_on_a_single_turn_env():
    with pytest.raises(ValueError) as got:
        _runtime("function_reward", max_turns=3)
    with pytest.raises(ValueError) as want:
        _jax_runtime("function_reward", max_turns=3)
    assert str(got.value) == str(want.value) and "single-turn" in str(got.value)


# --------------------------------------------------------------------------- #
# the built-in envs' reset and step against JAX's, on seeded token inputs
# --------------------------------------------------------------------------- #
def _responses(rng, answer):
    """Turn responses: a tool call, a malformed call, junk, the right answer
    with EOS, a wrong digit, and random byte tokens."""
    return [TOK.encode("CALL 12+34"), TOK.encode("CALL banana"), TOK.encode("xyz"),
            np.concatenate([TOK.encode(str(int(answer))), [TOK.eos_id]]), TOK.encode("9"),
            rng.integers(0, 260, int(rng.integers(1, 9))).astype(np.int32)]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("name", ["function_reward", "calculator", "dialog"])
def test_builtin_env_steps_equal_jax(name, seed):
    rng = np.random.default_rng(seed)
    kw = dict(max_turns=1 if name == "function_reward" else 3)
    rt, jrt = _runtime(name, **kw), _jax_runtime(name, **kw)
    prompts, answers = _math_prompts(3, seed=seed)
    for b in range(3):
        for resp in _responses(rng, answers[b]):
            env, jenv = rt.make_episode(), jrt.make_episode()
            np.testing.assert_array_equal(env.reset(prompts[b]), jenv.reset(prompts[b]))
            for _ in range(kw["max_turns"]):
                obs, r, done, info = env.step(resp)
                jobs, jr, jdone, jinfo = jenv.step(resp)
                np.testing.assert_array_equal(obs, jobs)
                assert (r, done, info) == (jr, jdone, jinfo)
                if done:
                    break


def test_calculator_protocol():
    rt = _runtime("calculator", max_turns=3)
    env = rt.make_episode()
    env.reset(TOK.encode("12+34="))
    obs, r, done, info = env.step(TOK.encode("CALL 12+34"))
    assert not done and info["tool_call"] and r == 0.0 and TOK.decode(obs) == "46="
    obs, r, done, info = env.step(np.concatenate([TOK.encode("46"), [TOK.eos_id]]))
    assert done and r == 1.0 and info == {"answered": True, "tool_calls": 1}
    env = rt.make_episode()
    env.reset(TOK.encode("03+04="))
    obs, _, done, info = env.step(TOK.encode("xyz"))
    assert not done and info["malformed"] and TOK.decode(obs) == ";03+04="


def test_dialog_per_turn_partial_rewards():
    env = _runtime("dialog", max_turns=3).make_episode()
    env.reset(TOK.encode("02+03="))
    right = np.concatenate([TOK.encode("5"), [TOK.eos_id]])
    obs, r1, d1, _ = env.step(right)
    assert not d1 and r1 == pytest.approx(0.5) and len(obs) > 0
    _, r2, d2, _ = env.step(TOK.encode("9"))
    assert not d2 and r2 == 0.0
    obs, r3, d3, _ = env.step(right)
    assert d3 and r3 == pytest.approx(1.0) and len(obs) == 0


def test_score_single_turn_equals_jax():
    prompts, answers = _math_prompts(6, seed=4)
    resp = np.stack([np.concatenate([TOK.encode(f"{int(a) + (b % 2):03d}"), [TOK.eos_id]])
                     for b, a in enumerate(answers)])
    tokens = np.concatenate([prompts, resp], axis=1)
    mask = np.zeros(tokens.shape, bool)
    mask[:, prompts.shape[1]:] = True
    got = _runtime("function_reward").score_single_turn(tokens, mask)
    np.testing.assert_array_equal(got, _jax_runtime("function_reward").score_single_turn(
        tokens, mask))
    assert got.max() == 1.0 and got.min() < 1.0


# --------------------------------------------------------------------------- #
# the engine's episode loop against the JAX engine's
# --------------------------------------------------------------------------- #
EPISODE_CASES = {
    # dialog always runs every turn: 6 episodes over 3 slots, continuations
    # queued behind fresh prompts
    "dialog_refill": dict(env="dialog", B=6, slots=3, max_new=8, turns=3, turn_budget=4,
                          obs_budget=8),
    # one slot an episode: turn waves out of step, no global barrier
    "dialog_early_exit": dict(env="dialog", B=6, slots=0, max_new=6, turns=3, turn_budget=6,
                              obs_budget=8),
    # calculator: junk re-asks, digit answers end an episode early
    "calculator": dict(env="calculator", B=8, slots=4, max_new=6, turns=3, turn_budget=4,
                       obs_budget=8),
    # an observation clipped by obs_budget
    "calculator_clipped": dict(env="calculator", B=4, slots=2, max_new=5, turns=2,
                               turn_budget=5, obs_budget=3),
}


def _episode_engines(qwen, c):
    jmodel, _, model, _ = qwen
    kw = dict(max_new=c["max_new"], temperature=0.0, eos_id=TOK.eos_id, pad_id=0,
              num_slots=c["slots"], max_turns=c["turns"], turn_budget=c["turn_budget"],
              obs_budget=c["obs_budget"])
    ekw = dict(max_turns=c["turns"], obs_budget=c["obs_budget"])
    jeng = jengine.ContinuousRolloutEngine(jax_fp32_arena(jmodel),
                                           env=_jax_runtime(c["env"], **ekw), **kw)
    eng = ContinuousRolloutEngine(fp32_arena(model), env=_runtime(c["env"], **ekw), **kw)
    return jeng, eng


@pytest.mark.parametrize("case", sorted(EPISODE_CASES))
def test_multi_turn_engine_matches_jax(qwen, case):
    c = EPISODE_CASES[case]
    _, jparams, _, params = qwen
    prompts, _ = _math_prompts(c["B"], seed=7)
    jeng, eng = _episode_engines(qwen, c)
    want = jeng(jparams, jnp.asarray(prompts), jax.random.PRNGKey(0))
    got = eng(params, torch.from_numpy(prompts), _gen(0))
    for field in ("tokens", "role_mask", "response_mask", "lengths"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.old_logprob.numpy(), np.asarray(want.old_logprob),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(eng.last_env["rewards"], jeng.last_env["rewards"])
    np.testing.assert_array_equal(eng.last_env["turns"], jeng.last_env["turns"])
    assert eng.last_env["tool_calls"] == jeng.last_env["tool_calls"]
    assert set(eng.last_stats) == set(jeng.last_stats)
    for k, v in eng.last_stats.items():
        if k not in CLOCK_KEYS:
            assert v == pytest.approx(jeng.last_stats[k], abs=1e-12), k
    rm, mask = got.role_mask.numpy(), got.response_mask.numpy()
    np.testing.assert_array_equal(rm == 1, mask)
    assert eng.last_stats["cont_refills"] >= 1 and (rm == 2).any()
    if c["env"] == "dialog":
        np.testing.assert_array_equal(eng.last_env["turns"], np.full(c["B"], c["turns"]))
    else:
        assert eng.last_env["turns"].min() < c["turns"] or c["turns"] == 2


def test_single_turn_env_is_bitwise_the_env_off_engine(qwen):
    """A single-turn env only scores: the schedule, seeds and shapes are
    untouched, so every output is the env-off engine's, bit for bit (sampled)."""
    _, _, model, params = qwen
    prompts, _ = _math_prompts(8, seed=1)
    kw = dict(max_new=10, temperature=2.0, eos_id=TOK.eos_id, pad_id=0, num_slots=3)
    ref = ContinuousRolloutEngine(model, **kw)(params, torch.from_numpy(prompts), _gen(9))
    eng = ContinuousRolloutEngine(model, env=_runtime("function_reward"), **kw)
    got = eng(params, torch.from_numpy(prompts), _gen(9))
    for field in ("tokens", "response_mask", "old_logprob", "lengths"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    np.testing.assert_array_equal(got.role_mask.numpy() == 1, ref.response_mask.numpy())
    np.testing.assert_array_equal(eng.last_env["turns"], np.ones(8))


def test_multi_turn_continuations_resume_at_their_offsets(qwen):
    """Sampled dialog episodes over 3 slots: each episode's recorded
    behaviour logprobs are the model's own logprobs of the assembled
    sequence (continuations wrote their feed at each row's saved offset),
    observation and prompt tokens carry 0, and later-turn prefill counts
    only observations plus one carried token a continuation."""
    _, _, model, params = qwen
    prompts, _ = _math_prompts(6, seed=5)
    eng = ContinuousRolloutEngine(fp32_arena(model), max_new=8, temperature=2.0,
                                  eos_id=TOK.eos_id, pad_id=0, num_slots=3,
                                  env=_runtime("dialog", max_turns=3, obs_budget=8),
                                  max_turns=3, turn_budget=4, obs_budget=8)
    got = eng(params, torch.from_numpy(prompts), _gen(8))
    with torch.no_grad():
        lp, _ = model.logprobs(params, got.tokens)
    m = got.response_mask.numpy()
    np.testing.assert_allclose(got.old_logprob.numpy()[m], lp.numpy()[m], atol=1e-4)
    assert np.all(got.old_logprob.numpy()[~m] == 0.0)
    s, rm = eng.last_stats, got.role_mask.numpy()
    n_cont = int((eng.last_env["turns"] - 1).sum())
    assert n_cont == 12 and s["obs_tokens"] == (rm == 2).sum()
    assert s["prefill_tokens_turn2plus"] == s["obs_tokens"] + n_cont
    assert s["prefill_tokens"] == s["prefill_tokens_turn1"] + s["prefill_tokens_turn2plus"]
    assert not (rm[:, :prompts.shape[1]] != 0).any()
    assert set(np.unique(rm)) <= {0, 1, 2} and ((rm == 2).sum(axis=1) >= 1).all()


def test_multi_turn_is_refused_on_ssm_stacks():
    model = get_model(reduced(get_config("mamba2-2.7b"), vocab_size=260, num_layers=2),
                      device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousRolloutEngine(model, max_new=4, env=_runtime("dialog", max_turns=2),
                                max_turns=2)
    ContinuousRolloutEngine(model, max_new=4, env=_runtime("function_reward"), max_turns=1)


# --------------------------------------------------------------------------- #
# observation tokens never train, for every registered algorithm
# --------------------------------------------------------------------------- #
def _masked_batch(seed=0):
    """4 sequences: 2 prompt, 3 action, 2 observation, 2 action positions."""
    rng = np.random.default_rng(seed)
    B, L = 4, 9
    roles = np.zeros((B, L), np.int8)
    roles[:, 2:5] = 1
    roles[:, 5:7] = 2
    roles[:, 7:9] = 1
    f = lambda: rng.normal(size=(B, L)).astype(np.float32)  # noqa: E731
    return roles, f() * 0.1, f() * 0.1, f()


@pytest.mark.parametrize("algo", ["grpo", "ppo", "rloo", "reinforce_pp"])
def test_obs_tokens_are_excluded_from_the_actor_loss(algo):
    """Perturbing logprobs, old logprobs and advantages at observation
    positions moves no algorithm's actor loss; the loss equals JAX's."""
    roles, lp, old_lp, adv = _masked_batch()
    rl = RLConfig(algorithm=algo, group_size=2)
    spec = algorithms.get_algorithm(algo)
    t = torch.from_numpy
    obs = t(roles == 2)
    batch = {"old_logprob": t(old_lp), "ref_logprob": t(old_lp) * 0.5,
             "advantages": t(adv), "response_mask": t(roles == 1)}
    base = spec.actor_loss(rl, t(lp), batch)["loss"]
    moved = dict(batch, old_logprob=torch.where(obs, t(old_lp) - 11.0, t(old_lp)),
                 advantages=torch.where(obs, t(adv) + 100.0, t(adv)))
    got = spec.actor_loss(rl, torch.where(obs, t(lp) + 37.0, t(lp)), moved)["loss"]
    assert float(got) == pytest.approx(float(base), rel=1e-6)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    from repro.rl.trainer import RLConfig as JaxRLConfig

    want = jalgorithms.get_algorithm(algo).actor_loss(
        JaxRLConfig(algorithm=algo, group_size=2), jnp.asarray(lp), jbatch)["loss"]
    assert float(base) == pytest.approx(float(want), rel=1e-5, abs=1e-7)


# --------------------------------------------------------------------------- #
# the stack: ExperimentSpec -> pipeline
# --------------------------------------------------------------------------- #
def test_with_env_stage_retargets_the_reward_node_as_jax_does():
    dag = envs.with_env_stage(algorithms.grpo_dag())
    assert "env_compute" in dag.nodes and "reward_compute" not in dag.nodes
    assert dag.nodes["env_compute"].role == Role.ENV
    assert dag.nodes["env_compute"].type == NodeType.COMPUTE
    assert dag.nodes["advantage_compute"].deps == ("env_compute",)
    algorithms.get_algorithm("grpo").validate_dag(dag)
    assert envs.with_env_stage(dag) is dag
    assert dag.to_spec() == jenvs.with_env_stage(jalgorithms.grpo_dag()).to_spec()


def test_experiment_spec_env_round_trips_with_jax():
    jexp = JaxExperimentSpec(
        model=jax_reduced(jax_get_config(ARCH), vocab_size=260),
        rollout=JaxRolloutEngineConfig(engine="continuous", num_slots=4),
        env=JaxEnvConfig(name="calculator", max_turns=3, turn_budget=4))
    d = jexp.to_dict()
    exp = ExperimentSpec.from_dict(d)
    assert exp.env == EnvConfig(name="calculator", max_turns=3, turn_budget=4)
    assert exp.to_dict() == d and ExperimentSpec.from_json(exp.to_json()) == exp
    assert JaxExperimentSpec.from_json(exp.to_json()).to_dict() == d
    del d["env"]
    assert ExperimentSpec.from_dict(d).env == EnvConfig() and not EnvConfig().enabled


def test_multi_turn_needs_the_continuous_engine():
    cfg = reduced(get_config(ARCH), **SMOKE)
    rl = RLConfig(group_size=2, max_new_tokens=4)
    with pytest.raises(ValueError, match="continuous"):
        build_pipeline(cfg, rl, device="cpu", prompts_per_iter=2,
                       env=EnvConfig(name="dialog", max_turns=2))
    with pytest.raises(ValueError, match="single-turn"):
        build_pipeline(cfg, rl, device="cpu", prompts_per_iter=2,
                       rollout=RolloutEngineConfig(engine="continuous"),
                       env=EnvConfig(name="function_reward", max_turns=2))


def test_single_turn_env_through_the_lockstep_pipeline():
    """The ENV stage scores each finished lockstep rollout on the host; on
    the same seed it gives the REWARD stage's rewards."""
    cfg = reduced(get_config(ARCH), **SMOKE)
    rl = RLConfig(group_size=2, max_new_tokens=6, lr=1e-4)
    base = build_pipeline(cfg, rl, device="cpu", prompts_per_iter=4, seed=7)
    with_env = build_pipeline(cfg, rl, device="cpu", prompts_per_iter=4, seed=7,
                              env=EnvConfig(name="function_reward"))
    assert "env_compute" in with_env.plan.order and "reward_compute" not in with_env.plan.order
    m0, m1 = base.worker.run_iteration(), with_env.worker.run_iteration()
    assert m1["reward/mean"] == m0["reward/mean"]
    assert m1["actor/loss"] == m0["actor/loss"]


@pytest.mark.parametrize("env", ["dialog", "calculator"])
def test_multi_turn_pipeline_matches_jax(env):
    """Two greedy GRPO iterations with an env through ExperimentSpec on
    bridged fp32 weights: tokens, rewards, the episode and slot counts and
    ``env/turns_mean`` equal JAX's, the actor's metrics within 2e-5, and the
    observation tokens out of the loss."""
    from test_torch_pipeline import jax_spec

    jexp = dataclasses.replace(
        jax_spec(), rollout=JaxRolloutEngineConfig(engine="continuous", num_slots=4),
        env=JaxEnvConfig(name=env, max_turns=3, turn_budget=3, obs_budget=8))
    (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(jexp)
    fp32_arenas(jpipe, tpipe)
    assert "env_compute" in tpipe.plan.order and tpipe.ctx.env.name == env
    jhist, thist = jpipe.run(2), tpipe.run(2)
    assert_continuous_iterations_match(jhist, thist, jtoks, ttoks)
    for jm, tm in zip(jhist, thist):
        assert tm["env/turns_mean"] == jm["env/turns_mean"]
        assert tm["rollout/turns"] == jm["rollout/turns"] > 16
        assert tm["rollout/cont_refills"] >= 1 and tm["rollout/obs_tokens"] > 0


def test_env_flags_of_the_entry_point(tmp_path):
    """``launch.train --env dialog --max-turns 3 --turn-budget 3`` selects
    the continuous engine's episode loop (one slot a sequence unless
    ``--rollout-slots``), and an iteration reports the env's metrics; the
    dumped spec is JAX's schema."""
    from repro_torch.launch import train

    small = ["--smoke", "--device", "cpu", "--prompts-per-iter", "2", "--group-size", "2",
             "--max-new-tokens", "4"]
    path = tmp_path / "exp.json"
    train.main(small + ["--env", "dialog", "--max-turns", "3", "--turn-budget", "3",
                        "--dump-experiment", str(path)])
    exp = ExperimentSpec.from_json(path.read_text())
    assert exp.env == EnvConfig(name="dialog", max_turns=3, turn_budget=3)
    assert exp.rollout == RolloutEngineConfig(engine="continuous", num_slots=0)
    assert JaxExperimentSpec.from_json(path.read_text()).to_dict() == exp.to_dict()
    out = train.main(["--experiment", str(path), "--device", "cpu", "--iters", "1",
                      "--rollout-slots", "2"])
    m = out["history"][0]
    assert m["env/turns_mean"] == 3.0 and m["rollout/turns"] == 12.0
    assert m["rollout/num_slots"] == 2.0 and "actor/loss" in m
    out = train.main(small + ["--iters", "1", "--env", "function_reward"])
    m = out["history"][0]
    assert "env/turns_mean" not in m and "env_compute" in out["pipeline"].plan.order
    assert all(np.isfinite(v) for v in m.values())
