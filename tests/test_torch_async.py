"""The port's async off-policy pipeline (``repro_torch.core.async_worker``
and the version store of ``repro_torch.distributed.weight_sync``) on the
CPU, mirroring ``tests/test_async_pipeline.py``, and against the JAX
package's pipeline.

The model is the reduced gemma-2b of ``tests/test_torch_pipeline.py``. The
JAX comparisons run both pipelines greedy on the JAX pipeline's initial
weights bridged as fp32 with the EOS row scaled (``bridged_pair``).

Tolerances: ``max_staleness=0`` and a disabled config are bitwise equal to
the synchronous worker (metrics, rollouts and the final weights); against
JAX, tokens, rewards and every count of the scheduler (staleness, weight
version, correction flag, inflight depth) are equal, and the actor's
metrics agree within 2e-5 (fp32). The truncated-IS weights equal a hand
computation and JAX's within 1e-6.
"""
import contextlib
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxExperimentSpec
from repro.configs import AsyncPipelineConfig as JaxAsyncPipelineConfig
from repro.rl import algorithms as jalgorithms
from repro.rl import trainer as jtrainer
from repro_torch import tree
from repro_torch.api import ExperimentSpec
from repro_torch.configs import (
    AsyncPipelineConfig,
    DataCoordinatorConfig,
    get_config,
    reduced,
)
from repro_torch.core import DAG, Node, NodeType, Role, build_pipeline
from repro_torch.core.async_worker import AsyncDAGWorker, PipelinedDAGWorker
from repro_torch.distributed.weight_sync import WeightVersionStore
from repro_torch.launch import train
from repro_torch.rl import RLConfig, algorithms, trainer
from repro_torch.rl import loss as losses
from repro_torch.rl.rollout import generate
from test_torch_pipeline import (
    SMOKE,
    assert_iterations_match,
    bridged_pair,
    jax_spec,
    record_rollouts,
)

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

# the scheduler's counts: equal to JAX's; the other async/* keys are clock
# readings
ASYNC_COUNTS = ("async/staleness", "async/weight_version", "async/is_corrected",
                "async/inflight", "pipeline/staleness")


def small_cfg():
    return reduced(get_config("gemma-2b"), **SMOKE)


def pipe_of(rl, window=None, **kw):
    """A port pipeline; ``window`` enables the async scheduler at that
    staleness bound."""
    if window is not None:
        kw["async_pipeline"] = AsyncPipelineConfig(enabled=True, max_staleness=window)
    return build_pipeline(small_cfg(), rl, device="cpu", **kw)


def value_keys(history):
    """Every metric that carries a value: timing and the scheduler's own
    accounting differ by construction."""
    return [{k: v for k, v in m.items()
             if not k.startswith(("time/", "async/")) and k != "pipeline/staleness"}
            for m in history]


@contextlib.contextmanager
def registered(spec, jspec):
    """Register an algorithm variant in both packages for one test."""
    algorithms.register_algorithm(spec, override=True)
    jalgorithms.register_algorithm(jspec, override=True)
    try:
        yield
    finally:
        algorithms._ALGORITHMS.pop(spec.name)
        jalgorithms._ALGORITHMS.pop(jspec.name)


def tis_variant(name):
    return (dataclasses.replace(algorithms.get_algorithm("grpo"), name=name,
                                is_correction="truncated"),
            dataclasses.replace(jalgorithms.get_algorithm("grpo"), name=name,
                                is_correction="truncated"))


# --------------------------------------------------------------------------- #
# max_staleness=0 (and a disabled config) are bitwise the synchronous worker
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("algo", ["grpo", "ppo"])
def test_staleness0_and_disabled_are_bitwise_the_sync_worker(algo):
    """Sampled, with an entropy bonus so that every step moves the weights:
    metrics, rollouts and the final actor weights are bit for bit the sync
    worker's."""
    rl = RLConfig(algorithm=algo, group_size=4, max_new_tokens=6, lr=1e-3, critic_lr=1e-3,
                  entropy_coef=0.01)
    runs = {}
    for arm, kw in {"sync": {}, "disabled": dict(async_pipeline=AsyncPipelineConfig()),
                    "s0": dict(window=0)}.items():
        pipe = pipe_of(rl, prompts_per_iter=4, seed=3, **kw)
        toks = record_rollouts(pipe, lambda t: t.clone())
        runs[arm] = (pipe, toks, value_keys(pipe.run(3)))
    sync, toks0, hist0 = runs["sync"]
    assert not isinstance(runs["disabled"][0].worker, AsyncDAGWorker)
    assert isinstance(runs["s0"][0].worker, AsyncDAGWorker)
    assert all(m["actor/grad_norm"] > 0 for m in hist0)
    for arm, (pipe, toks, hist) in runs.items():
        assert hist == hist0, arm  # exact, not approx
        assert all(torch.equal(a, b) for a, b in zip(toks, toks0)), arm
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(pipe.ctx.actor_state.params), tree.leaves(sync.ctx.actor_state.params)))
    assert runs["s0"][0].worker.weights.version == 3


def test_async_refuses_the_centralized_baseline():
    with pytest.raises(ValueError, match="centralized"):
        pipe_of(RLConfig(group_size=2, max_new_tokens=4), window=1, centralized=True)


def test_async_refuses_post_train_nodes():
    """The gen/train split keeps the order only when MODEL_TRAIN closes the
    chain; a post-update node fails fast, and the same DAG still runs on the
    synchronous worker."""
    dag = DAG.from_nodes([
        Node("actor_generation", Role.ACTOR, NodeType.GENERATE),
        Node("reward_compute", Role.REWARD, NodeType.COMPUTE, deps=("actor_generation",)),
        Node("advantage_compute", Role.ADVANTAGE, NodeType.COMPUTE, deps=("reward_compute",)),
        Node("actor_train", Role.ACTOR, NodeType.MODEL_TRAIN, deps=("advantage_compute",)),
        Node("post_update_logprobs", Role.ACTOR, NodeType.MODEL_INFERENCE,
             deps=("actor_train",)),
    ])
    rl = RLConfig(group_size=2, max_new_tokens=4)
    with pytest.raises(ValueError, match="post_update_logprobs"):
        pipe_of(rl, window=1, prompts_per_iter=2, dag=dag)
    pipe_of(rl, prompts_per_iter=2, dag=dag)


# --------------------------------------------------------------------------- #
# the staleness bound under a stalled trainer
# --------------------------------------------------------------------------- #
def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


@pytest.mark.parametrize("window", [0, 1, 2])
def test_staleness_bound_holds_with_a_stalled_trainer(window):
    """Generation stalls at the gate once the queue is window+1 deep, so a
    trainer that stops consuming never sees a batch staler than the bound;
    each consume frees one dispatch. The gate counts, it does not time."""
    w = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3), window=window,
                prompts_per_iter=2, seed=2).worker
    w.clock = _fake_clock()
    for _ in range(window + 1):
        assert w.dispatch_generation({}) is not None
    stalled = {}
    assert w.dispatch_generation(stalled) is None
    assert stalled["async/gen_stalled"] == 1.0 and len(w._inflight) == window + 1
    seen = []
    while w._inflight:
        m = {}
        assert w.consume_and_train(m) is not None
        seen.append(m["async/staleness"])
        assert m["async/t_train"] == 1.0  # one tick of the fake clock
    assert seen == list(range(window + 1)) and max(seen) <= window
    assert w.dispatch_generation({}) is not None  # the gate reopens
    assert w.weights.version == len(seen)


def test_steady_state_runs_at_the_configured_staleness():
    hist = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3), window=2,
                   prompts_per_iter=2, seed=5).run(5)
    assert "actor/loss" not in hist[0] and "actor/loss" not in hist[1]
    assert [m["async/staleness"] for m in hist[2:]] == [0.0, 1.0, 2.0]
    assert [m["async/weight_version"] for m in hist[2:]] == [1.0, 2.0, 3.0]
    assert hist[4]["async/overlap_ratio"] > 0.0 and hist[4]["pipeline/staleness"] == 2.0


def test_one_step_overlap_warmup_and_double_buffer():
    pipe = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3), window=1,
                   prompts_per_iter=4, seed=4,
                   coordinator=DataCoordinatorConfig(double_buffer=True, prefetch=1))
    hist = pipe.run(4)
    assert "actor/loss" not in hist[0] and hist[0]["async/overlap_ratio"] == 0.0
    assert "actor/loss" in hist[1]
    for m in hist[2:]:
        assert m["async/staleness"] == 1.0 and m["async/overlap_s"] > 0.0
        assert 0.0 < m["async/overlap_ratio"] <= 0.5  # min / (gen + train)
    assert pipe.buffer.stats.rotations == 4


def test_pipelined_worker_is_the_staleness1_scheduler():
    pipe = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3), prompts_per_iter=2,
                   seed=7)
    pipe.worker = PipelinedDAGWorker(pipe.ctx, pipe.plan, pipe.worker.registry, pipe.buffer)
    assert isinstance(pipe.worker, AsyncDAGWorker) and pipe.worker.max_staleness == 1
    hist = pipe.run(3)
    assert "actor/loss" not in hist[0] and "actor/loss" in hist[1]
    assert hist[2]["pipeline/staleness"] == 1.0


# --------------------------------------------------------------------------- #
# the version store: monotone tags, and copies no in-place step can change
# --------------------------------------------------------------------------- #
def test_version_store_publishes_monotone_copies():
    params = {"w": torch.arange(8.0).reshape(2, 4), "b": torch.ones(4).t()}
    store = WeightVersionStore()
    assert store.version == -1 and store.current is None
    v0 = store.publish(params)
    assert v0.version == 0 and store.current is v0
    for a, b in zip(tree.leaves(params), tree.leaves(v0.params)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr() and a.stride() == b.stride()
    params["w"].add_(1.0)  # an in-place step on the live weights
    assert v0.params["w"][0, 0] == 0.0
    with pytest.raises(ValueError, match="monotone"):
        store.publish(params, version=0)
    store.publish(params, version=5)  # gaps are fine (skipped publishes)
    assert store.version == 5 and store.current.params["w"][0, 0] == 1.0
    assert store.publish(None).params is None and store.version == 6
    # the train -> serve reshard rides along when a mesh is given, as in JAX
    with pytest.raises(ValueError, match="target_specs requires a mesh"):
        store.publish(params, target_specs={})
    from repro_torch.core.databuffer import DeviceMesh

    v7 = store.publish(params, mesh=DeviceMesh("cpu"), target_specs={"w": ("data", None),
                                                                     "b": (None,)})
    assert v7.version == 7 and torch.equal(v7.params["w"], params["w"])
    assert v7.params["w"].data_ptr() != params["w"].data_ptr()


def test_pipeline_weight_versions_track_updates_as_copies():
    pipe = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3, entropy_coef=0.01),
                   window=1, prompts_per_iter=2, seed=1)
    hist = pipe.run(4)
    assert [m.get("async/weight_version") for m in hist] == [None, 1.0, 2.0, 3.0]
    assert pipe.worker.weights.version == 3
    live, pub = pipe.ctx.actor_state.params, pipe.worker.weights.current.params
    for a, b in zip(tree.leaves(live), tree.leaves(pub)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_in_place_steps_never_reach_the_published_weights():
    """AdamW writes the live weights in place. After a consume at
    max_staleness=1 the published version keeps its bytes through a later
    step, and the next dispatch generates under that copy: its rollout is
    a ``generate`` on a clone of the published weights, not on the live
    weights that the later step changed."""
    rl = RLConfig(group_size=2, max_new_tokens=4, lr=1e-2, entropy_coef=0.01)
    pipe = pipe_of(rl, window=1, prompts_per_iter=2, seed=13)
    w, ctx = pipe.worker, pipe.ctx
    w.dispatch_generation({})
    batch = w.dispatch_generation({})
    w.consume_and_train({})  # trains the first batch, publishes version 1
    published = w.weights.current
    saved = tree.map(torch.clone, published.params)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(saved),
                                                 tree.leaves(ctx.actor_state.params)))
    # a step the scheduler has not published yet: the trainer running ahead
    data = dict(batch.data)
    data["advantages"] = torch.ones_like(data["old_logprob"])
    data["ref_logprob"] = data["old_logprob"]
    ctx.actor_state, _ = ctx.engines["actor_step"](ctx.actor_state, data)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(saved),
                                                 tree.leaves(published.params)))
    assert not all(torch.equal(a, b) for a, b in zip(tree.leaves(saved),
                                                     tree.leaves(ctx.actor_state.params)))
    state = ctx.gen.get_state()
    pending = w.dispatch_generation({})
    assert pending.behavior_version == 1
    prompts = pending.data["tokens"][:, :-rl.max_new_tokens]

    def rollout(params):
        return generate(_model(pipe), params, prompts, torch.Generator().set_state(state),
                        max_new=rl.max_new_tokens, temperature=rl.temperature,
                        eos_id=ctx.tokenizer.eos_id, pad_id=ctx.tokenizer.pad_id)

    want, live = rollout(saved), rollout(ctx.actor_state.params)
    assert torch.equal(pending.data["tokens"], want.tokens)
    assert torch.equal(pending.data["old_logprob"], want.old_logprob)
    assert not torch.equal(want.old_logprob, live.old_logprob)


def _model(pipe):
    """The pipeline's model (the lockstep generate engine's closure holds it)."""
    cells = {c.cell_contents for c in pipe.ctx.engines["generate"].__closure__
             if hasattr(c.cell_contents, "logprobs")}
    (model,) = cells
    return model


def test_resume_replaces_the_behaviour_policy_before_the_first_publish():
    """ctx.actor_state replaced after build_pipeline (a checkpoint resume):
    the first dispatch publishes, and generates under, the restored
    weights."""
    pipe = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3), window=1,
                   prompts_per_iter=2, seed=9)
    restored = trainer.init_state(tree.map(lambda t: t * 0.5, pipe.ctx.actor_state.params))
    pipe.ctx.actor_state = restored
    assert pipe.worker.dispatch_generation({}) is not None
    assert pipe.worker.weights.version == 0
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(pipe.worker.weights.current.params), tree.leaves(restored.params)))
    assert pipe.ctx.actor_state is restored


# --------------------------------------------------------------------------- #
# the decoupled truncated-IS correction
# --------------------------------------------------------------------------- #
def test_truncated_is_correction_matches_a_hand_reference_and_jax():
    rng = np.random.default_rng(0)
    B, T = 4, 6
    f = lambda *a: rng.normal(*a, (B, T)).astype(np.float32)  # noqa: E731
    mask = rng.integers(0, 2, (B, T)).astype(np.float32)
    old_lp, behavior_lp, adv = f(-1.0, 0.5), f(-1.0, 0.5), f(0.0, 1.0)
    spec, jspec = tis_variant("grpo_tis_ref")
    batch = {"old_logprob": old_lp, "behavior_logprob": behavior_lp, "advantages": adv,
             "response_mask": mask}
    out, metrics = trainer.apply_is_correction(
        RLConfig(is_rho_max=1.5), spec, {k: torch.from_numpy(v) for k, v in batch.items()})
    rho = np.minimum(np.exp(old_lp - behavior_lp), 1.5)
    np.testing.assert_allclose(out["advantages"].numpy(), adv * rho * mask, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["rho_mean"]), (rho * mask).sum() / mask.sum(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics["rho_clipfrac"]),
                               ((np.exp(old_lp - behavior_lp) > 1.5) * mask).sum() / mask.sum(),
                               rtol=1e-6)
    jout, jmetrics = jtrainer.apply_is_correction(
        jtrainer.RLConfig(is_rho_max=1.5), jspec, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["advantages"].numpy(), np.asarray(jout["advantages"]),
                               rtol=1e-6)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6)
    plain = {k: torch.from_numpy(v) for k, v in batch.items() if k != "behavior_logprob"}
    assert trainer.apply_is_correction(RLConfig(), spec, plain)[0] is plain
    assert trainer.apply_is_correction(RLConfig(), algorithms.get_algorithm("grpo"),
                                       batch)[0] is batch


def test_truncated_is_weights_are_bounded():
    behav = torch.tensor([[0.0, -10.0, 10.0]] * 2)
    rho = losses.truncated_is_weights(torch.zeros(2, 3), behav, torch.ones(2, 3),
                                      rho_max=2.0)["rho"]
    assert rho.max() <= 2.0 and rho.min() >= 0.0
    np.testing.assert_allclose(rho[0].numpy(), [1.0, 2.0, np.exp(-10.0)], rtol=1e-5)


def test_truncated_is_applies_only_to_stale_batches():
    spec, jspec = tis_variant("grpo_tis_e2e")
    rl = RLConfig(group_size=4, max_new_tokens=6, lr=1e-3, entropy_coef=0.01)
    with registered(spec, jspec):
        hist = pipe_of(rl, window=1, prompts_per_iter=4, seed=0, algorithm=spec).run(4)
    assert hist[1]["async/staleness"] == 0.0 and hist[1]["async/is_corrected"] == 0.0
    assert "actor/rho_mean" not in hist[1]
    for m in hist[2:]:
        assert m["async/is_corrected"] == 1.0 and 0.0 < m["actor/rho_mean"] <= rl.is_rho_max
        assert np.isfinite(m["actor/loss"])


def test_decoupled_driving_never_leaks_behavior_logprob():
    """A corrected consume under the decoupled API (no per-tick clear) must
    not leave behavior_logprob in the buffer for the next dispatch to pack
    into an unrelated batch."""
    spec, jspec = tis_variant("grpo_tis_leak")
    with registered(spec, jspec):
        w = pipe_of(RLConfig(group_size=2, max_new_tokens=4, lr=1e-3), window=1,
                    prompts_per_iter=2, seed=11, algorithm=spec).worker
        assert w.dispatch_generation({}) is not None
        assert w.dispatch_generation({}) is not None
        assert w.consume_and_train({}) is not None  # staleness 0
        m = {}
        assert w.consume_and_train(m) is not None  # staleness 1: corrected
        assert m["async/is_corrected"] == 1.0
        assert "behavior_logprob" not in w.buffer.keys()
        fresh = w.dispatch_generation({})
        assert fresh is not None and "behavior_logprob" not in fresh.data


# --------------------------------------------------------------------------- #
# against the JAX pipeline
# --------------------------------------------------------------------------- #
def _assert_async_matches(jhist, thist, jtoks, ttoks):
    assert_iterations_match(jhist, thist, jtoks, ttoks)
    for it, (jm, tm) in enumerate(zip(jhist, thist)):
        for k in ASYNC_COUNTS:
            assert tm.get(k) == jm.get(k), (it, k)


@pytest.mark.parametrize("window", [1, 2])
def test_async_grpo_matches_jax(window):
    """4 greedy GRPO ticks with the entropy bonus (the weights move): the
    same warm-up, the same staleness and versions, tokens equal, the actor's
    metrics within 2e-5."""
    jexp = dataclasses.replace(jax_spec(entropy_coef=0.01), async_pipeline=(
        JaxAsyncPipelineConfig(enabled=True, max_staleness=window)))
    (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(jexp)
    assert isinstance(tpipe.worker, AsyncDAGWorker) and tpipe.worker.max_staleness == window
    jhist, thist = jpipe.run(4), tpipe.run(4)
    _assert_async_matches(jhist, thist, jtoks, ttoks)
    assert [m.get("async/staleness") for m in thist][window:] == \
        [float(min(i, window)) for i in range(4 - window)]
    assert thist[-1]["actor/kl"] > 0


def test_async_truncated_is_matches_jax():
    """The truncated correction at max_staleness=1: the recomputed
    old_logprob and the IS weights give JAX's metrics within 2e-5."""
    spec, jspec = tis_variant("grpo_tis_parity")
    with registered(spec, jspec):
        jexp = dataclasses.replace(
            jax_spec(entropy_coef=0.01, algorithm="grpo_tis_parity"),
            async_pipeline=JaxAsyncPipelineConfig(enabled=True, max_staleness=1))
        (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(jexp)
        jhist, thist = jpipe.run(4), tpipe.run(4)
    _assert_async_matches(jhist, thist, jtoks, ttoks)
    assert [m.get("async/is_corrected") for m in thist] == [None, 0.0, 1.0, 1.0]
    assert all(0.0 < m["actor/rho_mean"] <= 2.0 for m in thist[2:])


# --------------------------------------------------------------------------- #
# ExperimentSpec and launch.train
# --------------------------------------------------------------------------- #
def test_experiment_spec_round_trips_async_with_jax():
    jexp = dataclasses.replace(jax_spec(), async_pipeline=JaxAsyncPipelineConfig(
        enabled=True, max_staleness=2))
    d = jexp.to_dict()
    exp = ExperimentSpec.from_dict(d)
    assert exp.async_pipeline == AsyncPipelineConfig(enabled=True, max_staleness=2)
    assert exp.to_dict() == d and ExperimentSpec.from_json(exp.to_json()) == exp
    assert JaxExperimentSpec.from_json(exp.to_json()).to_dict() == d
    pipe = exp.compile(device="cpu")
    assert isinstance(pipe.worker, AsyncDAGWorker) and pipe.worker.max_staleness == 2
    del d["async_pipeline"]
    assert ExperimentSpec.from_dict(d).async_pipeline == AsyncPipelineConfig()


def test_max_staleness_flag_overrides_an_experiment_file(tmp_path):
    base, path = tmp_path / "base.json", tmp_path / "exp.json"
    small = ["--smoke", "--device", "cpu", "--prompts-per-iter", "2", "--group-size", "2",
             "--max-new-tokens", "4"]
    train.main(small + ["--dump-experiment", str(base)])
    assert json.loads(base.read_text())["async_pipeline"] == {"enabled": False,
                                                               "max_staleness": 0}
    train.main(["--experiment", str(base), "--max-staleness", "1", "--dump-experiment",
                str(path)])
    assert json.loads(path.read_text())["async_pipeline"] == {"enabled": True,
                                                               "max_staleness": 1}
    out = train.main(["--experiment", str(base), "--device", "cpu", "--iters", "3",
                      "--max-staleness", "1"])
    assert isinstance(out["pipeline"].worker, AsyncDAGWorker)
    assert [m.get("async/staleness") for m in out["history"]] == [None, 0.0, 1.0]
    out = train.main(["--experiment", str(base), "--device", "cpu", "--iters", "1"])
    assert not isinstance(out["pipeline"].worker, AsyncDAGWorker)
