"""The port's GRPO/PPO pipeline (``ExperimentSpec`` -> ``build_pipeline`` ->
``DAGWorker`` over the databuffer) against the JAX package's on the CPU, its
coordinator arms against each other, and the ``launch.train`` entry point.

The model is the reduced gemma-2b of ``tests/test_torch_rl.py`` (padded heads
and vocab), and for the greedy GRPO iterations also a reduced mamba2. The port's spec is the JAX spec's ``to_dict()`` loaded back. The
JAX pipeline's own initial weights are bridged into the port as fp32 (the
JAX pipeline is switched to fp32 too), with the EOS row of the tied
embedding scaled by ``EOS_SCALE`` in both, so that some greedy rollouts end
early and the response masks, rewards and the balancer see ragged lengths.

Tolerances: tokens, rewards, rollout counts and ``BufferStats`` counts are
equal; the actor and critic metrics agree within 2e-5 (the fp32 tolerance of
``tests/test_torch_rl.py``); the coordinator arms of the port are bitwise
equal to each other.

The continuous rollout engine runs in both pipelines on fp32 cache arenas
(:func:`fp32_arenas`, ``tests/torch_arena.py``): the JAX engine's arena is
bf16, on which fp32 weights cannot run its decode ``while_loop``. Its slot
counts (``rollout/*``) are equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxExperimentSpec
from repro.configs import DataCoordinatorConfig as JaxCoordinatorConfig
from repro.configs import RolloutEngineConfig as JaxRolloutEngineConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.rl import trainer as jtrainer
from repro_torch import bridge
from repro_torch.api import ExperimentSpec
from repro_torch.configs import (
    DataCoordinatorConfig,
    DistributedConfig,
    RolloutEngineConfig,
    get_config,
    reduced,
)
from repro_torch.core import DAG, Node, NodeType, Role, build_pipeline, default_registry, stages
from repro_torch.launch import train
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.rl import trainer
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine
from torch_arena import Recorded, fp32_arena, jax_fp32_arena

# tiny CPU shapes run best on one intra-op thread: torch's default pool
# spins against the other test processes and slows every test severalfold
torch.set_num_threads(1)

SMOKE = dict(vocab_size=260, num_layers=2, pad_heads_to=8)
EOS_ID, EOS_SCALE = 2, 3.0
ITERS = 3
TOL = 2e-5
RL_CASES = {
    "plain": {},
    # an entropy bonus gives the greedy GRPO step a gradient (the advantages
    # of identical greedy groups are 0), so the weights move and the KL
    # against the reference is nonzero from iteration 1
    "entropy_bonus": {"entropy_coef": 0.01},
}


# the SSD family's case: reduced mamba2 (2 SSD layers, the scan under
# autograd in every actor step) with the entropy bonus
SSM_CASE = ("mamba2", "mamba2-2.7b", dict(vocab_size=260, num_layers=2))


def jax_spec(arch="gemma-2b", model_kw=SMOKE, **kw):
    rl = dict(temperature=0.0, group_size=4, max_new_tokens=4, lr=1e-3)
    rl.update(kw)
    return JaxExperimentSpec(model=jax_reduced(jax_get_config(arch), **model_kw),
                             rl=jtrainer.RLConfig(**rl), prompts_per_iter=4)


def counts(stats):
    return {**dataclasses.asdict(stats), "max_host_inbound_bytes": stats.max_host_inbound_bytes}


def record_rollouts(pipe, np_of):
    """Wrap the pipeline's generate engine to keep each iteration's tokens."""
    rec = pipe.ctx.engines["generate"] = Recorded(pipe.ctx.engines["generate"], np_of)
    return rec.seen


def fp32_arenas(jpipe, tpipe):
    """Give both pipelines' continuous engines an fp32 cache arena."""
    jeng, teng = (p.ctx.engines["generate"].engine for p in (jpipe, tpipe))
    jeng.model, teng.model = jax_fp32_arena(jeng.model), fp32_arena(teng.model)


# rollout/* keys that move with the host clock
CLOCK_KEYS = {"wall_s", "tokens_per_s"}


def assert_continuous_iterations_match(jhist, thist, jtoks, ttoks):
    """The continuous engine's iterations: the JAX stage's metrics, tokens
    equal, every count of the slot schedule and of the episodes equal, the
    actor's metrics at 2e-5."""
    clock = {f"rollout/{k}" for k in CLOCK_KEYS}
    for it, (jm, tm) in enumerate(zip(jhist, thist)):
        assert set(tm) == set(jm), it
        np.testing.assert_array_equal(ttoks[it], jtoks[it])
        for k in tm:
            if k.startswith(("rollout/", "reward/")) and k not in clock:
                assert tm[k] == jm[k], (it, k)
            elif k.startswith("actor/"):
                np.testing.assert_allclose(tm[k], jm[k], atol=TOL, rtol=TOL, err_msg=f"{it} {k}")
    assert len(thist) == len(jhist) == len(ttoks) == len(jtoks)


def bridged_pair(jexp, *, critic=False):
    """(JAX pipeline, port pipeline) on the JAX pipeline's initial weights,
    EOS-scaled, in fp32, each recording its rollouts."""
    jpipe = jexp.compile()
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), jpipe.ctx.actor_state.params)
    params["embed"][EOS_ID] *= EOS_SCALE
    fp32 = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jpipe.ctx.actor_state = jtrainer.init_state(fp32(params))
    jpipe.ctx.ref_params = fp32(params)
    tpipe = ExperimentSpec.from_dict(jexp.to_dict()).compile(device="cpu")
    to_port = lambda t: bridge.from_jax(t, device="cpu", dtype=torch.float32)  # noqa: E731
    tpipe.ctx.actor_state = trainer.init_state(to_port(params))
    tpipe.ctx.ref_params = to_port(params)
    if critic:
        cparams = jax.tree.map(lambda a: np.asarray(a, np.float32),
                               jpipe.ctx.critic_state.params)
        jpipe.ctx.critic_state = jtrainer.init_state(fp32(cparams))
        tpipe.ctx.critic_state = trainer.init_state(to_port(cparams))
    return (jpipe, record_rollouts(jpipe, np.asarray)), \
        (tpipe, record_rollouts(tpipe, lambda t: t.numpy()))


def assert_iterations_match(jhist, thist, jtoks, ttoks, *, roles=("actor",)):
    assert len(jhist) == len(thist) == len(jtoks) == len(ttoks)
    for it, (jm, tm) in enumerate(zip(jhist, thist)):
        assert set(tm) == set(jm), it
        np.testing.assert_array_equal(ttoks[it], jtoks[it])
        for k in ("reward/mean", "rollout/tokens", "rollout/mean_len"):
            assert tm[k] == jm[k], (it, k)
        for role in roles:
            for k in [k for k in jm if k.startswith(role + "/")]:
                np.testing.assert_allclose(tm[k], jm[k], atol=TOL, rtol=TOL, err_msg=f"{it} {k}")


@pytest.fixture(scope="module", params=[*sorted(RL_CASES), SSM_CASE[0]])
def greedy(request):
    """3 greedy GRPO iterations of each package; in the plain case a 4th
    with the length-aware load balancer on (2 buckets)."""
    if request.param == SSM_CASE[0]:
        jexp = jax_spec(SSM_CASE[1], SSM_CASE[2], **RL_CASES["entropy_bonus"])
    else:
        jexp = jax_spec(**RL_CASES[request.param])
    (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(jexp)
    out = {"case": request.param, "jexp": jexp, "jhist": jpipe.run(ITERS),
           "thist": tpipe.run(ITERS), "jtoks": jtoks, "ttoks": ttoks,
           "jstats": counts(jpipe.buffer.stats), "tstats": counts(tpipe.buffer.stats)}
    if request.param == "plain":
        jpipe.worker.coordinator = JaxCoordinatorConfig(load_balance=True, num_buckets=2)
        tpipe.worker.coordinator = DataCoordinatorConfig(load_balance=True, num_buckets=2)
        out["jbal"], out["tbal"] = jpipe.worker.run_iteration(), tpipe.worker.run_iteration()
        out["jbal_stats"], out["tbal_stats"] = counts(jpipe.buffer.stats), \
            counts(tpipe.buffer.stats)
    return out


def test_greedy_grpo_iterations_match_jax(greedy):
    """3 greedy iterations (gemma-2b, and mamba2 with the entropy bonus);
    in the plain case then a 4th with the load balancer, whose repack
    reorders rows, so its loss is not held bitwise (under greedy GRPO it is
    0 in both): its balance metrics are the JAX worker's."""
    assert_iterations_match(greedy["jhist"], greedy["thist"], greedy["jtoks"][:ITERS],
                            greedy["ttoks"][:ITERS])
    assert greedy["tstats"] == greedy["jstats"]
    assert greedy["tstats"]["redistributions"] == 5 * ITERS
    assert greedy["tstats"]["bytes_moved"] == 0
    lens = [m["rollout/mean_len"] for m in greedy["thist"]]
    assert min(lens) < 4.0  # EOS_SCALE: some rollouts end early
    if greedy["case"] != "plain":
        assert all(m["actor/grad_norm"] > 0 for m in greedy["thist"])
        # the weights moved: the 3 steps of the reduced mamba2 (2 layers,
        # no MLPs) move its policy about a tenth as far as gemma's
        assert greedy["thist"][-1]["actor/kl"] > (1e-3 if greedy["case"] == "entropy_bonus"
                                                  else 1e-4)
        return
    jm, tm = greedy["jbal"], greedy["tbal"]
    assert set(tm) == set(jm)
    bal = {k: v for k, v in tm.items() if k.startswith("balance/")}
    assert bal == {k: v for k, v in jm.items() if k.startswith("balance/")}
    assert bal["balance/repacked"] == 1.0
    assert bal["balance/token_ratio_after"] < bal["balance/token_ratio_before"]
    np.testing.assert_array_equal(greedy["ttoks"][ITERS], greedy["jtoks"][ITERS])
    assert tm["reward/mean"] == jm["reward/mean"]
    assert greedy["tbal_stats"] == greedy["jbal_stats"]


def test_ppo_iteration_with_the_critic_matches_jax():
    jexp = jax_spec(algorithm="ppo", critic_lr=1e-3)
    (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(jexp, critic=True)
    jhist, thist = jpipe.run(1), tpipe.run(1)
    assert_iterations_match(jhist, thist, jtoks, ttoks, roles=("actor", "critic"))
    assert "critic/loss" in thist[0] and thist[0]["actor/grad_norm"] > 0
    assert counts(tpipe.buffer.stats) == counts(jpipe.buffer.stats)


# --------------------------------------------------------------------------- #
# ExperimentSpec: the JAX schema in both directions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("extra", ["default", "coordinator", "dag_and_mesh"])
def test_experiment_spec_round_trips_with_jax(extra):
    jexp = jax_spec()
    if extra == "coordinator":
        jexp = dataclasses.replace(jexp, centralized=True, seed=5, coordinator=(
            JaxCoordinatorConfig(double_buffer=True, prefetch=2, load_balance=True)))
    elif extra == "dag_and_mesh":
        from repro.rl import algorithms as jalgos

        jexp = dataclasses.replace(jexp, mesh_shape=(1, 1), dag=jalgos.ppo_dag().to_spec())
    d = jexp.to_dict()
    exp = ExperimentSpec.from_dict(d)
    assert exp.to_dict() == d
    assert ExperimentSpec.from_json(exp.to_json()) == exp
    assert JaxExperimentSpec.from_json(exp.to_json()).to_dict() == d


# --------------------------------------------------------------------------- #
# the coordinator arms (paper Fig. 14 invariant), sampled, port only
# --------------------------------------------------------------------------- #
ARMS = {"distributed": dict(),
        "double_buffer_prefetch": dict(coordinator=DataCoordinatorConfig(double_buffer=True,
                                                                         prefetch=1)),
        "centralized": dict(centralized=True)}


@pytest.mark.parametrize("algo", ["grpo", "ppo"])
def test_coordinator_arms_are_bitwise_identical(algo):
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    # the entropy bonus gives the actor a gradient even where every reward
    # is 0, so the weights move and the arms are compared on moving weights
    rl = trainer.RLConfig(algorithm=algo, group_size=4, max_new_tokens=4, lr=1e-3,
                          critic_lr=1e-3, entropy_coef=0.01)
    runs = {}
    for arm, kw in ARMS.items():
        pipe = build_pipeline(cfg, rl, device="cpu", prompts_per_iter=4, seed=3, **kw)
        toks = record_rollouts(pipe, lambda t: t.clone())
        hist = pipe.run(ITERS)
        runs[arm] = (pipe, toks, [{k: v for k, v in m.items() if not k.startswith("time/")}
                                  for m in hist])
    _, toks0, hist0 = runs["distributed"]
    assert all(m["actor/grad_norm"] > 0 for m in hist0)
    if algo == "grpo":  # PPO's DAG has no reference model
        assert all(m["actor/kl"] > 0 for m in hist0[1:])
    for arm, (pipe, toks, hist) in runs.items():
        assert hist == hist0, arm  # exact, not approx
        assert all(torch.equal(a, b) for a, b in zip(toks, toks0)), arm
    assert len({tuple(row.tolist()) for row in toks0[0]}) > 1  # sampled, not greedy
    dist, db, cen = (runs[a][0] for a in ARMS)
    assert dist.buffer.stats.bytes_through_controller == 0
    assert cen.buffer.stats.bytes_through_controller > 0
    assert cen.buffer.controller_resident_bytes > 0
    assert db.ctx.dataloader.prefetch_hits == ITERS - 1
    # after the recording pass every reshard is staged ahead of its get
    db.buffer.stats.reset()
    db.run(ITERS)
    s = db.buffer.stats
    assert s.overlap_hits >= ITERS and s.sync_waits == 0 and s.rotations == ITERS


def test_generate_stage_hands_on_ordinary_tensors_and_skips_are_reported():
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    rl = trainer.RLConfig(group_size=2, max_new_tokens=4, lr=1e-3)
    pipe = build_pipeline(cfg, rl, device="cpu", prompts_per_iter=4, seed=0,
                          coordinator=DataCoordinatorConfig(load_balance=True, num_buckets=3))
    stages.actor_generate(pipe.ctx, pipe.buffer, pipe.dag.nodes["actor_generation"])
    for key in ("tokens", "response_mask", "old_logprob", "answers"):
        assert not pipe.buffer.get(key).is_inference(), key
    assert pipe.buffer.get("tokens").shape == (8, 6 + 4)
    pipe.buffer.clear()
    m = pipe.run(1)[-1]  # 8 rollouts -> 4 groups, 4 % 3 != 0
    assert m.get("balance/skipped") == 1.0 and "balance/token_ratio_before" not in m
    assert pipe.ctx.gen.device.type == "cpu"


# --------------------------------------------------------------------------- #
# custom DAGs and the registry (paper §4-5)
# --------------------------------------------------------------------------- #
def length_penalty_reward(ctx, buffer, node):
    """Blend the math reward with a brevity bonus: r + 0.05 * (1 - len/max)."""
    spec = (tuple(ctx.mesh.axis_names),)
    mask = buffer.get("response_mask", spec)
    r = buffer.get("rewards", spec)
    shaped = r + 0.05 * (1.0 - mask.float().sum(dim=1) / ctx.rl.max_new_tokens)
    buffer.put("rewards", shaped, spec)
    return {"reward/shaped_mean": float(shaped.mean())}


def _no_ref_dag(with_penalty: bool) -> DAG:
    nodes = [Node("actor_generation", Role.ACTOR, NodeType.GENERATE),
             Node("reward_compute", Role.REWARD, NodeType.COMPUTE, deps=("actor_generation",))]
    last = "reward_compute"
    if with_penalty:
        nodes.append(Node("length_penalty", Role.REWARD, NodeType.MODEL_INFERENCE,
                          deps=(last,)))
        last = "length_penalty"
    nodes += [Node("advantage_compute", Role.ADVANTAGE, NodeType.COMPUTE, deps=(last,)),
              Node("actor_train", Role.ACTOR, NodeType.MODEL_TRAIN, deps=("advantage_compute",))]
    return DAG.from_nodes(nodes)


SMALL = ["--smoke", "--device", "cpu", "--prompts-per-iter", "2", "--group-size", "4",
         "--max-new-tokens", "6"]


def test_custom_dag_from_json_with_a_registry_override(tmp_path):
    path = tmp_path / "dag.json"
    path.write_text(_no_ref_dag(with_penalty=True).to_json())
    args = SMALL + ["--iters", "2", "--dag-json", str(path)]
    with pytest.raises(KeyError, match="Registered keys"):  # the new node is unbound
        train.main(args)
    exp = train.build_experiment(train.parse_args(args))
    reg = default_registry()
    reg.register(Role.REWARD, NodeType.MODEL_INFERENCE, length_penalty_reward, override=True)
    pipe = exp.compile(device="cpu", registry=reg)
    assert pipe.plan.order == ["actor_generation", "reward_compute", "length_penalty",
                               "advantage_compute", "actor_train"]
    for m in pipe.run(2):
        want = m["reward/mean"] + 0.05 * (1.0 - m["rollout/mean_len"] / 6)
        assert m["reward/shaped_mean"] == pytest.approx(want, abs=1e-6)
        assert np.isfinite(m["actor/loss"])
    path.write_text(_no_ref_dag(with_penalty=False).to_json())
    out = train.main(SMALL + ["--iters", "1", "--dag-json", str(path)])
    assert "reference_inference" not in out["pipeline"].plan.order
    assert out["pipeline"].buffer.stats.puts == 6


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #
def test_train_entry_point_runs_and_dumps_an_experiment(tmp_path, capsys):
    out = train.main(["--smoke", "--device", "cpu", "--iters", "2"])
    assert len(out["history"]) == len(out["seconds"]) == 2
    for m in out["history"]:
        assert all(np.isfinite(v) for v in m.values())
        assert m["rollout/tokens"] > 0 and "actor/loss" in m
    assert out["pipeline"].buffer.stats.puts == 2 * 7
    text = capsys.readouterr().out
    assert "[train] it=0 " in text and "[train] it=1 " in text and "buffer stats" in text

    path = tmp_path / "exp.json"
    train.main(SMALL + ["--dump-experiment", str(path), "--double-buffer", "--prefetch", "1",
                        "--centralized-baseline", "--seed", "4"])
    d = json.loads(path.read_text())
    assert d["coordinator"]["double_buffer"] and d["coordinator"]["prefetch"] == 1
    assert d["centralized"] and d["seed"] == 4 and d["rl"]["max_new_tokens"] == 6
    assert ExperimentSpec.from_json(path.read_text()).to_dict() == d
    assert JaxExperimentSpec.from_json(path.read_text()).to_dict() == d
    out = train.main(["--experiment", str(path), "--device", "cpu", "--iters", "1",
                      "--prefetch", "2"])
    assert out["experiment"].coordinator.prefetch == 2 and out["experiment"].centralized
    assert out["pipeline"].buffer.stats.bytes_through_controller > 0


@pytest.mark.parametrize("flag,field,value", [
    (["--double-buffer"], "double_buffer", True), (["--load-balance"], "load_balance", True),
    (["--prefetch", "2"], "prefetch", 2), (["--num-buckets", "3"], "num_buckets", 3),
    (["--balance-tolerance", "1.5"], "balance_tolerance", 1.5),
    (["--centralized-baseline"], "centralized", True)])
def test_coordinator_flags_layer_on_an_experiment_file(tmp_path, flag, field, value):
    base, path = tmp_path / "base.json", tmp_path / "exp.json"
    train.main(SMALL + ["--dump-experiment", str(base)])
    train.main(["--experiment", str(base), "--dump-experiment", str(path), *flag])
    want = json.loads(base.read_text())
    (want if field == "centralized" else want["coordinator"])[field] = value
    assert json.loads(path.read_text()) == want
    assert set(json.loads(base.read_text())["coordinator"]) == \
        {f.replace("-", "_") for f in train.COORDINATOR_FLAGS}


# the fleet and its host:port coordinator (torch.distributed) are ported; a
# file-plane host of several devices is not
@pytest.mark.parametrize("flag", [["--num-hosts", "2", "--coordinator", "coord"]])
def test_unported_flags_raise(flag, tmp_path):
    exp = ExperimentSpec(model=reduced(get_config("gemma-2b"), **SMOKE),
                         distributed=DistributedConfig(devices_per_host=2))
    path = tmp_path / "exp.json"
    path.write_text(exp.to_json())
    flag = [str(tmp_path / f) if f == "coord" else f for f in flag]
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item \d"):
        train.main(["--experiment", str(path), "--device", "cpu", "--iters", "1", *flag])


@pytest.mark.parametrize("option", ["distributed"])
def test_unported_options_raise(option):
    # a fleet host of several devices waits for the rest of the sharding
    # layer (the async pipeline runs on a rank mesh:
    # tests/test_torch_tp_async.py)
    value = {"distributed": DistributedConfig(num_hosts=2, coordinator="/tmp/c",
                                              devices_per_host=2)}[option]
    exp = ExperimentSpec(model=reduced(get_config("gemma-2b"), **SMOKE), **{option: value})
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item \d"):
        exp.compile(device="cpu")


def test_without_cuda_every_entry_point_raises_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    cfg = reduced(get_config("gemma-2b"), **SMOKE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(cfg, trainer.RLConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExperimentSpec(model=cfg).compile()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--iters", "1"])


# --------------------------------------------------------------------------- #
# the continuous rollout engine through ExperimentSpec and launch.train
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("num_slots", [4, 0], ids=["refill", "early_exit"])
def test_continuous_engine_option_matches_jax(num_slots):
    """``ExperimentSpec(rollout=RolloutEngineConfig(engine="continuous"))``
    builds the continuous engine: 2 greedy GRPO iterations (16 rollouts over
    4 slots, or one slot each) equal the JAX pipeline's with its engine, with
    ``rollout/*`` in the metrics."""
    jexp = dataclasses.replace(jax_spec(), rollout=JaxRolloutEngineConfig(
        engine="continuous", num_slots=num_slots))
    (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(jexp)
    engine = tpipe.ctx.engines["generate"].engine
    assert isinstance(engine, ContinuousRolloutEngine) and engine.num_slots == num_slots
    fp32_arenas(jpipe, tpipe)
    jhist, thist = jpipe.run(2), tpipe.run(2)
    assert_continuous_iterations_match(jhist, thist, jtoks, ttoks)
    assert counts(tpipe.buffer.stats) == counts(jpipe.buffer.stats)
    for m in thist:
        assert m["rollout/num_slots"] == (num_slots or 16)
        assert 0.0 < m["rollout/slot_occupancy"] <= 1.0
        assert (m["rollout/refills"] > 1) == (num_slots == 4)
    assert min(m["rollout/mean_len"] for m in thist) < 4.0  # EOS_SCALE: early ends


def test_rollout_slots_flag_builds_the_continuous_engine(tmp_path):
    """``launch.train --rollout-slots 2``: the spec's engine is the continuous
    one over 2 slots, also layered on an experiment file; an iteration runs
    through it and reports ``rollout/*``; and the flag's experiment, made
    greedy, gives the JAX pipeline's rollout on the same weights."""
    base, path = tmp_path / "base.json", tmp_path / "exp.json"
    train.main(SMALL + ["--dump-experiment", str(base)])
    train.main(["--experiment", str(base), "--rollout-slots", "2", "--dump-experiment",
                str(path)])
    d = json.loads(path.read_text())
    assert d["rollout"] == dataclasses.asdict(RolloutEngineConfig(engine="continuous",
                                                                  num_slots=2))
    out = train.main(SMALL + ["--iters", "1", "--rollout-slots", "2"])
    assert out["experiment"].rollout.num_slots == 2
    assert isinstance(out["pipeline"].ctx.engines["generate"], ContinuousRolloutEngine)
    m = out["history"][0]
    assert m["rollout/num_slots"] == 2 and m["rollout/refills"] >= 4 and "actor/loss" in m

    d["rl"]["temperature"] = 0.0
    (jpipe, jtoks), (tpipe, ttoks) = bridged_pair(JaxExperimentSpec.from_dict(d))
    fp32_arenas(jpipe, tpipe)
    assert_continuous_iterations_match(jpipe.run(1), tpipe.run(1), jtoks, ttoks)


def test_rollout_slots_flag_keeps_the_files_engine_settings(tmp_path):
    """``--rollout-slots`` on an experiment file sets the engine and its
    slots; the file's ``prefill_chunk``, buckets and refill threshold stand."""
    base, path = tmp_path / "base.json", tmp_path / "exp.json"
    train.main(SMALL + ["--dump-experiment", str(base)])
    d = json.loads(base.read_text())
    d["rollout"].update(prefill_chunk=4, prefill_bucket=2, refill_threshold=2)
    base.write_text(json.dumps(d))
    train.main(["--experiment", str(base), "--rollout-slots", "3", "--dump-experiment",
                str(path)])
    assert json.loads(path.read_text())["rollout"] == dataclasses.asdict(RolloutEngineConfig(
        engine="continuous", num_slots=3, prefill_chunk=4, prefill_bucket=2,
        refill_threshold=2))


def _layer_cfg(**kw):
    return dataclasses.replace(reduced(get_config("gemma-2b"), **SMOKE), **kw)


# every NotImplementedError of the port, and the ROADMAP queue 1 item that
# ports its subsystem
def _paged_decode_on_model_ranks():
    """The serving engine's paged decode step under an ambient mesh that
    splits ``model`` over 2 ranks: refused before its first collective, so
    the mesh needs no world behind it."""
    from types import SimpleNamespace

    from repro_torch.distributed import constraint

    model = get_model_cpu(_layer_cfg())
    params = model.init(torch.Generator().manual_seed(0))
    pool = model.init_caches(5, 4)  # 4 pages of 4 slots and the sink
    mesh = SimpleNamespace(torch_mesh=object(), shape={"data": 1, "model": 2},
                           coords={"data": 0, "model": 0}, axis_names=("data", "model"))
    with constraint.use_mesh(mesh):
        model.decode_step_paged(params, torch.zeros(2, dtype=torch.int32), pool,
                                torch.zeros(2, dtype=torch.int32),
                                torch.zeros((2, 2), dtype=torch.int32))


NOT_PORTED_CASES = {
    "devices_per_host": (8, lambda: ExperimentSpec(
        model=_layer_cfg(), distributed=DistributedConfig(
            num_hosts=2, coordinator="/unused", devices_per_host=2)).compile(device="cpu")),
    "fleet_model_parallel": (8, lambda: make_fleet_mesh(2, model_parallel=2, device="cpu")),
    # the serving engine's paged decode on model > 1 (the continuous engine,
    # which this case pinned before, runs on a tensor-parallel mesh)
    "model_parallel_continuous": (8, _paged_decode_on_model_ranks),
}
ITEM_NAMES = {8: "distributed"}


def get_model_cpu(cfg):
    from repro_torch.models import get_model

    return get_model(cfg, device="cpu")


@pytest.mark.parametrize("case", sorted(NOT_PORTED_CASES))
def test_not_implemented_messages_cite_their_item(case):
    """Each refusal names the ROADMAP queue 1 item that ports it, by number
    and by name."""
    item, call = NOT_PORTED_CASES[case]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1, item {item}: {ITEM_NAMES[item]}"):
        call()


@pytest.mark.parametrize("option", ["centralized", "async_pipeline"])
def test_fleet_refuses_centralized_and_async_as_jax(tmp_path, option):
    """A fleet has no controller to centralize through, and its exchange is
    a per-iteration collective: both options raise the JAX package's
    ValueError, before any fleet file is written."""
    from repro.api import ExperimentSpec as JaxSpec
    from repro.configs import AsyncPipelineConfig as JaxAsync
    from repro.configs import DistributedConfig as JaxDistributed
    from repro_torch.configs import AsyncPipelineConfig

    kw, jkw = ({"centralized": True}, {"centralized": True}) if option == "centralized" else (
        {"async_pipeline": AsyncPipelineConfig(enabled=True)},
        {"async_pipeline": JaxAsync(enabled=True)})
    dist = dict(num_hosts=2, coordinator=str(tmp_path / "coord"))
    with pytest.raises(ValueError) as jexc:
        JaxSpec(model=jax_reduced(jax_get_config("gemma-2b"), **SMOKE),
                distributed=JaxDistributed(**dist), **jkw).compile()
    with pytest.raises(ValueError) as exc:
        ExperimentSpec(model=_layer_cfg(), distributed=DistributedConfig(**dist),
                       **kw).compile(device="cpu")
    assert str(exc.value) == str(jexc.value)
    assert not (tmp_path / "coord").exists()
