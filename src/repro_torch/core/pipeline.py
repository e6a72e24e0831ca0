"""Built-in RL pipelines (paper Fig. 1) and the end-to-end driver: the port of
``repro.core.pipeline``.

``build_pipeline`` is a thin compiler over specs: it resolves the
:class:`~repro_torch.rl.algorithms.AlgorithmSpec` for ``rl.algorithm`` (or
takes one directly) and wires together model init, the engines, the DAG (the
spec's template or user-supplied), the planner's serialized chain, the Data
Coordinator (Distributed Dataloader + Databuffer) and a DAG Worker, all on
one device. ``centralized=True`` swaps in the single-controller databuffer,
the baseline arm of the paper's comparisons. An enabled ``async_pipeline``
runs the staleness-bounded :class:`~repro_torch.core.async_worker.
AsyncDAGWorker`, and an enabled ``env`` binds an environment runtime
(``repro_torch.rl.envs``): its (ENV, COMPUTE) stage takes the reward node's
place, and with ``max_turns > 1`` the continuous engine runs the episodes.

The engines are plain callables where the JAX package jits. The pipeline
runs on the card unless ``device="cpu"`` is asked for; without CUDA it
raises. An enabled ``obs`` installs a process-global tracer and hangs an
:class:`~repro_torch.obs.ObsState` on the worker context, as in the JAX
package. An enabled ``distributed`` makes the process one host of a
data-parallel fleet: over a directory coordinator
(``repro_torch.distributed.fleet``), the fleet mesh's ``pod`` axis and an
actor step split into grad, the file-plane ``GradExchange`` and apply;
over a ``host:port`` coordinator, the rank mesh of
``launch.mesh.make_fleet_mesh``. The tracer then writes the host's process
id.

On a rank mesh (one process a device over ``torch.distributed``, ``model``
of 1: pure data parallelism; given as ``mesh``, made from ``mesh_shape``
over the running world, or made for a ``host:port`` coordinator) every rank
builds the same weights from the seed and keeps its shard of the actor's
``TrainState`` (and a critic's) under ``sharding.param_specs(...,
"train")``; the steps are ``trainer.make_dp_actor_step`` /
``make_dp_critic_step``, generation reads the params switched to the serve
layout (which, at ``model`` = 1, are the full params the actor step reads
too: one all-gather serves both), the reference params stay whole, and the
dataloader, generator and stages work on the rank's rows.

With ``model`` > 1 the model stages of a decoder are tensor-parallel
(``distributed.constraint``, the worker entering the mesh as the model
code's ambient one): the serve layout is no longer the full params, so the
logprob stages and the actor step read the train layout gathered over the
data axes (``WorkerContext.model_params``: this rank's ``model`` shards),
and the reference params are cut once to the train specs' ``model``
shards. The ranks of one data row share its rows and seeds. Every
architecture runs there: MoE and SSD layers (expert and head tensor
parallelism), sliding-window rings, the int8 KV cache, prefix embeddings
and ``top_p < 1``; an encoder-decoder's model code too, while its
pipeline fails as on one device, at ``rollout.generate`` ("fused sampling
is decoder-only"). The continuous engine runs there too.

The async pipeline runs on every rank mesh, as JAX's ``build_pipeline``
builds its ``AsyncDAGWorker`` on any mesh: each rank schedules its own
shards and rows, and a published version is a copy of the rank's
train-layout shards (``core.async_worker``). Over a ``host:port``
coordinator too, where the step's reduce-scatter takes the place of the
fleet's exchange; a fleet over a directory refuses it, with the JAX
package's message, as it refuses the centralized baseline.

The user-facing entry point is :class:`repro_torch.api.ExperimentSpec`, whose
``compile()`` lands here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch import tree
from repro_torch.configs.base import (
    AsyncPipelineConfig,
    DataCoordinatorConfig,
    DistributedConfig,
    EnvConfig,
    ModelConfig,
    ObsConfig,
    RolloutEngineConfig,
)
from repro_torch.core.async_worker import AsyncDAGWorker
from repro_torch.core.dag import DAG
from repro_torch.core.databuffer import (
    CentralizedDatabuffer,
    DeviceMesh,
    DistributedDatabuffer,
    DoubleBufferedDatabuffer,
)
from repro_torch.core.planner import DAGPlanner
from repro_torch.core.registry import Registry, default_registry
from repro_torch.core.worker import DAGWorker, WorkerContext
from repro_torch.data.dataloader import DistributedDataloader
from repro_torch.data.dataset import SyntheticMathDataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import get_model
from repro_torch.models.api import resolve_device
from repro_torch.rl import algorithms
from repro_torch.rl import critic as critic_mod
from repro_torch.rl import envs as envs_mod
from repro_torch.rl import rollout as rollout_mod
from repro_torch.rl import trainer
from repro_torch.rl.rollout_engine import ContinuousRolloutEngine
from repro_torch.rl.trainer import RLConfig


# looked up at call time: rl.algorithms imports core, so its attributes may
# not exist yet while this module is imported
def grpo_dag() -> DAG:
    return algorithms.grpo_dag()


def ppo_dag() -> DAG:
    return algorithms.ppo_dag()


# --------------------------------------------------------------------------- #
def _build_engines(model, rl: RLConfig, tok: ByteTokenizer, spec,
                   rollout: Optional[RolloutEngineConfig] = None,
                   env_runtime=None) -> Dict[str, Any]:
    """The engines of one algorithm spec: the GENERATE engine, logprobs, the
    reward (the registered reward ``env.reward`` names, ``math`` by
    default), the spec's advantage, the actor step, and the critic's values
    and step iff the spec uses a critic. The GENERATE engine is lockstep
    ``rollout.generate`` or the slot-refill
    :class:`~repro_torch.rl.rollout_engine.ContinuousRolloutEngine`
    (``RolloutEngineConfig.engine == "continuous"``): same call contract,
    same RolloutResult. An ``env_runtime`` turns the continuous engine's
    slot loop into the multi-turn episode loop."""
    eng: Dict[str, Any] = {}

    def _generate(params, prompts, gen):
        return rollout_mod.generate(
            model, params, prompts, gen,
            max_new=rl.max_new_tokens, temperature=rl.temperature,
            eos_id=tok.eos_id, pad_id=tok.pad_id,
        )

    if rollout is not None and rollout.engine == "continuous":
        env_kw = {}
        if env_runtime is not None:
            env_kw = dict(env=env_runtime, max_turns=env_runtime.cfg.max_turns,
                          turn_budget=env_runtime.cfg.turn_budget,
                          obs_budget=env_runtime.cfg.obs_budget)
        eng["generate"] = ContinuousRolloutEngine(
            model,
            max_new=rl.max_new_tokens,
            temperature=rl.temperature,
            eos_id=tok.eos_id,
            pad_id=tok.pad_id,
            num_slots=rollout.num_slots,
            prefill_chunk=rollout.prefill_chunk,
            prefill_bucket=rollout.prefill_bucket,
            refill_threshold=rollout.refill_threshold,
            **env_kw,
        )
    else:
        eng["generate"] = _generate
    eng["logprobs"] = lambda p, t: model.logprobs(p, t)
    token_fn = envs_mod.get_reward(
        env_runtime.cfg.reward if env_runtime is not None else "math").token_fn
    eng["reward"] = lambda tokens, mask, answers: token_fn(tokens, mask, answers, tok)
    eng["advantage"] = spec.make_advantage(rl)
    if spec.uses_critic:
        eng["values"] = lambda p, t: critic_mod.values_fn(model.cfg, p, t)
        eng["critic_step"] = trainer.make_critic_step(model.cfg, rl)
    eng["actor_step"] = trainer.make_actor_step(model, rl, algorithm=spec)
    return eng


@dataclasses.dataclass
class Pipeline:
    worker: DAGWorker
    ctx: WorkerContext
    buffer: DistributedDatabuffer
    dag: DAG
    plan: Any

    def run(self, iterations: int):
        history = []
        for _ in range(iterations):
            history.append(self.worker.run_iteration())
        return history


def _seeds(seed: int):
    """Three independent 32-bit seeds (actor init, critic init, the run's
    sampling generator) from ``seed``."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(3)]


def build_pipeline(
    cfg: ModelConfig,
    rl: RLConfig,
    *,
    device="cuda",
    mesh: Optional[DeviceMesh] = None,
    mesh_shape: Optional[Dict[str, int]] = None,
    dag: Optional[DAG] = None,
    dataset=None,
    prompts_per_iter: int = 8,
    centralized: bool = False,
    coordinator: Optional[DataCoordinatorConfig] = None,
    async_pipeline: Optional[AsyncPipelineConfig] = None,
    rollout: Optional[RolloutEngineConfig] = None,
    env: Optional[EnvConfig] = None,
    distributed: Optional[DistributedConfig] = None,
    obs: Optional[ObsConfig] = None,
    registry: Optional[Registry] = None,
    algorithm=None,
    seed: int = 0,
) -> Pipeline:
    spec = algorithm or algorithms.get_algorithm(rl.algorithm)
    coordinator = coordinator or DataCoordinatorConfig()
    device = resolve_device(device)
    fleet = distributed is not None and distributed.enabled
    if fleet:
        if centralized:
            raise ValueError(
                "a multi-host fleet has no single controller to centralize "
                "through; distributed cannot be combined with centralized=True")
        from repro_torch.launch.mesh import is_rank_coordinator

        # a host:port coordinator makes a rank mesh whose step reduces its
        # grads itself; the file plane's exchange is what cannot go async
        if (async_pipeline is not None and async_pipeline.enabled
                and not is_rank_coordinator(distributed.coordinator)):
            raise ValueError(
                "the fleet gradient exchange is a per-iteration collective; "
                "combine it with the async pipeline once the exchange is "
                "staleness-aware (not yet supported)")
    if mesh is None and mesh_shape is not None:
        from repro_torch.launch.mesh import mesh_of

        mesh = mesh_of(tuple(mesh_shape.values()), tuple(mesh_shape), device=device)
    if fleet:
        from repro_torch.launch.mesh import make_fleet_mesh

        if mesh is None:
            mesh = make_fleet_mesh(distributed.num_hosts, distributed.devices_per_host,
                                   device=device)
    elif mesh is None:
        mesh = DeviceMesh(device)
    ranked = mesh.torch_mesh is not None
    tok = ByteTokenizer()
    assert cfg.vocab_size >= tok.vocab_size, "model vocab must cover the tokenizer"
    model = get_model(cfg, device=device)

    env_runtime = None
    if env is not None and env.enabled:
        if env.max_turns > 1 and (rollout is None or rollout.engine != "continuous"):
            raise ValueError(
                "multi-turn environments need the continuous rollout "
                "engine's episode loop: set RolloutEngineConfig("
                "engine='continuous') (single-turn envs run on either engine)")
        env_runtime = envs_mod.EnvRuntime(envs_mod.get_env(env.name), env, tok)

    s_actor, s_critic, s_run = _seeds(seed)
    actor_params = model.init(torch.Generator(device=device).manual_seed(s_actor))
    ref_params = tree.map(torch.clone, actor_params)  # frozen reference
    gen = torch.Generator(device=device).manual_seed(s_run)
    if ranked:
        from repro_torch.distributed import collectives
        from repro_torch.distributed import sharding as shr

        # this rank's shard of the actor state; the rows it samples
        pspecs = shr.param_specs(cfg, mesh, actor_params, "train")
        serve_specs = shr.param_specs(cfg, mesh, actor_params, "serve")
        actor_state = trainer.shard_state(mesh, actor_params, pspecs)
        del actor_params
        if mesh.shape.get("model", 1) > 1:  # this rank's model shards of the reference
            ref_params = shr.map_with_specs(
                lambda p, s: collectives.shard(mesh, p, s, axes=("model",)).clone(),
                ref_params, pspecs)
        # the rank's data coordinate: the ranks of one data row share rows and seeds
        data_axes = shr.fsdp_axes(mesh)
        num_rows = math.prod(mesh.shape[a] for a in data_axes)
        gen = rollout_mod.RankRows(
            gen, collectives.region(mesh, (num_rows,), (data_axes,))[0].start, num_rows)
    else:
        actor_state = trainer.init_state(actor_params)

    ctx = WorkerContext(
        mesh=mesh,
        rl=rl,
        engines=_build_engines(model, rl, tok, spec, rollout, env_runtime),
        dataloader=DistributedDataloader(
            dataset or SyntheticMathDataset(4096, seed=seed),
            mesh=mesh,
            global_batch=prompts_per_iter,
            seed=seed,
            prefetch=coordinator.prefetch,
        ),
        actor_state=actor_state,
        ref_params=ref_params,
        tokenizer=tok,
        gen=gen,
        algorithm=spec,
        env=env_runtime,
    )
    if spec.uses_critic:
        critic_gen = torch.Generator(device=device).manual_seed(s_critic)
        critic_params = critic_mod.init(cfg, critic_gen, device=device)
        if ranked:
            cspecs = shr.param_specs(cfg, mesh, critic_params, "train")
            ctx.critic_state = trainer.shard_state(mesh, critic_params, cspecs)
            ctx.critic_specs = cspecs
            ctx.engines["critic_step"] = trainer.make_dp_critic_step(cfg, rl, mesh, cspecs)
        else:
            ctx.critic_state = trainer.init_state(critic_params)
        del critic_params

    if ranked:
        ctx.param_specs, ctx.serve_specs = pspecs, serve_specs
        # at model = 1 the serve layout is the full params: the step reads
        # the copy generation switched to, so one all-gather serves both;
        # at model > 1 it reads the train layout gathered over the data axes
        ctx.engines["actor_step"] = trainer.make_dp_actor_step(
            model, rl, mesh, pspecs, algorithm=spec, full_params=ctx.model_params)
    elif fleet:
        # Fleet DP gradient exchange: split the fused actor step so the
        # gradient crosses the host data plane between grad and apply, bit
        # for bit the fused step when grad_compression="none", int8 on the
        # wire otherwise.
        from repro_torch.distributed import fleet as fleet_mod

        fleet_ctx = fleet_mod.ensure_context(distributed)
        exchange = fleet_mod.GradExchange(fleet_ctx, distributed.grad_compression)
        ctx.engines["actor_step"] = fleet_mod.fleet_actor_step(
            trainer.make_actor_grad_fn(model, rl, algorithm=spec),
            trainer.make_actor_apply_fn(rl),
            exchange,
        )
        ctx.fleet = fleet_ctx
        ctx.grad_exchange = exchange

    if obs is not None and obs.enabled:
        # Telemetry runtime: a process-global tracer (instrumented call
        # sites reach it via obs.get_tracer) plus a registry that absorbs
        # each iteration's metrics dict. Disabled obs leaves the global
        # tracer untouched. A fleet host traces as its process id.
        tracer = obs_mod.Tracer(enabled=obs.trace,
                                host=distributed.process_id if distributed is not None else 0,
                                capacity=obs.ring_capacity)
        obs_mod.set_tracer(tracer)
        ctx.obs = obs_mod.ObsState(cfg=obs, tracer=tracer, registry=obs_mod.MetricsRegistry())

    dag = dag or spec.dag_factory()
    if env_runtime is not None:
        # retarget the reward node at the environment stage (it writes the
        # same `rewards` key; validate_dag takes ENV for REWARD)
        dag = envs_mod.with_env_stage(dag)
    spec.validate_dag(dag)
    plan = DAGPlanner().plan(dag)
    if centralized:
        buffer_cls = CentralizedDatabuffer
    elif coordinator.double_buffer:
        buffer_cls = DoubleBufferedDatabuffer
    else:
        buffer_cls = DistributedDatabuffer
    buffer = buffer_cls(mesh)
    if async_pipeline is not None and async_pipeline.enabled:
        if centralized:
            raise ValueError(
                "the centralized baseline gathers every stage output through "
                "one controller and is inherently synchronous; async_pipeline "
                "cannot be combined with centralized=True")
        worker = AsyncDAGWorker(ctx, plan, registry or default_registry(), buffer, coordinator,
                                async_cfg=async_pipeline)
    else:
        worker = DAGWorker(ctx, plan, registry or default_registry(), buffer, coordinator)
    return Pipeline(worker=worker, ctx=ctx, buffer=buffer, dag=dag, plan=plan)
