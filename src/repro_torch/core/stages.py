"""Built-in stage functions, the bodies behind the Fig. 5 dispatch table: the
port of ``repro.core.stages``, with its buffer keys and specs.

Stage specs realize the paper's per-stage parallelism: model-bound stages
(generate / inference / train) put and get the batch over the ``data`` axes
only, while pure COMPUTE stages (reward, advantage) use *all* axes, so the
databuffer's redistribution path is taken at every model<->compute boundary
exactly as in the JAX package (on one device it moves nothing, but it is
counted the same).

On a rank mesh (``torch.distributed``, one process a device) each rank runs
every stage on the rows it holds, under the JAX package's specs.
Generation reads the actor's params in the serve layout
(``WorkerContext.serve_params``), the logprob stages in the train layout
gathered over the data axes (``WorkerContext.model_params``). With
``model`` > 1 the model stages run tensor-parallel at dp = D, the ranks of
a data row holding the same rows, and the compute stages at dp = D x M. The advantage engine gets ``total``, a sum
over the ranks, so that an advantage normalised over the batch (PPO's
whitening, REINFORCE++) is normalised by the global batch's moments, as
GSPMD computes it in the JAX package. The stages' metrics are reduced over
the ranks to their global values.

``actor_generate`` drives lockstep ``generate`` or the continuous engine and
reports the engine's ``last_stats`` as ``rollout/*`` (on a rank mesh the
rank's own engine's, its data row's counts, which the ranks of that row
share and which are not summed over ``model``; but for ``rollout/tokens``,
the global batch's); episodes the engine
stepped put their ``role_mask``, ``env_rewards`` and ``env_turns`` for
``env_compute``, the (ENV, COMPUTE) stage of ``repro_torch.rl.envs``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core.dag import Node


def _algo(ctx):
    """The AlgorithmSpec driving this run (bound by build_pipeline; resolved
    from the registry for hand-rolled contexts)."""
    from repro_torch.rl import algorithms

    return algorithms.resolve(ctx)


def _specs(ctx):
    """(model-stage batch spec, compute-stage batch spec) for ctx.mesh."""
    axes = ctx.mesh.axis_names
    data_axes = tuple(a for a in axes if a != "model")
    return (data_axes,), (tuple(axes),)


def _ranked(ctx) -> bool:
    return getattr(ctx.mesh, "torch_mesh", None) is not None


def _total(ctx, x: torch.Tensor, axes=None) -> float:
    """The sum of ``x`` over the global batch (this rank's rows, reduced
    over the ranks on a rank mesh: over ``axes``, the axes that split the
    rows, or every axis)."""
    t = x.float().sum()
    if _ranked(ctx):
        from repro_torch.distributed import collectives

        t = collectives.all_reduce(ctx.mesh, t, axes=axes)
    return float(t)


def _mean(ctx, x: torch.Tensor, axes=None) -> float:
    """The mean of ``x`` over the global batch (the ranks hold equal row
    counts)."""
    if not _ranked(ctx):
        return float(x.float().mean())
    n = ctx.mesh.num_ranks if axes is None else math.prod(ctx.mesh.shape[a] for a in axes)
    return _total(ctx, x, axes) / (x.numel() * n)


def _model_axes(ctx):
    """The axes that split a model stage's rows (None: every axis, as at
    ``model`` = 1)."""
    from repro_torch.rl import trainer

    return trainer.data_axes(ctx.mesh) if _ranked(ctx) else None


# --------------------------------------------------------------------------- #
def actor_generate(ctx, buffer, node: Node) -> Dict:
    """(ACTOR, GENERATE): pull the iteration's prompts from the worker-bound
    prompt iterator (``ctx.prompt_source``, already group-expanded), run the
    generation engine (lockstep or continuous, same call contract) with the
    run's generator and store the trajectory. The continuous engine's
    tokens/s, padding waste and slot occupancy are reported as well.

    Both engines run under ``torch.inference_mode``; autograd cannot save
    their outputs for the actor step's backward. The rollouts are cloned
    here, once, as they enter the buffer."""
    model_spec, _ = _specs(ctx)
    if ctx.prompt_source is None:
        # hand-rolled ctx without a worker: bind the same iterator the
        # worker would, so group expansion has exactly one implementation
        from repro_torch.core.worker import PromptSource

        ctx.prompt_source = PromptSource(ctx.dataloader, _algo(ctx).group_size(ctx.rl))
    prompts, answers = ctx.prompt_source.next_prompts()
    engine = ctx.engines["generate"]
    res = engine(ctx.serve_params(), prompts, ctx.gen)
    buffer.put("tokens", res.tokens.clone(), model_spec)
    buffer.put("response_mask", res.response_mask.clone(), model_spec)
    buffer.put("old_logprob", res.old_logprob.clone(), model_spec)
    buffer.put("answers", answers, model_spec)
    if res.role_mask is not None:
        # multi-turn episodes: per-token roles (0 prompt, 1 action, 2 env
        # observation); response_mask already excludes observation tokens
        buffer.put("role_mask", res.role_mask.clone(), model_spec)
    env_out = getattr(engine, "last_env", None)
    if env_out:
        # engine-driven episodes: env rewards and turns ride the buffer to
        # the (ENV, COMPUTE) stage (the load balancer repacks them with the
        # batch like every other per-sequence key)
        dev = res.tokens.device
        buffer.put("env_rewards", torch.from_numpy(env_out["rewards"]).to(dev), model_spec)
        buffer.put("env_turns", torch.from_numpy(env_out["turns"]).to(dev), model_spec)
    gen_tokens = _total(ctx, res.lengths, _model_axes(ctx))
    ctx.counters["gen_tokens"] = ctx.counters.get("gen_tokens", 0.0) + gen_tokens
    out = {
        "rollout/mean_len": _mean(ctx, res.lengths, _model_axes(ctx)),
        "rollout/tokens": gen_tokens,
    }
    stats = getattr(engine, "last_stats", None)
    if stats:  # continuous engine: slot and throughput accounting
        out.update({f"rollout/{k}": float(v) for k, v in stats.items()})
        # the engine counts this rank's tokens; on a rank mesh the metric
        # stays the global batch's, as the lockstep path reports it
        out["rollout/tokens"] = gen_tokens
    return out


def actor_logprobs(ctx, buffer, node: Node) -> Dict:
    """(ACTOR, MODEL_INFERENCE): recompute behaviour logprobs under the
    training engine (optional: used by custom DAGs to validate engine
    agreement)."""
    model_spec, _ = _specs(ctx)
    tokens = buffer.get("tokens", model_spec)
    with torch.no_grad():
        lp, _ = ctx.engines["logprobs"](ctx.model_params(), tokens)
    buffer.put("old_logprob", lp * buffer.get("response_mask", model_spec), model_spec)
    return {}


def reference_logprobs(ctx, buffer, node: Node) -> Dict:
    model_spec, _ = _specs(ctx)
    tokens = buffer.get("tokens", model_spec)
    with torch.no_grad():
        lp, _ = ctx.engines["logprobs"](ctx.ref_params, tokens)
    buffer.put("ref_logprob", lp, model_spec)
    return {}


def critic_values(ctx, buffer, node: Node) -> Dict:
    model_spec, _ = _specs(ctx)
    tokens = buffer.get("tokens", model_spec)
    with torch.no_grad():
        params = ctx.critic_state.params
        if ctx.critic_specs is not None:  # a rank mesh: the critic's shards, gathered
            from repro_torch.rl import trainer

            params = trainer.gather_params(ctx.mesh, params, ctx.critic_specs,
                                           axes=trainer.data_axes(ctx.mesh))
        v = ctx.engines["values"](params, tokens)
    buffer.put("old_values", v, model_spec)
    return {}


def reward_compute(ctx, buffer, node: Node) -> Dict:
    """(REWARD, COMPUTE): function reward (the paper's PPO uses a function
    reward in place of a reward model). Runs at compute-stage DP (all axes)."""
    _, compute_spec = _specs(ctx)
    seq_spec = (compute_spec[0],)
    tokens = buffer.get("tokens", compute_spec)
    mask = buffer.get("response_mask", compute_spec)
    answers = buffer.get("answers", seq_spec)
    rewards = ctx.engines["reward"](tokens, mask, answers)
    buffer.put("rewards", rewards, seq_spec)
    return {"reward/mean": _mean(ctx, rewards)}


def env_compute(ctx, buffer, node: Node) -> Dict:
    """(ENV, COMPUTE): episode rewards from the environment subsystem
    (``repro_torch.rl.envs``; replaces the REWARD stage when ``EnvConfig``
    names an env). Engine-driven episodes were stepped during generation:
    their rewards ride the buffer as ``env_rewards``. On the lockstep
    engine, a single-turn env steps each episode here over the finished
    rollout."""
    _, compute_spec = _specs(ctx)
    seq_spec = (compute_spec[0],)
    out: Dict[str, float] = {}
    if "env_rewards" in buffer.keys():
        rewards = buffer.get("env_rewards", seq_spec)
        turns = buffer.get("env_turns", seq_spec)
        out["env/turns_mean"] = _mean(ctx, turns)
    else:
        if ctx.env is None:
            raise RuntimeError(
                "env_compute needs WorkerContext.env (an EnvRuntime); "
                "was the pipeline built with an enabled EnvConfig?")
        tokens = buffer.get("tokens", compute_spec)
        mask = buffer.get("response_mask", compute_spec)
        scored = ctx.env.score_single_turn(tokens.cpu().numpy(), mask.cpu().numpy())
        rewards = torch.from_numpy(np.asarray(scored, np.float32)).to(tokens.device)
    buffer.put("rewards", rewards, seq_spec)
    out["reward/mean"] = _mean(ctx, rewards)
    return out


def advantage_compute(ctx, buffer, node: Node) -> Dict:
    """(ADVANTAGE, COMPUTE): run the spec's advantage engine. The spec
    declares which extra buffer keys the engine consumes beyond
    (rewards, mask), e.g. PPO's GAE reads logprobs + values, and which
    keys its outputs land under (advantages, and returns for critic
    algorithms)."""
    spec = _algo(ctx)
    _, compute_spec = _specs(ctx)
    seq_spec = (compute_spec[0],)
    mask = buffer.get("response_mask", compute_spec)
    rewards = buffer.get("rewards", seq_spec)
    extra = [buffer.get(k, compute_spec) for k in spec.advantage_inputs]
    kw = {}
    if _ranked(ctx):  # a normalisation over the batch sums its moments over the ranks
        from repro_torch.distributed import collectives

        kw["total"] = functools.partial(collectives.all_reduce, ctx.mesh)
    out = ctx.engines["advantage"](rewards, mask, *extra, **kw)
    if len(spec.advantage_outputs) == 1:
        out = (out,)
    for key, val in zip(spec.advantage_outputs, out):
        buffer.put(key, val, compute_spec)
    return {}


def actor_train(ctx, buffer, node: Node) -> Dict:
    model_spec, _ = _specs(ctx)
    batch = {
        "tokens": buffer.get("tokens", model_spec),
        "response_mask": buffer.get("response_mask", model_spec),
        "old_logprob": buffer.get("old_logprob", model_spec),
        "advantages": buffer.get("advantages", model_spec),
    }
    if _algo(ctx).needs_reference:
        if "ref_logprob" in buffer.keys():
            batch["ref_logprob"] = buffer.get("ref_logprob", model_spec)
        else:
            # reference-free DAG variant (custom_dag example): KL term is 0
            batch["ref_logprob"] = batch["old_logprob"]
    if "behavior_logprob" in buffer.keys():
        # a stale batch's generation-time logprobs ride along for the
        # decoupled truncated-IS correction (trainer.apply_is_correction)
        batch["behavior_logprob"] = buffer.get("behavior_logprob", model_spec)
    ctx.actor_state, metrics = ctx.engines["actor_step"](ctx.actor_state, batch)
    return {f"actor/{k}": float(v) for k, v in metrics.items()}


def critic_train(ctx, buffer, node: Node) -> Dict:
    model_spec, _ = _specs(ctx)
    batch = {
        "tokens": buffer.get("tokens", model_spec),
        "response_mask": buffer.get("response_mask", model_spec),
        "old_values": buffer.get("old_values", model_spec),
        "returns": buffer.get("returns", model_spec),
    }
    ctx.critic_state, metrics = ctx.engines["critic_step"](ctx.critic_state, batch)
    return {f"critic/{k}": float(v) for k, v in metrics.items()}
