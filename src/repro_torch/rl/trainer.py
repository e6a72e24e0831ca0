"""Actor / critic update steps (port of ``repro.rl.trainer``; the DAG's
MODEL_TRAIN nodes).

Each step is a function ``(state, batch) -> (state, metrics)``: loss ->
grad -> global-norm clip -> AdamW, as in the JAX package. ``jax.value_and_grad``
becomes :func:`value_and_grad`, which runs the loss on detached leaves that
require grad and takes ``torch.autograd.grad`` over them. The AdamW update
is made in place (``optim.adamw``): a step uses up the state it is given.

On a rank mesh (``torch.distributed``, one process a device) the steps are
data-parallel with FSDP state (:func:`make_dp_step`): at rest each rank
holds its shard of the params and of both AdamW moments under
``distributed.sharding.param_specs(..., "train")``; a step all-gathers the
params over the data axes, computes the loss on the rank's rows of the
batch weighted so that the data ranks' losses sum to the global-batch loss,
reduce-scatters the grads over the data axes into the param shards, clips
on the global norm and runs AdamW on the shards. With ``model`` > 1 the
gathered params are this rank's ``model`` shards and the forward is
tensor-parallel (``distributed.constraint``): the ranks of one data row hold
the same rows, and a leaf replicated over ``model`` ends with the same
gradient on each of them.

The batch must hold ordinary tensors: rollouts come out of
``rl.rollout.generate`` as inference tensors, which autograd refuses to save
for the backward, so the stage that hands them on clones them first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import Model
from repro_torch.optim import adamw
from repro_torch.rl import critic as critic_mod
from repro_torch.rl import loss as losses


@dataclasses.dataclass(frozen=True)
class RLConfig:
    # registered algorithm name (rl.algorithms: grpo | ppo | rloo |
    # reinforce_pp | anything added via register_algorithm)
    algorithm: str = "grpo"
    lr: float = 1e-6
    critic_lr: float = 1e-5
    clip_eps: float = 0.2
    kl_coef: float = 0.001
    entropy_coef: float = 0.0
    max_grad_norm: float = 1.0
    gamma: float = 1.0
    gae_lambda: float = 0.95
    group_size: int = 8  # GRPO rollouts per prompt
    temperature: float = 1.0
    max_new_tokens: int = 16
    weight_decay: float = 0.0
    # truncation bound of the decoupled importance-ratio correction applied
    # to stale batches when the algorithm opts in (is_correction == "truncated")
    is_rho_max: float = 2.0


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(params) -> TrainState:
    return TrainState(params=params, opt=adamw.init(params))


def value_and_grad(f: Callable, params, *,
                   on_loss: Optional[Callable[[], None]] = None
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Any]:
    """``jax.value_and_grad(f, has_aux=True)(params)``: ((loss, aux), grads),
    grads a tree like ``params`` in each leaf's dtype (zeros for a leaf the
    loss does not reach). The loss and aux come back detached. ``on_loss``,
    if given, is called between the forward and the backward (a timing
    mark)."""
    flat, unflatten = tree.flatten(params)
    leaves = [t.detach().requires_grad_() for t in flat]
    loss, aux = f(unflatten(leaves))
    if on_loss is not None:
        on_loss()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), unflatten(grads)


def _resolve_algorithm(rl: RLConfig, algorithm=None):
    if algorithm is not None:
        return algorithm
    from repro_torch.rl import algorithms  # deferred: algorithms imports rl.loss

    return algorithms.get_algorithm(rl.algorithm)


def apply_is_correction(rl: RLConfig, spec, batch: Dict[str, torch.Tensor]):
    """Decoupled truncated-IS correction for stale (off-policy) batches: when
    the spec opted in (``is_correction == "truncated"``) and the batch carries
    ``behavior_logprob``, the advantages are scaled by
    min(exp(old - behaviour), rl.is_rho_max). Other batches pass through.
    Returns (batch, metrics)."""
    if spec.is_correction != "truncated" or "behavior_logprob" not in batch:
        return batch, {}
    w = losses.truncated_is_weights(batch["old_logprob"], batch["behavior_logprob"],
                                    batch["response_mask"], rho_max=rl.is_rho_max)
    rho = w.pop("rho")
    return dict(batch, advantages=batch["advantages"] * rho), w


def actor_loss_fn(model: Model, rl: RLConfig, params, batch: Dict[str, torch.Tensor], *,
                  algorithm=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    spec = _resolve_algorithm(rl, algorithm)
    lp, ent = model.logprobs(params, batch["tokens"], remat=True)
    mask = batch["response_mask"]
    batch, is_metrics = apply_is_correction(rl, spec, batch)
    out = spec.actor_loss(rl, lp, batch)
    out.update(is_metrics)
    loss = out.pop("loss")
    m = mask.float()
    out["entropy"] = torch.sum(ent * m) / torch.clamp(torch.sum(m), min=1.0)
    if rl.entropy_coef:
        loss = loss - rl.entropy_coef * out["entropy"]
    return loss, out


def _clip_and_update(state: TrainState, grads, *, max_grad_norm: float, lr: float,
                     weight_decay: float = 0.0):
    grads, gnorm = adamw.clip_by_global_norm(grads, max_grad_norm)
    params, opt = adamw.update(grads, state.opt, state.params, lr=lr,
                               weight_decay=weight_decay)
    return TrainState(params, opt), gnorm


def make_actor_grad_fn(model: Model, rl: RLConfig, *, algorithm=None) -> Callable:
    """The loss + grad half of :func:`make_actor_step`: ``(params, batch) ->
    (grads, metrics)``."""
    spec = _resolve_algorithm(rl, algorithm)

    def grad_fn(params, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: actor_loss_fn(model, rl, p, batch, algorithm=spec), params)
        return grads, dict(metrics, loss=loss)

    return grad_fn


def make_actor_apply_fn(rl: RLConfig) -> Callable:
    """The clip + update half of :func:`make_actor_step`: ``(state, grads) ->
    (state, metrics)``."""

    def apply_fn(state: TrainState, grads):
        state, gnorm = _clip_and_update(state, grads, max_grad_norm=rl.max_grad_norm,
                                        lr=rl.lr, weight_decay=rl.weight_decay)
        return state, {"grad_norm": gnorm}

    return apply_fn


def make_actor_step(model: Model, rl: RLConfig, *, algorithm=None) -> Callable:
    grad_fn = make_actor_grad_fn(model, rl, algorithm=algorithm)
    apply_fn = make_actor_apply_fn(rl)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = grad_fn(state.params, batch)
        state, applied = apply_fn(state, grads)
        return state, dict(metrics, **applied)

    return step


def make_critic_step(cfg: ModelConfig, rl: RLConfig) -> Callable:
    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        def loss_fn(p):
            v = critic_mod.values_fn(cfg, p, batch["tokens"], remat=True)
            out = losses.value_loss(v, batch["old_values"], batch["returns"],
                                    batch["response_mask"], clip_eps=rl.clip_eps)
            return out.pop("loss"), out

        (loss, metrics), grads = value_and_grad(loss_fn, state.params)
        state, gnorm = _clip_and_update(state, grads, max_grad_norm=rl.max_grad_norm,
                                        lr=rl.critic_lr)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step


def make_actor_step_accumulated(model: Model, rl: RLConfig, *, num_microbatches: int,
                                algorithm=None) -> Callable:
    """Gradient-accumulated actor update: the batch is split into
    ``num_microbatches`` taken one after another, their grads averaged in
    fp32, for the update of one whole-batch step with the activations of one
    microbatch. Metrics are the last microbatch's, the loss the mean."""
    spec = _resolve_algorithm(rl, algorithm)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        B = batch["tokens"].shape[0]
        assert B % num_microbatches == 0, (B, num_microbatches)
        mb = B // num_microbatches
        grads = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         state.params)
        loss = torch.zeros((), device=batch["tokens"].device)
        for i in range(num_microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            (mb_loss, metrics), mb_grads = value_and_grad(
                lambda p: actor_loss_fn(model, rl, p, part, algorithm=spec), state.params)
            grads = tree.map(lambda a, g: a + g.float() / num_microbatches, grads, mb_grads)
            loss = loss + mb_loss / num_microbatches
        state, gnorm = _clip_and_update(state, grads, max_grad_norm=rl.max_grad_norm,
                                        lr=rl.lr, weight_decay=rl.weight_decay)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step


def make_lm_train_step(model: Model, *, lr: float = 3e-4, max_grad_norm: float = 1.0):
    """Plain LM CE train step (the supervised arm of the framework)."""

    def step(state: TrainState, batch):
        (loss, metrics), grads = value_and_grad(lambda p: model.loss(p, batch), state.params)
        state, gnorm = _clip_and_update(state, grads, max_grad_norm=max_grad_norm, lr=lr)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return step


# --------------------------------------------------------------------------- #
# data parallelism over a rank mesh, FSDP state
# --------------------------------------------------------------------------- #
def shard_state(mesh, params, specs) -> TrainState:
    """A ``TrainState`` of this rank's shards: ``params`` (whole, the same on
    every rank) cut under ``specs``, and AdamW moments of the shards."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shr

    return init_state(shr.map_with_specs(
        lambda p, s: collectives.shard(mesh, p, s).clone(), params, specs))


def gather_params(mesh, params, specs, axes=None):
    """The full params from every rank's shards (all-gathered leaf by leaf;
    plain local tensors); with ``axes``, gathered over those mesh axes
    only."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shr

    return shr.map_with_specs(lambda p, s: collectives.all_gather(mesh, p, s, axes=axes),
                              params, specs)


def data_axes(mesh):
    """The axes a step sums its rows over: the data axes when ``model`` > 1
    (its ranks hold the same rows), else None (every axis)."""
    from repro_torch.distributed import sharding as shr

    return shr.fsdp_axes(mesh) if mesh.shape.get("model", 1) > 1 else None


def _replicas(mesh, spec) -> int:
    """Ranks that hold the same region of a leaf under ``spec``."""
    from repro_torch.distributed import sharding as shr

    split = 1
    for axes in shr.dim_axes(spec, len(spec)):
        for a in axes:
            split *= mesh.shape[a]
    return mesh.num_ranks // split


def make_dp_step(mesh, specs, loss_fn: Callable, *, lr: float, max_grad_norm: float,
                 weight_decay: float = 0.0,
                 full_params: Optional[Callable[[TrainState], Any]] = None) -> Callable:
    """A data-parallel ``(state, batch) -> (state, metrics)`` step over a
    rank mesh. ``state`` holds this rank's shards under ``specs``; ``batch``
    this rank's rows. ``loss_fn(params, batch) -> (loss, aux)`` is a
    token-level mean over ``batch["response_mask"]`` (as every RL loss here
    is), with aux metrics of the same kind. ``full_params(state)`` gives the
    params the forward reads (default: all-gathered from the shards over the
    data axes, :func:`data_axes`; at ``model`` > 1 this rank's ``model``
    shards, and the forward runs on the mesh as the ambient one).

    Rank r's loss is weighted by ``M_r / max(M, 1)`` (its mask's token count
    over the global count, both over the data axes), so the data ranks'
    losses and grads sum to the global-batch loss's and every metric sums
    to its global value. The grads cross as fp32 over the data axes and
    come back in each leaf's dtype; the global norm is an all-reduce over
    every rank of the shards' squared norms, each counted once over the
    ranks that hold it."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import constraint

    spec_list = None
    axes = data_axes(mesh)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        nonlocal spec_list
        full = (full_params(state) if full_params is not None
                else gather_params(mesh, state.params, specs, axes=axes))
        count = batch["response_mask"].float().sum()
        weight = count / torch.clamp(collectives.all_reduce(mesh, count, axes=axes), min=1.0)

        def weighted(p):
            loss, aux = loss_fn(p, batch)
            return loss * weight, aux

        with constraint.use_mesh(mesh):
            (loss, aux), grads = value_and_grad(weighted, full)
        del full
        names = sorted(aux)
        local = torch.stack([loss.float()] + [aux[k].float() * weight for k in names])
        summed = collectives.all_reduce(mesh, local, axes=axes)
        flat, unflatten = tree.flatten(grads)
        if spec_list is None:
            from repro_torch.distributed import sharding as shr

            spec_list = shr.spec_leaves(specs, state.params)
        shards = collectives.reduce_scatter(mesh, flat, spec_list, axes=axes)
        del grads, flat
        sq = sum(torch.sum(torch.square(g)) / _replicas(mesh, sp)
                 for g, sp in zip(shards, spec_list))
        gnorm = torch.sqrt(collectives.all_reduce(mesh, sq))
        shards = unflatten([g.to(p.dtype) for g, p in zip(shards, tree.leaves(state.params))])
        shards = adamw.clip_by_norm(shards, gnorm, max_grad_norm)
        params, opt = adamw.update(shards, state.opt, state.params, lr=lr,
                                   weight_decay=weight_decay)
        metrics = {k: summed[i + 1] for i, k in enumerate(names)}
        return TrainState(params, opt), dict(metrics, loss=summed[0], grad_norm=gnorm)

    return step


def make_dp_actor_step(model: Model, rl: RLConfig, mesh, specs, *, algorithm=None,
                       full_params: Optional[Callable[[TrainState], Any]] = None) -> Callable:
    """:func:`make_actor_step` over a rank mesh (:func:`make_dp_step`)."""
    spec = _resolve_algorithm(rl, algorithm)
    return make_dp_step(
        mesh, specs, lambda p, b: actor_loss_fn(model, rl, p, b, algorithm=spec),
        lr=rl.lr, max_grad_norm=rl.max_grad_norm, weight_decay=rl.weight_decay,
        full_params=full_params)


def make_dp_critic_step(cfg: ModelConfig, rl: RLConfig, mesh, specs) -> Callable:
    """:func:`make_critic_step` over a rank mesh (:func:`make_dp_step`)."""

    def loss_fn(p, batch):
        v = critic_mod.values_fn(cfg, p, batch["tokens"], remat=True)
        out = losses.value_loss(v, batch["old_values"], batch["returns"],
                                batch["response_mask"], clip_eps=rl.clip_eps)
        return out.pop("loss"), out

    return make_dp_step(mesh, specs, loss_fn, lr=rl.critic_lr,
                        max_grad_norm=rl.max_grad_norm)
