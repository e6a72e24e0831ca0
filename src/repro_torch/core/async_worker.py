"""Async off-policy pipeline: the staleness-bounded generation/training
scheduler, the port of ``repro.core.async_worker``.

The serialized chain splits at MODEL_TRAIN into a generation half and a
training half:

  * generated batches queue as :class:`PendingRollout`, each tagged with the
    behaviour policy's weight version (``distributed.weight_sync.
    WeightVersionStore``: the trainer publishes a new version per update);
  * a batch consumed at trainer version v must satisfy
    ``v - behavior_version <= max_staleness``. Generation dispatch is GATED
    on that bound: with one update per queued batch, a batch dispatched while
    ``len(inflight) <= max_staleness`` is consumed at staleness exactly
    ``len(inflight)``, so when the trainer falls behind, rollouts stall
    rather than go staler than the window;
  * specs with ``is_correction == "truncated"`` get the decoupled
    importance-ratio correction on stale batches: ``old_logprob`` is
    recomputed under the train-time (proximal) policy, the generation-time
    logprobs ride along as ``behavior_logprob``, and the trainer truncates
    ``exp(proximal - behaviour)`` at ``rl.is_rho_max``
    (``trainer.apply_is_correction``).

``max_staleness=0`` runs the same machinery in lockstep (generate, train the
same batch, publish) and is bitwise equal to the synchronous
:class:`~repro_torch.core.worker.DAGWorker`. ``max_staleness=1`` is the
one-step-off-policy pipelining of :class:`PipelinedDAGWorker`.

The two halves run one after the other on the one device, as in the JAX
package, with the data and staleness semantics of a concurrent schedule.
Each iteration reports what a concurrent schedule would hide:
``async/overlap_s = min(t_gen, t_train)`` whenever the trained batch is not
the one generated this iteration; that is a projection, not a measured
overlap. Generation runs on the published copy of the weights
(``WeightVersionStore.publish`` clones), never on the live tensors that the
in-place AdamW step writes.

On a rank mesh (``torch.distributed``, one process a device) every rank runs
the same scheduler over its own shards and rows. Each half enters the mesh
as the model code's ambient one (``constraint.use_mesh``), so
``dispatch_generation`` and ``consume_and_train`` may be driven alone. A
published version is a copy of the rank's train-layout shards; generation
reaches the serve layout through ``WorkerContext.serve_params`` of the
behaviour state, and the step and the truncated-IS recompute read the live
state through ``WorkerContext.model_params``, each once a half: the switched
copies are dropped when their half ends, so a rank holds no switched copy of
a version past its use. A queued batch keeps every key's databuffer spec
(``PendingRollout.specs``) and is put back under it, so a mesh whose data
axes split the rows hands each stage this rank's rows, as JAX's popped global
arrays keep their sharding. The gate counts, so every rank takes the same
dispatch and consume decision in every tick and enters the same collectives,
and every count metric (``async/staleness``, ``weight_version``,
``inflight``, ``is_corrected``, ``gen_stalled``) is equal on every rank.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional

import torch

from repro_torch.configs.base import AsyncPipelineConfig
from repro_torch.core.dag import NodeType
from repro_torch.core.worker import DAGWorker
from repro_torch.distributed import constraint
from repro_torch.distributed.weight_sync import WeightVersionStore
from repro_torch.obs.trace import get_tracer


@dataclass
class PendingRollout:
    """One generated batch waiting for the trainer: the popped buffer
    contents and the spec each key was put under (``DistributedDatabuffer.
    spec_of``; on a rank mesh the value is this rank's shard under it), the
    weight version of the behaviour policy that produced it, and the
    wall-clock the generation half took (for overlap accounting)."""

    data: Dict[str, Any]
    behavior_version: int
    gen_seconds: float = 0.0
    specs: Dict[str, Any] = field(default_factory=dict)


class AsyncDAGWorker(DAGWorker):
    """Staleness-bounded off-policy scheduler over the serialized DAG chain.

    ``clock`` is injectable (defaults to ``time.perf_counter``) so tests can
    drive the scheduler under a fake clock; the staleness gate itself is
    count-based and independent of time. ``dispatch_generation`` /
    ``consume_and_train`` are public so a driver (or test) can decouple the
    two halves, e.g. a slow trainer that stops consuming while generation
    keeps dispatching until the gate stalls it.
    """

    def __init__(self, ctx, plan, registry, buffer, coordinator=None, *,
                 async_cfg: Optional[AsyncPipelineConfig] = None, clock=None):
        super().__init__(ctx, plan, registry, buffer, coordinator)
        self.async_cfg = async_cfg or AsyncPipelineConfig(enabled=True, max_staleness=1)
        self.clock = clock or time.perf_counter
        # split the chain at MODEL_TRAIN: everything else is the rollout half.
        # The split only keeps the execution order (and the max_staleness=0
        # bitwise contract) when the train nodes close the serialized chain,
        # so DAGs with post-update nodes are refused instead of reordered.
        types = [n.type for n, _ in self.queue]
        if NodeType.MODEL_TRAIN in types:
            first_train = types.index(NodeType.MODEL_TRAIN)
            trailing = [n.node_id for (n, _) in self.queue[first_train:]
                        if n.type != NodeType.MODEL_TRAIN]
            if trailing:
                raise ValueError(
                    "async pipeline requires MODEL_TRAIN nodes to close the "
                    f"serialized chain; nodes {trailing} run after a train "
                    "node and would be reordered — run this DAG with the "
                    "synchronous worker (async_pipeline disabled)")
        self.gen_queue = [(n, f) for n, f in self.queue if n.type != NodeType.MODEL_TRAIN]
        self.train_queue = [(n, f) for n, f in self.queue if n.type == NodeType.MODEL_TRAIN]
        self._inflight: Deque[PendingRollout] = deque()
        self.train_steps = 0
        # version 0 = the pre-update weights, published lazily at the first
        # dispatch (not here: callers replace ctx.actor_state between
        # construction and the first iteration, e.g. a checkpoint resume,
        # and generation must follow)
        self.weights = WeightVersionStore()

    # ------------------------------------------------------------------ #
    @property
    def max_staleness(self) -> int:
        return self.async_cfg.max_staleness

    def can_dispatch_generation(self) -> bool:
        """The staleness gate. FIFO consumption trains the batch dispatched
        now after one update per batch already queued ahead of it, i.e. at
        staleness ``len(inflight)``: dispatch is allowed only while that
        cannot exceed the bound."""
        return len(self._inflight) <= self.max_staleness

    def _behavior_weights(self):
        """The behaviour policy for the next dispatch: the latest published
        weights. Version 0 is published lazily here, not at construction, so
        an externally replaced ctx.actor_state is what the first generation
        runs, instead of the discarded init weights."""
        if self.weights.current is None:
            self.weights.publish(
                self.ctx.actor_state.params if self.ctx.actor_state is not None else None)
        return self.weights.current

    def dispatch_generation(self, metrics: Optional[Dict[str, float]] = None
                            ) -> Optional[PendingRollout]:
        """Run the generation half under the latest published weights and
        queue the batch, unless the staleness gate stalls it (returns None)."""
        metrics = {} if metrics is None else metrics
        if not self.can_dispatch_generation():
            metrics["async/gen_stalled"] = 1.0
            return None
        with constraint.use_mesh(self.ctx.mesh):  # the model code's ambient mesh
            t0 = self.clock()
            behavior = self._behavior_weights()
            live = self.ctx.actor_state
            if (behavior is not None and behavior.params is not None and live is not None
                    and behavior.params is not live.params):
                # generation runs the published snapshot, never the live trainer
                # state (the in-place AdamW step writes the live tensors)
                self.ctx.actor_state = live._replace(params=behavior.params)
            try:
                # one span over the whole generation half: on a trace timeline
                # its width against async/train shows what overlap_ratio projects
                with get_tracer().span("async/generate", cat="async",
                                       behavior_version=self.weights.version,
                                       inflight=len(self._inflight)):
                    for node, fn in self.gen_queue:
                        self.execute_node(node, fn, metrics)
            finally:
                self.ctx.actor_state = live
                # no later stage reads the behaviour state's switched copy
                self.ctx.drop_switched()
        # continuous rollout engine: its measured generation throughput is the
        # gen-side capacity the staleness window buys overlap against
        stats = getattr(self.ctx.engines.get("generate"), "last_stats", None)
        if stats:
            metrics["async/gen_tokens_per_s"] = stats.get("tokens_per_s", 0.0)
            metrics["async/gen_slot_occupancy"] = stats.get("slot_occupancy", 1.0)
        keys = list(self.buffer.keys())
        specs = {k: self.buffer.spec_of(k) for k in keys}  # read before the pop drops them
        data = {k: self.buffer.pop(k) for k in keys}
        pending = PendingRollout(data=data, behavior_version=self.weights.version,
                                 gen_seconds=self.clock() - t0, specs=specs)
        self._inflight.append(pending)
        metrics["async/inflight"] = float(len(self._inflight))
        return pending

    def train_ready(self) -> bool:
        """A batch is consumed only once the pipeline is ``max_staleness``
        deep, so warm-up iterations are generation-only and steady-state
        consumption runs at exactly the configured staleness."""
        return len(self._inflight) > self.max_staleness

    def consume_and_train(self, metrics: Optional[Dict[str, float]] = None
                          ) -> Optional[PendingRollout]:
        """Train on the oldest queued batch, publish the new weight version,
        and report the batch's realized staleness."""
        metrics = {} if metrics is None else metrics
        if not self._inflight:
            return None
        pending = self._inflight.popleft()
        staleness = self.weights.version - pending.behavior_version
        if staleness > self.max_staleness:
            raise RuntimeError(
                f"staleness bound violated: batch generated at version "
                f"{pending.behavior_version} consumed at version "
                f"{self.weights.version} (max_staleness={self.max_staleness})")
        t0 = self.clock()
        data, specs = dict(pending.data), dict(pending.specs)
        from repro_torch.rl import algorithms

        spec = algorithms.resolve(self.ctx)
        corrected = (spec.is_correction == "truncated" and staleness > 0
                     and "old_logprob" in data and "tokens" in data
                     and "response_mask" in data)
        with constraint.use_mesh(self.ctx.mesh):  # the model code's ambient mesh
            if corrected:
                # decoupled correction: old_logprob becomes the train-time
                # (proximal) policy's logprobs, on the live params and the
                # rows a model stage reads (stages.actor_logprobs); the
                # behaviour policy's move to behavior_logprob for the
                # truncated-IS weight
                model_spec = self._model_spec()
                tokens, mask = (self._rows(data, specs, k, model_spec)
                                for k in ("tokens", "response_mask"))
                with torch.no_grad():
                    lp, _ = self.ctx.engines["logprobs"](self.ctx.model_params(), tokens)
                data["behavior_logprob"] = self._rows(data, specs, "old_logprob", model_spec)
                data["old_logprob"] = lp * mask
                specs["behavior_logprob"] = specs["old_logprob"] = model_spec
            for k, v in data.items():
                self.buffer.put(k, v, specs.get(k))
            try:
                with get_tracer().span("async/train", cat="async", staleness=staleness,
                                       is_corrected=corrected):
                    for node, fn in self.train_queue:
                        self.execute_node(node, fn, metrics)
            finally:
                # the pre-step state's switched copy goes before the publish
                self.ctx.drop_switched()
        # self-clean the consumed batch: run_iteration clears the buffer per
        # tick anyway, but a driver of the decoupled dispatch/consume API
        # must not have this batch's keys (behavior_logprob in particular)
        # leak into the next dispatch's pop
        for k in data:
            if k in self.buffer.keys():
                self.buffer.pop(k)
        self.train_steps += 1
        self.weights.publish(
            self.ctx.actor_state.params if self.ctx.actor_state is not None else None)
        metrics["async/t_train"] = self.clock() - t0
        metrics["async/staleness"] = float(staleness)
        metrics["async/weight_version"] = float(self.weights.version)
        metrics["async/is_corrected"] = float(corrected)
        return pending

    def _model_spec(self):
        """The batch spec of the model stages (``stages._specs``)."""
        from repro_torch.core import stages

        return stages._specs(self.ctx)[0]

    def _rows(self, data, specs, key: str, spec):
        """``data[key]`` (this rank's shard under ``specs[key]``) as its
        shard under ``spec``."""
        from repro_torch.distributed import collectives

        return collectives.repartition(self.ctx.mesh, data[key], spec, specs.get(key))

    # ------------------------------------------------------------------ #
    def run_iteration(self) -> Dict[str, float]:
        """One scheduler tick: dispatch generation if the gate allows, then
        train on the oldest batch once the pipeline is deep enough. With
        max_staleness=0 this is generate-then-train on the same batch (the
        synchronous schedule); with W>=1 the trained batch predates the one
        just generated, and a concurrent schedule would overlap the two."""
        metrics: Dict[str, float] = {}
        dispatched = self.dispatch_generation(metrics)
        consumed = None
        if self.train_ready():
            consumed = self.consume_and_train(metrics)
        t_gen = dispatched.gen_seconds if dispatched is not None else 0.0
        t_train = metrics.get("async/t_train", 0.0)
        metrics["async/t_gen"] = t_gen
        # overlap a concurrent schedule would realize this tick: gen(i+W) and
        # train(i) could run on disjoint resources iff they are different
        # batches, hiding the smaller of the two stage times
        pipelined = consumed is not None and consumed is not dispatched
        hidden = min(t_gen, t_train) if pipelined else 0.0
        busy = t_gen + t_train
        metrics["async/overlap_s"] = hidden
        metrics["async/overlap_ratio"] = hidden / busy if busy > 0 else 0.0
        # the one-step-off-policy worker's metric name
        metrics["pipeline/staleness"] = metrics.get("async/staleness", 0.0)
        self.buffer.clear()  # intermediate data is transient (paper §6)
        if self.ctx.obs is not None:
            self.ctx.obs.registry.record_dict(metrics)
        return metrics


class PipelinedDAGWorker(AsyncDAGWorker):
    """The one-step-off-policy worker: AsyncDAGWorker pinned at
    ``max_staleness=1``."""

    def __init__(self, ctx, plan, registry, buffer, coordinator=None):
        super().__init__(ctx, plan, registry, buffer, coordinator,
                         async_cfg=AsyncPipelineConfig(enabled=True, max_staleness=1))
