"""DAG Worker (paper §5), the per-process controller: the port of
``repro.core.worker``.

Lifecycle: Initialization (bind functions to nodes via the registry,
materialize the execution queue) + iterative Execution (walk the chain, the
databuffer brokering every stage boundary). Every process runs an identical
DAGWorker over its own data shard, the multi-controller paradigm; there is
no coordinator process anywhere. The port runs one worker on one device; a
fleet host runs it over the fleet mesh's ``pod`` axis, which the length
balancer bins hierarchically, as the JAX worker does.

JAX's ``key``/``next_key()`` becomes an explicit ``torch.Generator`` on the
run's device (``WorkerContext.gen``), which the generate engine draws its
per-step sampling seeds from. On a rank mesh the generator stands behind a
``rollout.RankRows`` view that draws the global batch's seeds and hands
this rank its rows', so the ranks sample as one device would.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import DataCoordinatorConfig
from repro_torch.core.dag import Node, NodeType
from repro_torch.core.databuffer import DistributedDatabuffer
from repro_torch.core.planner import ExecutionPlan
from repro_torch.core.registry import Registry
from repro_torch.distributed import constraint
from repro_torch.ft import straggler
from repro_torch.obs.trace import get_tracer


@dataclass
class WorkerContext:
    """Everything a stage function may touch. Mutable fields (actor_state,
    critic_state) are updated in place by train nodes."""

    mesh: Any
    rl: Any
    engines: Dict[str, Callable]
    dataloader: Any
    actor_state: Any = None
    critic_state: Any = None
    ref_params: Any = None
    tokenizer: Any = None
    # the run's sampling generator, on the run's device
    gen: Optional[torch.Generator] = None
    # the AlgorithmSpec driving this run (repro_torch.rl.algorithms); None
    # means "resolve rl.algorithm from the registry on demand"
    algorithm: Any = None
    # the prompt iterator the GENERATE stage pulls from (bound by the worker
    # at init, see PromptSource); None falls back to ctx.dataloader directly
    prompt_source: Any = None
    # the bound environment (repro_torch.rl.envs.EnvRuntime) when the run's
    # EnvConfig names one; the (ENV, COMPUTE) stage reads it
    env: Any = None
    counters: Dict[str, float] = field(default_factory=dict)
    # the ObsState (repro_torch.obs) when an ObsConfig is enabled; None = no
    # telemetry
    obs: Any = None
    # on a fleet host (an enabled DistributedConfig): its FleetContext and
    # the GradExchange inside its actor step (repro_torch.distributed.fleet)
    fleet: Any = None
    grad_exchange: Any = None
    # on a rank mesh (torch.distributed): the specs the actor state's shards
    # lie under (distributed.sharding.param_specs, "train"), and those of
    # the serve layout generation reads (mode "serve"); None on one device
    param_specs: Any = None
    serve_specs: Any = None
    critic_specs: Any = None
    _serve_cache: Any = None
    _model_cache: Any = None

    def serve_params(self, state=None):
        """The params of ``state`` (the actor's by default) that generation
        reads: the state's own on one device; on a rank mesh, its shards
        switched to the serve layout (``weight_sync.switch``), once for each
        new state."""
        state = self.actor_state if state is None else state
        if self.param_specs is None:
            return state.params
        cached = self._serve_cache
        if cached is None or cached[0] is not state:
            from repro_torch.distributed import weight_sync

            self._serve_cache = None  # the previous copy goes before the new one
            params = weight_sync.switch(self.mesh, state.params, self.serve_specs,
                                        specs=self.param_specs)
            self._serve_cache = (state, params)
        return self._serve_cache[1]

    def model_params(self, state=None):
        """The params of ``state`` (the actor's by default) that the logprob
        stages and the actor step read: with ``model`` > 1 its train-layout
        shards gathered over the data axes (this rank's ``model`` shards),
        once for each new state; else :meth:`serve_params`."""
        state = self.actor_state if state is None else state
        if self.param_specs is None or self.mesh.shape.get("model", 1) == 1:
            return self.serve_params(state)
        cached = self._model_cache
        if cached is None or cached[0] is not state:
            from repro_torch.rl import trainer

            self._model_cache = None
            params = trainer.gather_params(self.mesh, state.params, self.param_specs,
                                           axes=trainer.data_axes(self.mesh))
            self._model_cache = (state, params)
        return self._model_cache[1]

    def drop_switched(self) -> None:
        """Drop the copies that :meth:`serve_params` and :meth:`model_params`
        keep, and with them the state they were made for. The async worker
        calls it as each of its halves ends: generation reads the behaviour
        version and the step the live state, so neither half's copy serves
        the other, and a rank holds no switched copy past its half."""
        self._serve_cache = self._model_cache = None


class PromptSource:
    """The worker-owned prompt iterator handed to the GENERATE stage. Each
    ``next_prompts()`` serves the iteration's prompt batch already
    group-expanded (GRPO's ``group_size`` rollouts per prompt)."""

    def __init__(self, dataloader, group_size: int = 1):
        self.dataloader = dataloader
        self.group_size = group_size

    def next_prompts(self):
        batch = self.dataloader.next_batch()
        prompts, answers = batch["prompts"], batch["answers"]
        if self.group_size > 1:
            prompts = torch.repeat_interleave(prompts, self.group_size, dim=0)
            answers = torch.repeat_interleave(answers, self.group_size, dim=0)
        return prompts, answers


class DAGWorker:
    def __init__(
        self,
        ctx: WorkerContext,
        plan: ExecutionPlan,
        registry: Registry,
        buffer: DistributedDatabuffer,
        coordinator: Optional[DataCoordinatorConfig] = None,
    ):
        self.ctx = ctx
        self.plan = plan
        self.registry = registry
        self.buffer = buffer
        self.coordinator = coordinator or DataCoordinatorConfig()
        # Initialization phase: materialize the execution queue by binding a
        # concrete function to every node (paper Fig. 5).
        self.queue: List[tuple] = [
            (task.node, self.registry.resolve(task.node)) for task in plan.tasks
        ]
        # hand the GENERATE stage its prompt iterator: bound here, once, so
        # the group expansion is resolved from the algorithm spec instead of
        # re-derived per stage call
        if ctx.prompt_source is None and ctx.dataloader is not None:
            try:
                from repro_torch.rl import algorithms

                g = algorithms.resolve(ctx).group_size(ctx.rl)
            except (KeyError, AttributeError):
                # hand-rolled ctx without a resolvable algorithm (unknown
                # registry name / no rl config): no grouping. Anything else
                # (e.g. a custom spec whose group_size raises) stays loud.
                g = 1
            ctx.prompt_source = PromptSource(ctx.dataloader, g)

    def run_iteration(self) -> Dict[str, float]:
        """One RL iteration: execute the serialized chain; the databuffer is
        the intermediary state manager between nodes."""
        metrics: Dict[str, float] = {}
        with constraint.use_mesh(self.ctx.mesh):  # the model code's ambient mesh
            for node, fn in self.queue:
                self.execute_node(node, fn, metrics)
        self.buffer.clear()  # intermediate data is transient (paper §6)
        if self.ctx.obs is not None:
            self.ctx.obs.registry.record_dict(metrics)
        return metrics

    def execute_node(self, node: Node, fn, metrics: Dict[str, float]) -> None:
        """Run one stage, record its host wall time (``time/<node>``: the
        time for the stage to return, with no device synchronisation of its
        own), and apply the Data Coordinator's post-rollout hooks
        (length-aware load balancing runs right after GENERATE, once response
        lengths are known). While the balance repack may rewrite the rollout
        keys, a double buffer's put-time staging is paused so each key is
        staged only once, for the batch order consumers will actually read."""
        t0 = time.perf_counter()
        balance_here = node.type == NodeType.GENERATE and self.coordinator.load_balance
        pause = getattr(self.buffer, "staging_paused", None)
        with get_tracer().span(f"node/{node.node_id}", cat="dag",
                               node=node.node_id, role=node.role) as sp:
            try:
                with contextlib.ExitStack() as stack:
                    if balance_here and pause is not None:
                        stack.enter_context(pause())
                    out = fn(self.ctx, self.buffer, node)
                    metrics.update(out or {})
                    metrics[f"time/{node.node_id}"] = time.perf_counter() - t0
                    if balance_here:
                        metrics.update(self._balance_rollouts())
            except BaseException:
                # a raising stage is exactly when timing matters: keep the
                # partial duration and flag the failure instead of losing both
                metrics[f"time/{node.node_id}"] = time.perf_counter() - t0
                metrics[f"error/{node.node_id}"] = 1.0
                sp.set(error=1)
                raise

    # ------------------------------------------------------------------ #
    def _num_buckets(self) -> int:
        if self.coordinator.num_buckets > 0:
            return self.coordinator.num_buckets
        dp = 1
        for name, size in self.ctx.mesh.shape.items():
            if name != "model":
                dp *= size
        return dp

    def _balance_rollouts(self) -> Dict[str, float]:
        """Length-aware load balancing (paper §6.2): permute the just-rolled-
        out batch so contiguous DP shards carry near-equal token counts
        before the MODEL_INFERENCE / MODEL_TRAIN stages consume it. GRPO
        prompt groups move as units, so group-relative advantages are
        unaffected. Every worker computes the identical permutation from the
        response mask; no coordinator."""
        nb = self._num_buckets()
        if nb <= 1 or "response_mask" not in self.buffer.keys():
            return {}
        skipped = {"balance/skipped": 1.0}
        from repro_torch.rl import algorithms

        mask = self.buffer.global_value("response_mask")
        lengths = mask.sum(dim=1).cpu().numpy()
        g = algorithms.resolve(self.ctx).group_size(self.ctx.rl)
        B = len(lengths)
        # groups must divide evenly into buckets: the DP sharding splits rows
        # evenly, so uneven group capacities would balance token totals over
        # shard boundaries that don't exist on the hardware. The skip metric
        # keeps a misconfigured num_buckets from disabling balancing invisibly.
        if B % g or (B // g) % nb:
            return skipped
        # fleet meshes balance hierarchically: bin within a host first, swap
        # across the slow pod axis only when host totals exceed tolerance
        H = self.ctx.mesh.shape.get("pod", 1)
        hier = H > 1 and nb % H == 0 and (B // g) % H == 0
        before = straggler.bucket_token_ratio(lengths, nb)
        perm = straggler.balance_by_length(lengths, nb, group_size=g,
                                           hosts=H if hier else 1)
        after = straggler.bucket_token_ratio(lengths, nb, perm)
        if after < before:  # only repack when it helps
            from repro_torch.distributed import collectives

            dperm = torch.as_tensor(perm, device=self.ctx.mesh.device)
            for key in self.buffer.keys():
                value = self.buffer.global_value(key)
                if value.ndim >= 1 and value.shape[0] == B:
                    # re-put under the producer's spec (on a rank mesh, this
                    # rank's rows of the permuted global batch)
                    spec = self.buffer.spec_of(key)
                    value = value.index_select(0, dperm)
                    if self.ctx.mesh.torch_mesh is not None:
                        value = collectives.shard(self.ctx.mesh, value, spec)
                    self.buffer.put(key, value, spec)
        achieved = min(after, before)
        out = {
            "balance/token_ratio_before": before,
            "balance/token_ratio_after": achieved,
            "balance/repacked": float(after < before),
            # 1.0 when even the repacked batch exceeds the tolerance, i.e. a
            # single sequence/group dominates and only max-len bounding helps
            "balance/over_tolerance": float(achieved > self.coordinator.balance_tolerance),
        }
        if hier:
            out["balance/cross_host_row_moves"] = float(
                straggler.cross_host_rows(perm, H) if after < before else 0)
        return out
