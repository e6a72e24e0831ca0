"""Model, serving and run configuration (a copy of ``repro.configs.base``
without its parameter count and TPU shape cells).

Every architecture is expressed as a :class:`ModelConfig`: a pure description
of the layer-kind layout, head counts and MoE/SSM settings. The PyTorch model
(``repro_torch.models``) interprets it; the launcher selects it via
``--arch <id>`` through :mod:`repro_torch.configs.registry`. The fields and
their defaults are those of the JAX package, so one config describes the same
model in both packages and the weight bridge can map one onto the other.

The run-configuration dataclasses (``DataCoordinatorConfig``,
``RolloutEngineConfig``, ``EnvConfig``, ``AsyncPipelineConfig``,
``DistributedConfig``, ``ObsConfig``) are copies too, with the same fields,
defaults and checks, so that ``ExperimentSpec.to_dict()`` of either package
loads in the other. Their docstrings name the JAX package's subsystems; the
port's ``core.pipeline.build_pipeline`` raises ``NotImplementedError`` for
every option whose subsystem is not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

VOCAB_ALIGN = 256  # pad vocab to multiples of this


def pad_to(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering dense / MoE / SSM / hybrid /
    enc-dec / VLM families."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int  # raw (pre-padding) vocabulary size

    # --- MLP / norm flavour ---
    mlp_type: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    use_bias: bool = False
    parallel_block: bool = False  # command-r style parallel attn+mlp residual
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)

    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # mixtral SWA
    # Layer-kind layout for hybrid archs. attn_layer_period==0 -> all layers
    # attention (dense); period p with offset o -> layer i is attention iff
    # i % p == o, otherwise the SSM mixer.
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_layer_period: int = 1  # layer i is MoE iff i % period == offset
    moe_layer_offset: int = 0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # --- enc-dec (seamless) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_len: int = 4096  # encoder memory length used by decode shapes

    # --- modality frontend stubs ---
    # Number of prefix embedding slots supplied pre-computed (ViT patches for
    # VLM, audio frames for audio archs). 0 = pure text.
    num_prefix_embeds: int = 0

    # --- numerics / layout ---
    dtype: str = "bfloat16"
    # int8 KV cache with per-slot-per-head scales (not ported yet)
    kv_quant: bool = False
    # Pad num_heads up to a multiple of this (zero heads; exact, their W_o
    # rows are zero). Reduced smoke configs set 1.
    pad_heads_to: int = 16
    # Sub-quadratic? (SSM/hybrid state, or bounded SWA window.)
    subquadratic: bool = False

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_ALIGN)

    @property
    def padded_heads(self) -> int:
        return pad_to(self.num_heads, self.pad_heads_to)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        if self.ssm_state == 0:
            return 0
        return self.ssm_d_inner // self.ssm_headdim

    # layer-kind helpers ------------------------------------------------ #
    def is_attn_layer(self, i: int) -> bool:
        if self.ssm_state == 0:
            return True
        if self.attn_layer_period == 0:
            return False  # pure SSM
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_layer_period == self.moe_layer_offset

    def has_mlp(self) -> bool:
        """Pure Mamba2 blocks carry no separate MLP (d_ff == 0)."""
        return self.d_ff > 0

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """((mixer_kind, mlp_kind), ...) per layer.

        mixer_kind in {attn, ssm}; mlp_kind in {dense, moe, none}.
        """
        out = []
        for i in range(self.num_layers):
            mixer = "attn" if self.is_attn_layer(i) else "ssm"
            if not self.has_mlp():
                mlp = "none"
            elif self.is_moe_layer(i):
                mlp = "moe"
            else:
                mlp = "dense"
            out.append((mixer, mlp))
        return tuple(out)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=16,
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=256,
        pad_heads_to=1,
        sliding_window=16 if cfg.sliding_window else None,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        num_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_len=32,
        num_prefix_embeds=8 if cfg.num_prefix_embeds else 0,
        name=cfg.name + "-smoke",
    )
    # keep layer-layout periods valid for the reduced depth
    if cfg.attn_layer_period:
        base["attn_layer_period"] = 4
        base["attn_layer_offset"] = 1
        base["num_layers"] = 4
    base.update(overrides)
    return dataclasses.replace(cfg, **base)


# --------------------------------------------------------------------------- #
# Request-streaming serving (repro_torch.serving)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ServingConfig:
    """Flags for the streaming serving engine (``repro_torch.serving``).

    The serving engine promotes the continuous rollout engine's slot pool
    into a request-streaming server: an admission queue of per-request
    arrival-stamped :class:`repro_torch.serving.Request` objects, a paged KV arena
    (block tables over fixed-size pages, so resident KV — parked sequences
    plus cached prefixes — can outgrow the ``num_slots x max_len`` compute
    staging), a shared-prefix radix cache (a prompt prefix any request has
    prefilled is never prefilled again), and live weight hot-swap from a
    weight store (``.version``, ``.current.params``) between decode
    bursts. See ``docs/serving.md`` for the request lifecycle and the
    metrics glossary. A copy of ``repro.configs.base.ServingConfig``: the
    same fields, defaults and checks.
    """

    # decode-slot pool size (compute lanes; queued requests wait without KV)
    num_slots: int = 8
    # per-slot KV width: prompt + response tokens a slot can hold. Must be a
    # multiple of page_size (slot rows are staged page-aligned).
    max_len: int = 256
    # response-token cap per request (requests may ask for less, never more)
    max_new: int = 64
    # KV page size in tokens: the block-table / prefix-cache granularity.
    # Admission buckets, chunked prefill, and cache commits all run at this
    # grain, which is what makes a cache hit bitwise-identical to the cold
    # prefill of the same request.
    page_size: int = 16
    # page-pool capacity; 0 = 2 x the slot arena (num_slots * max_len /
    # page_size pages), i.e. resident KV can be 3x the compute staging
    num_pages: int = 0
    # shared-prefix radix cache over committed pages (off = every request
    # prefills its full prompt)
    prefix_cache: bool = True
    # decode steps per burst between scheduler visits: each visit flushes
    # stream deltas, polls the weight store, and admits/parks requests
    decode_burst: int = 8
    # fair-share preemption: a request that has decoded this many tokens
    # since its last (re)admission is parked to pages — freeing its slot for
    # waiting arrivals — and re-queued; 0 disables parking
    yield_quota: int = 0
    # poll the WeightVersionStore between bursts and hot-swap to the newest
    # published version without dropping in-flight requests
    poll_weights: bool = True

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.max_len < self.page_size or self.max_len % self.page_size:
            raise ValueError(
                f"max_len must be a positive multiple of page_size "
                f"({self.page_size}), got {self.max_len}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.max_new >= self.max_len:
            raise ValueError(
                f"max_new ({self.max_new}) must leave prompt room under "
                f"max_len ({self.max_len})")
        if self.num_pages < 0:
            raise ValueError(f"num_pages must be >= 0, got {self.num_pages}")
        if self.decode_burst < 1:
            raise ValueError(
                f"decode_burst must be >= 1, got {self.decode_burst}")
        if self.yield_quota < 0:
            raise ValueError(
                f"yield_quota must be >= 0, got {self.yield_quota}")

    @property
    def pages_per_slot(self) -> int:
        return self.max_len // self.page_size

    @property
    def pool_pages(self) -> int:
        """Effective page-pool capacity (resolves the num_pages=0 default).
        Active requests' KV lives in the pool too (decode attends pages
        directly through block tables), so the default budgets a full
        arena of active spans plus two arenas' worth of parked/prefix
        pages."""
        if self.num_pages:
            return self.num_pages
        return 3 * self.num_slots * self.pages_per_slot


# --------------------------------------------------------------------------- #
# Data Coordinator (paper §6: Distributed Dataloader + Databuffer).
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DataCoordinatorConfig:
    """Flags for Data Coordinator v2 (paper §6.2: "local caching, load
    balancing, and asynchronous double buffer"). All off by default — the
    defaults reproduce the synchronous v1 coordinator bit-for-bit."""

    # two rotating databuffer slots + spec prefetch: stage-boundary reshards
    # for iteration i+1 are dispatched while iteration i still computes
    double_buffer: bool = False
    # repack variable-length rollout batches into near-equal-token DP buckets
    # before MODEL_INFERENCE / MODEL_TRAIN stages (LPT binning,
    # ft.straggler.balance_by_length)
    load_balance: bool = False
    # dataloader look-ahead: materialize the next `prefetch` per-device
    # partitions one step ahead of the consumer (0 = synchronous)
    prefetch: int = 0
    # number of token buckets for the load balancer; 0 = the mesh's DP degree
    # (product of non-"model" axes). Values > DP degree create virtual
    # buckets, useful on small meshes / in tests.
    num_buckets: int = 0
    # alert threshold: balance metrics report when max/mean bucket tokens
    # exceeds this after repacking
    balance_tolerance: float = 1.25


# --------------------------------------------------------------------------- #
# Continuous-batching rollout engine (beyond-paper: vLLM/AsyncFlow-style
# in-flight batching for the GENERATE stage).
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class RolloutEngineConfig:
    """Flags for the GENERATE-stage generation engine
    (``rl/rollout_engine.ContinuousRolloutEngine``).

    ``engine="lockstep"`` (default) keeps the original ``rl.rollout.generate``
    path: every prompt padded to a common length, all ``max_new`` decode steps
    scanned even after every sequence emitted EOS. ``engine="continuous"``
    runs a fixed pool of ``num_slots`` decode slots over one persistent
    KV-cache arena: a slot whose sequence hits EOS is immediately refilled
    with the next queued prompt, and the decode loop early-exits (a
    ``lax.while_loop`` on ``all(done)``) once the prompt queue drains. Under
    a fixed slot schedule (``num_slots`` >= batch, one length bucket) the
    continuous engine is token-for-token identical to lockstep — asserted by
    the test suite. See ``docs/rollout_engine.md``.
    """

    engine: str = "lockstep"  # "lockstep" | "continuous"
    # decode-slot pool size; 0 = one slot per sequence in the batch (no
    # queueing — early-exit is then the only win). Values < batch enable
    # slot refill: the queue's remaining prompts backfill freed slots.
    num_slots: int = 0
    # chunked prefill: split each refill prompt into chunks of this many
    # tokens so one long prefill is broken into bounded pieces (0 = whole
    # prompt in one pass). Attention-only archs without KV rings.
    prefill_chunk: int = 0
    # length bucketing: round each prompt's true (non-pad) length up to a
    # multiple of this and prefill at the bucket length instead of the
    # batch's padded max (0 = single bucket at the padded length, which is
    # the lockstep-equivalent schedule).
    prefill_bucket: int = 0
    # minimum newly-freed slots before the decode loop hands control back
    # for a refill while prompts pend. 1 = refill eagerly (max occupancy);
    # 2-4 coalesces refill batches when dispatch overhead rivals a decode
    # step (CPU hosts).
    refill_threshold: int = 1

    def __post_init__(self):
        if self.engine not in ("lockstep", "continuous"):
            raise ValueError(
                f"engine must be 'lockstep' or 'continuous', got {self.engine!r}"
            )
        for name in ("num_slots", "prefill_chunk", "prefill_bucket"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        if self.refill_threshold < 1:
            raise ValueError(
                f"refill_threshold must be >= 1, got {self.refill_threshold}")


# --------------------------------------------------------------------------- #
# Multi-turn agentic environments (beyond-paper: tool-use / dialog workloads
# on the DistFlow DAG — repro.rl.envs, docs/environments.md).
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class EnvConfig:
    """Flags for the environment/reward subsystem (``repro.rl.envs``).

    ``name=""`` (default) disables the subsystem entirely: the DAG keeps its
    (REWARD, COMPUTE) stage and the GENERATE path is bit-for-bit the pre-env
    code. A named env swaps the reward node for an (ENV, COMPUTE) stage and
    — when ``max_turns > 1`` — turns the continuous rollout engine's slot
    loop into an episode loop: a sequence finishing a turn re-enters the
    prompt queue with the env observation appended and its KV rows preserved
    (only observation tokens are prefilled on later turns).
    """

    # registered environment name (repro.rl.envs: function_reward |
    # calculator | dialog | anything added via register_env); "" = off
    name: str = ""
    # episode turn cap; the engine truncates episodes the env never ends
    max_turns: int = 1
    # per-turn response-token budget (0 = rl.max_new_tokens); multi-turn
    # runs usually want this well under max_new_tokens
    turn_budget: int = 0
    # cap on observation tokens appended per turn (envs may return fewer)
    obs_budget: int = 16
    # registered RewardSpec the env (and the plain REWARD stage) scores with
    reward: str = "math"

    def __post_init__(self):
        if self.max_turns < 1:
            raise ValueError(f"max_turns must be >= 1, got {self.max_turns}")
        if self.turn_budget < 0:
            raise ValueError(
                f"turn_budget must be >= 0, got {self.turn_budget}")
        if self.obs_budget < 1:
            raise ValueError(f"obs_budget must be >= 1, got {self.obs_budget}")

    @property
    def enabled(self) -> bool:
        return bool(self.name)


# --------------------------------------------------------------------------- #
# Async off-policy pipeline v2 (beyond-paper: AsyncFlow / LlamaRL-style
# staleness-bounded generation/training overlap on the DistFlow DAG).
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class AsyncPipelineConfig:
    """Flags for the staleness-bounded off-policy scheduler
    (``core/async_worker.AsyncDAGWorker``). Off by default; ``enabled=True``
    with ``max_staleness=0`` runs the scheduler in lockstep and is
    bitwise-identical to the synchronous path (a property the test suite
    asserts).

    ``max_staleness`` is the hard bound on how many actor updates the
    behaviour policy of a consumed batch may lag the trainer: the batch
    trained at weight version ``v`` must have been generated at version
    ``>= v - max_staleness``. Generation dispatch is *gated* on this bound —
    when the trainer falls behind, the rollout side stalls rather than let
    trajectories go staler than the window (see ``docs/async_pipeline.md``).
    """

    enabled: bool = False
    # staleness window: 0 = fully on-policy lockstep (bitwise-identical to
    # the sync path); 1 = one-step overlap (AsyncFlow/LlamaRL's sweet spot)
    max_staleness: int = 0

    def __post_init__(self):
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}"
            )


# --------------------------------------------------------------------------- #
# Multi-host scale-out (paper §7.3: near-linear scaling to 512 GPUs —
# repro.distributed.fleet, launch/mesh.make_fleet_mesh, docs/multihost.md).
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class DistributedConfig:
    """Flags for multi-host execution (``repro.distributed.fleet``).

    ``num_hosts=1`` (default) disables the subsystem entirely: no fleet
    context, no gradient exchange, the pre-fleet single-process path
    bit-for-bit. With ``num_hosts > 1`` every host process runs the
    identical SPMD program over the global ``(pod, data, model)`` fleet
    mesh and the DP gradient exchange crosses the ``coordinator`` data
    plane: each host owns a contiguous slice of the flat gradient vector
    (reduce-scatter shape; ownership map from ``ft.straggler.rebalance``
    so a dead host's slices are re-assigned deterministically), publishes
    it — raw fp32, or int8 blocks + scales with an error-feedback
    accumulator when ``grad_compression="int8_ef"`` — and decodes every
    peer's slices. See ``docs/multihost.md`` for the coordinator /
    process-id contract and the CI fleet-simulation recipe.
    """

    # number of host processes in the fleet; 1 = subsystem off
    num_hosts: int = 1
    # this process's rank in [0, num_hosts)
    process_id: int = 0
    # local devices per host used for the fleet mesh's (data, model) plane;
    # 0 = whatever the backend offers divided by num_hosts (CPU simulation:
    # XLA_FLAGS=--xla_force_host_platform_device_count supplies them)
    devices_per_host: int = 0
    # data plane: a directory path (CPU-simulated file plane, the CI mode)
    # or a host:port coordinator address (jax.distributed on real fleets)
    coordinator: str = ""
    # DP gradient exchange encoding: "none" = raw fp32 slices (bitwise-
    # identical to single-host — test-asserted); "int8_ef" = per-block int8
    # + fp32 scales with error feedback (repro.distributed.compression)
    grad_compression: str = "none"
    # seconds a host waits for peers' exchange slices before consulting the
    # heartbeat monitor for dead hosts
    exchange_timeout_s: float = 60.0
    # iterations a host may lag the heartbeat monitor before it is declared
    # dead (ft.straggler.HeartbeatMonitor patience)
    heartbeat_patience: int = 2
    # wall-clock heartbeat staleness (seconds) that also declares a host
    # dead — catches a host killed after its last in-iteration beat
    dead_after_s: float = 30.0

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {self.num_hosts}")
        if not 0 <= self.process_id < self.num_hosts:
            raise ValueError(
                f"process_id must be in [0, {self.num_hosts}), "
                f"got {self.process_id}")
        if self.devices_per_host < 0:
            raise ValueError(
                f"devices_per_host must be >= 0, got {self.devices_per_host}")
        if self.grad_compression not in ("none", "int8_ef"):
            raise ValueError(
                f"grad_compression must be 'none' or 'int8_ef', "
                f"got {self.grad_compression!r}")
        if self.num_hosts > 1 and not self.coordinator:
            raise ValueError("num_hosts > 1 needs a coordinator (a shared "
                             "directory for the CPU-simulated data plane, or "
                             "a host:port address on real fleets)")
        if self.exchange_timeout_s <= 0:
            raise ValueError(f"exchange_timeout_s must be > 0, "
                             f"got {self.exchange_timeout_s}")
        if self.heartbeat_patience < 1:
            raise ValueError(f"heartbeat_patience must be >= 1, "
                             f"got {self.heartbeat_patience}")
        if self.dead_after_s <= 0:
            raise ValueError(
                f"dead_after_s must be > 0, got {self.dead_after_s}")

    @property
    def enabled(self) -> bool:
        return self.num_hosts > 1


@dataclass(frozen=True)
class ObsConfig:
    """Telemetry flags (``repro.obs``; see ``docs/observability.md``).

    Disabled (the default) is the pre-obs pipeline bit-for-bit: no tracer
    installed, no registry allocated, every metrics dict untouched — the
    no-overhead contract is test-asserted. Enabled, ``build_pipeline``
    installs a process-global :class:`~repro.obs.Tracer` (host id =
    ``DistributedConfig.process_id``) and hangs an
    :class:`~repro.obs.ObsState` on the worker context, so spans flow from
    DAG nodes, the async worker, the rollout engine, serving, and the fleet
    gradient exchange into one Chrome-trace-exportable ring.
    """

    # master switch; False = zero-cost no-op everywhere
    enabled: bool = False
    # record spans (the ring buffer); metrics registry works regardless
    trace: bool = True
    # span ring capacity: newest N events kept, oldest overwritten
    ring_capacity: int = 65536
    # Chrome-trace JSON output path ("" = don't export automatically)
    trace_path: str = ""
    # per-iteration metrics JSONL output path ("" = no file sink)
    metrics_path: str = ""
    # on fleets: publish per-iteration snapshots over the FleetContext
    # file plane for launch/obs_report.py aggregation
    fleet_snapshots: bool = True

    def __post_init__(self):
        if self.ring_capacity < 1:
            raise ValueError(
                f"ring_capacity must be >= 1, got {self.ring_capacity}")


# --------------------------------------------------------------------------- #
# The assigned shape cells of the production workloads (``launch.workloads``).
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}
