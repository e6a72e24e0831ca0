"""RL training entry point of the PyTorch port (port of
``repro.launch.train``).

Compiles a :class:`repro_torch.api.ExperimentSpec` for ``--arch`` and runs
``--iters`` RL iterations through the DAG worker and the Data Coordinator on
one device: ``--device`` (``cuda`` unless the CPU is asked
for; without CUDA it raises). The weights are random, drawn from
``--seed``. A full experiment can also be loaded from a JSON file
(``--experiment spec.json``, the ``ExperimentSpec.to_json`` form of either
package) and dumped with ``--dump-experiment``. The Data Coordinator flags
(``--double-buffer``, ``--prefetch``, ``--load-balance``, ``--num-buckets``,
``--balance-tolerance``, one for each field of ``DataCoordinatorConfig``) and
``--centralized-baseline`` layer on top of either, so that one experiment
file runs in every coordinator arm.

``--rollout-slots N`` generates with the continuous rollout engine over N
decode slots (0: one a sequence), on top of either; an experiment file's
other engine settings (``prefill_chunk``, the buckets) stand, and an
experiment's ``mesh_shape`` with ``model`` > 1 runs it on tensor-parallel
ranks. ``--max-staleness W``
runs the staleness-bounded async pipeline (0: the lockstep scheduler,
bitwise equal to the synchronous worker), on one device or on the ranks
below, and overrides an experiment file's setting. ``--env NAME`` (with ``--max-turns`` and ``--turn-budget``)
runs a registered environment of ``repro_torch.rl.envs``; more than one
turn selects the continuous engine's episode loop. As in the JAX package,
``--experiment`` takes the file's env, and these three flags shape only a
spec built from the flags.

``--ckpt-dir DIR`` writes the actor's ``TrainState`` every ``--ckpt-every``
iterations (``repro_torch.ft.checkpoint``, the JAX package's format), and
``--resume DIR`` restores it into the freshly built state and runs the
iterations from the saved one on. As in the JAX package, a resume restores
the actor state alone: the dataloader, the sampling generator, the
reference params and a PPO critic start again from the seed.
``--obs-trace PATH`` and ``--obs-metrics PATH`` switch telemetry on over
the spec's ``ObsConfig``: a Chrome trace of the run's spans is written at
the end, and one JSONL record an iteration as it ends.

``--num-hosts H --process-id h --coordinator DIR`` makes the process host
h of a data-parallel fleet of H (``repro_torch.distributed.fleet``): start
one copy a host on one experiment file, each on its own device (or all on
the CPU). Every host computes the whole batch and the hosts exchange the
actor's gradient over the shared directory, raw fp32 (``--grad-compression
none``: bit for bit a ``--num-hosts 1`` run) or as int8 blocks with error
feedback (``int8_ef``). With telemetry on, each host also publishes its
metrics under DIR for ``repro_torch.launch.obs_report``. The four fleet
flags layer over an experiment file's ``distributed``, as the coordinator
flags do, so one file serves every host and the solo run.

``--coordinator HOST:PORT`` instead makes the process rank h of a
``torch.distributed`` world of H (gloo on the CPU and where the ranks share
a card, NCCL where each has its own): the JAX package's
``jax.distributed`` flow. The ranks build the ``(pod, data, model) = (H, 1,
1)`` rank mesh (``launch.mesh.make_fleet_mesh``) and train data-parallel
with FSDP state: each rank computes its rows of the batch, and the grads
are reduce-scattered into the param shards (``trainer.make_dp_step``).
``--resume`` restores each rank's shard from any checkpoint (elastic), and
``--ckpt-dir`` writes each rank's shards. An experiment's ``mesh_shape``
lays the same ranks out as ``(data, model)`` instead (``model`` > 1:
tensor-parallel). ``--max-staleness W`` runs the async pipeline on either
layout, each rank scheduling its own shards and rows; under ``--resume`` the
restored shards are what the first dispatch publishes as version 0.

The default arch is gemma-2b, the port's main model.

Usage:
  python -m repro_torch.launch.train --arch gemma-2b --iters 3 \
      --prompts-per-iter 2 --group-size 8 --max-new-tokens 16
  python -m repro_torch.launch.train --smoke --device cpu --iters 2
  python -m repro_torch.launch.train --smoke --device cpu --iters 2 --rollout-slots 4
  python -m repro_torch.launch.train --smoke --device cpu --iters 3 --max-staleness 1
  python -m repro_torch.launch.train --smoke --device cpu --iters 2 --env dialog \
      --max-turns 3 --turn-budget 4 --rollout-slots 4
  python -m repro_torch.launch.train --experiment exp.json --iters 100
  python -m repro_torch.launch.train --smoke --device cpu --iters 4 --ckpt-dir ckpts \
      --ckpt-every 2 --obs-trace trace.json --obs-metrics metrics.jsonl
  python -m repro_torch.launch.train --smoke --device cpu --iters 6 --resume ckpts
  for h in 0 1; do python -m repro_torch.launch.train --smoke --device cpu --iters 2 \
      --num-hosts 2 --process-id $h --coordinator /tmp/coord --grad-compression int8_ef & done
  for r in 0 1; do python -m repro_torch.launch.train --smoke --device cpu --iters 2 \
      --num-hosts 2 --process-id $r --coordinator 127.0.0.1:29500 & done
  for r in 0 1; do python -m repro_torch.launch.train --experiment tp.json --device cpu \
      --iters 3 --num-hosts 2 --process-id $r --coordinator 127.0.0.1:29501 \
      --max-staleness 1 & done
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

from repro_torch.api import ExperimentSpec
from repro_torch.configs import (
    AsyncPipelineConfig,
    DistributedConfig,
    EnvConfig,
    RolloutEngineConfig,
    get_config,
    reduced,
)
from repro_torch.ft import checkpoint
from repro_torch.launch.mesh import init_distributed
from repro_torch.obs import JSONLSink, StdoutSink, iteration_record
from repro_torch.rl import RLConfig, list_algorithms

COORDINATOR_FLAGS = ("double_buffer", "load_balance", "prefetch", "num_buckets",
                     "balance_tolerance")
FLEET_FLAGS = ("num_hosts", "process_id", "coordinator", "grad_compression")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--algorithm", choices=list_algorithms(), default="grpo")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--prompts-per-iter", type=int, default=8)
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="write the actor's TrainState here every --ckpt-every iterations")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None,
                    help="restore the actor's TrainState from this checkpoint directory "
                         "and run the iterations from its step on")
    ap.add_argument("--centralized-baseline", action="store_true",
                    help="run the single-controller arm (comparisons)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model config (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dag-json", default=None,
                    help="custom DAG config file (paper §4.1)")
    ap.add_argument("--experiment", default=None,
                    help="ExperimentSpec JSON file; overrides the arch/rl flags")
    ap.add_argument("--dump-experiment", default=None,
                    help="write the resolved ExperimentSpec JSON here and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    # Data Coordinator v2 (DataCoordinatorConfig); unset = the spec's value
    ap.add_argument("--double-buffer", action="store_const", const=True, default=None,
                    help="two rotating databuffer slots + spec prefetch")
    ap.add_argument("--load-balance", action="store_const", const=True, default=None,
                    help="length-aware repack of the rollouts into DP buckets")
    ap.add_argument("--prefetch", type=int, default=None,
                    help="dataloader look-ahead depth (0 = synchronous)")
    ap.add_argument("--num-buckets", type=int, default=None,
                    help="load-balancer buckets (0 = the mesh's DP degree)")
    ap.add_argument("--balance-tolerance", type=float, default=None,
                    help="balance/over_tolerance threshold of max/mean bucket tokens")
    ap.add_argument("--rollout-slots", type=int, default=None,
                    help="continuous rollout engine over this many decode slots "
                         "(0 = one per sequence); unset = the spec's engine")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="enable the async off-policy pipeline with this "
                         "staleness bound (0 = lockstep scheduler, bitwise-"
                         "identical to sync; see docs/async_pipeline.md)")
    ap.add_argument("--env", default=None,
                    help="registered environment name (repro_torch.rl.envs: "
                         "function_reward | calculator | dialog); enables "
                         "the env/reward subsystem (docs/environments.md)")
    ap.add_argument("--max-turns", type=int, default=1,
                    help="episode turn cap for --env (>1 auto-enables the "
                         "continuous rollout engine's episode loop)")
    ap.add_argument("--turn-budget", type=int, default=0,
                    help="per-turn response-token cap for --env "
                         "(0 = --max-new-tokens)")
    ap.add_argument("--obs-trace", default=None, metavar="PATH",
                    help="enable telemetry and export a Chrome-trace JSON "
                         "here at the end of the run (docs/observability.md)")
    ap.add_argument("--obs-metrics", default=None, metavar="PATH",
                    help="enable telemetry and append per-iteration metrics "
                         "as JSONL here")
    # the fleet (DistributedConfig); unset = the spec's value
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="host processes in the fleet; >1 enables the "
                         "multi-host runtime: launch one copy of this driver "
                         "per host")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this host's rank in [0, --num-hosts)")
    ap.add_argument("--coordinator", default=None,
                    help="shared coordinator directory (the fleet's file plane) or "
                         "host:port (a torch.distributed world, one rank a process)")
    ap.add_argument("--grad-compression", choices=["none", "int8_ef"], default=None,
                    help="DP gradient exchange encoding: none = exact fp32 "
                         "(bit for bit a single host), int8_ef = block-int8 + "
                         "error feedback (~1/4 wire bytes)")
    return ap.parse_args(argv)


def build_experiment(args: argparse.Namespace) -> ExperimentSpec:
    """CLI flags -> ExperimentSpec (or load one wholesale from JSON), with the
    coordinator flags, ``--centralized-baseline``, ``--max-staleness``,
    ``--rollout-slots`` and the fleet flags on top."""
    if args.experiment:
        with open(args.experiment) as f:
            exp = ExperimentSpec.from_json(f.read())
    else:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = reduced(cfg, vocab_size=260, num_layers=2)
        rl = RLConfig(
            algorithm=args.algorithm,
            group_size=args.group_size,
            max_new_tokens=args.max_new_tokens,
            lr=args.lr,
        )
        dag = None
        if args.dag_json:
            from repro_torch.core import DAG

            dag = DAG.from_json(args.dag_json).to_spec()
        rollout = RolloutEngineConfig()
        env = EnvConfig()
        if args.env:
            env = EnvConfig(name=args.env, max_turns=args.max_turns,
                            turn_budget=args.turn_budget)
            if env.max_turns > 1:
                # the episode loop lives in the continuous engine: one slot a
                # sequence unless --rollout-slots says otherwise
                rollout = RolloutEngineConfig(engine="continuous", num_slots=0)
        exp = ExperimentSpec(
            model=cfg,
            rl=rl,
            rollout=rollout,
            env=env,
            prompts_per_iter=args.prompts_per_iter,
            centralized=args.centralized_baseline,
            seed=args.seed,
            dag=dag,
        )
    given = {k: getattr(args, k) for k in COORDINATOR_FLAGS if getattr(args, k) is not None}
    if given:
        exp = dataclasses.replace(exp, coordinator=dataclasses.replace(exp.coordinator, **given))
    if args.centralized_baseline:
        exp = dataclasses.replace(exp, centralized=True)
    if args.max_staleness is not None:
        # the flag overrides the file, as the usage line says
        exp = dataclasses.replace(exp, async_pipeline=AsyncPipelineConfig(
            enabled=True, max_staleness=args.max_staleness))
    if args.rollout_slots is not None:
        # the file's other engine settings (prefill_chunk, the buckets) stand
        exp = dataclasses.replace(exp, rollout=dataclasses.replace(
            exp.rollout, engine="continuous", num_slots=args.rollout_slots))
    fleet = {k: getattr(args, k) for k in FLEET_FLAGS if getattr(args, k) is not None}
    if fleet:
        exp = dataclasses.replace(exp, distributed=dataclasses.replace(
            exp.distributed or DistributedConfig(), **fleet))
    if args.obs_trace or args.obs_metrics:
        # the flags layer on top of whatever the spec (file or flags)
        # carries, as --max-staleness does
        exp = dataclasses.replace(exp, obs=dataclasses.replace(
            exp.obs,
            enabled=True,
            trace_path=args.obs_trace or exp.obs.trace_path,
            metrics_path=args.obs_metrics or exp.obs.metrics_path,
        ))
    return exp


def start_fleet(dist: Optional[DistributedConfig], device="cuda"):
    """This process's ``FleetContext`` for an enabled ``dist`` over a
    directory (None otherwise): registered with every field of ``dist``,
    beating from a daemon thread, and past the fleet's startup barrier. A
    ``host:port`` coordinator starts the ``torch.distributed`` world
    instead, and returns None."""
    if dist is None or not dist.enabled:
        return None
    fleet_ctx = init_distributed(
        dist.coordinator, dist.num_hosts, dist.process_id, device=device,
        **{f.name: getattr(dist, f.name) for f in dataclasses.fields(dist)
           if f.name not in ("num_hosts", "process_id", "coordinator")})
    if fleet_ctx is None:  # a torch.distributed world
        return None
    fleet_ctx.start_heartbeats()
    fleet_ctx.barrier("startup")
    return fleet_ctx


def main(argv=None) -> Dict[str, Any]:
    """Run the flags' experiment. Returns ``{"experiment"}`` after
    ``--dump-experiment``, else also the ``"pipeline"``, each iteration's
    metrics (``"history"``, from the resumed iteration on) and host wall
    seconds (``"seconds"``)."""
    args = parse_args(argv)
    exp = build_experiment(args)
    if args.dump_experiment:
        with open(args.dump_experiment, "w") as f:
            f.write(exp.to_json())
        print(f"[train] wrote {args.dump_experiment}")
        return {"experiment": exp}

    fleet_ctx = start_fleet(exp.distributed, args.device)
    pipe = exp.compile(device=args.device)
    mesh = pipe.ctx.mesh
    specs = None
    if pipe.ctx.param_specs is not None:  # a rank mesh: each rank's shards
        from repro_torch.distributed import sharding as shr
        from repro_torch.rl.trainer import TrainState

        specs = TrainState(params=pipe.ctx.param_specs,
                           opt=shr.opt_state_specs(pipe.ctx.param_specs))
    start = 0
    if args.resume:
        # into the built state's own tensors (the async worker publishes its
        # version 0 at the first dispatch, so generation follows)
        _, start = checkpoint.restore(args.resume, pipe.ctx.actor_state,
                                      **({"mesh": mesh, "specs": specs} if specs else {}))
        print(f"[train] resumed from {args.resume} at iteration {start}")

    obs_rt = pipe.ctx.obs
    stdout_sink = StdoutSink()
    jsonl_sink = (JSONLSink(obs_rt.cfg.metrics_path)
                  if obs_rt is not None and obs_rt.cfg.metrics_path else None)
    history, seconds = [], []
    for it in range(start, args.iters):
        if fleet_ctx is not None:
            fleet_ctx.heartbeat(it)
        t0 = time.perf_counter()
        metrics = pipe.worker.run_iteration()
        dt = time.perf_counter() - t0
        history.append(metrics)
        seconds.append(dt)
        if it % 5 == 0 or it == args.iters - 1:
            stdout_sink.emit_iteration(it, metrics, dt)
        if obs_rt is not None:
            obs_rt.registry.histogram("train/step_s").record(dt)
            if jsonl_sink is not None:
                jsonl_sink.write(iteration_record(it, metrics, dt))
            if fleet_ctx is not None and obs_rt.cfg.fleet_snapshots:
                fleet_ctx.publish_metrics(it, metrics)
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, pipe.ctx.actor_state, step=it + 1,
                            **({"mesh": mesh, "specs": specs} if specs else {}))
            print(f"[train] checkpoint @ {it + 1} -> {args.ckpt_dir}")
    if jsonl_sink is not None:
        jsonl_sink.close()
    if obs_rt is not None and obs_rt.cfg.trace_path:
        obs_rt.tracer.export_chrome(obs_rt.cfg.trace_path)
        print(f"[train] wrote trace {obs_rt.cfg.trace_path} "
              f"({obs_rt.tracer.num_events} events)")
    if fleet_ctx is not None:
        fleet_ctx.stop_heartbeats()
    print(f"[train] done; buffer stats: {pipe.buffer.stats}")
    return {"experiment": exp, "pipeline": pipe, "history": history, "seconds": seconds}

if __name__ == "__main__":
    main()
