"""One host of a port fleet: the program ``tests/test_torch_fleet.py``'s
runner spawns per process (the twin of ``tests/fleet/train_host.py``,
importing only ``repro_torch``).

Runs ``repro_torch.launch.train`` on one experiment file on the CPU, one
torch thread a host, and writes a JSON artifact with a digest of the final
params, every iteration's metrics, the membership view and the exchange and
buffer stats for cross-host assertions.

Two modes:

* the entry point itself (the default): ``launch.train.main`` with
  ``--num-hosts H --process-id h --coordinator DIR --grad-compression C``
  layered over the file (``--num-hosts 1`` for the solo reference);
* the recovery loop (``FLEET_RECOVER=1``): the same experiment through
  ``train.build_experiment`` and ``train.start_fleet``, checkpointing
  ``{"actor": TrainState, "gen": the sampling generator's state}`` after
  every iteration. When a peer dies mid-run the blocked exchange raises
  ``HostsLost``; this driver declares the hosts dead (a membership epoch),
  rebuilds the pipeline (fresh engines and exchange under the new epoch),
  restores the checkpoint into it, rewinds the dataloader and resumes. The
  trajectory after recovery is bit for bit an undisturbed run's, because
  a batch is a pure function of the step and the exact exchange rebuilds
  the gradient bit for bit.

Env contract (set by the runner; the rest of ``tests/fleet/runner.py``'s
``FLEET_*`` contract as there):
  FLEET_EXPERIMENT    the experiment file every host and the solo run share
  FLEET_RECOVER       "1" = the recovery loop
  FLEET_BALANCE       "1" = ``--load-balance``
  FLEET_OBS           "1" = ``--obs-trace``/``--obs-metrics`` into the
                      workdir (fleet hosts also publish metrics snapshots)
"""
import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

from repro_torch import tree
from repro_torch.distributed import fleet
from repro_torch.ft import checkpoint
from repro_torch.launch import train


def params_digest(params) -> str:
    flat = np.concatenate([leaf.detach().float().reshape(-1).numpy()
                           for leaf in tree.leaves(params)])
    return hashlib.sha256(flat.tobytes()).hexdigest()


def recovery_loop(argv, iters: int, die_at: int, ckpt_dir: str):
    """(pipeline, {iteration: metrics}, recoveries, hosts flagged dead)."""
    exp = train.build_experiment(train.parse_args(argv))
    fleet_ctx = train.start_fleet(exp.distributed)
    pipe = exp.compile(device="cpu")
    history, recoveries, flagged = {}, 0, set()
    it = 0
    while it < iters:
        fleet_ctx.heartbeat(it)
        if it == die_at:
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            metrics = pipe.worker.run_iteration()
        except fleet.HostsLost as exc:
            print(f"[host{fleet_ctx.process_id}] lost {exc.hosts} at it={it}; "
                  "recovering", flush=True)
            flagged.update(exc.hosts)
            fleet_ctx.declare_dead(exc.hosts)
            pipe = exp.compile(device="cpu")  # fresh engines + exchange, new epoch
            restored, step = checkpoint.restore(
                ckpt_dir, {"actor": pipe.ctx.actor_state, "gen": pipe.ctx.gen.get_state()})
            pipe.ctx.gen.set_state(restored["gen"])
            pipe.ctx.dataloader.step = step
            pipe.ctx.dataloader._built_step = step
            it = step
            recoveries += 1
            continue
        history[str(it)] = metrics
        checkpoint.save(ckpt_dir, {"actor": pipe.ctx.actor_state,
                                   "gen": pipe.ctx.gen.get_state()}, step=it + 1)
        it += 1
    fleet_ctx.stop_heartbeats()
    return pipe, history, recoveries, flagged


def main() -> None:
    torch.set_num_threads(1)
    coord = os.environ["FLEET_COORD"]
    H = int(os.environ.get("FLEET_NUM_HOSTS", "1"))
    pid = int(os.environ.get("FLEET_PROCESS_ID", "0"))
    iters = int(os.environ.get("FLEET_ITERS", "3"))
    comp = os.environ.get("FLEET_COMPRESSION", "none")
    die_at = int(os.environ.get("FLEET_DIE_AT", "-1"))
    solo = os.environ.get("FLEET_SOLO") == "1"
    obs_on = os.environ.get("FLEET_OBS") == "1"
    artifact_path = os.environ["FLEET_ARTIFACT"]
    workdir = os.environ.get("FLEET_WORKDIR", os.path.dirname(artifact_path))
    tag = f"host{pid}{'.solo' if solo else ''}"

    argv = ["--experiment", os.environ["FLEET_EXPERIMENT"], "--device", "cpu",
            "--iters", str(iters)]
    argv += (["--num-hosts", "1"] if solo else
             ["--num-hosts", str(H), "--process-id", str(pid), "--coordinator", coord,
              "--grad-compression", comp])
    if os.environ.get("FLEET_BALANCE") == "1":
        argv.append("--load-balance")
    trace_path = os.path.join(workdir, f"trace.{tag}.json")
    if obs_on:
        argv += ["--obs-trace", trace_path,
                 "--obs-metrics", os.path.join(workdir, f"metrics.{tag}.jsonl")]

    if os.environ.get("FLEET_RECOVER") == "1":
        pipe, history, recoveries, flagged = recovery_loop(
            argv, iters, -1 if solo else die_at, os.path.join(workdir, f"ckpt.{tag}"))
    else:
        out = train.main(argv)
        pipe, recoveries, flagged = out["pipeline"], 0, set()
        history = {str(i): m for i, m in enumerate(out["history"])}

    fleet_ctx = pipe.ctx.fleet
    stats = pipe.buffer.stats
    art = {
        "process_id": pid,
        "solo": solo,
        "compression": comp,
        "iters": iters,
        "params_sha256": params_digest(pipe.ctx.actor_state.params),
        "history": {k: {n: float(v) for n, v in m.items()} for k, m in history.items()},
        "steps": sorted(int(k) for k in history),
        "recoveries": recoveries,
        "epoch": fleet_ctx.epoch if fleet_ctx else 0,
        "members": fleet_ctx.members if fleet_ctx else [0],
        "dead_hosts": fleet_ctx.dead_hosts if fleet_ctx else [],
        # hosts flagged DURING training (the HostsLost path), not a post-exit
        # poll: a peer that already finished has stopped heartbeating
        "monitor_dead": sorted(flagged),
        "exchange": dict(pipe.ctx.grad_exchange.stats) if fleet_ctx else None,
        "buffer": {
            "bytes_through_controller": stats.bytes_through_controller,
            "max_host_inbound_bytes": stats.max_host_inbound_bytes,
            "redistributions": stats.redistributions,
        },
    }
    if obs_on:
        art["obs"] = {"trace": trace_path,
                      "snapshots_root": coord if fleet_ctx else None,
                      "num_events": pipe.ctx.obs.tracer.num_events}
    tmp = artifact_path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, artifact_path)
    print(f"[{tag}] done: {art['params_sha256'][:12]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
