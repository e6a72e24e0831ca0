"""Processes for the port's multi-rank tests: a ``torch.distributed`` world
of N ranks, each a subprocess of its own on the CPU (gloo) on a free
localhost port, and plain subprocess groups; each under a timeout of its
own. No process group ever starts in the pytest process.

``start_world(body, n)`` runs the same Python ``body`` on every rank after
``launch.mesh.init_distributed``; ``RANK``, ``WORLD`` and ``torch`` are in
scope, and the body reports by assigning a JSON-able ``RESULT``.
``join()`` returns the ranks' results in rank order. ``start_procs(argvs)``
starts one ``python`` process an argv, and ``join()`` returns their outputs.
A process that fails or outlives the timeout fails ``join`` with every
process's output. Several groups can run at once: start them all, then join.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 420  # as the JAX package's multi-device tests
MARK = "@@RESULT@@"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_script(body: str, n: int, rank: int, port: int) -> str:
    return (
        "import json, sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'src')!r})\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.launch.mesh import init_distributed\n"
        f"RANK, WORLD = {rank}, {n}\n"
        f"init_distributed('127.0.0.1:{port}', WORLD, RANK, device='cpu')\n"
        "RESULT = None\n"
        + textwrap.dedent(body)
        + "\nimport torch.distributed as dist\n"
        "dist.barrier()\n"
        "dist.destroy_process_group()\n"
        f"print({MARK!r} + json.dumps(RESULT), flush=True)\n"
    )


class Procs:
    """A group of started processes, their output in files under ``logdir``."""

    def __init__(self, argvs, *, logdir, name, timeout=TIMEOUT_S, env=None):
        os.makedirs(logdir, exist_ok=True)
        full_env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(REPO, "src"),
                    **(env or {})}
        self.deadline = time.monotonic() + timeout
        self.logs = [os.path.join(logdir, f"{name}.{i}.log") for i in range(len(argvs))]
        self.procs = []
        for argv, log in zip(argvs, self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen([sys.executable, *argv], stdout=f,
                                                   stderr=subprocess.STDOUT, env=full_env,
                                                   cwd=REPO))

    def join(self) -> list:
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [open(log).read() for log in self.logs]
        if any(p.returncode for p in self.procs):
            report = "\n".join(f"--- process {i} (exit {p.returncode}) ---\n{o[-4000:]}"
                               for i, (p, o) in enumerate(zip(self.procs, outs)))
            raise AssertionError(f"a process failed:\n{report}")
        return outs


class World(Procs):
    def join(self) -> list:
        results = []
        for out in super().join():
            line = [ln for ln in out.splitlines() if ln.startswith(MARK)][-1]
            results.append(json.loads(line[len(MARK):]))
        return results


def start_world(body: str, n: int, *, logdir, name="world", **kw) -> World:
    port = free_port()
    return World([["-c", _world_script(body, n, r, port)] for r in range(n)],
                 logdir=logdir, name=name, **kw)


def start_procs(argvs, *, logdir, name="proc", **kw) -> Procs:
    return Procs(argvs, logdir=logdir, name=name, **kw)


def wait_for(path: str, timeout: float = TIMEOUT_S) -> None:
    """Block until ``path`` exists (another process's output)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)
