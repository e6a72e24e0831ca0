"""Metrics sinks: where per-iteration records go (a copy of
``repro.obs.sinks``).

Three interchangeable sinks share one ``write(record)`` method:
:class:`JSONLSink` appends one JSON object per line to a file (what
``launch.train --obs-metrics`` uses), :class:`StdoutSink` prints —
including a byte-compatible reproduction of the legacy
``[train] it=... {...}`` line — and :class:`MemorySink` accumulates records
in a list for tests.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional


def iteration_record(iteration: int, metrics: Dict[str, Any],
                     wall_s: float) -> dict:
    return {
        "kind": "iteration",
        "iteration": int(iteration),
        "wall_s": float(wall_s),
        "time": time.time(),
        "metrics": {k: _num(v) for k, v in metrics.items()},
    }


def _num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class JSONLSink:
    """Append-mode JSONL writer; the file opens lazily on first write and
    every record is flushed (crash-safe up to the last line)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, record: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JSONLSink":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class StdoutSink:
    """Line printer. ``emit_iteration`` prints launch/train.py's progress
    line byte-for-byte as the JAX package prints it (same key filter,
    rounding, and json.dumps separators) — scripts grepping ``[train] it=``
    keep working."""

    def write(self, record: dict) -> None:
        print(json.dumps(record, sort_keys=True), flush=True)

    def emit_iteration(self, iteration: int, metrics: Dict[str, Any],
                       wall_s: float) -> None:
        keep = {k: round(v, 4) for k, v in metrics.items()
                if not k.startswith("time/")}
        print(f"[train] it={iteration} {wall_s:.2f}s {json.dumps(keep)}",
              flush=True)

    def close(self) -> None:
        pass


class MemorySink:
    """Record list for tests."""

    def __init__(self):
        self.records: List[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass
