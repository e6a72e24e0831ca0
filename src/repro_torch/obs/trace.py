"""Span tracing with Chrome trace-event export: a copy of ``repro.obs.trace``
(docs/observability.md describes both).

A :class:`Tracer` produces nested spans — name, category, host/process id,
start time, duration, ``key=value`` attributes — into a thread-safe
in-memory ring buffer, and exports them as Chrome trace-event JSON
(``chrome://tracing`` / Perfetto-loadable): one *process* track per host
(``pid``) and one *thread* track per subsystem category (``tid``), so a
2-host fleet run renders as two stacked host lanes with dag/rollout/fleet
sub-lanes each.

Disabled tracing is a true no-op: ``Tracer(enabled=False).span(...)``
returns a shared singleton context manager whose enter/exit/``set`` do
nothing and allocate nothing — instrumented code pays a dict-free function
call, not a span record (the overhead bound is test-asserted).

Instrumented call sites reach the tracer through the module-global
:func:`get_tracer`, which defaults to the disabled :data:`NULL_TRACER`;
``build_pipeline`` installs a live tracer via :func:`set_tracer` when
``ObsConfig.enabled`` is set. Timestamps are ``perf_counter`` deltas
anchored to the wall clock at tracer construction, so traces exported by
co-located host processes (the simulated-fleet harness) line up on one
Perfetto timeline.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """The shared do-nothing span: what a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records itself into the tracer's ring on exit."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._record(
            self.name, self.cat, self._t0,
            self._tracer.clock() - self._t0, self.attrs)
        return False

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes mid-span (``args`` in the export)."""
        self.attrs.update(attrs)


class Tracer:
    """Span recorder with a bounded ring buffer and Chrome-trace export.

    ``host`` becomes the trace's ``pid`` (one track per host); each span's
    category becomes its ``tid`` (one sub-track per subsystem). ``capacity``
    bounds memory: the ring keeps the newest ``capacity`` events and
    overwrites the oldest (``dropped`` counts the overwritten ones).
    """

    def __init__(self, *, enabled: bool = False, host: int = 0,
                 capacity: int = 65536, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.host = int(host)
        self.capacity = int(capacity)
        self.clock = clock
        # wall-clock anchor: exported timestamps are wall0 + (t - perf0),
        # so independently exported host traces share one absolute timeline
        self._wall0 = time.time()
        self._perf0 = clock()
        self._lock = threading.Lock()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0  # total events ever recorded

    # ---------------- recording ---------------- #
    def span(self, name: str, cat: str = "default", **attrs):
        """A context manager timing one nested span. Zero-cost when the
        tracer is disabled (returns the shared no-op span)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, attrs)

    def instant(self, name: str, cat: str = "default", **attrs) -> None:
        """A zero-duration marker event."""
        if not self.enabled:
            return
        self._record(name, cat, self.clock(), None, attrs)

    def _record(self, name: str, cat: str, t0: float,
                dur: Optional[float], attrs: Dict[str, Any]) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = (name, cat, t0, dur, attrs)
            self._n += 1

    # ---------------- inspection / export ---------------- #
    @property
    def num_events(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        return max(self._n - self.capacity, 0)

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0

    def _snapshot(self) -> List[tuple]:
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [e for e in self._buf[:n]]
            start = n % cap
            return self._buf[start:] + self._buf[:start]

    def _ts_us(self, t: float) -> float:
        return (self._wall0 + (t - self._perf0)) * 1e6

    def to_events(self) -> List[dict]:
        """The ring's events in Chrome trace-event form (oldest first).
        Complete spans are ``"ph": "X"`` with ``ts``/``dur`` in µs;
        instants are ``"ph": "i"``. ``pid`` is the host id, ``tid`` the
        subsystem category's stable index."""
        snap = self._snapshot()
        cats = sorted({e[1] for e in snap})
        tid = {c: i + 1 for i, c in enumerate(cats)}
        out = []
        for name, cat, t0, dur, attrs in snap:
            ev = {
                "name": name,
                "cat": cat,
                "ph": "X" if dur is not None else "i",
                "ts": self._ts_us(t0),
                "pid": self.host,
                "tid": tid[cat],
            }
            if dur is not None:
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "p"  # instant scope: process
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
            out.append(ev)
        return out

    def metadata_events(self) -> List[dict]:
        """Perfetto track naming: process_name per host, thread_name per
        subsystem category."""
        cats = sorted({e[1] for e in self._snapshot()})
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.host, "tid": 0,
            "args": {"name": f"host{self.host}"},
        }]
        for i, c in enumerate(cats):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": self.host,
                "tid": i + 1, "args": {"name": c},
            })
        return meta

    def to_chrome_trace(self) -> dict:
        return {
            "traceEvents": self.metadata_events() + self.to_events(),
            "displayTimeUnit": "ms",
        }

    def export_chrome(self, path: str) -> str:
        """Write the ring as a Chrome-trace JSON file; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return float(v)  # numpy / jax scalars
    except (TypeError, ValueError):
        return str(v)


# ---------------------------------------------------------------------- #
# module-global tracer: instrumented call sites are always wired, and cost
# nothing until build_pipeline (or a test) installs an enabled tracer.
# ---------------------------------------------------------------------- #
NULL_TRACER = Tracer(enabled=False, capacity=1)
_GLOBAL: Tracer = NULL_TRACER


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the process-global tracer (``None`` restores
    the disabled default); returns the previous one so callers can
    save/restore."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = NULL_TRACER if tracer is None else tracer
    return prev
