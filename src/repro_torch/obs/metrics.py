"""Typed metrics: Counter / Gauge / Histogram behind a MetricsRegistry.

The registry absorbs the repo's existing string-keyed ``Dict[str, float]``
metrics (``record_dict`` turns each key into a gauge) and reproduces them
*bitwise* through :meth:`MetricsRegistry.as_flat_dict` — gauges store the
recorded value verbatim, no float coercion — so every current test and
benchmark key survives the migration unchanged.

Histograms are fixed-boundary: ``boundaries`` of length K define K+1
buckets (underflow, K-1 interior, overflow), and a recorded value lands in
the bucket found by ``bisect_right``. Quantiles interpolate linearly inside
the rank's bucket, with the tracked min/max tightening the open-ended
underflow/overflow buckets. Because a quantile is a pure function of
(boundaries, counts, min, max) — and all of those combine exactly under
:meth:`Histogram.merge` — merged per-host histograms report *identical*
quantiles to one histogram fed the concatenated samples (test-asserted,
including as a hypothesis property).
"""
from __future__ import annotations

import math
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value-wins. Stores whatever it is handed, verbatim — the
    bitwise back-compat contract of ``as_flat_dict`` depends on it."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        self.value = v


def exponential_boundaries(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    """``n`` geometrically spaced boundaries spanning [lo, hi]."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError(f"bad boundary spec lo={lo} hi={hi} n={n}")
    r = math.log(hi / lo) / (n - 1)
    return tuple(lo * math.exp(r * i) for i in range(n))


# default latency boundaries: 100µs .. 100s, ~15% resolution per bucket
LATENCY_BOUNDARIES = exponential_boundaries(1e-4, 100.0, 100)


class Histogram:
    """Fixed-boundary histogram with interpolated quantiles, exact under
    merge. Bucket ``i`` covers ``[boundaries[i-1], boundaries[i])``; bucket
    0 is underflow, bucket ``len(boundaries)`` overflow."""

    __slots__ = ("name", "boundaries", "counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str,
                 boundaries: Sequence[float] = LATENCY_BOUNDARIES):
        b = tuple(float(x) for x in boundaries)
        if len(b) < 1 or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("boundaries must be strictly increasing")
        self.name = name
        self.boundaries = b
        self.counts = [0] * (len(b) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # ---------------- recording / merging ---------------- #
    def record(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_right(self.boundaries, v)] += 1
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def merge(self, other: "Histogram") -> "Histogram":
        if other.boundaries != self.boundaries:
            raise ValueError(
                f"histogram {self.name!r}: cannot merge differing boundaries")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self._count += other._count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    # ---------------- stats ---------------- #
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Interpolated quantile: find the bucket holding rank
        ``q * (count - 1)``, interpolate linearly within it. Underflow and
        overflow buckets borrow the tracked min/max as their missing edge,
        and the result is clamped to [min, max]."""
        if self._count == 0:
            return 0.0
        r = q * (self._count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > r:
                lo = self._min if i == 0 else self.boundaries[i - 1]
                hi = (self._max if i == len(self.boundaries)
                      else self.boundaries[i])
                est = lo + (hi - lo) * (r - cum) / c
                return min(max(est, self._min), self._max)
            cum += c
        return self._max

    def percentiles(self, ps: Iterable[int] = (50, 90, 99)
                    ) -> Dict[str, float]:
        return {f"p{p}": self.quantile(p / 100.0) for p in ps}

    # ---------------- (de)serialization ---------------- #
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "boundaries": list(self.boundaries),
            "counts": list(self.counts),
            "count": self._count,
            "sum": self._sum,
            "min": self._min if self._count else None,
            "max": self._max if self._count else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(d["name"], d["boundaries"])
        h.counts = [int(c) for c in d["counts"]]
        h._count = int(d["count"])
        h._sum = float(d["sum"])
        h._min = math.inf if d["min"] is None else float(d["min"])
        h._max = -math.inf if d["max"] is None else float(d["max"])
        return h


class MetricsRegistry:
    """Named instruments plus the flat-dict bridge the rest of the repo
    speaks. ``record_dict`` absorbs a per-iteration metrics dict (each key
    becomes a gauge holding the value verbatim); ``as_flat_dict`` emits
    gauges verbatim, counters as floats, and each histogram expanded to
    ``{name}/count|mean|p50|p90|p99``."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ---------------- instrument accessors (get-or-create) ------------- #
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  boundaries: Optional[Sequence[float]] = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(
                name, boundaries if boundaries is not None
                else LATENCY_BOUNDARIES)
        return h

    @property
    def histograms(self) -> Dict[str, Histogram]:
        return dict(self._hists)

    # ---------------- flat-dict bridge ---------------- #
    def record_dict(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self.gauge(k).set(v)

    def as_flat_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, g in self._gauges.items():
            out[k] = g.value
        for k, c in self._counters.items():
            out[k] = c.value
        for k, h in self._hists.items():
            out[f"{k}/count"] = float(h.count)
            out[f"{k}/mean"] = h.mean
            for pk, pv in h.percentiles((50, 90, 99)).items():
                out[f"{k}/{pk}"] = pv
        return out

    # ---------------- cross-host (de)serialization ---------------- #
    def to_dict(self) -> dict:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.to_dict() for k, h in self._hists.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetricsRegistry":
        r = cls()
        for k, v in d.get("counters", {}).items():
            r.counter(k).value = v
        for k, v in d.get("gauges", {}).items():
            r.gauge(k).set(v)
        for k, hd in d.get("histograms", {}).items():
            r._hists[k] = Histogram.from_dict(hd)
        return r

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another host's registry in: counters sum, histograms merge
        exactly, gauges last-write-wins."""
        for k, c in other._counters.items():
            self.counter(k).value += c.value
        for k, g in other._gauges.items():
            self.gauge(k).set(g.value)
        for k, h in other._hists.items():
            mine = self._hists.get(k)
            if mine is None:
                self._hists[k] = Histogram.from_dict(h.to_dict())
            else:
                mine.merge(h)
        return self
