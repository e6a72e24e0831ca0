"""Fleet-wide metrics aggregation: snapshots → straggler report (a copy of
``repro.obs.aggregate``).

Each host publishes a per-iteration metrics snapshot through the
FleetContext file plane (``FleetContext.publish_metrics`` →
``<coord>/obs/host{h}/it{NNNNNN}.json``). This module reads them all back
and answers the question the DistFlow scaling pitch depends on: *which host
is slow, on which stage, and by how much* — per-host step-time skew,
slowest-node attribution, and exact cross-host histogram merge.

``launch/obs_report.py`` renders :func:`straggler_report` as a text
timeline plus table; tests assert the report's per-host step times
sum-match the hosts' own ``time/*`` metrics.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.metrics import Histogram, exponential_boundaries

# step times span ~1ms..1000s in simulated fleets; ~7% bucket resolution
STEP_TIME_BOUNDARIES = exponential_boundaries(1e-3, 1e3, 200)


def collect_snapshots(root: str) -> Dict[int, Dict[int, dict]]:
    """Read every ``<root>/obs/host*/it*.json`` snapshot into
    ``{host: {iteration: payload}}``."""
    out: Dict[int, Dict[int, dict]] = {}
    for path in sorted(glob.glob(os.path.join(root, "obs", "host*",
                                              "it*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # torn write from a dying host: skip, don't crash
        h = int(payload["host"])
        out.setdefault(h, {})[int(payload["iteration"])] = payload
    return out


def step_time(metrics: Dict[str, float]) -> float:
    """A host's step time for one iteration: the sum of its per-node
    ``time/*`` stage timings (deterministic key order)."""
    return sum(float(metrics[k]) for k in sorted(metrics)
               if k.startswith("time/"))


def straggler_report(snapshots: Dict[int, Dict[int, dict]]) -> dict:
    """Merge per-host snapshots into a straggler report.

    Returns a dict with per-host step-time stats and slowest-node
    attribution, per-iteration cross-host skew (max/mean), and a fleet-wide
    step-time histogram built by exact merge of per-host histograms.
    """
    hosts = sorted(snapshots)
    per_host: Dict[int, dict] = {}
    host_hists: Dict[int, Histogram] = {}
    for h in hosts:
        its = sorted(snapshots[h])
        steps = {it: step_time(snapshots[h][it]["metrics"]) for it in its}
        # mean time per node across iterations → slowest-stage attribution
        node_tot: Dict[str, float] = {}
        for it in its:
            for k, v in snapshots[h][it]["metrics"].items():
                if k.startswith("time/"):
                    node_tot[k[len("time/"):]] = (
                        node_tot.get(k[len("time/"):], 0.0) + float(v))
        hist = Histogram(f"fleet/step_s/host{h}", STEP_TIME_BOUNDARIES)
        for v in steps.values():
            hist.record(v)
        host_hists[h] = hist
        n = max(len(its), 1)
        per_host[h] = {
            "iterations": its,
            "step_times": steps,
            "total_s": sum(steps.values()),
            "mean_s": sum(steps.values()) / n,
            "slowest_node": (max(node_tot, key=node_tot.get)
                             if node_tot else None),
            "node_mean_s": {k: v / n for k, v in sorted(node_tot.items())},
        }

    # per-iteration skew: how much slower the worst host is than the mean
    all_its = sorted({it for h in hosts for it in per_host[h]["step_times"]})
    skew: Dict[int, dict] = {}
    for it in all_its:
        vals = {h: per_host[h]["step_times"][it] for h in hosts
                if it in per_host[h]["step_times"]}
        mean = sum(vals.values()) / len(vals)
        worst = max(vals, key=vals.get)
        skew[it] = {
            "per_host": vals,
            "mean_s": mean,
            "max_s": vals[worst],
            "slowest_host": worst,
            "skew": vals[worst] / mean if mean > 0 else 1.0,
        }

    fleet_hist = Histogram("fleet/step_s", STEP_TIME_BOUNDARIES)
    for h in hosts:
        fleet_hist.merge(host_hists[h])
    slowest_host = (max(hosts, key=lambda h: per_host[h]["total_s"])
                    if hosts else None)
    return {
        "hosts": hosts,
        "per_host": per_host,
        "per_iteration": skew,
        "slowest_host": slowest_host,
        "max_skew": max((s["skew"] for s in skew.values()), default=1.0),
        "step_hist": fleet_hist.to_dict(),
        "step_percentiles": fleet_hist.percentiles((50, 99)),
    }


def render_report(report: dict, width: int = 40) -> str:
    """The straggler report as a text timeline + table."""
    lines: List[str] = []
    hosts = report["hosts"]
    per_it = report["per_iteration"]
    if not hosts:
        return "no snapshots found\n"
    lines.append("== per-iteration step-time timeline "
                 "(one bar per host, * = slowest) ==")
    vmax = max((s["max_s"] for s in per_it.values()), default=0.0) or 1.0
    for it in sorted(per_it):
        s = per_it[it]
        lines.append(f"it {it:>4}  skew x{s['skew']:.2f}")
        for h in hosts:
            if h not in s["per_host"]:
                continue
            v = s["per_host"][h]
            bar = "#" * max(int(round(v / vmax * width)), 1)
            mark = " *" if h == s["slowest_host"] else ""
            lines.append(f"  host{h} |{bar:<{width}}| {v:8.3f}s{mark}")
    lines.append("")
    lines.append("== per-host summary ==")
    lines.append("| host | iters | total s | mean s | slowest node |")
    lines.append("|------|-------|---------|--------|--------------|")
    for h in hosts:
        ph = report["per_host"][h]
        star = " *" if h == report["slowest_host"] else ""
        lines.append(
            f"| host{h}{star} | {len(ph['iterations'])} "
            f"| {ph['total_s']:.3f} | {ph['mean_s']:.3f} "
            f"| {ph['slowest_node']} |")
    p = report["step_percentiles"]
    lines.append("")
    lines.append(f"fleet step-time p50 {p['p50']:.3f}s  p99 {p['p99']:.3f}s"
                 f"  (merged across {len(hosts)} hosts)"
                 f"  max skew x{report['max_skew']:.2f}")
    return "\n".join(lines) + "\n"


def merge_traces(paths_or_dicts: List, out_path: Optional[str] = None
                 ) -> dict:
    """Concatenate per-host Chrome traces into one multi-track trace.
    Host traces carry distinct ``pid``s, so concatenation *is* the merge."""
    events: List[dict] = []
    for item in paths_or_dicts:
        if isinstance(item, str):
            with open(item) as f:
                item = json.load(f)
        events.extend(item.get("traceEvents", []))
    merged = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged
