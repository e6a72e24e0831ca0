"""Fleet straggler report: aggregate per-host obs snapshots + merge traces
(the port of ``repro.launch.obs_report``).

Reads the per-iteration metrics snapshots a fleet's hosts published under
``<coordinator>/obs/host*/it*.json`` (the ``FleetContext`` of either
package writes them with ``ObsConfig(enabled=True)``: the port's
``launch.train --num-hosts``) and prints a straggler report: a
per-iteration step-time timeline, a per-host summary table with slowest-node attribution, and the fleet-wide step-time
percentiles from the exact cross-host histogram merge. Optionally merges the
hosts' per-host Chrome traces into one Perfetto-loadable timeline.

Usage:
  python -m repro_torch.launch.obs_report --coordinator /tmp/fleet-coord
  python -m repro_torch.launch.obs_report --coordinator /tmp/fleet-coord \
      --merge-traces /tmp/fleet-coord/trace.host*.json --out merged.json
  python -m repro_torch.launch.obs_report --coordinator c/ --json   # raw report
"""
from __future__ import annotations

import argparse
import glob
import json

from repro_torch.obs.aggregate import (
    collect_snapshots,
    merge_traces,
    render_report,
    straggler_report,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True,
                    help="the fleet coordinator directory snapshots were "
                         "published under")
    ap.add_argument("--json", action="store_true",
                    help="print the raw report dict as JSON instead of the "
                         "rendered timeline/table")
    ap.add_argument("--merge-traces", nargs="*", default=None,
                    metavar="GLOB",
                    help="per-host Chrome-trace JSON files (globs ok) to "
                         "merge into one multi-host timeline")
    ap.add_argument("--out", default=None,
                    help="output path for the merged trace "
                         "(default: merged_trace.json under --coordinator)")
    args = ap.parse_args(argv)

    snapshots = collect_snapshots(args.coordinator)
    report = straggler_report(snapshots)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        print(render_report(report), end="")

    if args.merge_traces:
        paths = sorted(p for g in args.merge_traces for p in glob.glob(g))
        if paths:
            out = args.out or f"{args.coordinator.rstrip('/')}/merged_trace.json"
            merged = merge_traces(paths, out)
            print(f"[obs] merged {len(paths)} traces "
                  f"({len(merged['traceEvents'])} events) -> {out}")
        else:
            print("[obs] --merge-traces matched no files")


if __name__ == "__main__":
    main()
