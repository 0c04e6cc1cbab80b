"""Aggregate jax.profiler traces by HLO category — the perf ground truth.

Profiler device events, not host wall clocks, are the truth for sub-ms
kernels. This tool parses the
gzipped Chrome-trace JSON that ``jax.profiler.start_trace`` writes and sums
device-event durations by ``args.hlo_category`` ("custom-call" = Pallas
and library kernels) and by op name, so kernel budgets can be compared run-to-run.

Usage:
    python -m interactive_vit_tpu.tools.trace_agg /tmp/trace_dir [--top 20]

The reference has no profiling subsystem (console DEBUG prints only,
SURVEY.md §5); this replaces it with XLA's own device timeline.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
from typing import Dict, List, Tuple


def find_trace_files(log_dir: str, latest_only: bool = True) -> List[str]:
    """Trace files under ``log_dir``.

    ``jax.profiler.start_trace`` appends a NEW timestamped
    ``plugins/profile/<ts>/`` subdir per trace, so a re-run into the same
    dir leaves stale
    traces behind; summing them would silently multiply every total. By
    default only the newest profile subdir is aggregated
    (``latest_only=False`` restores the sum-everything behavior). A
    ``.trace.json.gz`` also shadows its uncompressed twin so a pair is
    never double-counted.
    """
    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*.trace.json"),
                    recursive=True)
    )
    # drop an uncompressed twin when the .gz exists
    gz_stems = {p[: -len(".gz")] for p in paths if p.endswith(".gz")}
    paths = [p for p in paths if p.endswith(".gz") or p not in gz_stems]
    if latest_only and paths:
        dirs = {os.path.dirname(p) for p in paths}
        if len(dirs) > 1:
            newest = max(dirs, key=lambda d: max(
                os.path.getmtime(p) for p in paths
                if os.path.dirname(p) == d))
            paths = [p for p in paths if os.path.dirname(p) == newest]
    return paths


def load_events(path: str) -> List[dict]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def aggregate(
    log_dir: str, latest_only: bool = True,
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, int]]:
    """Sum device-event durations (us) by hlo_category and by event name.

    Only complete events (ph == "X") carrying an ``args.hlo_category`` are
    device HLO executions; everything else (host runtime, flow arrows,
    counters) is skipped. Returns (by_category_us, by_name_us, counts).
    """
    by_cat: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    for path in find_trace_files(log_dir, latest_only=latest_only):
        for ev in load_events(path):
            if ev.get("ph") != "X":
                continue
            args = ev.get("args") or {}
            cat = args.get("hlo_category")
            if not cat:
                continue
            dur = float(ev.get("dur", 0.0))
            by_cat[cat] += dur
            by_name[ev.get("name", "?")] += dur
            counts[ev.get("name", "?")] += 1
    return dict(by_cat), dict(by_name), dict(counts)


def report(log_dir: str, top: int = 20, latest_only: bool = True) -> dict:
    by_cat, by_name, counts = aggregate(log_dir, latest_only=latest_only)
    total = sum(by_cat.values())
    out = {
        "total_device_us": round(total, 1),
        "by_category_us": {
            k: round(v, 1)
            for k, v in sorted(by_cat.items(), key=lambda kv: -kv[1])
        },
        "top_ops_us": [
            {"name": k, "us": round(v, 1), "count": counts[k]}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ],
    }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("log_dir")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--all-runs", action="store_true",
                    help="sum EVERY profile subdir under log_dir (default: "
                         "only the newest — re-runs into the same dir "
                         "would otherwise double-count)")
    args = ap.parse_args()
    print(json.dumps(
        report(args.log_dir, args.top, latest_only=not args.all_runs),
        indent=2))


if __name__ == "__main__":
    main()
