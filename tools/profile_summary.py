#!/usr/bin/env python3
"""Summarize a --jax-profile (xprof) trace into a flat duration table.

The top-N trace events by total duration, which is enough to read off
the split between on-device program time (jit_rel_only_dev, the while.*
loop bodies) and the host's fetch wait (np.asarray(jax.Array)).

Usage: python3 tools/profile_summary.py <trace_dir_or_json.gz> [N]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(
        path, "**", "*.trace.json.gz"), recursive=True))
    if not hits:
        sys.exit(f"no *.trace.json.gz under {path}")
    return hits[-1]


def main() -> None:
    path = find_trace(sys.argv[1] if len(sys.argv) > 1 else ".")
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    d = json.load(gzip.open(path))
    dur: dict[str, list[int]] = collections.defaultdict(list)
    for e in d.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            dur[e.get("name", "?")].append(e["dur"])
    print(f"# {path}")
    print(f"# {'total_s':>9} {'n':>6} {'avg_ms':>9}  event")
    for name, ds in sorted(dur.items(), key=lambda kv: -sum(kv[1]))[:n]:
        print(f"{sum(ds) / 1e6:9.3f}s n={len(ds):5d} "
              f"avg={sum(ds) / len(ds) / 1e3:8.2f}ms  {name[:100]}")


if __name__ == "__main__":
    main()
