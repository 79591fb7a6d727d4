"""A profiled slice of the window and its reduction to what the metric
readers take.

``Slice`` runs torch.profiler (host and device) over a bounded number of
the window's units (pairs' batches or steps), each ended by a
synchronise, and exports the Chrome trace to a fixed file inside the
checkout.  ``reduce`` reads it back: every device operation (kernels,
copies, sets) with its start and length, the seconds in which any ran
(the union of their intervals), and each idle gap between them named by
the innermost host operation that launched the device operation ending
the gap.
"""

from __future__ import annotations

import bisect
import json
import time
from pathlib import Path

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Slice:
    """``with Slice(path) as s: ...`` profiles the block; ``s.window_s`` is
    its wall time between two synchronises."""

    def __init__(self, path: Path):
        self.path = path
        self.window_s = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
        return False


def _union_and_gaps(ops):
    """Merged ``[start, end)`` spans of the device ops (sorted by start), and
    the gaps between them as ``(start, end, index of the op after)``."""
    spans, gaps = [], []
    for i, (_, ts, dur, _) in enumerate(ops):
        if spans and ts <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], ts + dur)
            continue
        if spans:
            gaps.append((spans[-1][1], ts, i))
        spans.append([ts, ts + dur])
    return spans, gaps


def reduce(events: list[dict]) -> dict:
    """``{"ops": [(name, start_s, dur_s)], "kernels": count of kernels,
    "busy_s", "gaps": {host op: idle seconds}}`` of a Chrome trace's
    events (times in µs in the trace)."""
    ops, launches, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), cat, corr))
        elif cat == "cuda_runtime" and corr is not None:
            launches[corr] = float(e["ts"])
        elif cat == "cpu_op":
            host.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]))
    ops.sort(key=lambda o: o[1])
    host.sort()
    starts = [h[0] for h in host]
    spans, gaps = _union_and_gaps([(n, ts, dur, cat) for n, ts, dur, cat, _ in ops])

    def launcher(corr) -> str:
        ts = launches.get(corr)
        if ts is None:
            return "unattributed"
        # Walking back by start, the first op still open at ``ts`` is the
        # innermost one that encloses it.
        for j in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
            if host[j][1] >= ts:
                return host[j][2]
        return "no host op"

    named: dict[str, float] = {}
    for start, end, i in gaps:
        name = launcher(ops[i][4])
        named[name] = named.get(name, 0.0) + (end - start) * 1e-6
    return {
        "ops": [(n, ts * 1e-6, dur * 1e-6) for n, ts, dur, _, _ in ops],
        "kernels": sum(1 for o in ops if o[3] == "kernel"),
        "busy_s": sum(e - s for s, e in spans) * 1e-6,
        "gaps": named,
    }


def read(path: Path) -> dict:
    with open(path) as f:
        return reduce(json.load(f)["traceEvents"])


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
