"""The program's own spans in a traced slice, and the device work, host
time and idle gaps put down to them.

The program marks its work with ``torch.profiler.record_function`` spans
named ``dv.*`` while a profiler records (``diffuvolume_tpu_torch/utils/
spans.py``); they reach the Chrome trace as ``user_annotation`` events on
the clock of the device operations and their launches.  A device
operation belongs to every span open when the launch that issued it
(matched by ``correlation``) started, on any thread: autograd launches
the backward from a thread of its own while the step's span stays open on
the caller's.  An idle gap of ``tracing.reduce`` is put down to the
innermost span open at the launch of the operation that ends it.

``of(ctx, phase, name)`` reads ``run.TRACE_FILE`` once a process, and
only where it is the trace ``ctx`` was made from (the same count of device
operations and the same first start) and holds the span ``name``; else,
or with no file, no busy time or another phase, None.

    python3 -m benchmark.spans    # the last traced run's spans, as JSON
"""

from __future__ import annotations

import bisect
import functools
import json
from collections import Counter
from pathlib import Path

from benchmark import run, tracing

PREFIX = "dv."
INFER, PREP, FEATURES, REFINE, DDIM_STEP, H2D = (
    "dv.infer", "dv.prep", "dv.features", "dv.refine", "dv.ddim.step", "dv.h2d")
TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIMIZER = (
    "dv.train.forward", "dv.train.backward", "dv.train.optimizer")
NAMES = (INFER, PREP, FEATURES, REFINE, DDIM_STEP, H2D, TRAIN_FORWARD, TRAIN_BACKWARD,
         TRAIN_OPTIMIZER)
# Where a gap's launch lies in no span, or has no launch in the trace.
OUTSIDE, UNATTRIBUTED = "no dv span", "unattributed"


def _open_at(intervals, ts: float) -> bool:
    """Whether ``ts`` lies in one of the merged, sorted ``[start, end]``."""
    i = bisect.bisect_right(intervals, [ts, float("inf")]) - 1
    return i >= 0 and intervals[i][1] >= ts


def _merged(spans) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list[dict]) -> dict:
    """The spans of a Chrome trace's events (times in µs there, seconds
    here): ``ops`` and ``first_s`` (the device operations' count and first
    start, as ``tracing.reduce`` has them); ``device`` ``{frozenset of the
    span names open at the launch: device seconds}``; ``host`` ``{(name,
    frozenset of the names enclosing it): [seconds, instances]}``;
    ``idle`` ``{innermost span at the gap's end: idle seconds}``."""
    ops, launches, cu_launches, spans = [], {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in tracing.DEVICE_CATS:
            ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), cat, corr))
        elif cat == "cuda_runtime" and corr is not None:
            launches[corr] = float(e["ts"])
        elif cat == "cuda_driver" and corr is not None:
            cu_launches[corr] = float(e["ts"])
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                          e["name"]))
    # Kernels launched through the driver API have a `cuda_driver` launch only.
    launches = {**cu_launches, **launches}
    ops.sort(key=lambda o: o[1])
    # Outer spans first where two start together.
    spans.sort(key=lambda s: (s[0], -s[1]))
    by_name = {n: _merged((s, e) for s, e, m in spans if m == n) for n in {s[2] for s in spans}}
    starts = [s[0] for s in spans]

    def open_at(ts: float) -> frozenset:
        return frozenset(n for n, iv in by_name.items() if _open_at(iv, ts))

    def innermost(ts: float) -> str:
        for j in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
            if spans[j][1] >= ts:
                return spans[j][2]
        return OUTSIDE

    device: Counter = Counter()
    for _, _, dur, _, corr in ops:
        ts = launches.get(corr)
        device[frozenset() if ts is None else open_at(ts)] += dur * 1e-6

    host: dict = {}
    for i, (s, e, name) in enumerate(spans):
        outer = frozenset(m for j, (s2, e2, m) in enumerate(spans)
                          if j != i and s2 <= s and e <= e2)
        acc = host.setdefault((name, outer), [0.0, 0])
        acc[0] += (e - s) * 1e-6
        acc[1] += 1

    _, gaps = tracing._union_and_gaps([(n, ts, dur, cat) for n, ts, dur, cat, _ in ops])
    idle: Counter = Counter()
    for start, end, i in gaps:
        ts = launches.get(ops[i][4])
        idle[UNATTRIBUTED if ts is None else innermost(ts)] += (end - start) * 1e-6
    return {"ops": len(ops), "first_s": ops[0][1] * 1e-6 if ops else None,
            "device": dict(device), "host": host, "idle": dict(idle)}


@functools.lru_cache(maxsize=1)
def _read(path: str, mtime_ns: int, size: int) -> dict:
    with open(path) as f:
        return reduce(json.load(f)["traceEvents"])


def of(ctx: dict, phase: str, name: str) -> dict | None:
    """The reduction of ``run.TRACE_FILE`` where it is the trace of
    ``ctx``, a ``phase`` cell's, and holds a span ``name``; else None."""
    path = Path(run.TRACE_FILE)
    if ctx["phase"] != phase or ctx["busy_s"] <= 0 or not ctx["ops"] or not path.is_file():
        return None
    st = path.stat()
    red = _read(str(path), st.st_mtime_ns, st.st_size)
    if red["ops"] != len(ctx["ops"]) or red["first_s"] != ctx["ops"][0][1]:
        return None
    return red if count(red, name) else None


def device_s(red: dict, *names: str) -> float:
    """Device seconds launched while a span of one of ``names`` was open."""
    return sum(v for k, v in red["device"].items() if k & set(names))


def host_s(red: dict, name: str, inside: str | None = None) -> float:
    """Host seconds of the spans ``name`` (those within a span ``inside``)."""
    return sum(v[0] for (n, outer), v in red["host"].items()
               if n == name and (inside is None or inside in outer))


def count(red: dict, name: str) -> int:
    return sum(v[1] for (n, _), v in red["host"].items() if n == name)


def summary(red: dict) -> dict:
    """Per name: device and host ms, instances; idle ms by innermost span;
    the device ms launched in no span and the total."""
    total = sum(red["device"].values())
    out = {n: {"device_ms": device_s(red, n) * 1e3, "host_ms": host_s(red, n) * 1e3,
               "count": count(red, n)} for n in NAMES if count(red, n)}
    return {"spans": out, "idle_ms": {k: v * 1e3 for k, v in red["idle"].items()},
            "device_ms_total": total * 1e3,
            "device_ms_in_no_span": red["device"].get(frozenset(), 0.0) * 1e3}


if __name__ == "__main__":
    with open(run.TRACE_FILE) as f:
        print(json.dumps(summary(reduce(json.load(f)["traceEvents"])), indent=1))
