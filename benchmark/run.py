"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the traced slice),
with ``--trace 1`` ``breakdown``, and last ``checks``: each number of the
comparison with the reference beside its limit, which also end standard
error.  Exits non-zero and prints no result when there is no CUDA device
(or fewer than the cell asks for), when the program or the run fails, or
when ``jax``, ``jaxlib``, ``flax`` or ``diffuvolume_tpu`` is loaded once
the window has closed.  Every build and kernel cache lives under
``build/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda"}
TRACE_FILE = ROOT / "build" / "benchmark" / "trace.json"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def layer_metrics(cell: dict, res: dict, dev_name: str, trace_file: Path):
    """``(metrics, device additions, breakdown)`` of a traced run."""
    from benchmark import harness, peaks, tracing

    red = tracing.read(trace_file)
    phase = cell["traffic"]["phase"]
    ctx = {
        "phase": phase, **res["units"], "window_s": res["slice"].window_s,
        "busy_s": red["busy_s"], "ops": red["ops"], "kernels": red["kernels"],
        "work": res["count"](), "peaks": peaks.PEAKS[dev_name],
        "peak_dtype": cell["cfg"][phase]["peak"], "group_of": peaks.group_of,
    }
    metrics = {}
    for m in cell["per_layer"]:
        v = harness.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    by_name: dict[str, float] = {}
    for name, _, dur in red["ops"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    breakdown = {"device_ops": tracing.top(by_name), "idle_gaps": tracing.top(red["gaps"])}
    return metrics, {"busy_s": red["busy_s"], "window_s": ctx["window_s"]}, breakdown


def result(cell: dict, res: dict, started: float, dev_name: str,
           trace_file: Path | None) -> tuple[dict, list[str]]:
    """The result line and the lines that end standard error."""
    device = {"platform": "gpu", "kind": dev_name, "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace_file is not None:
        metrics, more, breakdown = layer_metrics(cell, res, dev_name, trace_file)
        device.update(more)
    else:
        e2e = dict(res["e2e"], setup_s=res["setup_end"] - started)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    limits = cell["cfg"]["limits"][cell["traffic"]["phase"]]
    checks = {k: {"value": res["checks"][k], "limit": v} for k, v in limits.items()}
    line = {"correct": all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace_file is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    err = [f"read at: {k} {v}" for k, v in res.get("notes", {}).items()]
    err += [f"not compared: {k} {v!r}" for k, v in res["checks"].items() if k not in limits]
    err += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return line, err


def main(argv=None) -> int:
    from benchmark import harness

    started = harness.process_start()
    args = parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    import torch

    cell = harness.cell(harness.load_spec(), args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"run: {cell['chips']} CUDA device(s) needed, {found} found; nothing was run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    trace_file = TRACE_FILE if args.trace else None
    res = harness.driver(cell["traffic"]).run(cell, args.seed, args.seconds, trace_file, dev)
    loaded = harness.banned_modules()
    if loaded:
        print(f"run: modules that may not load were loaded: {loaded}", file=sys.stderr)
        return 3
    line, err = result(cell, res, started, torch.cuda.get_device_name(0), trace_file)
    print("\n".join(err), file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not this folder
    sys.exit(main())
