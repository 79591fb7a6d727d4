"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything particular to one of them is a file found by its name:

* ``benchmark/configs/<config>.json`` (the ``file`` of its entry): the
  sizes, the sampler, the precisions, the weights' rules and the limits of
  the comparison that decides ``correct``; its ``family`` names the
  reference network and the program's names for it,
  ``benchmark/systems/<family>.py``;
* ``benchmark/workloads/<traffic>.json``: the inputs' shapes, the batch,
  the loop, the pool and the checked sample; its ``driver`` names the
  loop, ``benchmark/drivers/<driver>.py``;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) → float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a run (compared whole:
# the program's name begins with the last one's).
BANNED = ("jax", "jaxlib", "flax", "diffuvolume_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "workloads" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return {"name": name, "chips": w["chips"], "cfg": cfg, "traffic": traffic,
            "end_to_end": [m for m in spec["end_to_end"] if _applies(m, name)],
            "per_layer": [m for m in spec["per_layer"] if _applies(m, name)]}


def family(cfg: dict):
    return importlib.import_module(f"benchmark.systems.{cfg['family']}")


def driver(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def reader(metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list[str]:
    """Banned top-level names in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def process_start() -> float:
    """This process's start on the wall clock (``time.time``): its age from
    ``/proc`` (10 ms ticks), or the harness's import where that cannot be
    read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
