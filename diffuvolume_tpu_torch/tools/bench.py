"""Throughput of the port's two-pass DDIM inference on one card.

The port's counterpart of the JAX package's ``bench.py`` (``--model acv``,
the default: SceneFlow ACVNet two-pass DDIM-5 at 512×960),
``tools/bench_pcw.py`` (``--model pcw``: KITTI12 PCWNet DDIM-3 at 384×1248)
and ``tools/bench_igev.py`` (``--model igev``: KITTI15 IGEV-Stereo DDIM-2
at 384×1248, ``--iters`` GRU iterations a rollout), with their flags:

    python -m diffuvolume_tpu_torch.tools.bench [--model acv|pcw|igev] [--height H]
        [--width W] [--iters N] [--reps N] [--f32] [--refine-module]

Weights and images come from seed 0 (``tools/random_weights.py``
``seeded_main_path`` / ``seeded_pcw_path`` / ``seeded_igev_path``: bf16
models, ``--f32`` casts them to float32); both models run the folded path,
folded once (a bfloat16 PCW's refinement net on the flat 2-D conv kernel;
``--refine-module``: the module refinement, the JAX package's default).
One warm-up pair (it builds the kernels), then ``--reps`` timed pairs, each
ended by a synchronise, then one pair under torch.profiler for the card's
busy time.  Prints one JSON line: pairs/s (reps over their wall time) with
the median, p10 and p90 of the per-pair rate, wall ms a pair, device-busy
ms a pair (the profiled pair's kernels summed) and the idle share it
leaves, CUDA events around each timed pair (median), and the card's name
and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# model → its metric's name, as the JAX package's tools name it
METRICS = {
    "acv": "sceneflow_ddim5_pairs_per_s",
    "pcw": "kitti12_pcw_ddim3_pairs_per_s",
    "igev": "kitti15_igev_ddim2_pairs_per_s",
}
DEFAULT_HW = {"acv": (512, 960), "pcw": (384, 1248), "igev": (384, 1248)}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=list(METRICS), default="acv")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--iters", type=int, default=32, help="IGEV GRU iterations a rollout")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--f32", action="store_true", help="float32 models (default bfloat16)")
    p.add_argument("--refine-module", action="store_true",
                   help="PCW: the module refinement net (cuDNN), not the flat 2-D conv kernel")
    return p.parse_args(argv)


def setup(args, dev: torch.device):
    """``(run, pair_label)``: ``run(generator)`` makes one pair's final
    disparity on ``dev``."""
    from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM, KITTI15_DDIM, SCENEFLOW_DDIM
    from diffuvolume_tpu_torch.eval import pipeline as pl
    from diffuvolume_tpu_torch.models.acv_fold import fold_acv
    from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
    from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
    from diffuvolume_tpu_torch.tools import random_weights as rw

    h, w = DEFAULT_HW[args.model]
    h, w = args.height or h, args.width or w
    if args.refine_module and args.model != "pcw":
        raise ValueError("--refine-module is PCW's")
    seeded, fold, pipeline, cfg, kw = {
        "acv": (rw.seeded_main_path, fold_acv, pl.acv_ddim_inference, SCENEFLOW_DDIM, {}),
        "pcw": (rw.seeded_pcw_path,
                lambda m: fold_pcw(m, refine_flat=False if args.refine_module else None),
                pl.pcw_ddim_inference, KITTI12_DDIM, {}),
        "igev": (rw.seeded_igev_path, fold_igev, pl.igev_ddim_inference, KITTI15_DDIM,
                 {"iters": args.iters}),
    }[args.model]
    baseline, ddim, left, right = seeded(dev, h, w)
    if args.f32:
        baseline, ddim = baseline.float(), ddim.float()
    baseline, ddim = fold(baseline), fold(ddim)

    def run(generator):
        final, _ = pipeline(baseline, ddim, left, right, cfg, device=dev, generator=generator,
                            **kw)
        return final

    return run, (h, w)


def busy_ms(run, generator) -> float:
    """The card's time in the kernels of one pair (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from diffuvolume_tpu_torch.tools.profiling import device_time_by_group

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(generator)
        torch.cuda.synchronize()
    return device_time_by_group(prof)["device_ms"]


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; nothing was run", file=sys.stderr)
        raise SystemExit(1)
    dev = torch.device("cuda:0")
    run, (h, w) = setup(args, dev)
    generator = torch.Generator(device=dev).manual_seed(0)

    t0 = time.perf_counter()
    out = run(generator)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("the warm-up pair's disparity is not finite")

    walls, events = [], []
    for _ in range(args.reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        run(generator)
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(start.elapsed_time(end))
    busy = busy_ms(run, generator)
    rates = 1.0 / np.asarray(walls)
    wall_ms = float(np.median(walls)) * 1e3
    metric = f"{METRICS[args.model]}_{h}x{w}"
    if args.model == "igev":
        metric += f"_iters{args.iters}"
    rec = {
        "metric": metric, "model": args.model, "refine_module": args.refine_module,
        "dtype": "float32" if args.f32 else "bfloat16", "height": h, "width": w,
        "reps": args.reps, "pairs_per_s": args.reps / float(np.sum(walls)),
        "pairs_per_s_median": float(np.median(rates)),
        "pairs_per_s_p10": float(np.percentile(rates, 10)),
        "pairs_per_s_p90": float(np.percentile(rates, 90)),
        "wall_ms_median": wall_ms, "events_ms_median": float(np.median(events)),
        "busy_ms_per_pair": busy, "idle_share": 1.0 - busy / wall_ms,
        "warmup_s": warmup_s, "device": torch.cuda.get_device_name(0), "card": card_line(),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
