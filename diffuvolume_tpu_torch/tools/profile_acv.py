"""Where one pair spends its device time.

    python -m diffuvolume_tpu_torch.tools.profile_acv [--model acv|pcw|igev]
        [--pairs N] [--path folded|module] [--refine-module] [--routed] [--tf32-off]

Runs the inputs of ``chip_smoke.py``'s paths: ACV two-pass DDIM-5 at
512×960 (``--model acv``, the default), PCW two-pass KITTI12 DDIM-3 at
384×1248 (``--model pcw``) or IGEV-Stereo two-pass KITTI15 DDIM-2 at
384×1248 with 32 GRU iterations a rollout (``--model igev``), batch 1,
bfloat16, on the folded path
(``packed=True``, the default) or the module path; ``--refine-module`` folds
PCW with ``refine_flat=False`` (the module refinement on cuDNN, not row 18),
``--routed`` runs the module path after ``route_conv3d`` (its 3×3×3 convs on
row 15).  ``--tf32-off`` turns TF32 off globally for cuDNN and matmuls
first (to compare with a profile taken that way; the pipelines set their own
precision for float32 models and leave bf16 ones as they are).  One
warm-up pair, then ``N`` pairs under ``torch.profiler``.
Prints the device time per pair by kernel group and the top kernels, the
wall time per pair (profiled, and over ``N`` pairs run without the
profiler, which adds host time of its own) and the device's idle share (1 − device busy / unprofiled wall), and writes them
to ``profile_<model>_<path>[_refine_module|_routed].json`` in the output
directory.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from diffuvolume_tpu_torch.diffusion import DDIMConfig
from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM, KITTI15_DDIM
from diffuvolume_tpu_torch.eval.pipeline import (
    acv_ddim_inference,
    igev_ddim_inference,
    pcw_ddim_inference,
)
from diffuvolume_tpu_torch.models.acv_fold import fold_acv
from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
from diffuvolume_tpu_torch.models.layers import route_conv3d
from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
from diffuvolume_tpu_torch.tools.profiling import device_time_by_group
from diffuvolume_tpu_torch.tools.random_weights import (
    seeded_igev_path,
    seeded_main_path,
    seeded_pcw_path,
)
from diffuvolume_tpu_torch.utils.device import resolve_device

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("acv", "pcw", "igev"), default="acv")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--path", choices=("folded", "module"), default="folded")
    ap.add_argument("--refine-module", action="store_true",
                    help="PCW folded: the module refinement net, not conv2d_flat")
    ap.add_argument("--routed", action="store_true",
                    help="module path: the 3x3x3 convs on conv3d_packed (route_conv3d)")
    ap.add_argument("--tf32-off", action="store_true",
                    help="TF32 off globally for cuDNN and matmuls")
    args = ap.parse_args(argv)
    packed = args.path == "folded"
    if args.refine_module and not (packed and args.model == "pcw"):
        ap.error("--refine-module is PCW's folded path's")
    if args.routed and packed:
        ap.error("--routed is the module path's")
    dev = resolve_device(None)
    if args.tf32_off:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.model == "acv":
        bm, dm, left, right = seeded_main_path(dev)
        cfg, infer, fold = DDIMConfig(), acv_ddim_inference, fold_acv
    elif args.model == "pcw":
        bm, dm, left, right = seeded_pcw_path(dev)
        cfg, infer = KITTI12_DDIM, pcw_ddim_inference
        flat = False if args.refine_module else None
        fold = lambda m: fold_pcw(m, refine_flat=flat)  # noqa: E731
    else:
        bm, dm, left, right = seeded_igev_path(dev)
        cfg, infer, fold = KITTI15_DDIM, igev_ddim_inference, fold_igev
    if packed:  # folded once, as a caller running many pairs does
        bm, dm = fold(bm), fold(dm)
    elif args.routed:
        bm, dm = route_conv3d(bm), route_conv3d(dm)
    variant = "_refine_module" if args.refine_module else "_routed" if args.routed else ""

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return infer(bm, dm, left, right, cfg, device=dev, generator=gen, packed=packed)

    pair(100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.pairs):
        pair(i)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.pairs
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(args.pairs):
            pair(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.pairs

    split = device_time_by_group(prof, args.pairs)
    device_ms, groups, kernels = split["device_ms"], split["groups_ms"], split["kernels_ms"]
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    idle = 1 - device_ms / plain_wall_ms
    print(f"{card}, {args.model} {args.path}{variant} path: wall {plain_wall_ms:.2f} ms/pair "
          f"({wall_ms:.2f} under the profiler), device busy {device_ms:.2f} ms/pair, "
          f"idle share {idle:.3f}")
    for g, ms in groups.items():
        print(f"  {ms:10.3f} ms  {ms / device_ms:6.1%}  {g}")
    print("top kernels:")
    top = list(kernels.items())[:15]
    for name, ms in top:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    os.makedirs("chiprun_out", exist_ok=True)
    name = f"profile_{args.model}_{args.path}{variant}.json"
    with open(os.path.join("chiprun_out", name), "w") as f:
        json.dump({"card": card, "model": args.model, "path": args.path + variant,
                   "wall_ms_per_pair": plain_wall_ms,
                   "profiled_wall_ms_per_pair": wall_ms, "device_ms_per_pair": device_ms,
                   "idle_share": idle, "groups_ms": groups,
                   "top_kernels_ms": dict(top)}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
