"""Where one main-path pair spends its device time.

    python -m diffuvolume_tpu_torch.tools.profile_acv [--pairs N]

Runs ACV two-pass DDIM-5 at 512×960, batch 1, bfloat16 (the inputs of
``chip_smoke.py``'s main path), one warm-up pair, then ``N`` pairs under
``torch.profiler``.  Prints the device time per pair by kernel group and the
top kernels, the wall time per pair and the device's idle share, and writes
them to ``chiprun_out/profile_acv.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import torch

from diffuvolume_tpu_torch.diffusion import DDIMConfig
from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference
from diffuvolume_tpu_torch.tools.random_weights import seeded_main_path
from diffuvolume_tpu_torch.utils.device import resolve_device

# Kernel name → group, first match wins.
GROUPS = [
    ("port: fused head", r"fused_head_kernel"),
    ("port: gwc volume", r"gwc_kernel"),
    ("port: concat volume", r"concat_kernel"),
    ("port: dhw multiply", r"dhw_mul_kernel"),
    ("conv / deconv (cuDNN, CUTLASS)", r"conv|cudnn|xmma|implicit|wgrad|dgrad|fprop|winograd|sm90_"),
    ("matmul (attention, resizes)", r"gemm|cublas|cutlass"),
    ("batch norm", r"batch_norm|bn_"),
    ("softmax", r"softmax"),
    ("copies / layout", r"copy|transpose|permute|cat|pad|Memcpy|Memset"),
    ("elementwise / reduce", r"elementwise|reduce|vectorized|unrolled"),
]


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, re.IGNORECASE):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bm, dm, left, right = seeded_main_path(dev)
    cfg = DDIMConfig()

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return acv_ddim_inference(bm, dm, left, right, cfg, device=dev, generator=gen)

    pair(100)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(args.pairs):
            pair(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.pairs

    kernels = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / args.pairs
    device_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    card = torch.cuda.get_device_name(0)
    print(f"{card}: wall {wall_ms:.2f} ms/pair, device busy {device_ms:.2f} ms/pair, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / device_ms:6.1%}  {g}")
    print("top kernels:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    for name, ms in top:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_acv.json"), "w") as f:
        json.dump({"card": card, "wall_ms_per_pair": wall_ms,
                   "device_ms_per_pair": device_ms, "groups_ms": groups,
                   "top_kernels_ms": dict(top)}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
