"""A projection of data-parallel scaling over H100 cards joined by NVLink.

The port's counterpart of ``diffuvolume_tpu/tools/scaling_model.py``: what
sets the scaling of the data-parallel step (``parallel/ddp.py``) is the
gradient all-reduce against the step's own time.  Here:

* **all-reduce bytes**: the trainable parameters' float32 bytes, the
  payload of ``Mesh.all_reduce_gradients``' one flattened all-reduce a
  step (the BatchNorms' sums and the loss's count are a few KB);
* **FLOPs per device**: ``tools/flops.py`` ``flop_count`` of one step at
  the per-device batch, on the CPU (matmuls, convolutions and their
  transposes, forward and backward; not elementwise ops);
* **compute time**: a step time the caller measured at the same
  configuration on one card (``--step-ms``, from ``tools/bench_train.py``),
  not an assumed utilisation;
* **link**: ``tools/profiling.py`` ``PEAKS``' NVLink rate of the H100 SXM5,
  each way.

A ring all-reduce sends and receives ``2·(N − 1)/N`` of the payload a
device, so ``t_comm = 2·(N − 1)/N · bytes / link``.  With the all-reduce
overlapped with the backward the step takes ``max(t_compute, t_comm)``,
without it their sum; the efficiencies are ``t_compute`` over each:

    python -m diffuvolume_tpu_torch.tools.scaling_model --step-ms T [--devices 8]
        [--hw 256 512] [--per_device_batch 4] [--maxdisp 192]

Prints one JSON line.  A projection, not a measurement: no NCCL run above
one card has been timed (``tools/scaling_bench.py`` measures one).
"""

from __future__ import annotations

import argparse
import json

import torch

DEVICE = "NVIDIA H100 80GB HBM3"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--step-ms", type=float, required=True,
                   help="one card's measured step time at this configuration "
                   "(tools/bench_train.py)")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(256, 512))
    p.add_argument("--per_device_batch", type=int, default=4)
    p.add_argument("--maxdisp", type=int, default=192)
    return p.parse_args(argv)


def project(n_params: int, step_ms: float, devices: int, link_bytes_per_s: float) -> dict:
    """The ring all-reduce of ``n_params`` float32 gradients over
    ``devices`` against a ``step_ms`` step: its bytes, its time, and the
    overlapped and serial efficiencies."""
    ar_bytes = 4 * n_params
    t_compute = step_ms / 1e3
    t_comm = 2 * (devices - 1) / devices * ar_bytes / link_bytes_per_s
    return {"allreduce_bytes_per_step": ar_bytes, "t_compute_ms": step_ms,
            "t_comm_ms": t_comm * 1e3,
            "projected_efficiency_overlapped": t_compute / max(t_compute, t_comm),
            "projected_efficiency_serial": t_compute / (t_compute + t_comm)}


def step_flops(model, b: int, h: int, w: int) -> dict:
    """``flop_count`` of one ACV step (forward, backward, Adam) at batch
    ``b`` on the CPU."""
    from diffuvolume_tpu_torch.tools.flops import flop_count
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    g = torch.Generator().manual_seed(1)
    left = torch.randn((b, h, w, 3), generator=g) * 0.3
    batch = {"left": left, "right": torch.roll(left, -3, dims=2),
             "disp_gt": torch.rand((b, h, w), generator=g) * (model.max_disp - 1) + 1.0}
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    step = make_train_step(model)
    return flop_count(step, state, batch, torch.Generator().manual_seed(2))


def main(argv=None) -> dict:
    from diffuvolume_tpu_torch.models import build_model
    from diffuvolume_tpu_torch.tools.flops import count_params
    from diffuvolume_tpu_torch.tools.profiling import PEAKS

    args = parse_args(argv)
    h, w = args.hw
    model = build_model("acvnet_ddim", max_disp=args.maxdisp)
    model.init_weights(torch.Generator().manual_seed(0))
    model.train()
    n_params = count_params(p for p in model.parameters() if p.requires_grad)
    flops = step_flops(model, args.per_device_batch, h, w)
    peaks = PEAKS[DEVICE]
    link = peaks["nvlink_bytes_per_s_each_way"]
    rec = {"metric": "dp_scaling_projection_h100", "devices": args.devices, "hw": [h, w],
           "per_device_batch": args.per_device_batch, "maxdisp": args.maxdisp,
           "params": n_params, "flops_per_device_step": flops["flops"],
           "flops_counted": flops["counted"],
           **project(n_params, args.step_ms, args.devices, link),
           "assumptions": {"card": peaks["card"], "power_limit_w": peaks["power_limit_w"],
                           "link": "NVLink 4, each way", "link_bytes_per_s": link,
                           "collective": "ring all-reduce, 2(N-1)/N of the payload a device",
                           "step_ms": "measured by the caller on one card"}}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
