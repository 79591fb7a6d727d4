"""Stage timings on the card, speed of light against its peaks.

Counterpart of ``diffuvolume_tpu/tools/profiling.py``:

* ``StageReport.speed_of_light``: a stage's time against the least time
  the card could take for its operations and bytes, from ``PEAKS``, keyed
  on ``torch.cuda.get_device_name``; each entry names its card and the
  power limit its figures assume, and a card not in the table raises;
* ``time_stage``: a call's device time in ms, by CUDA events around each
  call (median) or by torch.profiler's device time (the kernels' sum a
  call).  Events read the host's issue time below about 30 µs a call, so
  short stages take the profiler's reading;
* ``device_time_by_group``: a profiler session's kernel time by the
  kernel groups of ``GROUPS`` (the port's kernels by source, cuDNN,
  matmuls, BatchNorm, the optimiser, copies, elementwise).

Needs a CUDA device for every reading; nothing here falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import re
import statistics
from typing import Callable

import torch

# device name (as torch.cuda.get_device_name gives it) → its published
# peaks: NVIDIA's H100 data sheet, SXM5 part, dense rates without sparsity,
# at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "card": "NVIDIA H100 SXM5 80GB", "power_limit_w": 700.0,
        "flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12,
                  "float64": 34e12},
        "hbm_bytes_per_s": 3.35e12,
        # NVLink 4 between the cards of one host: 18 links, 900 GB/s both
        # ways together, 450 GB/s each way (the same data sheet); a ring
        # all-reduce sends and receives at once (tools/scaling_model.py).
        "nvlink_bytes_per_s_each_way": 450e9,
    },
}

# Kernel name → group, first match wins.  BatchNorm comes before the cuDNN
# group: cuDNN's own BatchNorm kernels (``cudnn::bn_fw_inf_…``) carry its name.
GROUPS = [
    # head_kernel<T, bins a lane, at a query>: rows 1 and 17
    ("port: fused head", r"head_kernel<[^>]*false>"),
    ("port: uncertainty at query", r"head_kernel<[^>]*true>"),
    ("port: gwc volume", r"gwc_ncdhw_kernel"),
    ("port: gwc volume in the slot", r"gwc_slot_kernel"),
    ("port: patch stencils", r"depthwise_hw_kernel"),
    ("port: concat volume", r"concat_kernel|concat_cl_kernel"),
    ("port: dhw multiply", r"dhw_mul_kernel|dhw_mul_cl"),
    # conv_s1<BN, MT, wgmma, plane, 2-D> and conv_s1_head<2-D>: the last
    # template argument tells the 3-D conv from row 18
    ("port: 3-D conv, folded (conv3d_fold.cu)",
     r"conv_k1<|direct_f32<false|conv_bf16<false|splitk_finish|conv_s1(_head)?<[^>]*false>"),
    ("port: transposed conv, folded (conv3d_up.cu)", r"direct_f32<true|conv_bf16<true"),
    ("port: dilated 2-D conv (conv2d_flat.cu)", r"conv2d_f32|conv_s1(_head)?<[^>]*true>"),
    ("port: layout pack / unpack", r"transpose_vec_kernel|transpose_tile_kernel|hwdc"),
    # On the folded path every BatchNorm left is a 2-D one (the feature
    # trunk's; PCW's refinement net's unless it is flat): chip_smoke.py's op
    # census shows no 3-D one.
    ("batch norm", r"batch_norm|bn_fw|bn_bw"),
    ("collectives (NCCL)", r"nccl"),
    ("conv / deconv (cuDNN, CUTLASS)", r"conv|cudnn|xmma|implicit|wgrad|dgrad|fprop|winograd|sm90_"),
    ("matmul (attention, resizes)", r"gemm|cublas|cutlass"),
    ("grid sample (PCW refinement warp)", r"grid_sampler"),
    ("instance norm (IGEV trunk)", r"instance_norm|welford"),
    ("softmax", r"softmax"),
    ("optimizer (Adam, clip)", r"multi_tensor|adam|foreach"),
    ("copies / layout", r"copy|transpose|permute|cat|pad|Memcpy|Memset"),
    ("elementwise / reduce", r"elementwise|reduce|vectorized|unrolled"),
]


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, re.IGNORECASE):
            return group
    return "other"


def device_peaks(name: str | None = None) -> dict:
    """The peaks of the card ``name`` (default: ``cuda:0``'s); a card not in
    ``PEAKS`` raises."""
    name = torch.cuda.get_device_name(0) if name is None else name
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}; known: {sorted(PEAKS)}")
    return PEAKS[name]


@dataclasses.dataclass
class StageReport:
    """A stage's measured time, and the operations and bytes its work
    needs (each input read once, each output written once)."""

    name: str
    ms: float
    flops: float | None = None
    bytes_moved: float | None = None
    dtype: str = "float32"

    def speed_of_light(self, device_name: str | None = None) -> dict:
        """The stage's bounds (``flops_sol_ms`` at the dtype's peak rate,
        ``bw_sol_ms`` at the memory rate), the larger of them, and the
        share of ``ms`` each is, with the card and power limit they
        assume."""
        peaks = device_peaks(device_name)
        out = {"name": self.name, "ms": self.ms, "card": peaks["card"],
               "power_limit_w": peaks["power_limit_w"]}
        if self.flops:
            out["flops_sol_ms"] = self.flops / peaks["flops"][self.dtype] * 1e3
            out["flops_efficiency"] = out["flops_sol_ms"] / self.ms
        if self.bytes_moved:
            out["bw_sol_ms"] = self.bytes_moved / peaks["hbm_bytes_per_s"] * 1e3
            out["bw_efficiency"] = out["bw_sol_ms"] / self.ms
        bounds = {k: out[k] for k in ("flops_sol_ms", "bw_sol_ms") if k in out}
        if bounds:
            key = max(bounds, key=bounds.get)
            out["bound_ms"] = bounds[key]
            out["bound_by"] = "operations" if key == "flops_sol_ms" else "bytes"
        return out


def _check_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing on the card needs a CUDA device")


def kernel_times(prof) -> dict:
    """Device ms by kernel name over a torch.profiler session."""
    out = {}
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
    return out


def device_time_by_group(prof, per: int = 1) -> dict:
    """``{"device_ms", "groups_ms", "kernels_ms"}`` of a profiler session,
    divided by ``per`` (the calls or steps it covered); raises if the
    profiler saw no device time."""
    kernels = {k: v / per for k, v in kernel_times(prof).items()}
    if not kernels:
        raise RuntimeError("torch.profiler saw no device time")
    groups = {}
    for name, ms in kernels.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + ms
    return {"device_ms": sum(kernels.values()),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}


def time_stage(fn: Callable, *args, iters: int = 5, warmup: int = 1, method: str = "events",
               **kw) -> float:
    """``fn(*args, **kw)``'s time on the card in ms: the median over
    ``iters`` calls of CUDA events around each (``method="events"``), or
    the kernels' device time a call over ``iters`` calls under
    torch.profiler (``"profiler"``), after ``warmup`` calls."""
    _check_card()
    for _ in range(warmup):
        fn(*args, **kw)
    torch.cuda.synchronize()
    if method == "profiler":
        activities = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(iters):
                fn(*args, **kw)
            torch.cuda.synchronize()
        return device_time_by_group(prof, iters)["device_ms"]
    if method != "events":
        raise ValueError(f"method must be 'events' or 'profiler', got {method!r}")
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
