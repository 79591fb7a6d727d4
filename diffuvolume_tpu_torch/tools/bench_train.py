"""Training-step throughput on one card: the ACV SceneFlow recipe's step.

The port's counterpart of ``diffuvolume_tpu/tools/bench_train.py``: one
``make_train_step`` step (the diffusion-conditioned forward, the weighted
smooth-L1 over the four heads, the backward, Adam) at the recipe's
256×512 crop and a batch of 4 (the reference's 23 over 6 GPUs, per card):

    python -m diffuvolume_tpu_torch.tools.bench_train [--batch 4] [--height 256]
        [--width 512] [--steps 10] [--ddp] [--profile]

The model is ``acvnet_ddim`` at ``max_disp`` 192 with the JAX package's
initialisation drawn from seed 0, in float32 as the training CLI's default,
under PyTorch's default precision settings as the CLI runs (cuDNN's
convolutions may take TF32); the batch (images of std 0.3, the right
shifted 3 px, ground truth uniform in [1, 150) px) is made on the card from
seed 1, and the step's draws from seed 2.  ``--ddp``: the same step
through ``parallel/ddp.py`` in a group of one process over NCCL (BatchNorm
over the global batch, the loss's count and the gradients summed over the
ranks, every collective run), what a ``torchrun`` training run pays a card
beyond the plain step.  One warm-up step, then ``--steps`` steps, each
ended by a synchronise.  Prints one JSON line: ms a step (median, p10, p90
over the steps after the warm-up), training pairs/s (the batch over the
median step), peak memory, the first and last loss, and the card's name
and power limit.  ``--profile`` adds ``PROFILE_STEPS`` steps under
torch.profiler: the step's device time by kernel group
(``tools/profiling.py``), its top kernels and the idle share it leaves of
the median step, printed as lines before the JSON line and in it.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from diffuvolume_tpu_torch.tools.bench import card_line

MAX_DISP = 192
PROFILE_STEPS = 2


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--ddp", action="store_true",
                   help="the step through parallel/ddp.py in a group of one process")
    p.add_argument("--profile", action="store_true",
                   help="the step's device time by kernel group (torch.profiler)")
    return p.parse_args(argv)


def make_step(args, dev, dp=None):
    """``step()``: one training step on ``dev`` (with ``dp``, a
    ``parallel.Mesh``, through it); returns its loss (a tensor on the
    card)."""
    from diffuvolume_tpu_torch.models import build_model
    from diffuvolume_tpu_torch.parallel import sync_batch_norm
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    model = build_model("acvnet_ddim", max_disp=MAX_DISP)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    if dp is not None:
        sync_batch_norm(model, dp)
        dp.broadcast_parameters(model)
    state = TrainState(model, make_optimizer(model),
                       milestone_lr_schedule(1e-3, "16,24,32,40,48:2", 1000))
    g = torch.Generator(device=dev).manual_seed(1)
    b, h, w = args.batch, args.height, args.width
    left = torch.randn((b, h, w, 3), generator=g, device=dev) * 0.3
    batch = {"left": left, "right": torch.roll(left, -3, dims=2),
             "disp_gt": torch.rand((b, h, w), generator=g, device=dev) * 149.0 + 1.0}
    if dp is not None:
        batch = dp.shard(batch)
    train_step = make_train_step(model, dp=dp)
    draws = torch.Generator(device=dev).manual_seed(2)
    return lambda: train_step(state, batch, draws)["loss"]


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_train: no CUDA device; nothing was run", file=sys.stderr)
        raise SystemExit(1)
    from diffuvolume_tpu_torch.parallel import ddp

    dev = torch.device("cuda:0")
    dp = ddp.init(0, 1, dev, f"tcp://localhost:{ddp.free_port()}") if args.ddp else None
    try:
        return _run(args, make_step(args, dev, dp))
    finally:
        if dp is not None:
            ddp.shutdown()


def _run(args, step) -> dict:
    from diffuvolume_tpu_torch.tools.profiling import device_time_by_group

    t0 = time.perf_counter()
    first = float(step())
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, loss = [], first
    for _ in range(args.steps):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    loss = float(loss)
    if not (np.isfinite(first) and np.isfinite(loss)):
        raise AssertionError(f"a non-finite loss: {first}, {loss}")
    ms = float(np.median(times))
    rec = {
        "metric": f"acv_sceneflow_train_step_{args.height}x{args.width}_b{args.batch}"
                  + ("_ddp1" if args.ddp else ""),
        "dtype": "float32", "ddp": args.ddp, "batch": args.batch,
        "height": args.height, "width": args.width, "steps": args.steps,
        "step_ms_median": ms, "step_ms_p10": float(np.percentile(times, 10)),
        "step_ms_p90": float(np.percentile(times, 90)), "step_ms": times,
        "pairs_per_s": args.batch / ms * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "first_loss": first,
        "last_loss": loss, "warmup_s": warmup_s,
        "device": torch.cuda.get_device_name(0), "card": card_line(),
    }
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
        prof_rec = device_time_by_group(prof, PROFILE_STEPS)
        prof_rec["kernels_ms"] = dict(list(prof_rec["kernels_ms"].items())[:15])
        prof_rec["idle_share"] = 1.0 - prof_rec["device_ms"] / ms
        rec["profile"] = prof_rec
        print(f"{rec['card']}: training step{' through parallel/ddp.py' if args.ddp else ''} "
              f"{ms:.2f} ms (median), device busy "
              f"{prof_rec['device_ms']:.2f} ms a step, idle share {prof_rec['idle_share']:.3f}")
        for g, t in prof_rec["groups_ms"].items():
            print(f"  {t:10.3f} ms  {t / prof_rec['device_ms']:6.1%}  {g}")
        print("top kernels:")
        for name, t in prof_rec["kernels_ms"].items():
            print(f"  {t:10.3f} ms  {name[:110]}")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
