"""Data-parallel scaling efficiency: training pairs/s at 1 and at N ranks.

The port's counterpart of ``diffuvolume_tpu/tools/scaling_bench.py``: the
ACV DDIM training step (``make_train_step``, Adam) through
``parallel/ddp.py`` on a group of one rank, then on a group of ``N``, each
rank holding ``--per_device_batch`` rows of the global batch; the
efficiency is ``tput_N / (N · tput_1)``:

    python -m diffuvolume_tpu_torch.tools.scaling_bench [--devices N] [--hw 64 128]
        [--per_device_batch 1] [--maxdisp 64] [--iters 5] [--device cpu]

The ranks are spawned processes (one a card, NCCL, rank ``r`` on
``cuda:r``; ``--device cpu``: gloo on the CPU, one thread a rank), joined
within ``TIMEOUT_S``.  ``--devices`` defaults to every card; more than the
machine has raises.  The model is ``acvnet_ddim`` with the JAX package's
initialisation from seed 0, float32; the batch (images of std 0.3, the
right shifted 3 px, ground truth uniform in [1, maxdisp) px) from seed 1,
the step's draws from seed 2.  One warm-up step, then ``--iters`` steps,
each ended by a synchronise and a barrier; throughput is the global batch
over the mean step.  Prints one JSON line, the JAX tool's fields
(``metric``, ``devices``, ``tput_1``, ``tput_N``, ``value``, ``unit``)
with the device's name and the card's power limit (``nvidia-smi``; null on
the CPU, where the numbers are the host's, not a card's).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

import torch

TIMEOUT_S = 1800


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=0, help="ranks of the N run; 0: every card")
    p.add_argument("--hw", type=int, nargs=2, default=(64, 128))
    p.add_argument("--per_device_batch", type=int, default=1)
    p.add_argument("--maxdisp", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default=None, help="cuda (default) or cpu (gloo ranks)")
    return p.parse_args(argv)


def rank_main(rank: int, world: int, port: int, args, out: str) -> None:
    """One rank: the step on its rows, timed; rank 0 writes pairs/s."""
    from diffuvolume_tpu_torch.models import build_model
    from diffuvolume_tpu_torch.parallel import ddp
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    cpu = args.device == "cpu"
    if cpu:
        torch.set_num_threads(1)
    dev = torch.device("cpu" if cpu else f"cuda:{rank}")
    dp = ddp.init(rank, world, dev, f"tcp://localhost:{port}")
    try:
        model = build_model("acvnet_ddim", max_disp=args.maxdisp)
        model.init_weights(torch.Generator().manual_seed(0))
        model = ddp.sync_batch_norm(model.to(dev).train(), dp)
        dp.broadcast_parameters(model)
        state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
        g = torch.Generator().manual_seed(1)
        b, (h, w) = args.per_device_batch * world, args.hw
        left = torch.randn((b, h, w, 3), generator=g) * 0.3
        batch = dp.shard({"left": left, "right": torch.roll(left, -3, dims=2),
                          "disp_gt": torch.rand((b, h, w), generator=g) * (args.maxdisp - 1)
                          + 1.0})
        batch = {k: v.to(dev) for k, v in batch.items()}
        step = make_train_step(model, dp=dp)
        draws = torch.Generator(device=dev).manual_seed(2)

        def one():
            loss = step(state, batch, draws)["loss"]
            if not cpu:
                torch.cuda.synchronize(dev)
            dp.barrier()
            return loss

        one()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            loss = one()
        dt = (time.perf_counter() - t0) / args.iters
        if not torch.isfinite(loss):
            raise AssertionError(f"a non-finite loss: {float(loss)}")
        if dp.is_main:
            torch.save({"pairs_per_s": b / dt, "step_s": dt}, out)
    finally:
        ddp.shutdown()


def throughput(world: int, args, tmp: str) -> dict:
    """Pairs/s of the step on ``world`` spawned ranks."""
    from diffuvolume_tpu_torch.parallel.ddp import free_port

    out, port = os.path.join(tmp, f"world{world}.pt"), free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode for p in procs):
        raise RuntimeError(f"the {world}-rank run failed: exit codes "
                           f"{[p.exitcode for p in procs]}")
    return torch.load(out)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("scaling_bench: no CUDA device (pass --device cpu for gloo ranks on the CPU)",
              file=sys.stderr)
        raise SystemExit(1)
    cards = 0 if cpu else torch.cuda.device_count()
    n = args.devices or cards
    if n < 1:
        raise ValueError("--devices: give the ranks of the N run (--device cpu has no cards "
                         "to count)")
    if not cpu and n > cards:
        raise ValueError(f"--devices {n}: this machine has {cards} cards")
    with tempfile.TemporaryDirectory() as tmp:
        one, many = throughput(1, args, tmp), throughput(n, args, tmp)
    if cpu:
        device, card = "cpu", None
    else:
        from diffuvolume_tpu_torch.tools.bench import card_line

        device, card = torch.cuda.get_device_name(0), card_line()
    rec = {"metric": "dp_scaling_efficiency", "devices": n, "tput_1": one["pairs_per_s"],
           "tput_N": many["pairs_per_s"],
           "value": many["pairs_per_s"] / (n * one["pairs_per_s"]), "unit": "fraction",
           "step_ms_1": one["step_s"] * 1e3, "step_ms_N": many["step_s"] * 1e3,
           "hw": list(args.hw), "per_device_batch": args.per_device_batch,
           "maxdisp": args.maxdisp, "iters": args.iters, "backend": "gloo" if cpu else "nccl",
           "device": device, "card": card}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
