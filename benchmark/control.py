"""The readings that the comparison's limits are set from, on the card.

    python3 benchmark/control.py --workload <name> [--seeds 12] [--control-seeds 3]
        [--seconds 3] [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds, a sound run of the cell's timed path at the
cell's own size and load (its driver, a ``--seconds`` window) and its
compared numbers; for each of ``--control-seeds`` further seeds, the same
numbers of the control:

* evaluation: the reference computed in float8 (``reference/precision.py``)
  put in the program's place, on the batches a run would check;
* training: the program's own bfloat16 path (``make_train_step(bf16=True)``),
  and the fault of half the batch left out (the step's loss the mean over
  the other half).

A state left unchanged reads 1 on ``change_gap`` by definition and is not
run.  One JSON line per reading (stdout, and ``--out``).  Every process and
model is this one's; the harness's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def eval_readings(cell, seed, seconds, dev, control: bool) -> dict:
    from benchmark.drivers import eval_closed_loop as ev

    fam, states, pool, models, ddim_cfg, call = ev.setup(cell, seed, dev)
    for _ in range(cell["traffic"]["warmup_calls"]):
        call(models, ddim_cfg, *pool[0], dev)
    lat, kept, _, _ = ev.window(cell, seed, seconds, pool, models, ddim_cfg, call, dev)
    del models
    ev.free()
    if control:
        lower = cell["cfg"]["eval"]["control"]
        kept = {i: ev.reference_outputs(fam, cell["cfg"], states, pool[i % len(pool)], dev, lower)
                for i in kept}
    return ev.compare(fam, cell["cfg"], states, pool, kept, dev)


class HalfBatch:
    """The fault: the program's step sees the first half of each batch."""

    def __init__(self, trainer):
        self.trainer = trainer

    def step(self, batch, t, noise):
        h = t.shape[0] // 2
        return self.trainer.step(tuple(x[:h] for x in batch), t[:h], noise[:h])

    def __getattr__(self, name):
        return getattr(self.trainer, name)


def train_readings(cell, seed, dev, kind: str) -> dict:
    import torch

    from benchmark import harness, program, weights
    from benchmark.drivers import train_steps as ts

    cfg, n = cell["cfg"], cell["traffic"]["check_steps"]
    fam = harness.family(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    state0 = weights.train_state(fam, cfg, g, dev)
    pool = ts.inputs(cell, g, dev)
    trainer = program.Trainer(fam, cfg, state0, dev, bf16=kind == "bf16")
    prog = ts.first_steps(HalfBatch(trainer) if kind == "half_batch" else trainer, pool, n)
    del trainer
    ts.free()
    numbers, where = ts.gaps(prog, ts.reference_steps(fam, cfg, state0, pool, n, dev), state0)
    return {**numbers, "at": where}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2**31 + 101)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = harness.cell(harness.load_spec(), args.workload)
    train = cell["traffic"]["phase"] == "train"
    plan = [("program", args.first_seed + 7919 * k) for k in range(args.seeds)]
    kinds = ("bf16", "half_batch") if train else ("control",)
    plan += [(kind, args.first_seed + 7919 * (args.seeds + k))
             for k in range(args.control_seeds) for kind in kinds]
    out = open(args.out, "a") if args.out else None
    for kind, seed in plan:
        t0 = time.perf_counter()
        if train:
            r = train_readings(cell, seed, dev, kind)
        else:
            r = eval_readings(cell, seed, args.seconds, dev, kind == "control")
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **r,
                           "s": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
