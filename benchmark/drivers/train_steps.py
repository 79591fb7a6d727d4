"""The training step, steps back to back.

Set-up (counted in ``setup_s``): the DDIM model's initial weights from the
seed on the card; a pool of ``pool_batches`` distinct batches (images,
ground truth uniform in ``gt_range`` px) each with its timestep and noise;
the program's training state (model, Adam, the recipe's rate); then its
first ``check_steps`` steps through the window's own call on the pool's
first batches (which warm every shape), keeping their losses, the first
gradient as Adam's first moment holds it, and the parameters after them.
Window: the same object steps through the pool in turn, each step ended
by a synchronise, until ``seconds`` have passed; the last step counts
whole.  After the window: the peak memory, the program freed, then the
reference follows the first steps from the same weights and draws.  With
``trace``, the window's first ``trace_units`` steps run under the
profiler.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, program, tracing, weights
from benchmark.drivers.eval_closed_loop import free, sync
from benchmark.reference import train as ref_train

ADAM_BETA1 = 0.9


def inputs(cell: dict, g: torch.Generator, dev):
    """The pool: ``[((left, right, gt), t, noise)]``."""
    t, cfg = cell["traffic"], cell["cfg"]
    b, h, w = t["batch"], t["height"], t["width"]
    lo, hi = t["gt_range"]
    pool = []
    for _ in range(t["pool_batches"]):
        left, right = weights.image_pairs(b, h, w, t["image_std"], t["shift_px"], g, dev)
        gt = torch.rand((b, h, w), generator=g, device=dev) * (hi - lo) + lo
        step_t = torch.randint(0, 1000, (1,), generator=g, device=dev).expand(b)
        noise = torch.randn((b, cfg["model"]["max_disp"] // 4, h // 4, w // 4), generator=g,
                            device=dev)
        pool.append(((left, right, gt), step_t, noise))
    return pool


def first_steps(trainer, pool, n: int) -> dict:
    """The program's first ``n`` steps on ``pool[:n]``: losses, the first
    step's last head, the first gradient (Adam's first moment after one
    step, over 1 − β1) and the parameters after the ``n``."""
    losses, grads, pred = [], None, None
    for k in range(n):
        out = trainer.step(*pool[k])
        losses.append(out["loss"])
        if k == 0:
            pred = out["pred"].float().clone()
            grads = {name: m / (1 - ADAM_BETA1) for name, m in trainer.first_moments().items()}
    params = {name: p.clone() for name, p in trainer.params().items()}
    return {"losses": [float(x) for x in losses], "pred": pred, "grads": grads,
            "params": params}


def reference_steps(fam, cfg, state0, pool, n: int, dev) -> dict:
    """The reference's first ``n`` steps from ``state0``, float32, TF32 off."""
    with torch.device(dev):
        net = fam.reference(cfg, diffusion=True)
    net.load_state_dict(state0)
    opt = ref_train.make_adam(net, cfg["train"]["lr"])
    weights_ = tuple(cfg["train"]["loss_weights"])
    losses, grads, pred = [], None, None
    with weights.exact_float32():
        for k in range(n):
            loss, head = ref_train.step(net, opt, *pool[k], weights_)
            losses.append(float(loss))
            if k == 0:
                pred = head
                grads = {name: p.grad.detach().clone() for name, p in net.named_parameters()}
    return {"losses": losses, "pred": pred, "grads": grads,
            "params": {name: p.detach() for name, p in net.named_parameters()}}


def _median(values):
    s = sorted(values)
    return s[len(s) // 2]


def gaps(prog: dict, ref: dict, state0: dict) -> tuple[dict, dict]:
    """The compared numbers (shares), and the step or leaf each is read at.
    Per leaf, the gap between the program's and the reference's norms of
    the first gradient and of the parameters' change over the first steps,
    each over the reference's norm of that leaf or of the median leaf,
    whichever is larger; leaves whose reference gradient is under a
    thousandth of the median leaf's move under Adam by rounding alone and
    are left out of the change.  Read: the worst leaf's and the median
    leaf's gap (``*_median``), the loss's gap at each step (the worst, and
    the first step's before any update), and the first step's last head's
    mean gap in px (``pred_gap_first``; infinite where the shapes differ)."""
    loss = {f"step {k + 1}": abs(p - r) / abs(r)
            for k, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    g_ref = {k: float(v.norm()) for k, v in ref["grads"].items()}
    g_prog = {k: float(prog["grads"][k].norm()) for k in g_ref}
    g_med = _median(g_ref.values())
    d_ref = {k: float((ref["params"][k] - state0[k]).norm()) for k in g_ref}
    d_prog = {k: float((prog["params"][k] - state0[k]).norm()) for k in g_ref}
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    d_med = _median([d_ref[k] for k in moved])
    grad = {k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref}
    change = {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], d_med) for k in moved}
    same = prog["pred"].shape == ref["pred"].shape
    numbers = {"loss_gap_first": loss["step 1"],
               "pred_gap_first": float((prog["pred"] - ref["pred"]).abs().mean()) if same
               else float("inf")}
    where = {}
    for name, per in (("loss_gap", loss), ("grad_gap", grad), ("change_gap", change)):
        where[name] = max(per, key=per.get)
        numbers[name] = per[where[name]]
        if name != "loss_gap":
            numbers[f"{name}_median"] = _median(per.values())
    return numbers, where


def run(cell: dict, seed: int, seconds: float, trace_path, dev) -> dict:
    t, cfg = cell["traffic"], cell["cfg"]
    fam = harness.family(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    state0 = weights.train_state(fam, cfg, g, dev)
    pool = inputs(cell, g, dev)
    trainer = program.Trainer(fam, cfg, state0, dev)
    n = t["check_steps"]
    prog = first_steps(trainer, pool, n)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_end = time.time()

    steps = [0]

    def step():
        trainer.step(*pool[(n + steps[0]) % len(pool)])
        sync(dev)
        steps[0] += 1

    start = time.perf_counter()
    sl = None
    if trace_path is not None:
        with tracing.Slice(trace_path) as sl:
            for _ in range(t["trace_units"]):
                step()
    while time.perf_counter() - start < seconds or not steps[0]:
        step()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del trainer
    free()
    ref = reference_steps(fam, cfg, state0, pool, n, dev)
    return {
        "setup_end": setup_end,
        "e2e": {"train_step_ms": window_s / steps[0] * 1e3},
        "attempted": steps[0], "failed": 0, "memory_peak_bytes": peak,
        **dict(zip(("checks", "notes"), gaps(prog, ref, state0))), "slice": sl,
        "units": {"steps": t["trace_units"], "calls": t["trace_units"]},
        "count": lambda: _count(fam, cell),
    }


def _count(fam, cell):
    """The reference step's forward and backward at the cell's shapes (meta)."""
    from benchmark import counting

    t, cfg = cell["traffic"], cell["cfg"]
    b, h, w = t["batch"], t["height"], t["width"]
    with torch.device("meta"):
        net = fam.reference(cfg, diffusion=True).train()
        batch = (torch.empty(b, h, w, 3), torch.empty(b, h, w, 3), torch.empty(b, h, w))
        step_t = torch.zeros(b, dtype=torch.long)
        noise = torch.empty(b, cfg["model"]["max_disp"] // 4, h // 4, w // 4)

    def fwd_bwd():
        loss, _ = ref_train.loss_of(net, batch, step_t, noise, tuple(cfg["train"]["loss_weights"]))
        loss.backward()

    return counting.count(fwd_bwd, 4)
