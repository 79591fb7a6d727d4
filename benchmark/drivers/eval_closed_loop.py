"""Two-pass DDIM evaluation, one client in a closed loop.

Set-up (counted in ``setup_s``): the weights from the seed on the card,
calibrated on the reference; a pool of ``pool_batches`` distinct batches of
image pairs with their DDIM draws; the program's two models folded; the
entry called ``warmup_calls`` times on the pool's first batch (the first
call of a checkout builds the kernels).  Window: the client sends the
pool's batches in turn, each call ended by a synchronise, the next sent
when the last completes, until ``seconds`` have passed; the last call
counts whole.  A seeded reservoir keeps ``check_batches`` of the served
batches' outputs.  After the window: the peak memory, the program freed,
then the reference on the kept batches' inputs and the comparison.
With ``trace``, the window's first ``trace_units`` calls run under the
profiler.
"""

from __future__ import annotations

import gc
import random
import statistics
import time

import torch

from benchmark import harness, program, tracing, weights
from benchmark.reference import ddim as ref_ddim
from benchmark.reference.precision import lower_precision


def inputs(cell: dict, g: torch.Generator, dev):
    """The pool: ``[(left, right, draws)]``."""
    t, cfg = cell["traffic"], cell["cfg"]
    b, h, w = t["batch"], t["height"], t["width"]
    shape = (b, cfg["sampler"]["num_bins"], h // 4, w // 4)
    pool = []
    for _ in range(t["pool_batches"]):
        left, right = weights.image_pairs(b, h, w, t["image_std"], t["shift_px"], g, dev,
                                          t.get("image_mean", 0.0))
        pool.append((left, right, weights.sampler_draws(cfg["sampler"], shape, g, dev)))
    return pool


def setup(cell: dict, seed: int, dev):
    """``(family, states, pool, models, ddim_cfg, call)`` from the seed."""
    fam = harness.family(cell["cfg"])
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = inputs(cell, g, dev)
    states = weights.eval_states(fam, cell["cfg"], g, dev, pool[0][0][:1], pool[0][1][:1])
    models = program.eval_models(fam, cell["cfg"], *states, dev)
    return fam, states, pool, models, program.ddim_config(cell["cfg"]), program.eval_entry(fam)


def window(cell, seed, seconds, pool, models, ddim_cfg, call, dev, trace_path=None):
    """The closed loop: ``(latencies s a call, kept {index: outputs},
    traced slice or None, window seconds)``."""
    keep, rng = cell["traffic"]["check_batches"], random.Random(seed)
    kept: dict[int, tuple] = {}
    lat = []

    def serve(i):
        left, right, draws = pool[i % len(pool)]
        t0 = time.perf_counter()
        out = call(models, ddim_cfg, left, right, draws, dev)
        sync(dev)
        lat.append(time.perf_counter() - t0)
        # Reservoir sampling: a uniform sample of the served calls.
        if i < keep:
            kept[i] = out
            return
        j = rng.randrange(i + 1)
        if j < keep:
            del kept[sorted(kept)[j]]
            kept[i] = out

    sync(dev)
    start = time.perf_counter()
    sl = None
    if trace_path is not None:
        with tracing.Slice(trace_path) as sl:
            for i in range(cell["traffic"]["trace_units"]):
                serve(i)
    while time.perf_counter() - start < seconds or not lat:
        serve(len(lat))
    return lat, kept, sl, time.perf_counter() - start


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# The smallest rounding gap a ratio is taken against (px; mean, median):
# below it the network is insensitive to rounding and a ratio would only
# read noise.
GAP_FLOOR_PX = {"mean": 1e-2, "median": 1e-4}


def _gaps(x, r) -> dict:
    """Each pair's mean and median absolute gap (px) between ``x`` and
    ``r`` ``(B, H, W)``; a non-finite value reads infinity."""
    gap = (x.float() - r).abs().flatten(1)
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    return {"mean": gap.mean(1), "median": gap.median(1).values}


def pair_errors(outputs, ref, rounded) -> dict:
    """Each pair's statistics: the mean and median gap (px) of the baseline
    (pass 1) and of the final disparity to the float32 reference, and each
    over the same gap of the reference with its convolutions' and linear
    layers' operands rounded to the served dtype (``*_ratio``)."""
    out = {}
    for i, name in enumerate(("final", "base")):
        prog, floor = _gaps(outputs[i], ref[i]), _gaps(rounded[i], ref[i])
        for stat in ("mean", "median"):
            out[f"{name}_{stat}_px"] = prog[stat]
            out[f"{name}_{stat}_ratio"] = prog[stat] / floor[stat].clamp_min(GAP_FLOOR_PX[stat])
    return out


def reference_outputs(fam, cfg, states, batch, dev, lower=None):
    """The reference's ``(final, baseline)`` for a pool batch, float32 with
    TF32 off (``lower``: operands rounded to that precision)."""
    left, right, draws = batch
    nets = []
    for diffusion, state in ((False, states[0]), (True, states[1])):
        with torch.device(dev):
            net = fam.reference(cfg, diffusion)
        net.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in state.items()})
        net.eval()
        if lower:
            lower_precision(net, lower)
        nets.append(net)
    with weights.exact_float32():
        final, base, _ = ref_ddim.two_pass(*nets, dict(cfg["sampler"]), left, right, draws)
    return final, base


def compare(fam, cfg, states, pool, kept, dev) -> dict:
    """The worst kept pair's statistics: ``{name: value}``."""
    refs = {}
    worst: dict[str, float] = {}
    for i, outputs in sorted(kept.items()):
        k = i % len(pool)
        if k not in refs:
            refs[k] = [reference_outputs(fam, cfg, states, pool[k], dev, lower)
                       for lower in (None, cfg["eval"]["dtype"])]
        for name, v in pair_errors(outputs, *refs[k]).items():
            worst[name] = max(worst.get(name, 0.0), float(v.max()))
    return worst


def free():
    """Return what the dropped objects held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, trace_path, dev) -> dict:
    fam, states, pool, models, ddim_cfg, call = setup(cell, seed, dev)
    for _ in range(cell["traffic"]["warmup_calls"]):
        call(models, ddim_cfg, *pool[0], dev)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_end = time.time()
    lat, kept, sl, window_s = window(cell, seed, seconds, pool, models, ddim_cfg, call, dev,
                                     trace_path)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    b = cell["traffic"]["batch"]
    del models
    free()
    worst = compare(fam, cell["cfg"], states, pool, kept, dev)
    pairs = [x for x in lat for _ in range(b)]
    return {
        "setup_end": setup_end,
        "e2e": {"pairs_per_s": len(pairs) / window_s,
                "pair_ms_p95": harness.nearest_rank(pairs, 0.95) * 1e3},
        "attempted": len(pairs), "failed": 0, "memory_peak_bytes": peak,
        "checks": worst, "slice": sl,
        "notes": {"call_ms_median_first_half": 1e3 * statistics.median(lat[:len(lat) // 2 or 1]),
                  "call_ms_median_second_half": 1e3 * statistics.median(lat[len(lat) // 2:])},
        "units": {"pairs": cell["traffic"]["trace_units"] * b,
                  "calls": cell["traffic"]["trace_units"]},
        "count": lambda: _count(fam, cell),
    }


def _count(fam, cell):
    """The reference's work for one call at the cell's shapes (meta)."""
    from benchmark import counting

    t, cfg = cell["traffic"], cell["cfg"]
    b, h, w = t["batch"], t["height"], t["width"]
    meta = torch.device("meta")
    with meta:
        nets = [fam.reference(cfg, d).eval() for d in (False, True)]
        left = torch.empty(b, h, w, 3)
    draws = weights.sampler_draws(cfg["sampler"], (b, cfg["sampler"]["num_bins"], h // 4, w // 4),
                                  None, meta)
    itemsize = torch.empty((), dtype=getattr(torch, cfg["eval"]["dtype"])).element_size()
    return counting.count(lambda: ref_ddim.two_pass(*nets, dict(cfg["sampler"]), left, left,
                                                   draws), itemsize)
