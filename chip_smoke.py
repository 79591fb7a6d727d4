"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any fault exits non-zero; nothing runs without a CUDA device):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from ``diffuvolume_tpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at every
     shape the paths (ACV, PCW, IGEV; the flat refinement's 2-D convs, row
     18, its 1×1 downsamples, row 9, and its input's pack, row 11; the
     routed module paths' 3-D convs, row 15) give it, in float32 (TF32 off)
     and bfloat16: max-abs error against the stated tolerance, the kernel's
     time on the card (torch.profiler's device time, CUDA events and the
     host's time to issue a call beside it; the plain versions under CUDA
     events), the device time of one PyTorch call computing the same
     function where there is one, and the bound (bytes or operations over
     the H100's peak rates); rows 2-4 (row 2 at the ACV and IGEV module
     paths' shapes with its plan, row 3 in both forms with its
     channels-last plan) and rows 11-13 (with rows 11-12's transpose plan)
     at every path's shape; rows 1 and 17 at the ACV and PCW shapes, both
     align-corners conventions, row 16 at every path's shape (ACV, PCW 1/4
     … 1/32, IGEV, and gwcnet-g's 40 groups alone in a 48 slot at PCW's
     four scales) and row 10 (each stencil, and the fused pair the ACV
     attention chain runs, asserted equal to two single launches), timed
     on the card (torch.profiler's device time, as the convs); the convs (rows 5-9, 14, 15 with the epilogue
     — none, ReLU, Mish, LeakyReLU, × post_mul — each path gives each shape;
     row 18 at the refinement's 11 convs, bare and with a residual and
     Mish; row 9 at its three downsamples; gwcnet-g's volume convs at C_in
     48, rows 5 and 6) timed on the card (torch.profiler's
     device time; CUDA events and the host's time to issue a call beside
     it; row 9 beside ``F.linear`` on the (positions, C_in) view and
     ``F.conv3d``), and their total over one pair's launches, by row; for every
     3×3×3 and 2-D conv shape also the tile plan (tile, blocks, K splits,
     blocks an SM, shared memory, tensor-core form, kh taps a stage) and,
     where the plan has a wgmma form (32 to 128 output channels a tile),
     the wgmma and the mma.sync form each checked and timed (the previous
     commit's times come from ``tools/conv_device_times.py --root`` in the
     same call);
  4. agreement on a small input: each whole two-pass pipeline (ACV, PCW,
     IGEV) on the card against the same pipeline on the CPU (plain
     versions), float32, same seeded weights and injected draws, on the
     folded path and on the module path, PCW's folded path with the flat
     refinement forced (``fold_pcw(..., refine_flat=True)``; a float32
     model keeps the module refinement by default) and the three module
     paths with their 3-D convs routed (``route_conv3d``); gwcnet-g (PCWNet
     without the concat volume) with its DDIM model as PCW, folded, module
     and routed (its row-15 launches a pair asserted); then IGEV's folded
     path at 64×192 with 32 GRU iterations a rollout, every disparity of
     both runs inside the band lookup's exact domain (asserted); a sampler
     decision that flipped at its threshold is told apart from a fault
     (``agree``).  The pipelines set their own float32 precision (no TF32);
     the global TF32 switch is off in phase 3 only;
  5. the ACV main path: two-pass DDIM-5 at 512×960, batch 1, bfloat16 model,
     folded path (``packed=True``), weights and images from a fixed seed;
     one warm-up pair, 20 timed pairs (pairs/s with median and spread),
     per-pair kernel launch counts (asserted), an op census of one pair (no
     3-D BatchNorm, no 3-D conv), output finite in [0, 191];
  6. the ACV module path (``packed=False``) the same way, 1 timed pair, and
     after ``route_conv3d`` (row 15 launches asserted, the census's cuDNN
     3-D convs fewer by exactly as many), 1 timed pair;
  7. the PCW path: PCWNet two-pass KITTI12 DDIM-3 at 384×1248, batch 1,
     bfloat16 model, folded path with the flat refinement (row 18, 44
     launches a pair, row 9's 12 downsamples and row 11's 4 packs,
     asserted); one warm-up
     pair, 6 timed pairs, launch counts (asserted), a census with no 3-D
     BatchNorm and no 3-D conv, a finite (1, 384, 1248) output; then with
     the module refinement (``refine_flat=False``; the census's 2-D
     BatchNorms and cuDNN 2-D convs more by the refinement's, derived from
     the model), 3 timed pairs;
     its module path, 1 timed pair, and routed, 1 timed pair; then gwcnet-g
     and ``pcwnet_ddim(use_concat_volume=False)`` the same way, folded (3
     timed pairs) and module (1), launches asserted from
     ``pcw_expected_launches(..., concat=False)``; its folded pair against
     its module pair in float32 at 384×1248 (the same models, images and
     injected draws) by phase 4's bounds and flip rule
     (``fold_vs_module``); the bfloat16 warm-up pairs' folded-against-module
     gap recorded for gwcnet-g and PCW (``bf16_path_gap``);
  8. the IGEV path: IGEV-Stereo two-pass KITTI15 DDIM-2 at 384×1248, 32 GRU
     iterations a rollout, batch 1, bfloat16 model, folded path; one warm-up
     pair, 3 timed pairs, launch counts (asserted), the same census, a finite
     (1, 384, 1248) output; then its module path, 1 timed pair, and
     routed, 1 timed pair;
  9. the evaluation entry point: ``cli/evaluate`` on the card over a
     synthetic SceneFlow-layout set written to a temporary directory (3
     pairs at 540×960 with PFM ground truth, cropped to 512×960 by
     ``TEST_CROP``), random weights, ACV DDIM-5, float32, folded: launch
     counts per pair (asserted, as phase 5's), finite ``FINAL:`` metrics,
     ``metrics_batch`` on the card within 1e-5 of the same metrics on the
     CPU from the same disparities, the CLI's pairs/s; then
     ``tools/bench.py --model acv --reps 3`` in a subprocess, its JSON line
     parsed;
 10. training: every wrapper refuses a CUDA input that requires grad in
     grad mode (the kernels have no backward); one ACV SceneFlow train
     step on the card against the CPU at B=2, 32×64, max_disp 64 (tamed
     seeded weights, injected draws), float32 without TF32 and float64:
     the loss, every gradient, the BatchNorm statistics and the parameters
     after Adam within the stated tolerances, the CPU step taking the
     card's branch at a ReLU input within rounding of zero (each such flip
     listed); then ``cli/train.py``: the
     ACV SceneFlow recipe (``acvnet_ddim``, stage ``full``) over a
     synthetic SceneFlow set of 540×960 pairs, the random 256×512 crop,
     batch 4, float32, 8 steps (each loss finite, step times, training
     pairs/s, peak memory; every parameter with a finite non-zero gradient;
     parameters and BatchNorm statistics moved), its epoch evaluation
     (ACV DDIM-5 on the kernels, one pair, launch counts asserted as
     phase 5's, none in the steps) and its checkpoint loaded and evaluated
     by ``cli/evaluate``; the KITTI12 recipe (PCWNet, 256×512) and the
     KITTI15 recipe (IGEV-Stereo, 320×736, ``--bf16``, 22 GRU iterations,
     ``--init_from`` a calibrated random IGEV), batch 1, 3 steps each over
     a synthetic KITTI set, and the KITTI12 recipe with ``--model
     gwcnet-g``, 2 steps;
 11. IGEV's reference-faithful evaluation, data parallelism and the
     training step's profile: (a) ``igev_ddim_inference(quirk=True)`` on
     the folded path at 384×1248, 32 GRU iterations a rollout, bfloat16,
     one warm-up pair and 3 timed pairs (pairs/s, prep ms, ms a DDIM step,
     peak memory), its launches a pair asserted equal to phase 8's folded
     path's, a finite output; (b) the quirk path on the card against the
     CPU, float32, 64×192, 32 GRU iterations, under phase 4's flip rule;
     (c) one ACV train step through ``parallel/ddp.py`` at world size 1
     over NCCL against the plain step on the card (float64, and float32
     without TF32, phase 10 (b)'s shapes and tolerances; the float32
     gradients recorded; every BatchNorm of the step through
     ``_GlobalBatchNorm`` in float32 against float64; the collectives
     counted); (d) ``tools/bench_train.py --profile``: the ACV SceneFlow
     step at 256×512, batch 4, float32, by kernel group, plain and through
     ``parallel/ddp.py`` at world size 1 (``--ddp``);
 12. the cost volume's rows split over 2 processes on cuda:0 over gloo
     (``parallel/volume_sharding.py``; NCCL takes one rank a device), against
     the unsplit runs on the card: (a) the module path forwards, seeded
     weights, float32 (held to the float32 floor measured in the run) and
     bfloat16 (phase 4's flip rule), each rank's launches equal to the
     unsplit forward's, the backend and the staging printed: ACV routed at
     512×960 (rows 2, 3, 15 and 1), PCW routed at 384×1248 (rows 16, 15 and
     1; 48 of the 96 rows at H/4 a rank), IGEV at 384×1248 with 32 GRU
     iterations (rows 2 and 14); (b) the ACV SceneFlow step on a 1 × 2 grid
     in float64 at 32×64 against one process (phase 11 (c)'s tolerances),
     and the float32 step at 256×512, batch 4, timed (median, p10, p90, peak
     memory a process) beside the plain step: a one-card figure over gloo,
     not a scaling one; the PCW KITTI12 and IGEV KITTI15 steps (3 GRU
     iterations) in float64 at 64×64 on the same grid, the same
     tolerances, and gwcnet-g's KITTI12 step beside PCW's; (c) IGEV's step at
     160×64 with uneven bands (40 rows at H/4 cut 24 / 16);
 13. one ``kernels`` JSON line, the card line, and the result line.
Each path's launch counts are set to 0 just before it is driven and read
just after.  Everything printed is also written to
``chiprun_out/chip_smoke.json``.  Run from a directory without the
``diffuvolume_tpu_torch`` package beside it, the script says so on stderr and
exits 1 before it prints anything.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor)
# FLOP/s, bf16 dense tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

MAIN_H, MAIN_W, MAIN_DISP = 512, 960, 192
D4, H4, W4 = MAIN_DISP // 4, MAIN_H // 4, MAIN_W // 4
FEAT_C, GROUPS, CAT_C = 320, 40, 32
STEPS = 5
TIMED_PAIRS = 20
MODULE_TIMED_PAIRS = 1
FULL, HALF, QUARTER = (D4, H4, W4), (D4 // 2, H4 // 2, W4 // 2), (D4 // 4, H4 // 4, W4 // 4)
ATT_SLOT = 48

# The PCW path: PCWNet, KITTI 2012 at the size the reference pads KITTI to.
PCW_H, PCW_W = 384, 1248
PCW_D4, PCW_H4, PCW_W4 = MAIN_DISP // 4, PCW_H // 4, PCW_W // 4
PCW_CC, PCW_SLOT, PCW_STEPS = 12, 64, 3
PCW_TIMED_PAIRS = 6
PCW_MODULE_REFINE_TIMED_PAIRS = 3
PCW_MODULE_TIMED_PAIRS = 1
P1, P2, P3, P4 = ((PCW_D4 >> k, PCW_H4 >> k, PCW_W4 >> k) for k in range(4))
# The PCW volumes: (scale, D, H, W), each 40 groups + 12 + 12 in a 64 slot;
# gwcnet-g's (PCWNet without the concat volume) the 40 groups in a 48 slot.
PCW_VOLUMES = [(f"1/{4 << k}", *dhw) for k, dhw in enumerate((P1, P2, P3, P4))]
PCWG_SLOT = 48
PCWG_TIMED_PAIRS = 3
PCWG_MODULE_TIMED_PAIRS = 1

# The IGEV path: IGEV-Stereo, KITTI 2015 at 384×1248 (tools/bench_igev.py of
# the JAX package); the GEV tower's levels 1/4 … 1/32.
IGEV_H, IGEV_W, IGEV_STEPS, IGEV_ITERS = 384, 1248, 2, 32
IGEV_C, IGEV_GROUPS, IGEV_SLOT = 96, 8, 16
G1, G2, G3, G4 = ((D4 >> k, (IGEV_H // 4) >> k, (IGEV_W // 4) >> k) for k in range(4))
IGEV_TIMED_PAIRS = 3
IGEV_MODULE_TIMED_PAIRS = 1
# The module paths after route_conv3d (row 15).
ROUTED_TIMED_PAIRS = {"acv": 1, "pcw": 1, "igev": 1}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int, warmup: int = 2) -> dict:
    """``fn``'s cost a call over ``iters`` back-to-back calls: ``ms``, the
    card's time in the kernels it launches (torch.profiler, every kernel of
    the call summed, no gaps between calls; a session that recorded no
    kernel, or whose kernel counts are not a multiple of ``iters`` (it
    dropped some), is taken again, up to eight sessions, then the largest
    reading stands); ``events_ms``, CUDA
    events around the calls, which reads the host where a call costs the
    host more than the card; ``host_us``, the host's time to issue a call
    (the calls' wall clock before the synchronisation that ends them; the
    least of three runs, as other processes share the host's cores)."""
    from torch.profiler import ProfilerActivity, profile

    events_ms = time_ms(fn, iters, warmup)
    host_us = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us = min(host_us, (time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    readings = []
    for _ in range(8):  # a profiler session now and then drops kernels, or all of them
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
        device_us = sum(e.device_time_total for e in kernels) / iters
        if kernels and all(e.count % iters == 0 for e in kernels):
            return dict(ms=device_us / 1e3, events_ms=events_ms, host_us=host_us)
        readings.append(device_us)
    if max(readings) > 0.0:
        return dict(ms=max(readings) / 1e3, events_ms=events_ms, host_us=host_us)
    raise AssertionError("torch.profiler saw no device time in 8 sessions")


def on_card(t: dict) -> str:
    """A ``device_times`` reading as phase 3 prints it."""
    return (f"{t['ms']:.4f} ms device (events {t['events_ms']:.4f}, host "
            f"{t['host_us']:.0f} µs)")


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, atol, rtol):
    """Elementwise |got - want| ≤ atol + rtol·|want|; returns max-abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.all(err <= atol + rtol * want.abs()))
    max_err = float(err.max())
    log(f"  {name}: max_abs_err {max_err:.3e} (tol {atol:g} + {rtol:g}·|ref|) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


def kernel_checks(dev) -> dict:
    """Phase 3: each kernel at the main path's shapes, float32 and bfloat16."""
    from diffuvolume_tpu_torch.ops import cost_volume as plain
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(dev)

    bf16_ulp = 2.0 ** -7  # one bfloat16 ulp, relative, at worst
    out = {}

    # -- gwc volume: (1, 320, 128, 240) ×2 → (1, 40, 48, 128, 240)
    log("gwc_volume  features 2×(1,320,128,240) → (1,40,48,128,240)")
    l32, r32 = randn(1, FEAT_C, H4, W4), randn(1, FEAT_C, H4, W4)
    errs = {}
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, bf16_ulp)):
        l, r = l32.to(dt), r32.to(dt)
        got = kg.gwc_volume(l, r, D4, GROUPS)
        want = plain.build_gwc_volume(l, r, D4, GROUPS)
        torch.cuda.synchronize()
        tag = str(dt).split(".")[1]
        errs[tag] = check(f"{tag} volume", got, want, 1e-6, rtol)
        del got, want
    lb, rb = l32.bfloat16(), r32.bfloat16()
    t = device_times(lambda: kg.gwc_volume(lb, rb, D4, GROUPS), 20)
    plain_ms = time_ms(lambda: plain.build_gwc_volume(lb, rb, D4, GROUPS), 3)
    cpg = FEAT_C // GROUPS
    pairs_dw = sum(max(W4 - d, 0) for d in range(D4))
    nbytes = 2 * lb.numel() * 2 + GROUPS * D4 * H4 * W4 * 2
    ops = GROUPS * H4 * pairs_dw * 2 * cpg
    plan = kg.gwc_plan(1, FEAT_C, H4, W4, GROUPS, D4, torch.bfloat16, dev)
    b_ms, by = bound(nbytes, ops)
    log(f"  bf16 {on_card(t)} (plain {plain_ms:.4f}, bound {b_ms:.4f} ms by {by})"
        f"{gwc_plan_line(plan)}")
    out["gwc_volume"] = dict(errs=errs, **t, plain_ms=plain_ms, bound=(b_ms, by),
                             library_ms=None, dtype="bfloat16", plan=plan)

    # -- concat volume: (1, 32, 128, 240) ×2 (+ att) → (1, 64, 48, 128, 240)
    log("concat_volume  features 2×(1,32,128,240), att (1,48,128,240) → (1,64,48,128,240)")
    cl32, cr32 = randn(1, CAT_C, H4, W4), randn(1, CAT_C, H4, W4)
    att32 = torch.softmax(randn(1, D4, H4, W4), dim=1)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        cl, cr, att = cl32.to(dt), cr32.to(dt), att32.to(dt)
        tag = str(dt).split(".")[1]
        e = 0.0
        for a in (att, None):
            got = kc.concat_volume(cl, cr, D4, a)
            want = plain.concat_volume_mul(cl, cr, D4, a)
            torch.cuda.synchronize()
            e = max(e, check(f"{tag} volume, att={'yes' if a is not None else 'none'}",
                             got, want, 0.0, 0.0))
            del got, want
        errs[tag] = e
    clb, crb, attb = cl32.bfloat16(), cr32.bfloat16(), att32.bfloat16()
    t = device_times(lambda: kc.concat_volume(clb, crb, D4, attb), 20)
    plain_ms = time_ms(lambda: plain.concat_volume_mul(clb, crb, D4, attb), 3)
    vol_elems = 2 * CAT_C * D4 * H4 * W4
    nbytes = 2 * clb.numel() * 2 + attb.numel() * 2 + vol_elems * 2
    # Without att, for the channels-last form's comparison (the DDIM prep's call).
    no_att = device_times(lambda: kc.concat_volume(clb, crb, D4), 20)
    out["concat_volume"] = dict(errs=errs, **t, plain_ms=plain_ms,
                                bound=bound(nbytes, vol_elems), library_ms=None,
                                dtype="bfloat16", without_att=no_att)

    # -- dhw multiply: vol (1, 64, 48, 128, 240) × att ⊙ noise
    log("dhw_mul  vol (1,64,48,128,240) × (att ⊙ noise) (1,48,128,240)")
    errs = {}
    noise32 = rand(1, D4, H4, W4)
    for dt in (torch.float32, torch.bfloat16):
        vol = kc.concat_volume(cl32.to(dt), cr32.to(dt), D4)
        m1, m2 = att32.to(dt), noise32.to(dt)
        got = kc.dhw_mul(vol, m1, m2)
        want = plain.volume_dhw_mul(vol, m1, m2)
        torch.cuda.synchronize()
        tag = str(dt).split(".")[1]
        errs[tag] = check(f"{tag} volume", got, want, 0.0, 0.0)
        del got, want, vol
    volb = kc.concat_volume(clb, crb, D4)
    noiseb = noise32.bfloat16()
    t = device_times(lambda: kc.dhw_mul(volb, attb, noiseb), 20)
    plain_ms = time_ms(lambda: plain.volume_dhw_mul(volb, attb, noiseb), 3)
    # The library: one bfloat16 einsum on the same three inputs (two bf16
    # roundings, so within 2⁻⁶ relative of the kernel's one).  For scale
    # only, bf16 torch.mul with the att ⊙ noise map already formed.
    def library():
        return torch.einsum("bcdhw,bdhw,bdhw->bcdhw", volb, attb, noiseb)
    check("bfloat16 library einsum", library(), kc.dhw_mul(volb, attb, noiseb), 0.0, 2.0 ** -6)
    library_ms = device_times(library, 20)["ms"]
    mapb = attb * noiseb
    mul_ms = device_times(lambda: torch.mul(volb, mapb[:, None]), 20)["ms"]
    nbytes = 2 * volb.numel() * 2 + 2 * attb.numel() * 2
    ops = attb.numel() + volb.numel()
    out["dhw_mul"] = dict(errs=errs, **t, plain_ms=plain_ms, bound=bound(nbytes, ops),
                          library_ms=library_ms, library_mul_ms=mul_ms, dtype="bfloat16")
    del volb, mapb
    for k, v in out.items():
        lib = "" if v["library_ms"] is None else f", library {v['library_ms']:.4f} ms device"
        log(f"  {k}: {on_card(v)} (plain {v['plain_ms']:.4f} ms{lib}, "
            f"bound {v['bound'][0]:.4f} ms by {v['bound'][1]}, {v['dtype']})")
    log(f"  concat_volume without att: {on_card(out['concat_volume']['without_att'])}")
    log(f"  dhw_mul for scale: bf16 torch.mul with the map formed {mul_ms:.4f} ms device")
    return out


def mixed(cases: list[dict], errs: dict, dtype: str = "bfloat16") -> dict:
    """One row's numbers over the main path's mix of shapes: ms, plain ms,
    library ms and bound per launch, each the mean over the row's launches
    in one pair (every shape weighted by its launches per pair)."""
    n = sum(c["per_pair"] for c in cases)

    def mean(key):
        vals = [c[key] for c in cases]
        if any(v is None for v in vals):
            return None
        return sum(v * c["per_pair"] for v, c in zip(vals, cases)) / n

    b_ms = mean("bound_ms")
    by_ops = sum(c["ops_ms"] * c["per_pair"] for c in cases) / n
    return dict(errs=errs, ms=mean("ms"), plain_ms=mean("plain_ms"),
                library_ms=mean("library_ms"),
                bound=(b_ms, "operations" if by_ops >= b_ms - 1e-12 else "bytes"),
                dtype=dtype, shapes=cases)


def gwc_plan_line(plan: dict | None) -> str:
    """Row 2's plan as phase 3 prints it ('' for none)."""
    if plan is None:
        return ""
    form = "16-byte" if plan["vec"] else "element"
    return (f"; tile {plan['tw']} W × {plan['ds']} D an item ({form} form), {plan['items']} "
            f"items on {plan['blocks']} blocks of {plan['threads']} ({plan['blocks_per_sm']} "
            f"an SM), shared memory {plan['smem_bytes']} B")


def concat_plan_line(plan: dict | None) -> str:
    """Row 3's channels-last plan as phase 3 prints it ('' for none)."""
    if plan is None:
        return ""
    return (f"; tile {plan['tw']} W × {plan['ds']} D, {plan['items']} items on "
            f"{plan['blocks']} blocks of {plan['threads']} ({plan['blocks_per_sm']} an SM)")


def volume_cl_checks(dev) -> dict:
    """Phase 3, rows 3-4 in their channels-last forms (the folded path's):
    each exact against its plain version in float32 and bf16; bf16 timed on
    the card (``device_times``), row 3 with and without att and its plan, row
    4 beside its one-call library einsum."""
    from diffuvolume_tpu_torch.ops import cost_volume as plain
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc

    g = torch.Generator().manual_seed(2)
    cl32 = torch.randn((1, CAT_C, H4, W4), generator=g).to(dev)
    cr32 = torch.randn((1, CAT_C, H4, W4), generator=g).to(dev)
    att32 = torch.softmax(torch.randn((1, D4, H4, W4), generator=g), 1).to(dev)
    noise32 = torch.rand((1, D4, H4, W4), generator=g).to(dev)
    vol_elems = 2 * CAT_C * D4 * H4 * W4
    out = {}

    log("concat_volume, channels-last  2×(1,32,128,240) (× att) → (1,48,128,240,64)")
    errs, cases = {}, []
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        e = 0.0
        for a in (att32.to(dt), None):
            got = kc.concat_volume(cl32.to(dt), cr32.to(dt), D4, a, channels_last=True)
            want = plain.concat_volume_mul(cl32.to(dt), cr32.to(dt), D4, a, channels_last=True)
            torch.cuda.synchronize()
            e = max(e, check(f"{tag} volume, att={'yes' if a is not None else 'none'}",
                             got, want, 0.0, 0.0))
            del got, want
        errs[tag] = e
    clb, crb, attb = cl32.bfloat16(), cr32.bfloat16(), att32.bfloat16()
    for a, label in ((attb, "with att (baseline)"), (None, "without att (DDIM prep)")):
        nbytes = 2 * clb.numel() * 2 + (0 if a is None else a.numel() * 2) + vol_elems * 2
        b_ms, _ = bound(nbytes, vol_elems if a is not None else 0)
        t = device_times(lambda: kc.concat_volume(clb, crb, D4, a, channels_last=True), 20)
        plan = kc.concat_plan(1, CAT_C, H4, W4, D4, a is not None, torch.bfloat16, dev)
        cases.append(dict(
            label=label, per_pair=1, **t,
            plain_ms=time_ms(lambda: plain.concat_volume_mul(clb, crb, D4, a, True), 3),
            library_ms=None, bound_ms=b_ms, ops_ms=0.0, plan=plan))
        log(f"  bf16 {label}: {on_card(t)}, plain {cases[-1]['plain_ms']:.4f}, bound "
            f"{b_ms:.4f} ms{concat_plan_line(plan)}")
    out["concat_volume"] = mixed(cases, errs)

    log("dhw_mul, channels-last  vol (1,48,128,240,64) × (att ⊙ noise) (1,48,128,240)")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        vol = kc.concat_volume(cl32.to(dt), cr32.to(dt), D4, channels_last=True)
        got = kc.dhw_mul(vol, att32.to(dt), noise32.to(dt), channels_last=True)
        want = plain.volume_dhw_mul(vol, att32.to(dt), noise32.to(dt), channels_last=True)
        torch.cuda.synchronize()
        tag = str(dt).split(".")[1]
        errs[tag] = check(f"{tag} volume", got, want, 0.0, 0.0)
        del got, want, vol
    volb = kc.concat_volume(clb, crb, D4, channels_last=True)
    noiseb = noise32.bfloat16()

    def library():
        return torch.einsum("bdhwc,bdhw,bdhw->bdhwc", volb, attb, noiseb)
    check("bfloat16 library einsum", library(),
          kc.dhw_mul(volb, attb, noiseb, channels_last=True), 0.0, 2.0 ** -6)
    nbytes = 2 * volb.numel() * 2 + 2 * attb.numel() * 2
    b_ms, _ = bound(nbytes, attb.numel() + volb.numel())
    t = device_times(lambda: kc.dhw_mul(volb, attb, noiseb, channels_last=True), 20)
    out["dhw_mul"] = mixed([dict(
        label="(1,48,128,240,64)", per_pair=STEPS, **t,
        plain_ms=time_ms(lambda: plain.volume_dhw_mul(volb, attb, noiseb, True), 3),
        library_ms=device_times(library, 20)["ms"], bound_ms=b_ms, ops_ms=0.0)], errs)
    log(f"  bf16 {on_card(t)}")
    for k, v in out.items():
        lib = "" if v["library_ms"] is None else f", library {v['library_ms']:.4f} ms device"
        log(f"  {k} (channels-last): {v['ms']:.4f} ms device a launch (plain "
            f"{v['plain_ms']:.4f} ms{lib}, bound {v['bound'][0]:.4f} ms by {v['bound'][1]})")
    return out


def dtype_tag(dt) -> str:
    return str(dt).split(".")[1]


class VolumeCase(NamedTuple):
    """One shape of row 16 (the GWC volume in the conv slot): features (1,
    C, H, W) → (1, D, H, W, slot), G groups, cc concat channels, and the
    launches a pair on each folded path (``gwcnet_g``: PCWNet without the
    concat volume)."""
    label: str
    c: int
    groups: int
    dhw: tuple
    cc: int
    slot: int
    mask_ref: bool
    acv: int
    pcw: int
    igev: int
    gwcnet_g: int = 0


VOLUME_CASES = [
    VolumeCase("ACV 40 in 48", FEAT_C, GROUPS, (D4, H4, W4), 0, ATT_SLOT, False, 2, 0, 0),
    *(VolumeCase(f"PCW {sc}", FEAT_C, GROUPS, (d, h, w), PCW_CC, PCW_SLOT, True, 0, 2, 0)
      for sc, d, h, w in PCW_VOLUMES),
    VolumeCase("IGEV 8 groups in 16", IGEV_C, IGEV_GROUPS, G1, 0, IGEV_SLOT, False, 0, 0, 2),
    *(VolumeCase(f"gwcnet-g {sc}, 40 in 48", FEAT_C, GROUPS, (d, h, w), 0, PCWG_SLOT, True,
                 0, 0, 0, 2) for sc, d, h, w in PCW_VOLUMES),
]
VOLUME_PATHS = ("acv", "pcw", "igev", "gwcnet_g")
# Row 10 at the ACV slot volume: the attention chain's two stencils alone and
# the fused pair it runs; (label, dilations of the first, of the second).
PATCH_DIL = (1,) * ATT_SLOT
PATCH_L123_DIL = (1,) * 8 + (2,) * 16 + (3,) * 16 + (1,) * (ATT_SLOT - GROUPS)


def volume_checks(dev) -> dict:
    """Phase 3, row 16 at every ``VOLUME_CASES`` shape: float32 (1e-6 +
    1e-5 relative) and bf16 (one ulp) against the plain version; bf16 timed
    on the card (torch.profiler's device time, CUDA events and the host's
    time to issue a call beside it), with the tile plan."""
    from diffuvolume_tpu_torch.ops import cost_volume as plain
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(5)
    bf16_ulp = 2.0 ** -7
    cases, errs = [], {}
    log("gwc_volume_packed  features (1,C,H,W) [+ concat (1,12,H,W)] → (1,D,H,W,slot)")
    for vc in VOLUME_CASES:
        d, h, w = vc.dhw
        l32 = torch.randn((1, vc.c, h, w), generator=g).to(dev)
        r32 = torch.randn((1, vc.c, h, w), generator=g).to(dev)
        cat32 = {k: torch.randn((1, vc.cc, h, w), generator=g).to(dev)
                 for k in ("cat_l", "cat_r")} if vc.cc else {}
        e = {}
        for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, bf16_ulp)):
            tag = dtype_tag(dt)
            args = (l32.to(dt), r32.to(dt), d, vc.groups, vc.slot)
            kw = dict(mask_ref=vc.mask_ref, **{k: v.to(dt) for k, v in cat32.items()})
            got, want = kg.gwc_volume_packed(*args, **kw), plain.gwc_volume_slot(*args, **kw)
            torch.cuda.synchronize()
            e[tag] = check(f"{vc.label} {tag}", got, want, 1e-6, rtol)
            errs[tag] = max(errs.get(tag, 0.0), e[tag])
            del got, want
        lb, rb = l32.bfloat16(), r32.bfloat16()
        cb = {k: v.bfloat16() for k, v in cat32.items()}
        pairs_dw = sum(max(w - k, 0) for k in range(d))
        nbytes = (2 * lb.numel() + 2 * vc.cc * h * w + d * h * w * vc.slot) * 2
        ops = 2 * vc.c * h * pairs_dw
        b_ms, by = bound(nbytes, ops)
        t = device_times(lambda: kg.gwc_volume_packed(lb, rb, d, vc.groups, vc.slot,
                                                      mask_ref=vc.mask_ref, **cb), 20)
        plan = kg.slot_plan(1, vc.c, vc.cc, h, w, d, vc.slot, torch.bfloat16, dev)
        rec = dict(label=vc.label, c=vc.c, groups=vc.groups, dhw=[d, h, w], cc=vc.cc,
                   slot=vc.slot, mask_ref=vc.mask_ref,
                   per_pair=sum(getattr(vc, k) for k in VOLUME_PATHS),
                   **{f"per_pair_{k}": getattr(vc, k) for k in VOLUME_PATHS}, errs=e,
                   ms=t["ms"], events_ms=t["events_ms"], host_us=t["host_us"],
                   plain_ms=time_ms(lambda: plain.gwc_volume_slot(
                       lb, rb, d, vc.groups, vc.slot, mask_ref=vc.mask_ref, **cb), 2),
                   library_ms=None, bound_ms=b_ms, bound_by=by,
                   ops_ms=ops / F32_OPS_PER_S * 1e3, plan=plan)
        tile = "" if plan is None else (f"; tile {plan['tw']} W × {plan['ds']} D, "
                                        f"{plan['blocks']} blocks of {plan['threads']}")
        log(f"  bf16 {rec['ms']:.4f} ms device (events {t['events_ms']:.4f}, host "
            f"{t['host_us']:.0f} µs; plain {rec['plain_ms']:.4f}, bound {b_ms:.4f} ms by "
            f"{by}){tile}; a pair ACV {vc.acv} / PCW {vc.pcw} / IGEV {vc.igev} / gwcnet-g "
            f"{vc.gwcnet_g}")
        cases.append(rec)
        del l32, r32, lb, rb, cat32, cb
    # No one PyTorch call builds a group-wise correlation volume: library null.
    out = mixed(cases, errs)
    out["ms_by_path"] = {}
    for path in VOLUME_PATHS:
        sel = [c for c in cases if c[f"per_pair_{path}"]]
        n = sum(c[f"per_pair_{path}"] for c in sel)
        out["ms_by_path"][path] = dict(
            ms=sum(c["ms"] * c[f"per_pair_{path}"] for c in sel) / n,
            bound_ms=sum(c["bound_ms"] * c[f"per_pair_{path}"] for c in sel) / n,
            pair_ms=sum(c["ms"] * c[f"per_pair_{path}"] for c in sel))
    log("  gwc_volume_packed a launch by path: " + ", ".join(
        f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}; a pair {v['pair_ms']:.4f})"
        for k, v in out["ms_by_path"].items()))
    return out


def stencil_checks(dev) -> dict:
    """Phase 3, row 10 on the ACV slot volume (1, 48, 128, 240, 48) bf16:
    ``patch`` (dilation 1) and ``patch_l123`` (1/2/3) alone and the fused
    pair the attention chain runs (``depthwise_hw_p2``: equal to two single launches bit for bit, asserted;
    within the stencil tolerance of the plain second stencil on the kernel's
    intermediate, and in float32 of the plain pair).  Device time
    (torch.profiler) for the kernels and the library's grouped ``F.conv3d``;
    the ``kernels`` line's row 10 is the fused pair, which the path
    launches."""
    import torch.nn.functional as F

    from diffuvolume_tpu_torch.ops.kernels import depthwise as kd

    g = torch.Generator().manual_seed(7)
    x32 = torch.randn((1, D4, H4, W4, ATT_SLOT), generator=g).to(dev)
    x32[..., GROUPS:] = 0.0
    wts = []
    for _ in range(2):
        wt = torch.randn((3, 3, ATT_SLOT), generator=g).to(dev) * 0.3
        wt[..., GROUPS:] = 0.0
        wts.append(wt)
    vox = D4 * H4 * W4
    ops = 2 * 9 * GROUPS * vox
    xb = x32.bfloat16()
    log(f"depthwise_hw_p  (1,{D4},{H4},{W4},{ATT_SLOT}): patch (dil 1), patch_l1/2/3 (dil 1,2,3)")
    cases, errs = [], {}
    for label, dil, wt in (("patch, dilation 1", PATCH_DIL, wts[0]),
                           ("patch_l1/2/3, dilation 1/2/3", PATCH_L123_DIL, wts[1])):
        e = {}
        for dt in (torch.float32, torch.bfloat16):
            tag = dtype_tag(dt)
            got = kd.depthwise_hw_p(x32.to(dt), wt, dil)
            want = kd.depthwise_hw_plain(x32.to(dt), wt, dil)
            torch.cuda.synchronize()
            e[tag] = check(f"{label} {tag}", got, want, *CONV_TOL[tag])
            errs[tag] = max(errs.get(tag, 0.0), e[tag])
            del got, want
        # The library: one grouped F.conv3d on channels-last bf16 operands;
        # the mixed dilations as one 7×7 kernel with each channel's taps at
        # its own spacing (zeros between).
        r, wt_host = max(dil), wt.cpu()
        w_lib = torch.zeros((ATT_SLOT, 1, 1, 2 * r + 1, 2 * r + 1))
        for c, dc in enumerate(dil):
            for i in range(3):
                for j in range(3):
                    w_lib[c, 0, 0, r + (i - 1) * dc, r + (j - 1) * dc] = wt_host[i, j, c]
        w_lib = w_lib.to(dev, torch.bfloat16)
        x_cl = xb.permute(0, 4, 1, 2, 3)

        def library():
            return F.conv3d(x_cl, w_lib, padding=(0, r, r), groups=ATT_SLOT)
        lib_err = float((library().permute(0, 2, 3, 4, 1).float()
                         - kd.depthwise_hw_p(xb, wt, dil).float()).abs().max())
        b_ms, by = bound(2 * vox * ATT_SLOT * 2, ops)
        t = device_times(lambda: kd.depthwise_hw_p(xb, wt, dil), 20)
        plan = kd.depthwise_plan(D4, H4, W4, ATT_SLOT, torch.bfloat16, max(dil), 0, dev)
        # per_pair weighs the mean over the two shapes (each once).
        rec = dict(label=label, dil=sorted(set(dil)), per_pair=1, errs=e, ms=t["ms"],
                   events_ms=t["events_ms"], host_us=t["host_us"],
                   plain_ms=time_ms(lambda: kd.depthwise_hw_plain(xb, wt, dil), 3),
                   library_ms=device_times(library, 20)["ms"], library_max_abs_vs_kernel=lib_err,
                   bound_ms=b_ms, bound_by=by, ops_ms=ops / F32_OPS_PER_S * 1e3, plan=plan)
        log(f"  bf16 {rec['ms']:.4f} ms device (events {t['events_ms']:.4f}, host "
            f"{t['host_us']:.0f} µs; plain {rec['plain_ms']:.4f}, library "
            f"{rec['library_ms']:.4f} [max |Δ| to the kernel {lib_err:.2e}], bound {b_ms:.4f} ms "
            f"by {by}){'' if plan is None else '; plan ' + str(plan)}")
        cases.append(rec)
    out = {"depthwise_hw_p": mixed(cases, errs)}
    pair_ms = sum(c["ms"] for c in cases)

    log("depthwise_hw_p2  the pair in one launch: patch, then patch_l1/2/3")
    args = (wts[0], PATCH_DIL, wts[1], PATCH_L123_DIL)
    e = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = dtype_tag(dt)
        x = x32.to(dt)
        got = kd.depthwise_hw_p2(x, *args)
        mid = kd.depthwise_hw_p(x, wts[0], PATCH_DIL)
        two = kd.depthwise_hw_p(mid, wts[1], PATCH_L123_DIL)
        torch.cuda.synchronize()
        if not torch.equal(got, two):
            raise AssertionError(f"the fused pair differs from two single launches ({tag})")
        e[tag] = check(f"fused pair {tag} (two launches: equal)", got,
                       kd.depthwise_hw_plain(mid, wts[1], PATCH_L123_DIL), *CONV_TOL[tag])
        if dt == torch.float32:
            e[tag] = max(e[tag], check("fused pair float32 against the plain pair", got,
                                       kd.depthwise_hw_plain2(x, *args), *CONV_TOL[tag]))
        del got, mid, two
    b_ms, by = bound(2 * vox * ATT_SLOT * 2, 2 * ops)
    t = device_times(lambda: kd.depthwise_hw_p2(xb, *args), 20)
    plan = kd.depthwise_plan(D4, H4, W4, ATT_SLOT, torch.bfloat16, 1, 3, dev)
    # No one PyTorch call applies the two stencils: library null.
    rec = dict(label="patch then patch_l1/2/3, one launch", per_pair=2, errs=e, ms=t["ms"],
               events_ms=t["events_ms"], host_us=t["host_us"],
               plain_ms=time_ms(lambda: kd.depthwise_hw_plain2(xb, *args), 3), library_ms=None,
               bound_ms=b_ms, bound_by=by, ops_ms=2 * ops / F32_OPS_PER_S * 1e3, plan=plan)
    log(f"  bf16 {rec['ms']:.4f} ms device (events {t['events_ms']:.4f}, host "
        f"{t['host_us']:.0f} µs; plain {rec['plain_ms']:.4f}, bound {b_ms:.4f} ms by {by}); the "
        f"two alone {pair_ms:.4f} ms; plan {plan}; 2 per ACV pair")
    out["depthwise_hw_p2"] = mixed([rec], e)
    out["chain_ms"] = rec["ms"]
    return out


def front_checks(dev) -> dict:
    """Phase 3, rows 16 and 10 (``tools/conv_device_times.py --rows front``)."""
    return {"gwc_volume_packed": volume_checks(dev), **stencil_checks(dev)}


def pcw_mul_checks(dev) -> dict:
    """Phase 3, row 4 with one map at the PCW path's shape: the noise into
    the 32-channel combine volume, 3 per PCW pair."""
    from diffuvolume_tpu_torch.ops import cost_volume as plain
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc

    g = torch.Generator().manual_seed(8)
    log(f"dhw_mul, one map  vol (1,{PCW_D4},{PCW_H4},{PCW_W4},32) × noise; 3 per PCW pair")
    vol32 = torch.randn((1, PCW_D4, PCW_H4, PCW_W4, 32), generator=g).to(dev)
    m32 = torch.rand((1, PCW_D4, PCW_H4, PCW_W4), generator=g).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = dtype_tag(dt)
        got = kc.dhw_mul(vol32.to(dt), m32.to(dt), None, channels_last=True)
        want = plain.volume_dhw_mul(vol32.to(dt), m32.to(dt), None, channels_last=True)
        torch.cuda.synchronize()
        errs[tag] = check(tag, got, want, 0.0, 0.0)
    vb, mb = vol32.bfloat16(), m32.bfloat16()
    b_ms, by = bound(2 * vb.numel() * 2 + mb.numel() * 2, vb.numel())
    t = device_times(lambda: kc.dhw_mul(vb, mb, None, channels_last=True), 20)
    r = dict(errs=errs, **t, plain_ms=time_ms(lambda: plain.volume_dhw_mul(vb, mb, None, True), 3),
             library_ms=device_times(lambda: torch.mul(vb, mb[..., None]), 20)["ms"],
             bound=(b_ms, by), dtype="bfloat16", per_pair_pcw=PCW_STEPS)
    log(f"  bf16 {on_card(t)} (plain {r['plain_ms']:.4f}, library torch.mul "
        f"{r['library_ms']:.4f} ms device, bound {b_ms:.4f} ms by {by})")
    return {"dhw_mul_one_map_pcw": r}


class HeadCase(NamedTuple):
    """One shape of the fused heads (rows 1 and 17): logits (B, D4, H4, W4)
    → (H, W) at MAIN_DISP bins, the align-corners convention, and the
    launches a pair of row 1 and of row 17 on the path it belongs to (0 for
    the other convention, checked and timed but run by no path)."""
    label: str
    cost: tuple
    out_hw: tuple
    align_corners: bool
    row1_acv: int
    row1_pcw: int
    row17_pcw: int


HEAD_CASES = [
    HeadCase("ACV (1,48,128,240) → 512×960", (1, D4, H4, W4), (MAIN_H, MAIN_W), False,
             1 + STEPS, 0, 0),
    HeadCase("ACV shape, align_corners", (1, D4, H4, W4), (MAIN_H, MAIN_W), True, 0, 0, 0),
    HeadCase("PCW (1,48,96,312) → 384×1248, align_corners", (1, PCW_D4, PCW_H4, PCW_W4),
             (PCW_H, PCW_W), True, 0, 1 + PCW_STEPS, PCW_STEPS),
    HeadCase("PCW shape, no align_corners", (1, PCW_D4, PCW_H4, PCW_W4), (PCW_H, PCW_W), False,
             0, 0, 0),
]


def head_checks(dev, iters: int = 20) -> dict:
    """Phase 3, rows 1 and 17 at every ``HEAD_CASES`` shape: float32 and
    bfloat16 logits against the plain versions (1e-4 absolute + 1e-4
    relative), the float32 kernels (the paths' input) timed on the card
    (``device_times``), the plain versions under CUDA events.  Row 1's
    numbers in the ``kernels`` line are the ACV main path's shape, row 17's
    PCW's; no one PyTorch call computes either (library null)."""
    from diffuvolume_tpu_torch.ops.kernels import fused_head as kf

    g = torch.Generator().manual_seed(3)
    rows = {"fused_head": ({}, []), "fused_uncertainty_at": ({}, [])}
    for case in HEAD_CASES:
        (h, w), ac = case.out_hw, case.align_corners
        cost32 = (torch.randn(case.cost, generator=g) * 3.0).to(dev)
        q = (torch.rand((case.cost[0], h, w), generator=g) * (MAIN_DISP - 1)).to(dev)
        hw, nd4 = case.cost[0] * h * w, case.cost[1]
        calls = {
            "fused_head": (lambda c: kf.fused_upsample_softargmin(c, MAIN_DISP, (h, w), ac),
                           lambda c: kf.fused_upsample_softargmin_plain(c, MAIN_DISP, (h, w), ac),
                           hw * (9 * nd4 + 13 * MAIN_DISP + 2), 2 * hw * 4,
                           (case.row1_acv, case.row1_pcw)),
            "fused_uncertainty_at": (
                lambda c: kf.fused_uncertainty_at(c, q, MAIN_DISP, (h, w), ac),
                lambda c: kf.fused_uncertainty_at_plain(c, q, MAIN_DISP, (h, w), ac),
                hw * (9 * nd4 + 9 * MAIN_DISP + 2), 2 * hw * 4, (0, case.row17_pcw)),
        }
        for name, (kernel, plain, ops, io_bytes, (acv_n, pcw_n)) in calls.items():
            log(f"{name}  {case.label}: cost {case.cost} → {(case.cost[0], h, w)}, "
                f"D={MAIN_DISP}, align_corners={ac}")
            errs, e = rows[name][0], {}
            for dt in (torch.float32, torch.bfloat16):
                tag = dtype_tag(dt)
                got, want = kernel(cost32.to(dt)), plain(cost32.to(dt))
                torch.cuda.synchronize()
                got, want = (got, want) if isinstance(got, tuple) else ((None, got), (None, want))
                e[tag] = max(check(f"{tag} {k}", a, b, 1e-4, 1e-4)
                             for k, a, b in zip(("disp", "unc"), got, want) if a is not None)
                errs[tag] = max(errs.get(tag, 0.0), e[tag])
            t = device_times(lambda: kernel(cost32), iters)
            b_ms, by = bound(cost32.numel() * 4 + io_bytes, ops)
            rec = dict(label=case.label, cost=list(case.cost), out_hw=[h, w], align_corners=ac,
                       per_pair=acv_n + pcw_n, per_pair_acv=acv_n, per_pair_pcw=pcw_n, errs=e,
                       ms=t["ms"], events_ms=t["events_ms"], host_us=t["host_us"],
                       plain_ms=time_ms(lambda: plain(cost32), 3), library_ms=None,
                       bound_ms=b_ms, bound_by=by, ops_ms=ops / F32_OPS_PER_S * 1e3)
            log(f"  float32 {t['ms']:.4f} ms on the card ({t['events_ms']:.4f} under CUDA "
                f"events, {t['host_us']:.1f} µs of host to issue a call; plain "
                f"{rec['plain_ms']:.4f}, bound {b_ms:.4f} ms by {by}); {acv_n} per ACV pair, "
                f"{pcw_n} per PCW pair")
            rows[name][1].append(rec)
        del cost32, q
    main = {"fused_head": HEAD_CASES[0].label, "fused_uncertainty_at": HEAD_CASES[2].label}
    out = {}
    for name, (errs, recs) in rows.items():
        rec = next(r for r in recs if r["label"] == main[name])
        out[name] = dict(errs=errs, ms=rec["ms"], plain_ms=rec["plain_ms"], library_ms=None,
                         bound=(rec["bound_ms"], rec["bound_by"]), dtype="float32",
                         shapes=recs)
    return out


class ConvCase(NamedTuple):
    """One path's conv shape: its wrapper (row), kind ("p" 3×3×3 stride 1,
    "s2" stride 2, "k1" 1×1×1, "up" transposed k3, "up4" transposed k4),
    channels, input (D, H, W), launches per pair and the epilogue the path
    gives it (``act`` None, "relu", "mish" or "leaky"; ``post_mul`` a
    (B, H, W, C_out) map broadcast over D).  ``real_cin`` / ``real_cout``:
    the channels that carry data when a slot holds zero fill."""
    row: str
    label: str
    kind: str
    cin: int
    cout: int
    dhw: tuple
    per_pair: int
    residual: bool = False
    act: str | None = "relu"
    bias: bool = True
    real_cin: int | None = None
    post_mul: bool = False
    real_cout: int | None = None


# The conv launches of one main-path pair: 6 aggregation passes (baseline +
# 5 DDIM steps; each: the dres0_0 wide entry; dres0_1, dres1_0 and
# classif2_0 at 32→32; dres1_1 + residual; the 32→1 head; 2 hourglasses)
# and 2 attention chains (baseline + DDIM prep; each: the dres1_att_0 wide
# entry; dres1_att_1, no ReLU; classif_att_0; the head; 1 hourglass).  An
# hourglass: conv1 s2, conv2, conv3 s2, conv4, the redir2 / redir1 1×1s (no
# ReLU), the transposed conv5 and conv6 (+ redir, ReLU).
CONV_CASES = [
    ConvCase("conv3d_fold_p", "32→32", "p", 32, 32, FULL, 20),
    ConvCase("conv3d_fold_p", "32→32, no ReLU", "p", 32, 32, FULL, 2, act=None),
    ConvCase("conv3d_fold_p", "32→32 + residual, no ReLU", "p", 32, 32, FULL, 6,
             residual=True, act=None),
    ConvCase("conv3d_fold_p", "32→1 head, no bias or ReLU", "p", 32, 1, FULL, 8,
             act=None, bias=False),
    ConvCase("conv3d_fold_p", "64→64 half", "p", 64, 64, HALF, 14),
    ConvCase("conv3d_fold_p", "128→128 quarter", "p", 128, 128, QUARTER, 14),
    ConvCase("conv3d_fold_x2", "64→32", "p", 64, 32, FULL, 6),
    ConvCase("conv3d_fold_x2", "40 in a 48 slot→32", "p", 48, 32, FULL, 2, real_cin=GROUPS),
    ConvCase("conv3d_fold_s2", "32→64 full→half", "s2", 32, 64, FULL, 14),
    ConvCase("conv3d_fold_s2", "64→128 half→quarter", "s2", 64, 128, HALF, 14),
    ConvCase("conv1x1_fold_p", "32→32, no ReLU", "k1", 32, 32, FULL, 14, act=None),
    ConvCase("conv1x1_fold_p", "64→64 half, no ReLU", "k1", 64, 64, HALF, 14, act=None),
    ConvCase("conv3d_fold_up", "128→64 quarter→half + residual", "up", 128, 64, QUARTER, 14,
             residual=True),
    ConvCase("conv3d_fold_up", "64→32 half→full + residual", "up", 64, 32, HALF, 14,
             residual=True),
]


def pcw_volume_convs(slot: int, real_cin: int | None = None, tag: str = "") -> list:
    """The PCW convs that read a scale's volume, 2 a pair each (one a volume
    build): dres0_0 (the wide entry) at 1/4 and the volume's part of each
    ``HourglassUp`` combine conv at 1/8, 1/16 and 1/32.  Their input is the
    volume's ``slot`` (``real_cin`` of it carry data)."""
    return [
        ConvCase("conv3d_fold_x2", f"{tag}dres0_0 {slot}→32, Mish", "p", slot, 32, P1, 2,
                 act="mish", real_cin=real_cin),
        ConvCase("conv3d_fold_p", f"{tag}1/8 volume part of combine1, {slot}→64", "p", slot, 64,
                 P2, 2, act=None, bias=False, real_cin=real_cin),
        ConvCase("conv3d_fold_p", f"{tag}1/16 volume part of combine2, {slot}→128", "p", slot,
                 128, P3, 2, act=None, bias=False, real_cin=real_cin),
        ConvCase("conv3d_fold_p", f"{tag}1/32 volume part of combine3, {slot}→128", "p", slot,
                 128, P4, 2, act=None, bias=False, real_cin=real_cin),
    ]


# The conv launches of one PCW pair: 2 volume builds (baseline + DDIM prep;
# each: dres0_0 wide entry, dres0_1, dres1_0, dres1_1 + residual, and
# HourglassUp: at each of 1/8, 1/16, 1/32 a bare stride-2 conv, the combine
# conv as the volume's part then the rest + residual, a conv; back up the
# transposed conv7/8/9, each + its 1×1 redir) and 4 aggregation passes
# (baseline + 3 DDIM steps; each: 3 Mish hourglasses, classif3_0 and the
# 32→1 head).  Mish wherever the reference applies one.  gwcnet-g runs these
# convs as they are and those that read a volume (``pcw_volume_convs``) on
# its 48-channel slot (``GWCNET_G_CONV_CASES``).
PCW_SHARED_CONV_CASES = [
    ConvCase("conv3d_fold_p", "32→32, Mish", "p", 32, 32, P1, 8, act="mish"),
    ConvCase("conv3d_fold_p", "32→32 + residual, no act", "p", 32, 32, P1, 2, residual=True,
             act=None),
    ConvCase("conv3d_fold_p", "32→1 head, no bias or act", "p", 32, 1, P1, 4, act=None,
             bias=False),
    ConvCase("conv3d_fold_p", "combine1 64→64 + residual, Mish", "p", 64, 64, P2, 2,
             residual=True, act="mish"),
    ConvCase("conv3d_fold_p", "64→64 half, Mish", "p", 64, 64, P2, 14, act="mish"),
    ConvCase("conv3d_fold_p", "combine2 128→128 + residual, Mish", "p", 128, 128, P3, 2,
             residual=True, act="mish"),
    ConvCase("conv3d_fold_p", "128→128 quarter, Mish", "p", 128, 128, P3, 14, act="mish"),
    ConvCase("conv3d_fold_p", "combine3 128→128 at 1/32 + residual, Mish", "p", 128, 128, P4,
             2, residual=True, act="mish"),
    ConvCase("conv3d_fold_p", "conv6 128→128 at 1/32, Mish", "p", 128, 128, P4, 2, act="mish"),
    ConvCase("conv3d_fold_s2", "32→64 full→half, no bias or act", "s2", 32, 64, P1, 2,
             act=None, bias=False),
    ConvCase("conv3d_fold_s2", "64→128 half→quarter, no bias or act", "s2", 64, 128, P2, 2,
             act=None, bias=False),
    ConvCase("conv3d_fold_s2", "128→128 quarter→1/32, no bias or act", "s2", 128, 128, P3, 2,
             act=None, bias=False),
    ConvCase("conv3d_fold_s2", "32→64 full→half, Mish", "s2", 32, 64, P1, 12, act="mish"),
    ConvCase("conv3d_fold_s2", "64→128 half→quarter, Mish", "s2", 64, 128, P2, 12,
             act="mish"),
    ConvCase("conv1x1_fold_p", "32→32, no act", "k1", 32, 32, P1, 14, act=None),
    ConvCase("conv1x1_fold_p", "64→64 half, no act", "k1", 64, 64, P2, 14, act=None),
    ConvCase("conv1x1_fold_p", "128→128 quarter, no act", "k1", 128, 128, P3, 2, act=None),
    ConvCase("conv3d_fold_up", "128→128 1/32→quarter + residual, Mish", "up", 128, 128, P4, 2,
             residual=True, act="mish"),
    ConvCase("conv3d_fold_up", "128→64 quarter→half + residual, Mish", "up", 128, 64, P3, 14,
             residual=True, act="mish"),
    ConvCase("conv3d_fold_up", "64→32 half→full + residual, Mish", "up", 64, 32, P2, 14,
             residual=True, act="mish"),
]
PCW_CONV_CASES = PCW_SHARED_CONV_CASES + pcw_volume_convs(PCW_SLOT)
# gwcnet-g's new shapes: the volume convs at C_in 48, 40 of them data.
GWCNET_G_CONV_CASES = pcw_volume_convs(PCWG_SLOT, GROUPS, "gwcnet-g ")


# The IGEV path's conv launches of one pair, 2 encodes (baseline + DDIM
# prep), each the folded GEV tower: corr_stem × its attention; per level a
# stride-2 conv, then a conv × the level's attention; conv3_up / conv2_up (k4,
# leaky), each followed by the agg 1×1 over concat(up, skip) as two launches
# (the skip's half, then the up half + it as residual, leaky) and two convs
# (the second × the attention); conv1_up (k4, no BN, bias or act) into the
# 16 slot; the 8 → 1 classifier.  The 8-channel volumes live in 16-wide slots.
IGEV_CONV_CASES = [
    ConvCase("conv3d_fold_p", "corr_stem 8 in 16 → 8 in 16, leaky × att", "p", 16, 16, G1, 2,
             act="leaky", real_cin=8, real_cout=8, post_mul=True),
    ConvCase("conv3d_fold_p", "conv1_1 16→16 at 1/8, leaky × att", "p", 16, 16, G2, 2,
             act="leaky", post_mul=True),
    ConvCase("conv3d_fold_p", "agg1_1 16→16 at 1/8, leaky", "p", 16, 16, G2, 2, act="leaky"),
    ConvCase("conv3d_fold_p", "agg1_2 16→16 at 1/8, leaky × att", "p", 16, 16, G2, 2,
             act="leaky", post_mul=True),
    ConvCase("conv3d_fold_p", "conv2_1 32→32 at 1/16, leaky × att", "p", 32, 32, G3, 2,
             act="leaky", post_mul=True),
    ConvCase("conv3d_fold_p", "agg0_1 32→32 at 1/16, leaky", "p", 32, 32, G3, 2, act="leaky"),
    ConvCase("conv3d_fold_p", "agg0_2 32→32 at 1/16, leaky × att", "p", 32, 32, G3, 2,
             act="leaky", post_mul=True),
    ConvCase("conv3d_fold_p", "conv3_1 48→48 at 1/32, leaky × att", "p", 48, 48, G4, 2,
             act="leaky", post_mul=True),
    ConvCase("conv3d_fold_p", "classifier 8 in 16 → 1, no bias or act", "p", 16, 1, G1, 2,
             act=None, bias=False, real_cin=8),
    ConvCase("conv3d_fold_s2", "conv1_0 8 in 16 → 16, 1/4→1/8, leaky", "s2", 16, 16, G1, 2,
             act="leaky", real_cin=8),
    ConvCase("conv3d_fold_s2", "conv2_0 16→32, 1/8→1/16, leaky", "s2", 16, 32, G2, 2,
             act="leaky"),
    ConvCase("conv3d_fold_s2", "conv3_0 32→48, 1/16→1/32, leaky", "s2", 32, 48, G3, 2,
             act="leaky"),
    ConvCase("conv1x1_fold_p", "agg0_0 skip half 32→32, no bias or act", "k1", 32, 32, G3, 2,
             act=None, bias=False),
    ConvCase("conv1x1_fold_p", "agg0_0 up half 32→32 + residual, leaky", "k1", 32, 32, G3, 2,
             residual=True, act="leaky"),
    ConvCase("conv1x1_fold_p", "agg1_0 skip half 16→16, no bias or act", "k1", 16, 16, G2, 2,
             act=None, bias=False),
    ConvCase("conv1x1_fold_p", "agg1_0 up half 16→16 + residual, leaky", "k1", 16, 16, G2, 2,
             residual=True, act="leaky"),
    ConvCase("conv3d_fold_up", "conv3_up k4 48→32, 1/32→1/16, leaky", "up4", 48, 32, G4, 2,
             act="leaky"),
    ConvCase("conv3d_fold_up", "conv2_up k4 32→16, 1/16→1/8, leaky", "up4", 32, 16, G3, 2,
             act="leaky"),
    ConvCase("conv3d_fold_up", "conv1_up k4 16 → 8 in 16, 1/8→1/4, no bias or act", "up4", 16,
             16, G2, 2, act=None, bias=False, real_cout=8),
]

# The IGEV module path's row-14 launches of one pair (2 encodes): every 3×3×3
# stride-1 conv at C_in ≤ 16 on plain NDHWC, BatchNorm and LeakyReLU after it
# as PyTorch ops.
IGEV_SMALL_CASES = [
    ConvCase("conv3d_fold_small", "corr_stem 8→8 at 1/4", "p", 8, 8, G1, 2, act=None,
             bias=False),
    ConvCase("conv3d_fold_small", "conv1_1, agg1_1, agg1_2 16→16 at 1/8", "p", 16, 16, G2, 6,
             act=None, bias=False),
    ConvCase("conv3d_fold_small", "classifier 8→1 at 1/4", "p", 8, 1, G1, 2, act=None,
             bias=False),
]


# The module paths' row-15 launches of one pair after route_conv3d: every
# 3×3×3 stride-1 conv of a 3-D ConvBN (IGEV: of a BasicConv) at C_in 32, 64
# or 128 with D a multiple of 128 / C_in, on plain NDHWC without bias or
# activation (BatchNorm and the activation follow as PyTorch ops).  ACV: 6
# aggregation passes (dres0_0; dres0_1, dres1_0, dres1_1, classif2_0; conv2
# and conv4 of 2 hourglasses) and 2 attention chains (dres1_att_1,
# classif_att_0; conv2 and conv4 of 1 hourglass; dres1_att_0's 40 channels
# are not eligible).  PCW: 2 volume builds (dres0_0; dres0_1, dres1_0,
# dres1_1; HourglassUp's combine1, conv2, conv4, conv6; combine2 and combine3
# take 192 channels) and 4 aggregation passes (conv2 and conv4 of 3
# hourglasses; classif3_0).  IGEV: 2 encodes (conv2[1], agg_0[1], agg_0[2]
# at 32 channels; conv3[1]'s 48 are not eligible; C_in 8 and 16 stay on
# row 14).
ACV_PACKED_CASES = [
    ConvCase("conv3d_packed", "dres0_0 64→32", "p", 64, 32, FULL, 6, act=None, bias=False),
    ConvCase("conv3d_packed", "32→32", "p", 32, 32, FULL, 28, act=None, bias=False),
    ConvCase("conv3d_packed", "64→64 half", "p", 64, 64, HALF, 14, act=None, bias=False),
    ConvCase("conv3d_packed", "128→128 quarter", "p", 128, 128, QUARTER, 14, act=None,
             bias=False),
]
PCW_PACKED_CASES = [
    ConvCase("conv3d_packed", "dres0_0 64→32", "p", 64, 32, P1, 2, act=None, bias=False),
    ConvCase("conv3d_packed", "32→32", "p", 32, 32, P1, 10, act=None, bias=False),
    ConvCase("conv3d_packed", "combine1 128→64 at 1/8", "p", 128, 64, P2, 2, act=None,
             bias=False),
    ConvCase("conv3d_packed", "64→64 at 1/8", "p", 64, 64, P2, 14, act=None, bias=False),
    ConvCase("conv3d_packed", "128→128 at 1/16", "p", 128, 128, P3, 14, act=None, bias=False),
    ConvCase("conv3d_packed", "conv6 128→128 at 1/32", "p", 128, 128, P4, 2, act=None,
             bias=False),
]
IGEV_PACKED_CASES = [
    ConvCase("conv3d_packed", "conv2[1], agg_0[1], agg_0[2] 32→32 at 1/16", "p", 32, 32, G3, 6,
             act=None, bias=False),
]
PACKED_CASES = {"acv": ACV_PACKED_CASES, "pcw": PCW_PACKED_CASES, "igev": IGEV_PACKED_CASES}
# gwcnet-g routes PCW's convs but dres0_0 and combine1: without the concat
# volume they take 40 and 104 channels, not among PACKED_CIN, and stay on
# cuDNN (phase 4 asserts the count on its routed module path).
GWCNET_G_PACKED_CASES = [c for c in PCW_PACKED_CASES
                         if not c.label.startswith(("dres0_0", "combine1"))]


class RefineCase(NamedTuple):
    """One 3×3 conv of PCW's folded refinement (row 18) at 384×1248: input
    channels (the slot) and those that carry data, output channels,
    dilation, bias; once per refinement, so 1 + PCW_STEPS a pair."""
    label: str
    cin: int
    real_cin: int
    cout: int
    dil: int
    bias: bool = True
    per_pair: int = 1 + PCW_STEPS


# RefineNetV3's 3×3 convs in order (pcw.py:208-227 of the JAX package):
# conv1 … conv4, the two convs of the conv5 … conv7 blocks, conv8.
REFINE_CASES = [
    RefineCase("conv1 146 in 160 → 128", 160, 146, 128, 1),
    RefineCase("conv2 128→128", 128, 128, 128, 1),
    RefineCase("conv3 128→128 d2", 128, 128, 128, 2),
    RefineCase("conv4 128→128 d4", 128, 128, 128, 4),
    RefineCase("conv5.conv1 128→96 d8", 128, 128, 96, 8),
    RefineCase("conv5.conv2 96→96 d8", 96, 96, 96, 8),
    RefineCase("conv6.conv1 96→64 d16", 96, 96, 64, 16),
    RefineCase("conv6.conv2 64→64 d16", 64, 64, 64, 16),
    RefineCase("conv7.conv1 64→32", 64, 64, 32, 1),
    RefineCase("conv7.conv2 32→32", 32, 32, 32, 1),
    RefineCase("conv8 32→1, no bias", 32, 32, 1, 1, bias=False),
]
# The folded refinement's three 1×1 downsamples on row 9 at D = 1, 384×1248:
# BatchNorm folded into the bias, no act (the block's conv2 takes the result
# as its residual); once per refinement.
REFINE_DOWN_CASES = [
    ConvCase("conv1x1_fold_p", f"refinement downsample {ci}→{co}, no act", "k1", ci, co,
             (1, PCW_H, PCW_W), 1 + PCW_STEPS, act=None)
    for ci, co in ((128, 96), (96, 64), (64, 32))
]


def case_inputs(case: ConvCase, dev, dtype, seed: int) -> dict:
    """A case's operands from ``seed`` (the same values in every dtype,
    rounded): x, w, bias (float32, or None), res and post_mul (or None), and
    geometry.  Channels past ``real_cin`` are zero in x and w, channels past
    ``real_cout`` zero in w, bias and post_mul, as pack and the fold leave
    them."""
    ks = {"k1": 1, "up4": 4}.get(case.kind, 3)
    stride = 2 if case.kind == "s2" else 1
    if case.kind in ("up", "up4"):
        o = tuple(2 * n for n in case.dhw)
    else:
        o = tuple((n + 2 * ((ks - 1) // 2) - ks) // stride + 1 for n in case.dhw)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, *case.dhw, case.cin), generator=g)
    w = torch.randn((ks,) * 3 + (case.cin, case.cout), generator=g) / (ks ** 3 * case.cin) ** 0.5
    if case.real_cin is not None:
        x[..., case.real_cin:] = 0.0
        w[..., case.real_cin:, :] = 0.0
    bias = torch.randn((case.cout,), generator=g) * 0.1
    res = torch.randn((1, *o, case.cout), generator=g) if case.residual else None
    pm = torch.sigmoid(torch.randn((1, o[1], o[2], case.cout), generator=g))
    if case.real_cout is not None:
        for t in (w, bias, pm):
            t[..., case.real_cout:] = 0.0
    return dict(x=x.to(dev, dtype), w=w.to(dev, dtype), bias=bias.to(dev) if case.bias else None,
                res=None if res is None else res.to(dev, dtype),
                post_mul=pm.to(dev, dtype) if case.post_mul else None, ks=ks, stride=stride,
                out_dhw=o)


def case_calls(case: ConvCase, op: dict, tc: int | None = None):
    """``(kernel call, plain call)`` of a case on the operands ``op``, with
    the case's epilogue; on tensor-core form ``tc`` (``conv3d_fold.TC_MMA``
    / ``TC_WGMMA``) where given."""
    from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
    from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup

    x, w, bias, res, act, pm = op["x"], op["w"], op["bias"], op["res"], case.act, op["post_mul"]
    if case.kind in ("up", "up4"):
        up = kup.conv3d_fold_up if tc is None else functools.partial(kup.conv3d_fold_up_on, tc)
        return (lambda: up(x, w, bias, residual=res, act=act, post_mul=pm),
                lambda: kup.conv3d_up_plain(x, w, bias, res, act, pm))
    fn = getattr(kconv, case.row)
    if tc is not None:
        # rows 5, 6, 14 and 15 share one kernel: its forms through row 5's entry
        fn = functools.partial(kconv.conv3d_fold_s2_on if case.kind == "s2"
                               else kconv.conv3d_fold_p_on, tc)
    if case.row == "conv3d_fold_p" or (tc is not None and case.kind == "p"):
        kernel = lambda: fn(x, w, bias, residual=res, act=act, post_mul=pm)  # noqa: E731
    elif case.row == "conv1x1_fold_p":
        kernel = lambda: fn(x, w, bias, act=act, residual=res)  # noqa: E731
    else:
        kernel = lambda: fn(x, w, bias, act=act)  # noqa: E731
    return kernel, lambda: kconv.conv3d_fold_plain(x, w, bias, op["stride"], res, act, pm)


def tile_plan(case: ConvCase, dev, tc: int = -1) -> dict | None:
    """The tile plan the bf16 kernel takes at the case's shape on
    tensor-core form ``tc`` (-1: its own choice; conv_hopper.cuh;
    ``_build.PLAN_KEYS``): rows 5, 6, 14, 15 (3×3×3 stride 1), 7 and 8;
    row 9 (its stream's plan: ``_build.K1_PLAN_KEYS``); else None (a
    package without plans)."""
    from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
    from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup

    shape = (1, *case.dhw, case.cin)
    if case.kind == "k1" and hasattr(kconv, "k1_plan"):
        return dict(kconv.k1_plan(shape, case.cout, case.residual, dev))
    if case.kind == "p" and hasattr(kconv, "s1_plan"):
        return dict(kconv.s1_plan(shape, case.cout, dev, tc))
    if case.kind == "s2" and hasattr(kconv, "conv3d_fold_s2_on"):
        return dict(kconv.s2_plan(shape, case.cout, dev, tc))
    if case.kind in ("up", "up4") and hasattr(kup, "conv3d_fold_up_on"):
        return dict(kup.up_plan(shape, case.cout, 4 if case.kind == "up4" else 3, dev, tc))
    return None


def plan_line(plan: dict, fill: float) -> str:
    return (f"tile {plan['bh']}×{plan['bmw']} of {plan['positions']} positions ({fill:.3f} of "
            f"the plane's tiles used), {plan['blocks']} blocks × {plan['splits']} K splits, "
            f"{plan['blocks_per_sm']} blocks an SM at {plan['smem_bytes']} B of shared memory, "
            f"{'wgmma' if plan['wgmma'] else 'mma.sync'} at {plan['bn']} channels a tile, "
            f"{plan.get('kh_a_stage', 1)} kh taps a stage")


def forms_of(plans: dict, calls, plain, iters: int) -> dict | None:
    """Both tensor-core forms of one shape (``plans``: "mma" / "wgmma" →
    the plan on that form; ``calls``: form → the kernel call forced to it)
    where the plan has a wgmma form: each against ``plain()`` (bf16
    CONV_TOL) and timed (``device_times``); else None."""
    if plans["wgmma"] is None or not plans["wgmma"]["wgmma"]:
        return None
    want, out = plain(), {}
    for f in ("mma", "wgmma"):
        got = calls[f]()
        torch.cuda.synchronize()
        err = check(f"bfloat16 on {f}", got, want, *CONV_TOL["bfloat16"])
        del got
        out[f] = dict(max_abs_err=err, bn=plans[f]["bn"], smem_bytes=plans[f]["smem_bytes"],
                      blocks_per_sm=plans[f]["blocks_per_sm"], splits=plans[f]["splits"],
                      **device_times(calls[f], iters))
    log(f"  tensor-core forms: mma.sync {out['mma']['ms']:.4f} ms, wgmma "
        f"{out['wgmma']['ms']:.4f} ms on the card")
    return out


def tc_forms(case: ConvCase, dev, op: dict, iters: int) -> dict | None:
    """Rows 5-8, 14, 15 where the plan has a wgmma form: each form checked
    and timed (``forms_of``); else None."""
    plans = {f: tile_plan(case, dev, tc) for f, tc in (("mma", 0), ("wgmma", 1))}
    if plans["wgmma"] is None:  # a package without the plan (an older checkout)
        return None
    return forms_of(plans, {f: case_calls(case, op, tc)[0] for f, tc in (("mma", 0), ("wgmma", 1))},
                    case_calls(case, op)[1], iters)


# float32: the FMA kernel against cuDNN's float32 conv (TF32 off), summation
# order only.  bfloat16: the same float32 sums of the same bf16 products,
# each rounded once: one bf16 ulp (2⁻⁷ relative) at most.
CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -7)}


def conv_checks(dev, cases: list[ConvCase], path: str, iters: int = 20) -> dict:
    """Phase 3, rows 5-9 and 14: the fold-conv kernels at every shape of one
    path (``CONV_CASES``, ``PCW_CONV_CASES``, ``IGEV_CONV_CASES``,
    ``IGEV_SMALL_CASES``), each with the epilogue the path gives it;
    ``iters`` timed launches of the kernel and of the library."""
    import torch.nn.functional as F

    log(f"-- the {path} path's conv shapes")
    rows: dict[str, tuple[dict, list]] = {}
    for i, case in enumerate(cases):
        (d, h, w), cin, cout = case.dhw, case.cin, case.cout
        errs, e = rows.setdefault(case.row, ({}, []))[0], {}
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt).split(".")[1]
            op = case_inputs(case, dev, dt, seed=i)
            kernel, plain = case_calls(case, op)
            if dt == torch.float32:
                o = op["out_dhw"]
                log(f"{case.row} {case.label}: (1,{d},{h},{w},{cin}) → "
                    f"(1,{o[0]},{o[1]},{o[2]},{cout})")
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            e[tag] = check(f"{tag}", got, want, *CONV_TOL[tag])
            errs[tag] = max(errs.get(tag, 0.0), e[tag])
            del got, want
        t = device_times(kernel, iters)
        forms = tc_forms(case, dev, op, iters) if case.kind != "k1" else None
        plain_ms = time_ms(plain, 2)
        # The library: cuDNN on channels-last bf16 operands, with the case's
        # bias (no residual, no ReLU); never called by the port.
        ks, stride = op["ks"], op["stride"]
        x_cl = op["x"].permute(0, 4, 1, 2, 3)
        bias, bias_b = op["bias"], None if op["bias"] is None else op["bias"].bfloat16()
        if case.kind in ("up", "up4"):
            w_lib = op["w"].permute(3, 4, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            op_pad = 1 if case.kind == "up" else 0

            def library():
                return F.conv_transpose3d(x_cl, w_lib, bias_b, stride=2, padding=1,
                                          output_padding=op_pad)
            lib_ref = F.conv_transpose3d(x_cl.float(), w_lib.float(), bias, stride=2,
                                         padding=1, output_padding=op_pad)
        else:
            w_lib = op["w"].permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)

            def library():
                return F.conv3d(x_cl, w_lib, bias_b, stride=stride, padding=(ks - 1) // 2)
            lib_ref = F.conv3d(x_cl.float(), w_lib.float(), bias, stride=stride,
                               padding=(ks - 1) // 2)
        lib_err = float((library().float() - lib_ref).abs().max())
        lib_t = device_times(library, iters)
        conv_lib_ms, linear = lib_t["ms"], None
        if case.kind == "k1":
            # Row 9's function as one matmul: F.linear on the (positions,
            # C_in) view with the bias, the library yardstick of its row;
            # cuDNN's conv beside it.
            x_rows, w_rows = op["x"].view(-1, cin), op["w"].view(cin, cout).t().contiguous()

            def linear():
                return F.linear(x_rows, w_rows, bias_b)
            ref_rows = lib_ref.permute(0, 2, 3, 4, 1).reshape(-1, cout)
            linear = dict(max_abs_vs_f32=float((linear().float() - ref_rows).abs().max()),
                          **device_times(linear, iters))
            lib_t = linear
            log(f"  library F.linear {linear['ms']:.4f} ms on the card [max |Δ| to the float32 "
                f"conv {linear['max_abs_vs_f32']:.2e}], F.conv3d {conv_lib_ms:.4f} ms")
        # The bound counts the function the path needs: the real channels,
        # not the slot's zero fill.  A transposed conv's output takes 27/8
        # taps on average (k3) or 8 (k4).
        o = op["out_dhw"]
        out_vox, in_vox = o[0] * o[1] * o[2], d * h * w
        cin_f, cout_f = case.real_cin or cin, case.real_cout or cout
        taps = {"up": 27 / 8, "up4": 8}.get(case.kind, ks ** 3)
        macs = out_vox * taps * cin_f * cout_f
        nbytes = (in_vox * cin_f + ks ** 3 * cin_f * cout_f
                  + out_vox * cout_f * (2 if case.residual else 1)) * 2
        nbytes += cout_f * 4 if case.bias else 0
        nbytes += o[1] * o[2] * cout_f * 2 if case.post_mul else 0
        b_ms, by = bound(nbytes, 2 * macs, BF16_TC_OPS_PER_S)
        log(f"  bf16 {t['ms']:.4f} ms on the card ({t['events_ms']:.4f} under CUDA events, "
            f"{t['host_us']:.1f} µs of host to issue a call; plain {plain_ms:.4f}, library "
            f"{lib_t['ms']:.4f} ms [max |Δ| to its float32 {lib_err:.2e}], bound {b_ms:.4f} ms "
            f"by {by}); {case.per_pair} per pair")
        plan = tile_plan(case, dev)
        if plan is not None and case.kind == "k1":
            log(f"  {plan['tiles']} tiles of {plan['positions']} positions on {plan['blocks']} "
                f"blocks ({plan['blocks_per_sm']} an SM at {plan['smem_bytes']} B of shared "
                f"memory), {plan['stages']} stages, {plan['bn']} channels a tile")
        elif plan is not None:
            o_hw = o[1] * o[2] if case.kind in ("s2", "p") else h * w
            plan["fill"] = o_hw / (plan["nth"] * plan["ntw"] * plan["positions"])
            log("  " + plan_line(plan, plan["fill"]))
        rows[case.row][1].append(dict(
            plan=plan, tc_forms=forms, events_ms=t["events_ms"],
            host_us=t["host_us"], library_events_ms=lib_t["events_ms"],
            label=case.label, cin=cin, real_cin=cin_f, cout=cout, real_cout=cout_f,
            in_dhw=[d, h, w], kind=case.kind, out_dhw=list(o), residual=case.residual,
            act=case.act, post_mul=case.post_mul, bias=case.bias,
            per_pair=case.per_pair, errs=e, ms=t["ms"], plain_ms=plain_ms,
            library_ms=lib_t["ms"], library_conv_ms=conv_lib_ms, library_linear=linear,
            library_max_abs_vs_f32=lib_err, bound_ms=b_ms, bound_by=by,
            ops_ms=2 * macs / BF16_TC_OPS_PER_S * 1e3, macs=macs, bytes=nbytes))
        del op, x_cl, w_lib, lib_ref
    cases = [c for _, rec in rows.values() for c in rec]
    totals = {k: sum(c[k] * c["per_pair"] for c in cases)
              for k in ("ms", "events_ms", "bound_ms", "library_ms", "plain_ms")}
    log(f"  one {path} pair's conv launches: kernels {totals['ms']:.2f} ms on the card "
        f"({totals['events_ms']:.2f} under CUDA events), bound "
        f"{totals['bound_ms']:.2f} ms, library {totals['library_ms']:.2f} ms, plain "
        f"{totals['plain_ms']:.2f} ms")
    by_row = {}
    for row, (_, rec) in rows.items():
        by_row[row] = {k: sum(c[k] * c["per_pair"] for c in rec)
                       for k in ("ms", "events_ms", "bound_ms", "library_ms")}
        by_row[row]["host_us"] = sum(c["host_us"] * c["per_pair"] for c in rec)
        log(f"    {row}: {by_row[row]['ms']:.4f} ms a pair on the card "
            f"({by_row[row]['events_ms']:.4f} under CUDA events; library "
            f"{by_row[row]['library_ms']:.4f}, bound {by_row[row]['bound_ms']:.4f}; host "
            f"{by_row[row]['host_us']:.0f} µs to issue them)")
    out = {row: mixed(rec, errs) for row, (errs, rec) in rows.items()}
    out["conv_pair_totals_ms"] = totals
    out["pair_ms_by_row"] = by_row
    return out


def layout_plan_line(plan: dict | None) -> str:
    """Rows 11-12's transpose plan as phase 3 prints it ('' for none)."""
    if plan is None:
        return ""
    form = (f"16-byte {plan['lr']}×8 lanes a tile column" if plan["vec"]
            else "element tiles (a stride or pointer leaves a partial vector)")
    return (f"; {form}, {plan['tiles']} warp tiles on {plan['blocks']} blocks of "
            f"{plan['threads']} ({plan['blocks_per_sm']} an SM)")


# Rows 11-12 at the ACV folded path's shape: (label, C, c_slot, (D, H, W), a
# pair): the hourglass bottleneck around the attention block (one of each
# per hourglass).  The patch volume is built in its slot (row 16).
LAYOUT_CASES = [("128, quarter", 128, 128, QUARTER, 14)]
# Row 11 at the PCW folded refinement's input: its 146 channels (a ragged
# last 8 × 8 block) into the zero-filled 160 slot at D = 1, once per
# refinement.
REFINE_PACK_CASES = [("PCW refinement input, 146 in 160", 146, 160, (1, PCW_H, PCW_W),
                      1 + PCW_STEPS)]


def layout_checks(dev) -> dict:
    """Phase 3, rows 11-12: pack (NCDHW → NDHWC, slot fill) and unpack, exact
    in float32 and bf16; bf16 timed on the card (``device_times``) beside the
    library copy, with the transpose's plan.  ``pack`` and ``unpack`` at
    the ACV path's ``LAYOUT_CASES``; ``pcw_refine_pack`` the PCW
    refinement's input (``REFINE_PACK_CASES``)."""
    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    g = torch.Generator().manual_seed(4)
    out = {}
    for key, name, cases in (("pack", "pack", LAYOUT_CASES), ("unpack", "unpack", LAYOUT_CASES),
                             ("pcw_refine_pack", "pack", REFINE_PACK_CASES)):
        errs, rec = {}, []
        for label, c, c_slot, (d, h, w), per_pair in cases:
            log(f"{name} {label}: C {c}, (D,H,W) ({d},{h},{w})")
            s = d * h * w
            x32 = torch.randn((1, c, d, h, w) if name == "pack" else (1, d, h, w, c),
                              generator=g).to(dev)
            fn = (lambda x: kl.pack(x, c_slot)) if name == "pack" else kl.unpack
            ref = (lambda x: kl.pack_plain(x, c_slot)) if name == "pack" else kl.unpack_plain
            for dt in (torch.float32, torch.bfloat16):
                tag = str(dt).split(".")[1]
                got, want = fn(x32.to(dt)), ref(x32.to(dt))
                torch.cuda.synchronize()
                errs[tag] = max(errs.get(tag, 0.0), check(tag, got, want, 0.0, 0.0))
            xb = x32.bfloat16()
            if name == "pack":  # no slot fill in the library copy
                def library():
                    return xb.contiguous(memory_format=torch.channels_last_3d)
                mnl = (c, s, c_slot)
            else:
                def library():
                    return xb.permute(0, 4, 1, 2, 3).contiguous()
                mnl = (s, c, s)
            nbytes = (c + c_slot) * s * 2
            b_ms, _ = bound(nbytes, 0)
            t = device_times(lambda: fn(xb), 50)
            lib = device_times(library, 50)
            plan = kl.transpose_plan(1, *mnl, torch.bfloat16, dev)
            rec.append(dict(label=label, c=c, c_slot=c_slot, dhw=[d, h, w], per_pair=per_pair,
                            **t, plain_ms=time_ms(lambda: ref(xb), 10),
                            library_ms=lib["ms"], library_events_ms=lib["events_ms"],
                            bound_ms=b_ms, ops_ms=0.0, plan=plan))
            r = rec[-1]
            log(f"  bf16 {on_card(t)}; plain {r['plain_ms']:.4f}, library {on_card(lib)}, "
                f"bound {b_ms:.4f} ms by bytes; {per_pair} per pair{layout_plan_line(plan)}")
        out[key] = mixed(rec, errs)
    return out


def flat_plan(c: RefineCase, dev, tc: int = -1) -> dict | None:
    """Row 18's tile plan at a refinement conv on tensor-core form ``tc``,
    or None for a package without plans."""
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    if not hasattr(k2, "flat_plan"):
        return None
    return dict(k2.flat_plan((1, PCW_H, PCW_W, c.cin), c.cout, c.dil, dev, tc))


def refine_checks(dev, iters: int = 10) -> dict:
    """Phase 3, row 18: ``conv2d_flat`` at each of the folded refinement's
    11 convs at 384×1248, float32 and bfloat16 against ``conv2d_flat_plain``
    (``CONV_TOL``), bare and with a residual and Mish in the epilogue; the
    kernel's and the library's time on the card
    (``device_times``: torch.profiler, with CUDA events and the host's time
    to issue a call beside; the library is bf16 ``F.conv2d`` with the bias,
    dilated, channels-last, on the same slot input), the plain version's
    (events), the tile plan and, where it has a wgmma form, both forms; the
    bound (2·9·C_in·C_out·H·W operations on the real channels at the bf16
    tensor-core rate, against the bytes)."""
    import torch.nn.functional as F

    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    log(f"-- the flat refinement's 2-D convs at {PCW_H}×{PCW_W}")
    g = torch.Generator(device=dev).manual_seed(9)
    hw = PCW_H * PCW_W
    cases, errs = [], {}
    for c in REFINE_CASES:
        x32 = torch.randn((1, PCW_H, PCW_W, c.cin), generator=g, device=dev)
        w32 = torch.randn((3, 3, c.cin, c.cout), generator=g, device=dev) / (9 * c.real_cin) ** 0.5
        x32[..., c.real_cin:] = 0.0
        w32[:, :, c.real_cin:] = 0.0
        bias = torch.randn((c.cout,), generator=g, device=dev) * 0.1 if c.bias else None
        log(f"conv2d_flat {c.label}: (1,{PCW_H},{PCW_W},{c.cin}) → (1,{PCW_H},{PCW_W},{c.cout}), "
            f"dilation {c.dil}")
        e = {}
        for dt in (torch.float32, torch.bfloat16):
            tag = dtype_tag(dt)
            x, w = x32.to(dt), w32.to(dt)
            got, want = k2.conv2d_flat(x, w, bias, c.dil), k2.conv2d_flat_plain(x, w, bias, c.dil)
            torch.cuda.synchronize()
            e[tag] = check(tag, got, want, *CONV_TOL[tag])
            errs[tag] = max(errs.get(tag, 0.0), e[tag])
            res = (want.float() * 0.5).to(dt)
            got = k2.conv2d_flat(x, w, bias, c.dil, residual=res, act="mish")
            want = k2.conv2d_flat_plain(x, w, bias, c.dil, residual=res, act="mish")
            torch.cuda.synchronize()
            e[f"{tag}_res_mish"] = check(f"{tag} + residual, Mish", got, want, *CONV_TOL[tag])
            errs[tag] = max(errs[tag], e[f"{tag}_res_mish"])
            del got, want, res
        xb, wb = x32.bfloat16(), w32.bfloat16()
        del x32, w32
        x_cl = xb.permute(0, 3, 1, 2)
        w_lib = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bias_b = None if bias is None else bias.bfloat16()

        def library():
            return F.conv2d(x_cl, w_lib, bias_b, padding=c.dil, dilation=c.dil)
        lib_err = float((library().permute(0, 2, 3, 1).float()
                         - k2.conv2d_flat_plain(xb, wb, bias, c.dil).float()).abs().max())
        macs = hw * 9 * c.real_cin * c.cout
        nbytes = (hw * c.real_cin + 9 * c.real_cin * c.cout + hw * c.cout) * 2
        nbytes += c.cout * 4 if c.bias else 0
        b_ms, by = bound(nbytes, 2 * macs, BF16_TC_OPS_PER_S)
        t = device_times(lambda: k2.conv2d_flat(xb, wb, bias, c.dil), iters)
        lib_t = device_times(library, iters)
        plan = flat_plan(c, dev)
        forms = None
        if plan is not None:
            plan["fill"] = hw / (plan["nth"] * plan["ntw"] * plan["positions"])
            log("  " + plan_line(plan, plan["fill"]))
            forms = forms_of(
                {f: flat_plan(c, dev, tc) for f, tc in (("mma", 0), ("wgmma", 1))},
                {f: functools.partial(k2.conv2d_flat_on, tc, xb, wb, bias, c.dil)
                 for f, tc in (("mma", 0), ("wgmma", 1))},
                lambda: k2.conv2d_flat_plain(xb, wb, bias, c.dil), iters)
        rec = dict(label=c.label, cin=c.cin, real_cin=c.real_cin, cout=c.cout, dil=c.dil,
                   bias=c.bias, per_pair=c.per_pair, errs=e, plan=plan, tc_forms=forms,
                   ms=t["ms"], events_ms=t["events_ms"], host_us=t["host_us"],
                   plain_ms=time_ms(lambda: k2.conv2d_flat_plain(xb, wb, bias, c.dil), 2),
                   library_ms=lib_t["ms"], library_events_ms=lib_t["events_ms"],
                   library_max_abs_vs_plain=lib_err,
                   bound_ms=b_ms, bound_by=by, ops_ms=2 * macs / BF16_TC_OPS_PER_S * 1e3,
                   macs=macs, bytes=nbytes)
        log(f"  bf16 {rec['ms']:.4f} ms on the card ({t['events_ms']:.4f} under CUDA events, "
            f"{t['host_us']:.1f} µs of host to issue a call; plain {rec['plain_ms']:.4f}, library "
            f"{rec['library_ms']:.4f} ms [max |Δ| to the plain version {lib_err:.2e}], bound "
            f"{b_ms:.4f} ms by {by}); {c.per_pair} per PCW pair")
        cases.append(rec)
        del xb, wb, x_cl, w_lib
    totals = {k: sum(c[k] for c in cases)
              for k in ("ms", "events_ms", "host_us", "bound_ms", "library_ms", "plain_ms")}
    log(f"  one refinement's 11 convs: kernels {totals['ms']:.3f} ms on the card "
        f"({totals['events_ms']:.3f} under CUDA events, {totals['host_us']:.0f} µs of host), "
        f"bound {totals['bound_ms']:.3f} ms, library {totals['library_ms']:.3f} ms, plain "
        f"{totals['plain_ms']:.2f} ms")
    out = mixed(cases, errs)
    out["refinement_totals_ms"] = totals
    return out


def igev_volume_checks(dev) -> dict:
    """Phase 3 at the IGEV path's shapes: row 2 (``igev_gwc_checks``) and
    row 13 (``hwdc_checks``).  Row 16 at the IGEV shape is in
    ``volume_checks``."""
    return {"gwc_volume": igev_gwc_checks(dev), "unpack_hwdc": hwdc_checks(dev)}


def igev_gwc_checks(dev) -> dict:
    """Row 2 at the IGEV module path's shape (8 groups of 12 channels)
    against its plain version in float32 and bf16, bf16 on the card by
    ``device_times``, with its plan."""
    from diffuvolume_tpu_torch.ops import cost_volume as plain
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(6)
    d, h, w = G1
    l32 = torch.randn((1, IGEV_C, h, w), generator=g).to(dev)
    r32 = torch.randn((1, IGEV_C, h, w), generator=g).to(dev)
    lb, rb = l32.bfloat16(), r32.bfloat16()
    pairs_dw = sum(max(w - k, 0) for k in range(d))
    ops = 2 * IGEV_C * h * pairs_dw
    log(f"gwc_volume at IGEV  features 2×(1,{IGEV_C},{h},{w}) → G {IGEV_GROUPS}, D {d}")
    errs = {}
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        tag = dtype_tag(dt)
        got = kg.gwc_volume(l32.to(dt), r32.to(dt), d, IGEV_GROUPS)
        want = plain.build_gwc_volume(l32.to(dt), r32.to(dt), d, IGEV_GROUPS)
        torch.cuda.synchronize()
        errs[tag] = check(tag, got, want, 1e-6, rtol)
        del got, want
    b_ms, by = bound((2 * lb.numel() + d * h * w * IGEV_GROUPS) * 2, ops)
    t = device_times(lambda: kg.gwc_volume(lb, rb, d, IGEV_GROUPS), 20)
    plan = kg.gwc_plan(1, IGEV_C, h, w, IGEV_GROUPS, d, torch.bfloat16, dev)
    rec = dict(label=f"IGEV (1,{IGEV_C},{h},{w}) → D {d}, {IGEV_GROUPS} groups", per_pair=2,
               errs=errs, **t,
               plain_ms=time_ms(lambda: plain.build_gwc_volume(lb, rb, d, IGEV_GROUPS), 2),
               library_ms=None, bound_ms=b_ms, bound_by=by, ops_ms=ops / F32_OPS_PER_S * 1e3,
               plan=plan)
    log(f"  bf16 {on_card(t)} (plain {rec['plain_ms']:.4f}, bound {b_ms:.4f} ms by "
        f"{by}); 2 per IGEV module pair{gwc_plan_line(plan)}")
    return mixed([rec], errs)


def hwdc_checks(dev) -> dict:
    """Phase 3, row 13 at the IGEV folded path's two shapes (the GEV's 8 of
    16 channels, the classifier's 1-channel cost, each 2 a pair), exact in
    float32 and bf16; bf16 timed on the card (``device_times``) beside the
    library's permute and copy."""
    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    g = torch.Generator().manual_seed(7)
    d, h, w = G1
    cases, errs = [], {}
    for label, c_slot, co in (("GEV: 8 of 16 channels", IGEV_SLOT, 8),
                              ("classifier cost: 1 channel", 1, 1)):
        log(f"unpack_hwdc {label}  (1,{d},{h},{w},{c_slot}) → (1,{h},{w},{d}·{co})")
        x32 = torch.randn((1, d, h, w, c_slot), generator=g).to(dev)
        e = {}
        for dt in (torch.float32, torch.bfloat16):
            tag = dtype_tag(dt)
            got, want = kl.unpack_hwdc(x32.to(dt), co), kl.unpack_hwdc_plain(x32.to(dt), co)
            torch.cuda.synchronize()
            e[tag] = check(tag, got, want, 0.0, 0.0)
            errs[tag] = max(errs.get(tag, 0.0), e[tag])
        xb = x32.bfloat16()

        def library():
            return xb[..., :co].permute(0, 2, 3, 1, 4).contiguous()
        b_ms, by = bound(2 * d * h * w * co * 2, 0)
        t = device_times(lambda: kl.unpack_hwdc(xb, co), 50)
        lib = device_times(library, 50)
        rec = dict(label=label, c_slot=c_slot, co=co, dhw=[d, h, w], per_pair=2, errs=e, **t,
                   plain_ms=time_ms(lambda: kl.unpack_hwdc_plain(xb, co), 10),
                   library_ms=lib["ms"], library_events_ms=lib["events_ms"], bound_ms=b_ms,
                   bound_by=by, ops_ms=0.0)
        log(f"  bf16 {on_card(t)}; plain {rec['plain_ms']:.4f}, library permute + contiguous "
            f"{on_card(lib)}, bound {b_ms:.4f} ms by bytes; 2 per IGEV folded pair")
        cases.append(rec)
    return mixed(cases, errs)


# A sampler decision may flip between the card and the CPU where its
# statistic lies at its threshold: at most FLIP_SHARE of the pixels, each
# flipped pixel's statistic (a disparity gap or an uncertainty, in px) within
# FLIP_PX of the threshold on both runs.  Set from the flips measured on an
# H100 (the same in every run): ACV's step-0 renewal gap reads 0.9773 on the
# CPU and 1.0191–1.0209 on the card at a threshold of 1 (at most 0.023 px
# from it), on 7 (folded), 3 (module) and 4 (routed) of 2048 px, at most
# 0.34%; IGEV's 32-iteration run flips one clamp decision at 2.99948 / 3.00007
# px (1 of 12288 px); PCW none.  FLIP_PX is twice the largest distance,
# FLIP_SHARE 1.5 times the largest share.  ACV's gap is the floor of float32
# summation order in its attention chain, amplified by the random network
# (tools/stage_dump.py; PERF.md §6).
FLIP_SHARE, FLIP_PX = 5e-3, 0.05


def decision_flips(cpu_dec: list, card_dec: list):
    """Compare the two runs' sampler decisions (``ddim_sample(...,
    return_masks=True)``): ``(agreed (B,H,W) bool, flips, unexplained)``,
    the pixels whose every decision agrees at every step, one record per
    decision that flipped somewhere, and the count of flipped pixels whose
    statistic is not within ``FLIP_PX`` of the threshold on both runs."""
    agreed, flips, unexplained = None, [], 0
    for i, (dc, dg) in enumerate(zip(cpu_dec, card_dec)):
        for key, (sc, tau) in dc.items():
            sc, sg = sc.float().cpu(), dg[key][0].float().cpu()
            if agreed is None:
                agreed = torch.ones_like(sc, dtype=torch.bool)
            flip = (sc < tau) != (sg < tau)
            if not flip.any():
                continue
            near = ((sc - tau).abs() <= FLIP_PX) & ((sg - tau).abs() <= FLIP_PX)
            unexplained += int((flip & ~near).sum())
            agreed &= ~flip
            flips.append(dict(step=i, decision=key, threshold=tau, pixels=int(flip.sum()),
                              cpu=sc[flip][:8].tolist(), card=sg[flip][:8].tolist()))
    return agreed, flips, unexplained


def agree(name: str, cpu_run, card_run) -> dict:
    """One pipeline on the card against the CPU: the bounds the CPU parity
    tests calibrated against the JAX package (tests/test_torch_pipeline.py),
    1e-2 px on the baseline, 0.1 px max and 5e-3 px mean on the output.
    Each run returns ``(final, baseline, decisions)``.  Where the sampler's
    decisions agree at every step the output bounds hold over every pixel.
    Where they differ on at most ``FLIP_SHARE`` of the pixels, each flipped
    pixel's statistic within ``FLIP_PX`` of its threshold on both runs,
    the bounds hold over the pixels whose decisions agree and the flips are
    printed; any other difference fails."""
    cpu_final, cpu_base, cpu_dec = cpu_run()
    final, base, dec = card_run()
    torch.cuda.synchronize()
    agreed, flips, unexplained = decision_flips(cpu_dec, dec)
    n_flip = int((~agreed).sum())
    e_base = (base.cpu() - cpu_base).abs()
    e_final = (final.cpu() - cpu_final).abs()[agreed]
    res = dict(baseline_max=float(e_base.max()), final_max=float(e_final.max()),
               final_mean=float(e_final.mean()), flipped_pixels=n_flip,
               flipped_share=n_flip / agreed.numel(), flips=flips,
               unexplained_flips=unexplained)
    over = "every pixel" if not n_flip else f"the {int(agreed.sum())} pixels whose decisions agree"
    log(f"  {name}: baseline max |Δ| {res['baseline_max']:.3e} px (tol 1e-2); "
        f"final max |Δ| {res['final_max']:.3e} px (tol 0.1), mean "
        f"{res['final_mean']:.3e} px (tol 5e-3), over {over}")
    for f in flips:
        log(f"    flipped: step {f['step']} {f['decision']} < {f['threshold']:g} at "
            f"{f['pixels']} px; statistic CPU {f['cpu']}, card {f['card']}")
    if n_flip and (res["flipped_share"] > FLIP_SHARE or unexplained):
        raise AssertionError(f"the {name} pipeline's sampler decisions differ on {n_flip} px, "
                             f"{unexplained} of them away from their threshold")
    if not (res["baseline_max"] < 1e-2 and res["final_max"] < 0.1
            and res["final_mean"] < 5e-3):
        raise AssertionError(f"the {name} pipeline on the card disagrees with the CPU")
    return res


def sampled(prep, fold, bm, dm, left, right, cfg, dev, ns, packed: bool, **prep_kw):
    """A two-pass pipeline as its entry point runs it (the prep, then the
    DDIM loop on the DDIM model's ``denoise``; with ``quirk=True`` among
    ``prep_kw``, IGEV's reference-faithful ``denoise_ref`` and re-encode),
    with the sampler's decisions: ``(final, baseline, decisions)``."""
    from diffuvolume_tpu_torch.diffusion import ddim_sample, make_schedule
    from diffuvolume_tpu_torch.eval.pipeline import float32_exact, sampler_args

    if packed:
        bm, dm = fold(bm), fold(dm)
    lt = torch.as_tensor(left, device=dev, dtype=torch.float32)
    rt = torch.as_tensor(right, device=dev, dtype=torch.float32)
    # The pipelines' own precision for float32 models (no TF32), as the
    # entry points set it.
    with torch.no_grad(), float32_exact(bm, dm):
        base, latent, entry = prep(bm, dm, lt, rt, cfg, packed, **prep_kw)
        final, _, dec = ddim_sample(
            make_schedule(1000, device=dev), cfg, baseline_disp=base, baseline_latent=latent,
            noise_source=ns, return_masks=True,
            **sampler_args(dm, entry, (lt.shape[1], lt.shape[2]), prep_kw.get("quirk", False)))
    return final, base.float(), dec


def small_agreement(dev) -> dict:
    """Phase 4: each pipeline on the card against the CPU, float32, on both
    paths: ACV DDIM-5 at 32×64, max_disp 64; PCW KITTI12 DDIM-3 at 64×64,
    max_disp 192; IGEV KITTI15 DDIM-2 at 64×96, max_disp 64, 2 GRU
    iterations (the sizes of tests/test_torch_pipeline.py,
    tests/test_torch_pcw_pipeline.py and tests/test_torch_igev_pipeline.py);
    gwcnet-g (PCWNet without the concat volume) as PCW.  Also PCW's folded
    path with the flat refinement and each module path after
    ``route_conv3d``; on the card each of those must launch its kernel (row
    18, row 15; gwcnet-g's routed pair as often as
    ``GWCNET_G_PACKED_CASES`` says)."""
    import dataclasses

    from diffuvolume_tpu_torch.models.layers import route_conv3d
    from diffuvolume_tpu_torch.ops.kernels.conv2d import conv2d_flat
    from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import conv3d_packed

    from diffuvolume_tpu_torch.diffusion import DDIMConfig
    from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM, KITTI15_DDIM
    from diffuvolume_tpu_torch.eval.pipeline import acv_prep, igev_prep, pcw_prep
    from diffuvolume_tpu_torch.models.acv_fold import fold_acv
    from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
    from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
    from diffuvolume_tpu_torch.tools.random_weights import (
        calibrate_heads,
        calibrate_igev,
        calibrate_pcw,
        random_igev_pair,
        random_pair,
        random_pcw_pair,
    )

    out = {}
    for seed, model in enumerate(("acv", "pcw", "igev", "gwcnet-g")):
        h, w, md = {"acv": (32, 64, 64), "igev": (64, 96, 64)}.get(model, (64, 64, MAIN_DISP))
        rng = np.random.default_rng(seed)
        if model == "igev":  # RAW images in [0, 255)
            left = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
        else:
            left = rng.standard_normal((1, h, w, 3)).astype(np.float32) * 0.3
        right = np.roll(left, -3, axis=2)
        lt, rt = torch.from_numpy(left), torch.from_numpy(right)
        gen = torch.Generator().manual_seed(0)
        kw = {}
        if model == "acv":
            cfg, prep, fold = DDIMConfig(max_disp=md, num_bins=md // 4), acv_prep, fold_acv
            bm, dm = random_pair(md, gen)
            calibrate_heads(bm, lt, rt, target_std=10.0)
            dm.load_state_dict(bm.state_dict(), strict=False)
        elif model in ("pcw", "gwcnet-g"):
            cfg, prep, fold = KITTI12_DDIM, pcw_prep, fold_pcw
            bm, dm = random_pcw_pair(md, gen, use_concat_volume=model == "pcw")
            calibrate_pcw(bm, lt, rt)
            dm.load_state_dict(bm.state_dict(), strict=False)
        else:
            # Baseline and DDIM model from their own draws, as in
            # tests/test_torch_igev_pipeline.py, so that the DDIM model's
            # disparity lies within the hard clamp's 3 px at some pixels only.
            cfg = dataclasses.replace(KITTI15_DDIM, max_disp=md, num_bins=md // 4)
            prep, fold, kw = igev_prep, fold_igev, dict(iters=2)
            bm, _ = random_igev_pair(md, gen)
            _, dm = random_igev_pair(md, gen)
            calibrate_igev(bm, lt, rt)
            calibrate_igev(dm, lt, rt)
        shape = (1, md // 4, h // 4, w // 4)
        steps = (cfg.sampling_steps, *shape)
        ns = {"z": rng.standard_normal(steps).astype(np.float32),
              "replace": (rng.uniform(size=steps) if cfg.replace_mode == "uniform"
                          else rng.standard_normal(steps)).astype(np.float32)}
        if cfg.init_mode == "noise":
            ns["init"] = rng.standard_normal(shape).astype(np.float32)
        bg, dg = copy.deepcopy(bm).to(dev), copy.deepcopy(dm).to(dev)
        # (label, packed, fold, routed, the kernel the variant must launch)
        variants = [("folded path", True, fold, False, None),
                    ("module path", False, fold, False, None)]
        if model == "pcw":
            variants.append(("folded path, flat refinement", True,
                             lambda m: fold_pcw(m, refine_flat=True), False, conv2d_flat))
        variants.append(("module path, routed 3-D convs", False, fold, True, conv3d_packed))
        for label, packed, fold_fn, routed, kernel in variants:
            cpu_m, card_m = (bm, dm), (bg, dg)
            if routed:
                cpu_m, card_m = ([route_conv3d(copy.deepcopy(m)) for m in ms]
                                 for ms in (cpu_m, card_m))
            before = None if kernel is None else kernel.launches
            name = f"{model} {label}"
            out[name] = agree(
                name,
                lambda: sampled(prep, fold_fn, *cpu_m, left, right, cfg, torch.device("cpu"), ns,
                                packed, **kw),
                lambda: sampled(prep, fold_fn, *card_m, left, right, cfg, dev, ns, packed, **kw))
            if kernel is not None:
                out[name]["launches_on_the_card"] = kernel.launches - before
                if kernel.launches == before:
                    raise AssertionError(f"{name}: {kernel.__name__} was not launched on the card")
                want = routed_launches("gwcnet_g")["conv3d_packed"]
                if routed and model == "gwcnet-g" and kernel.launches - before != want:
                    raise AssertionError(f"{name}: {kernel.launches - before} row-15 launches "
                                         f"a pair, not GWCNET_G_PACKED_CASES' {want}")
    out["igev folded path, 32 GRU iterations"] = igev_iters_agreement(dev)
    return out


# IGEV at its production iteration count (phase 4): W 192, not the other
# IGEV check's 96, because at W 96 the band lookup's exact domain is
# [−1, 2] quarter-res px (models/igev/geometry.py band_exact_domain), below
# the initial disparity's [0, D/4 − 1] = [0, 15]; at W 192 it is [−1, 26].
IGEV_ITERS_HW, IGEV_ITERS_DISP = (64, 192), 64


def igev_iters_agreement(dev) -> dict:
    """Phase 4: IGEV's folded path at 64×192, max_disp 64, 32 GRU iterations
    a rollout, the port on the card against the port on the CPU, float32,
    with ``agree``'s bounds and flip rule.  Both models come from
    ``calibrate_igev_drift`` (no rollout moves a disparity more than 0.5
    quarter-res px); every disparity that enters or leaves a GRU update, on
    both runs, must lie in the band lookup's exact domain."""
    import dataclasses

    from diffuvolume_tpu_torch.diffusion.ddim import KITTI15_DDIM
    from diffuvolume_tpu_torch.eval.pipeline import igev_prep
    from diffuvolume_tpu_torch.models.igev.geometry import band_exact_domain
    from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
    from diffuvolume_tpu_torch.models.igev.model import track_disparity
    from diffuvolume_tpu_torch.tools.random_weights import calibrate_igev_drift, random_igev_pair

    (h, w), md = IGEV_ITERS_HW, IGEV_ITERS_DISP
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    gen = torch.Generator().manual_seed(0)
    bm, _ = random_igev_pair(md, gen)
    _, dm = random_igev_pair(md, gen)
    for m in (bm, dm):
        calibrate_igev_drift(m, lt, rt, iters=IGEV_ITERS)
    cfg = dataclasses.replace(KITTI15_DDIM, max_disp=md, num_bins=md // 4)
    shape = (1, md // 4, h // 4, w // 4)
    steps = (cfg.sampling_steps, *shape)
    ns = {"z": rng.standard_normal(steps).astype(np.float32),
          "replace": (rng.uniform(size=steps) if cfg.replace_mode == "uniform"
                      else rng.standard_normal(steps)).astype(np.float32)}
    if cfg.init_mode == "noise":
        ns["init"] = rng.standard_normal(shape).astype(np.float32)
    lo, hi = band_exact_domain(w // 4, bm.corr_levels)
    bg, dg = copy.deepcopy(bm).to(dev), copy.deepcopy(dm).to(dev)
    tracks, outputs = {}, {}

    def run(where, ms, on):
        def go():
            with track_disparity(*ms) as track:
                final, base, dec = sampled(igev_prep, fold_igev, *ms, left, right, cfg, on, ns,
                                           True, iters=IGEV_ITERS)
            tracks[where], outputs[where] = track, final
            return final, base, dec
        return go

    name = "igev folded path, 32 GRU iterations"
    res = agree(name, run("cpu", (bm, dm), torch.device("cpu")), run("card", (bg, dg), dev))
    for where, t in tracks.items():
        out = outputs[where]
        res[f"{where}_disparity_range_quarter_px"] = [t.lo, t.hi]
        res[f"{where}_output_range_px"] = [float(out.min()), float(out.max())]
        log(f"    {where}: {t.updates} GRU updates, quarter-res disparity in [{t.lo:.4f}, "
            f"{t.hi:.4f}] (the band's exact domain [{lo:g}, {hi:g}]); output in "
            f"[{float(out.min()):.4f}, {float(out.max()):.4f}] px")
        if not (lo <= t.lo and t.hi <= hi) or t.updates != (1 + cfg.sampling_steps) * IGEV_ITERS:
            raise AssertionError(f"{name}: the {where} run left the band's exact domain "
                                 f"[{lo}, {hi}]: [{t.lo}, {t.hi}] over {t.updates} updates")
    res["exact_domain_quarter_px"] = [lo, hi]
    return res


def routed_launches(model: str) -> dict:
    """Row 15's launches per pair on a module path after ``route_conv3d``:
    ``PACKED_CASES[model]`` (``"gwcnet_g"``: ``GWCNET_G_PACKED_CASES``)."""
    cases = GWCNET_G_PACKED_CASES if model == "gwcnet_g" else PACKED_CASES[model]
    return {"conv3d_packed": sum(c.per_pair for c in cases)}


def expected_launches(packed: bool, routed: bool = False) -> dict:
    """ACV launches per pair: 6 aggregation passes (baseline + 5 DDIM steps)
    and 2 attention chains (baseline + DDIM prep).  The convs are
    ``CONV_CASES``; an aggregation pass has 2 pack + 2 unpack, an attention
    chain 2 pack + 1 unpack and, on the folded path, its GWC volume in the
    slot and its 2 patch stencils in one launch (the module path builds the
    NCDHW volume).  A routed module path adds ``routed_launches``."""
    out = {"fused_head": 6, "concat_volume": 2, "dhw_mul": STEPS,
           "gwc_volume": 0 if packed else 2}
    folded = {"pack": 14, "unpack": 14, "gwc_volume_packed": 2, "depthwise_hw_p": 0,
              "depthwise_hw_p2": 2}
    for case in CONV_CASES:
        folded[case.row] = folded.get(case.row, 0) + case.per_pair
    out.update({k: (v if packed else 0) for k, v in folded.items()})
    if routed:
        out.update(routed_launches("acv"))
    return out


def pcw_conv_cases(concat: bool = True) -> list:
    """One PCW pair's folded convs: ``PCW_CONV_CASES``; without the concat
    volume (gwcnet-g) the same with its volume convs on the 48 slot
    (``GWCNET_G_CONV_CASES``)."""
    return PCW_CONV_CASES if concat else PCW_SHARED_CONV_CASES + GWCNET_G_CONV_CASES


def pcw_expected_launches(packed: bool, refine_flat: bool = False, routed: bool = False,
                          concat: bool = True) -> dict:
    """PCW launches per pair: 2 volume builds (4 scales each, on both paths),
    4 aggregation passes (one fused head each, and with the flat refinement
    the 11 convs of ``REFINE_CASES``, the 3 downsamples on row 9 and the
    input's pack on row 11 each), 3 DDIM steps (the noise multiply and the
    uncertainty at the refined disparity); the folded path's convs are
    ``pcw_conv_cases(concat)``.  A routed module path adds
    ``routed_launches``.  ``concat=False``: gwcnet-g and its DDIM model,
    PCWNet without the concat volume."""
    out = {"gwc_volume_packed": 8, "fused_head": 4, "fused_uncertainty_at": PCW_STEPS,
           "dhw_mul": PCW_STEPS}
    for case in pcw_conv_cases(concat):
        out[case.row] = out.get(case.row, 0) + (case.per_pair if packed else 0)
    if refine_flat:
        out["conv2d_flat"] = sum(c.per_pair for c in REFINE_CASES)
        out["conv1x1_fold_p"] = out.get("conv1x1_fold_p", 0) + sum(
            c.per_pair for c in REFINE_DOWN_CASES)
        out["pack"] = sum(c[-1] for c in REFINE_PACK_CASES)
    if routed:
        out.update(routed_launches("pcw" if concat else "gwcnet_g"))
    return out


def igev_expected_launches(packed: bool, routed: bool = False) -> dict:
    """IGEV launches per pair: 2 encodes (baseline + DDIM prep).  Folded:
    each encode's GEV tower is one 8-group volume in its slot, the convs of
    ``IGEV_CONV_CASES`` and 2 unpacks (the GEV, the cost).  Module: the
    NCDHW volume and the small-channel convs of ``IGEV_SMALL_CASES``.  The
    GRU rollouts (96 iterations a pair) launch none of the port's kernels.  A
    routed module path adds ``routed_launches``."""
    if not packed:
        out = {"gwc_volume": 2}
        for case in IGEV_SMALL_CASES:
            out[case.row] = out.get(case.row, 0) + case.per_pair
        if routed:
            out.update(routed_launches("igev"))
        return out
    out = {"gwc_volume_packed": 2, "unpack_hwdc": 4}
    for case in IGEV_CONV_CASES:
        out[case.row] = out.get(case.row, 0) + case.per_pair
    return out


def op_census(fn) -> dict:
    """The BatchNorm and convolution ATen calls ``fn`` makes on 5-D (3-D
    conv) and 4-D (2-D conv) tensors, and its 5-D copies (``clone`` or
    ``copy_``: a permuted volume made contiguous, among others)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {"batch_norm_5d": 0, "conv_5d": {}, "batch_norm_4d": 0, "conv_4d": 0, "copy_5d": 0}

    class Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__
            x = args[0] if args and isinstance(args[0], torch.Tensor) else None
            if x is not None and x.dim() == 5:
                if "batch_norm" in name:
                    seen["batch_norm_5d"] += 1
                elif name.startswith("convolution"):
                    transposed, groups = args[6], args[8]
                    kind = ("transposed" if transposed else
                            "depthwise" if groups == x.shape[1] else "dense")
                    seen["conv_5d"][kind] = seen["conv_5d"].get(kind, 0) + 1
                elif name.startswith(("clone", "copy_")):
                    seen["copy_5d"] += 1
            elif x is not None and x.dim() == 4:
                if "batch_norm" in name:
                    seen["batch_norm_4d"] += 1
                elif name.startswith("convolution"):
                    seen["conv_4d"] += 1
            return func(*args, **(kwargs or {}))

    with Census():
        fn()
    return seen


def drive(dev, counters, pairs: int, pair, stages, steps: int, expected: dict, packed: bool,
          out_shape: tuple, keep: dict | None = None) -> dict:
    """Drive one path: one warm-up pair, then ``pairs`` timed pairs (each
    ended by a synchronise) with the launch counts set to 0 just before and
    read just after; one more pair split into its prep and its ``steps``
    DDIM steps (``stages() -> (t0, t1, t2)``), and one under the op census.
    Asserts the per-pair launch counts, no 3-D BatchNorm or 3-D conv on the
    folded path, and a finite output of ``out_shape``.  ``keep["final"]``
    and ``keep["base"]`` take the warm-up pair's output and baseline (its
    draws seeded 100) where given."""
    warm = pair(100)  # warm-up
    if keep is not None:
        keep["final"], keep["base"] = (x.float() for x in warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    times = []
    for i in range(pairs):
        t0 = time.perf_counter()
        final, _ = pair(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        t0, t1, t2 = stages()
    census = op_census(lambda: pair(200))

    per_pair = {k: v / pairs for k, v in launches.items()}
    expected = {k: expected.get(k, 0) for k in counters}
    fin = final.float()
    ms_sorted = sorted(t * 1e3 for t in times)
    res = dict(
        pair_s=times, pairs_per_s=pairs / sum(times),
        pair_ms_median=float(np.median(ms_sorted)), pair_ms_min=ms_sorted[0],
        pair_ms_max=ms_sorted[-1], pair_ms_p10=float(np.percentile(ms_sorted, 10)),
        pair_ms_p90=float(np.percentile(ms_sorted, 90)),
        prep_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3 / steps,
        peak_mem_bytes=peak, launches=launches, launches_per_pair=per_pair, census=census,
        out_shape=list(fin.shape), out_min=float(fin.min()), out_max=float(fin.max()),
        finite=bool(torch.isfinite(fin).all()),
    )
    log(f"  {pairs} pairs: {res['pairs_per_s']:.4f} pairs/s (total work over total "
        f"time); ms per pair median {res['pair_ms_median']:.2f}, p10 {res['pair_ms_p10']:.2f}, "
        f"p90 {res['pair_ms_p90']:.2f}, min {res['pair_ms_min']:.2f}, "
        f"max {res['pair_ms_max']:.2f}")
    log(f"  prep {res['prep_ms']:.1f} ms, per DDIM step {res['step_ms']:.1f} ms, "
        f"peak memory {peak / 2**30:.3f} GiB")
    log(f"  launches per pair: {per_pair}")
    log(f"  expected:          {expected}")
    log(f"  op census of one pair: {census}")
    log(f"  output {tuple(fin.shape)} in [{res['out_min']:.3f}, {res['out_max']:.3f}], "
        f"finite={res['finite']}")
    if per_pair != expected:
        raise AssertionError(f"launch counts {per_pair} != {expected}")
    if packed and (census["batch_norm_5d"] or census["conv_5d"]):
        raise AssertionError(f"the folded path ran a 3-D BatchNorm or a 3-D conv: {census}")
    if not (res["finite"] and tuple(fin.shape) == out_shape):
        raise AssertionError(f"the output is not a finite {out_shape} map")
    return res


def main_path(dev, counters, packed: bool, pairs: int, routed: bool = False) -> dict:
    """Phases 5 and 6: ACV two-pass DDIM-5 at 512×960, bfloat16 model; the
    module path after ``route_conv3d`` when ``routed``."""
    from diffuvolume_tpu_torch.diffusion import DDIMConfig, ddim_sample, make_schedule
    from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference, acv_prep
    from diffuvolume_tpu_torch.models.acv_fold import fold_acv
    from diffuvolume_tpu_torch.models.layers import route_conv3d
    from diffuvolume_tpu_torch.tools.random_weights import seeded_main_path

    bm, dm, left, right = seeded_main_path(dev, MAIN_H, MAIN_W, MAIN_DISP)
    if packed:  # folded once, as a caller running many pairs does
        bm, dm = fold_acv(bm), fold_acv(dm)
    elif routed:
        bm, dm = route_conv3d(bm), route_conv3d(dm)
    cfg = DDIMConfig(max_disp=MAIN_DISP, num_bins=D4)

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return acv_ddim_inference(bm, dm, left, right, cfg, device=dev, generator=gen,
                                  packed=packed)

    def stages():
        t0 = time.perf_counter()
        b_disp, b_lat, entry = acv_prep(bm, dm, left, right, cfg, packed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ddim_sample(make_schedule(1000, device=dev), cfg,
                    lambda lat, t: dm.denoise(entry, lat, t, (MAIN_H, MAIN_W)),
                    b_disp, b_lat, generator=torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        return t0, t1, time.perf_counter()

    res = drive(dev, counters, pairs, pair, stages, STEPS, expected_launches(packed, routed),
                packed, (1, MAIN_H, MAIN_W))
    if not (res["out_min"] >= 0.0 and res["out_max"] <= MAIN_DISP - 1):
        raise AssertionError("the ACV output is not in [0, 191]")
    return res


def refine_ops(net) -> dict:
    """The 2-D BatchNorms and convs one module refinement runs (every
    ``BatchNorm2d`` and ``Conv2d`` of ``RefineNetV3``, each once), and its
    3×3 convs: what the flat refinement takes off the census, and its row-18
    launches."""
    import torch.nn as nn

    convs = [m for m in net.modules() if isinstance(m, nn.Conv2d)]
    return {"batch_norm_4d": sum(isinstance(m, nn.BatchNorm2d) for m in net.modules()),
            "conv_4d": len(convs), "conv3x3": sum(m.kernel_size == (3, 3) for m in convs)}


def pcw_path(dev, counters, packed: bool, pairs: int, refine_module: bool = False,
             routed: bool = False, concat: bool = True, keep: dict | None = None) -> dict:
    """Phase 7: PCWNet two-pass KITTI12 DDIM-3 at 384×1248, bfloat16 model;
    folded with the flat refinement (its convs checked against
    ``REFINE_CASES``) unless ``refine_module``, the module path after
    ``route_conv3d`` when ``routed``; without ``concat``, gwcnet-g and its
    DDIM model (PCWNet without the concat volume).  ``keep``: ``drive``'s, and ``keep["inputs"]``
    the unfolded models and the images."""
    from diffuvolume_tpu_torch.diffusion import ddim_sample, make_schedule
    from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM as cfg
    from diffuvolume_tpu_torch.eval.pipeline import pcw_ddim_inference, pcw_prep
    from diffuvolume_tpu_torch.models.layers import route_conv3d
    from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
    from diffuvolume_tpu_torch.tools.random_weights import seeded_pcw_path

    bm, dm, left, right = seeded_pcw_path(dev, PCW_H, PCW_W, MAIN_DISP, use_concat_volume=concat)
    if keep is not None:
        keep["inputs"] = (bm, dm, left, right)
    ops = refine_ops(bm.refinenet3)
    refine_flat = packed and not refine_module
    if packed:  # folded once, as a caller running many pairs does
        bm, dm = (fold_pcw(m, refine_flat=False if refine_module else None) for m in (bm, dm))
    elif routed:
        bm, dm = route_conv3d(bm), route_conv3d(dm)
    if refine_flat:
        fr = dm.refine
        convs = [*fr.convs, *(c for b in fr.blocks for c in (b.conv1, b.conv2)), fr.conv8]
        got = [(c.w.shape[2], c.w.shape[3], c.dil, c.b is not None) for c in convs]
        want = [(c.cin, c.cout, c.dil, c.bias) for c in REFINE_CASES]
        if got != want or len(convs) != ops["conv3x3"]:
            raise AssertionError(f"the folded refinement's convs {got} are not REFINE_CASES")

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return pcw_ddim_inference(bm, dm, left, right, cfg, device=dev, generator=gen,
                                  packed=packed)

    def stages():
        t0 = time.perf_counter()
        b_disp, b_lat, entry = pcw_prep(bm, dm, left, right, cfg, packed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ddim_sample(make_schedule(1000, device=dev), cfg,
                    lambda lat, t: dm.denoise(entry, lat, t, (PCW_H, PCW_W)),
                    b_disp, b_lat, generator=torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        return t0, t1, time.perf_counter()

    res = drive(dev, counters, pairs, pair, stages, PCW_STEPS,
                pcw_expected_launches(packed, refine_flat, routed, concat), packed,
                (1, PCW_H, PCW_W), keep)
    res["refine_ops"] = ops
    return res


def bf16_path_gap(name: str, folded: dict, module: dict) -> dict:
    """The bfloat16 folded and module paths' outputs and baselines of one
    pair (``drive``'s ``keep``: the same models, images and draws), apart:
    max and mean |Δ| px and the share past ``SPLIT_BF16_PX``.  Recorded, not
    held: the two paths round every layer differently (BatchNorm folded
    into bf16 weights against cuDNN's bf16 conv then BatchNorm), and the
    random network amplifies it (``fold_vs_module`` holds the float32 pair)."""
    rec = {}
    for key in ("final", "base"):
        err = (folded[key] - module[key]).abs()
        rec[key] = dict(max_px=float(err.max()), mean_px=float(err.mean()),
                        past_share=float((err > SPLIT_BF16_PX).double().mean()))
    log(f"  {name}, bfloat16, folded against module (recorded): final max |Δ| "
        f"{rec['final']['max_px']:.3e} px, mean {rec['final']['mean_px']:.3e}, "
        f"{rec['final']['past_share']:.2%} past {SPLIT_BF16_PX:g} px; baseline max "
        f"{rec['base']['max_px']:.3e}, mean {rec['base']['mean_px']:.3e}")
    return rec


def fold_vs_module(dev, keep: dict) -> dict:
    """gwcnet-g's folded pair against its module pair at 384×1248 under
    phase 4's flip rule (``agree``'s bounds: 1e-2 px on the baseline, 0.1
    px max and 5e-3 px mean on the output over the pixels whose sampler
    decisions agree, flips only at a threshold), both on the card in
    float32 (the bfloat16 models of phase 7 in float32, the pipelines'
    precision without TF32) with the same injected draws; then the
    bfloat16 runs' gap, recorded (``bf16_path_gap``)."""
    from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM as cfg
    from diffuvolume_tpu_torch.eval.pipeline import pcw_prep
    from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw

    bm, dm, left, right = keep["folded"]["inputs"]
    bm, dm = copy.deepcopy(bm).float(), copy.deepcopy(dm).float()
    rng = np.random.default_rng(16)
    shape = (1, PCW_D4, PCW_H4, PCW_W4)
    steps = (cfg.sampling_steps, *shape)
    ns = {"z": rng.standard_normal(steps).astype(np.float32),
          "replace": (rng.uniform(size=steps) if cfg.replace_mode == "uniform"
                      else rng.standard_normal(steps)).astype(np.float32)}
    if cfg.init_mode == "noise":
        ns["init"] = rng.standard_normal(shape).astype(np.float32)

    def run(packed: bool, on_cpu: bool):
        final, base, dec = sampled(pcw_prep, fold_pcw, bm, dm, left, right, cfg, dev, ns,
                                   packed)
        return (final.cpu(), base.cpu(), dec) if on_cpu else (final, base, dec)

    rec = agree("gwcnet-g 384×1248 float32, folded (as the CPU side) against module",
                lambda: run(True, True), lambda: run(False, False))
    rec["bfloat16"] = bf16_path_gap("gwcnet-g 384×1248", keep["folded"], keep["module"])
    return rec


def igev_path(dev, counters, packed: bool, pairs: int, routed: bool = False,
              quirk: bool = False) -> dict:
    """Phase 8: IGEV-Stereo two-pass KITTI15 DDIM-2 at 384×1248, 32 GRU
    iterations a rollout, bfloat16 model; the module path after
    ``route_conv3d`` when ``routed``.  Phase 11 (a): ``quirk=True``, the
    reference-faithful evaluation, with the same launch counts."""
    from diffuvolume_tpu_torch.diffusion import ddim_sample, make_schedule
    from diffuvolume_tpu_torch.diffusion.ddim import KITTI15_DDIM as cfg
    from diffuvolume_tpu_torch.eval.pipeline import (
        igev_ddim_inference,
        igev_prep,
        sampler_args,
    )
    from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
    from diffuvolume_tpu_torch.models.layers import route_conv3d
    from diffuvolume_tpu_torch.tools.random_weights import seeded_igev_path

    bm, dm, left, right = seeded_igev_path(dev, IGEV_H, IGEV_W, MAIN_DISP)
    if packed:  # folded once, as a caller running many pairs does
        bm, dm = fold_igev(bm), fold_igev(dm)
    elif routed:
        bm, dm = route_conv3d(bm), route_conv3d(dm)

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return igev_ddim_inference(bm, dm, left, right, cfg, device=dev, generator=gen,
                                   packed=packed, iters=IGEV_ITERS, quirk=quirk)

    def stages():
        t0 = time.perf_counter()
        b_disp, b_lat, entry = igev_prep(bm, dm, left, right, cfg, packed, IGEV_ITERS, quirk)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ddim_sample(make_schedule(1000, device=dev), cfg, baseline_disp=b_disp,
                    baseline_latent=b_lat, generator=torch.Generator(device=dev).manual_seed(7),
                    **sampler_args(dm, entry, (IGEV_H, IGEV_W), quirk))
        torch.cuda.synchronize()
        return t0, t1, time.perf_counter()

    return drive(dev, counters, pairs, pair, stages, IGEV_STEPS,
                 igev_expected_launches(packed, routed), packed, (1, IGEV_H, IGEV_W))


# The evaluation entry point (phase 9): a synthetic SceneFlow-layout set of
# EVAL_PAIRS pairs at 540×960, cropped to the main path's 512×960 by
# SceneFlowDataset.TEST_CROP; then tools/bench.py with BENCH_REPS timed pairs.
EVAL_PAIRS, EVAL_H, EVAL_W = 3, 540, 960
BENCH_REPS = 3
METRIC_ATOL = 1e-5


def write_sceneflow(root: str, pairs: int, h: int, w: int, seed: int = 0) -> None:
    """``pairs`` stereo pairs in the SceneFlow test tree's layout under
    ``root`` (frames_finalpass/TEST/…/{left,right}/*.png and
    disparity/TEST/…/left/*.pfm): random RGB images, the right one the left
    shifted 4 px, and a PFM ground truth of 4 px plus noise, a tenth of it
    0 (invalid)."""
    from PIL import Image

    from diffuvolume_tpu_torch.data.readers import write_pfm

    rng = np.random.default_rng(seed)
    scene = os.path.join("TEST", "A", "0000")
    for sub in (("frames_finalpass", "left"), ("frames_finalpass", "right"),
                ("disparity", "left")):
        os.makedirs(os.path.join(root, sub[0], scene, sub[1]), exist_ok=True)
    for k in range(pairs):
        name = f"{6 + k:04d}"
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "frames_finalpass", scene, "left",
                                               name + ".png"))
        Image.fromarray(np.roll(img, -4, axis=1)).save(
            os.path.join(root, "frames_finalpass", scene, "right", name + ".png"))
        disp = 4.0 + rng.uniform(0.0, 0.5, (h, w)).astype(np.float32)
        disp[rng.uniform(size=(h, w)) < 0.1] = 0.0
        write_pfm(os.path.join(root, "disparity", scene, "left", name + ".pfm"), disp)


def evaluate_phase(dev, counters, card: str) -> dict:
    """Phase 9: ``cli/evaluate`` on the card over a synthetic SceneFlow set
    (random weights, ACV DDIM-5, float32, the folded path), its launch
    counts set to 0 just before and read just after (per pair as the main
    path's), finite ``FINAL:`` metrics, and ``metrics_batch`` on the card
    against the same metrics on the CPU from the same disparities (within
    ``METRIC_ATOL``); then ``tools/bench.py --model acv`` in a subprocess,
    its JSON line parsed."""
    import tempfile

    from diffuvolume_tpu_torch.cli import evaluate
    from diffuvolume_tpu_torch.eval.metrics import metrics_batch

    seen = []
    with tempfile.TemporaryDirectory() as root:
        write_sceneflow(root, EVAL_PAIRS, EVAL_H, EVAL_W)
        args = evaluate.parse_args(["--backbone", "acv", "--datapath", root,
                                    "--device", str(dev), "--seed", "0"])
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        result = evaluate.run(args, on_pair=lambda i, final, gt, mask, m: seen.append(
            (final.cpu(), gt.cpu(), mask.cpu(), {k: v.cpu() for k, v in m.items()})))
        wall_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
    per_pair = {k: v / EVAL_PAIRS for k, v in launches.items()}
    expected = {k: expected_launches(packed=True).get(k, 0) for k in counters}
    log(f"  launches per pair: {per_pair}")
    if per_pair != expected:
        raise AssertionError(f"the evaluate CLI's launch counts {per_pair} != {expected}")
    final = result["final"]
    if len(seen) != EVAL_PAIRS or not all(math.isfinite(v) for v in final.values()):
        raise AssertionError(f"FINAL metrics not finite over {EVAL_PAIRS} pairs: {final}")
    worst = 0.0
    for disp, gt, mask, card_m in seen:
        if tuple(disp.shape) != (1, MAIN_H, MAIN_W):
            raise AssertionError(f"the CLI's disparity is {tuple(disp.shape)}")
        cpu_m = metrics_batch(disp, gt, mask)
        for k, v in cpu_m.items():
            worst = max(worst, float((card_m[k] - v).abs().max()))
    log(f"  FINAL {final}; metrics on the card against the CPU: max abs diff {worst:.3e} "
        f"(tol {METRIC_ATOL:g})")
    if worst > METRIC_ATOL:
        raise AssertionError("metrics_batch on the card disagrees with the CPU")
    log(f"  evaluate CLI: {result['pairs_per_s']:.4f} pairs/s (pairs 2-{EVAL_PAIRS}, float32), "
        f"{wall_s:.1f} s with set-up; {card}")

    cmd = [sys.executable, "-m", "diffuvolume_tpu_torch.tools.bench", "--model", "acv",
           "--reps", str(BENCH_REPS)]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"tools/bench.py failed ({proc.returncode}):\n{proc.stderr[-2000:]}")
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    if not (bench["pairs_per_s"] > 0 and math.isfinite(bench["busy_ms_per_pair"])):
        raise AssertionError(f"tools/bench.py printed {bench}")
    log(f"  tools/bench.py --model acv --reps {BENCH_REPS}: {bench['pairs_per_s']:.4f} pairs/s "
        f"(median {bench['pairs_per_s_median']:.4f}, p10 {bench['pairs_per_s_p10']:.4f}, p90 "
        f"{bench['pairs_per_s_p90']:.4f}), busy {bench['busy_ms_per_pair']:.2f} ms a pair, "
        f"idle {bench['idle_share']:.3f}; {bench['card']}")
    return dict(final=final, pairs_per_s=result["pairs_per_s"], wall_s=wall_s,
                metric_max_abs_diff=worst, launches=launches, launches_per_pair=per_pair,
                bench=bench)


# The training phase (10): the card-against-CPU step at the parity tests'
# size, then the recipes through cli/train.py.
TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_DISP = 2, 32, 64, 64
# Card against CPU, the worst tensor's relative L2 (float32: two float32
# runs each within the floor tests/test_torch_train_acv.py measures, 5.4e-3,
# of the float64 gradient; float64: summation order only).
TRAIN_TOL = {"float32": dict(loss=1e-4, grad=3e-2, stat=1e-4, param=1e-2),
             "float64": dict(loss=1e-10, grad=1e-6, stat=1e-8, param=1e-6)}
# A gradient that vanishes in exact arithmetic is rounding: a tensor's
# whole gradient under VANISH of the largest tensor's (a conv's bias before
# a training-mode BatchNorm), or an element under RESOLVE of its tensor's
# RMS (the key third of an attention block's qkv bias: the softmax does
# not see a shift of every key).  Adam's first step moves such an element
# by ±lr at rounding's whim; the parameters after the step are compared
# over the other elements.
VANISH, RESOLVE = 1e-9, 1e-4
# A ReLU whose pre-activation lies within rounding of zero takes its branch
# at rounding's whim, and which float32 rounding the CPU gives depends on
# the host (oneDNN's instruction set: at this step's inputs one element of
# dres2_att_'s decoder sum reads +4.4e-6 under AVX2 and -2.0e-6 under
# AVX-512, -1.3e-6 in float64).  Its gradient passes in one run only and
# every leaf behind it moves (5.4e-2 relative under AVX2 against AVX-512).
# So the CPU step takes the card's branch at an element whose sign differs
# from the card's, if the two pre-activations are at most BRANCH_GAP of the
# site's RMS apart (float32 rounding leaves them within 1.8e-4 at these
# inputs) and at most BRANCH_SHARE of the step's pre-activations flip; any
# other sign difference fails.  The gates above are unchanged.
BRANCH_GAP, BRANCH_SHARE = 1e-3, 1e-5
# The ACV SceneFlow recipe at full width: the training crop, the per-card
# batch (the reference's 23 over 6 GPUs), at least 8 steps.
ACV_TRAIN_BATCH, ACV_TRAIN_STEPS = 4, 8
KITTI_H, KITTI_W = 375, 1242
IGEV_TRAIN_CROP, IGEV_TRAIN_ITERS = (320, 736), 22
OTHER_TRAIN_STEPS = 3
PCWG_TRAIN_STEPS = 2


def grad_refusal_calls(dev) -> dict:
    """Every counted wrapper on float32 CUDA inputs of a shape it takes;
    ``call(track)`` passes its first tensor through ``track``."""
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2
    from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
    from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
    from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
    from diffuvolume_tpu_torch.ops.kernels import fused_head as kf
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg
    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    def r(*shape):
        return torch.randn(shape, device=dev) * 0.1

    def conv(fn, cin, cout, k=3, dhw=(4, 4, 8), **kw):
        return lambda g: fn(g(r(1, *dhw, cin)), r(k, k, k, cin, cout), r(cout), **kw)

    dil = (1,) * 16
    return {
        "fused_head": lambda g: kf.fused_upsample_softargmin(g(r(1, 4, 2, 3)), 8, (4, 6)),
        "fused_uncertainty_at": lambda g: kf.fused_uncertainty_at(g(r(1, 4, 2, 3)), r(1, 4, 6),
                                                                  8, (4, 6)),
        "gwc_volume": lambda g: kg.gwc_volume(g(r(1, 8, 2, 8)), r(1, 8, 2, 8), 4, 4),
        "gwc_volume_packed": lambda g: kg.gwc_volume_packed(g(r(1, 80, 3, 37)), r(1, 80, 3, 37),
                                                            12, 40, 48),
        "concat_volume": lambda g: kc.concat_volume(g(r(1, 4, 2, 8)), r(1, 4, 2, 8), 4),
        "dhw_mul": lambda g: kc.dhw_mul(g(r(1, 4, 4, 2, 8)), r(1, 4, 2, 8), r(1, 4, 2, 8)),
        "conv3d_fold_p": conv(kconv.conv3d_fold_p, 32, 32),
        "conv3d_fold_x2": conv(kconv.conv3d_fold_x2, 64, 32),
        "conv3d_fold_s2": conv(kconv.conv3d_fold_s2, 32, 64),
        "conv1x1_fold_p": conv(kconv.conv1x1_fold_p, 32, 32, k=1),
        "conv3d_fold_small": conv(kconv.conv3d_fold_small, 8, 8),
        "conv3d_packed": conv(kconv.conv3d_packed, 32, 32),
        "conv3d_fold_up": conv(kup.conv3d_fold_up, 32, 32, dhw=(2, 2, 4)),
        "pack": lambda g: kl.pack(g(r(1, 32, 4, 4, 8))),
        "unpack": lambda g: kl.unpack(g(r(1, 4, 4, 8, 32))),
        "unpack_hwdc": lambda g: kl.unpack_hwdc(g(r(1, 4, 4, 8, 16)), 8),
        "depthwise_hw_p": lambda g: kd.depthwise_hw_p(g(r(1, 4, 5, 7, 16)), r(3, 3, 16), dil),
        "depthwise_hw_p2": lambda g: kd.depthwise_hw_p2(g(r(1, 4, 5, 7, 16)), r(3, 3, 16), dil,
                                                        r(3, 3, 16), (2,) * 16),
        "conv2d_flat": lambda g: k2.conv2d_flat(g(r(1, 7, 9, 32)), r(3, 3, 32, 32), r(32)),
    }


def grad_refusals(dev, counters: dict) -> dict:
    """Phase 10 (a): each wrapper raises on a CUDA input that requires grad
    in grad mode (``_build.check_cuda``), and launches on the same input
    under ``torch.no_grad``."""
    calls = grad_refusal_calls(dev)
    if set(calls) != set(counters):
        raise AssertionError(f"refusal calls {sorted(calls)} != wrappers {sorted(counters)}")
    refused = []
    for name, call in calls.items():
        try:
            call(lambda t: t.requires_grad_())
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            refused.append(name)
        else:
            raise AssertionError(f"{name} launched on an input that requires grad")
        with torch.no_grad():
            out = call(lambda t: t.requires_grad_())
        if not all(torch.isfinite(o).all() for o in (out if isinstance(out, tuple) else (out,))):
            raise AssertionError(f"{name} under no_grad gave non-finite values")
    torch.cuda.synchronize()
    log(f"  {len(refused)} wrappers refuse a tracked input in grad mode and launch under "
        f"no_grad: {', '.join(refused)}")
    return {"refused": refused}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


class ReluBranches:
    """The step's ReLU pre-activations in call order: every ``nn.ReLU``
    module's input and each ``HourglassACV`` decoder sum (``conv5(c4) +
    redir2(c2)``, ``conv6(c5) + redir1(x)``).  Without ``card`` it records
    them; given the card run's record it aligns the run to the card's
    branches by the rule at ``BRANCH_GAP``: a flipped element takes the
    card's value through an added constant, so the gradient's path is the
    card's, and each flip is listed."""

    def __init__(self, model, card: list | None = None):
        from diffuvolume_tpu_torch.models.layers import HourglassACV

        self.card, self.seen, self.flips, self.size, self.first = card, [], [], 0, {}
        self.handles = [m.register_forward_pre_hook(functools.partial(self._relu, name))
                        for name, m in model.named_modules() if isinstance(m, torch.nn.ReLU)]
        for name, m in model.named_modules():
            if isinstance(m, HourglassACV):
                for a, b in (("conv5", "redir2"), ("conv6", "redir1")):
                    key = f"{name}.{a}+{b}"
                    self.handles += [
                        getattr(m, a).register_forward_hook(
                            lambda mod, i, o, k=key: self.first.__setitem__(k, o)),
                        getattr(m, b).register_forward_hook(functools.partial(self._sum, key))]

    def _relu(self, name, mod, args):
        x = args[0]
        flip = self._site(name, x)
        if flip is None:
            return None
        ref = self.card[len(self.seen) - 1][1].to(x.device, x.dtype)
        y = x + torch.where(flip, ref - x.detach(), 0.0)
        self._took(name, y, flip)
        return (y,) + args[1:]

    def _sum(self, name, mod, args, o):
        a = self.first.pop(name)
        flip = self._site(name, a + o)
        if flip is None:
            return None
        ref = self.card[len(self.seen) - 1][1].to(o.device, o.dtype)
        o = o + torch.where(flip, (ref - a.detach()) - o.detach(), 0.0)
        self._took(name, a + o, flip)
        return o

    def _site(self, name: str, x: torch.Tensor):
        """Records ``x``, or returns the mask of elements whose sign differs
        from the card's (None where none does)."""
        cur = x.detach().double().cpu()
        self.size += cur.numel()
        if self.card is None:
            self.seen.append((name, cur))
            return None
        seen, ref = self.card[len(self.seen)]
        if seen != name:
            raise AssertionError(f"the CPU step reached {name} where the card's reached {seen}")
        self.seen.append((name, ref))
        flip = (cur > 0) != (ref > 0)
        if not flip.any():
            return None
        rms = float(ref.pow(2).mean().sqrt())
        for ix in flip.nonzero().tolist():
            ix = tuple(ix)
            gap = abs(float(cur[ix] - ref[ix])) / rms
            self.flips.append({"site": name, "at": ix, "card": float(ref[ix]),
                               "cpu": float(cur[ix]), "gap_over_rms": gap})
            if gap > BRANCH_GAP:
                raise AssertionError(f"{name} at {ix}: ReLU input {float(cur[ix])!r} on the CPU, "
                                     f"{float(ref[ix])!r} on the card, {gap:.2e} of its RMS apart")
        return flip.to(x.device)

    def _took(self, name: str, y: torch.Tensor, flip: torch.Tensor) -> None:
        """Asserts that the aligned input ``y`` takes the card's branch."""
        ref = self.seen[-1][1].to(y.device)
        if ((y.detach() > 0) != (ref > 0))[flip].any():
            raise AssertionError(f"{name}: the CPU step could not take the card's ReLU branch")

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


@functools.lru_cache(maxsize=1)
def train_step_inputs():
    """Phase 10 (b)'s seeded source weights (tamed and calibrated as the
    parity tests do), images, ground truth, timestep and noise."""
    from diffuvolume_tpu_torch.tools.random_weights import (calibrate_heads, random_acv,
                                                            tame_residual_branches)

    b, h, w, md = TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_DISP
    g = torch.Generator().manual_seed(5)
    left = torch.randn((b, h, w, 3), generator=g) * 0.3
    right = torch.roll(left, -3, dims=2)
    gt = torch.rand((b, h, w), generator=g) * (md + 8) + 0.5
    gt[:, :, :3] = 0.0
    t = torch.randint(0, 1000, (1,), generator=g).expand(b)
    noise = torch.randn((b, md // 4, h // 4, w // 4), generator=g)
    src = tame_residual_branches(random_acv(md, True, torch.Generator().manual_seed(11)))
    calibrate_heads(src, left, right)
    return src, left, right, gt, t, noise


def train_step_run(where, dtype, card: list | None = None) -> dict:
    """One ACV SceneFlow step (``make_train_step``, Adam) on ``where`` in
    ``dtype`` (float32 without TF32: ``float32_exact``): the loss, the
    gradients, the parameters after Adam, the BatchNorm running statistics
    and the step's ``ReluBranches`` (recorded, or aligned to ``card``)."""
    from diffuvolume_tpu_torch.eval.pipeline import float32_exact
    from diffuvolume_tpu_torch.models.acv import ACVNet
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    src, left, right, gt, t, noise = train_step_inputs()
    model = ACVNet(TRAIN_DISP, True)
    model.load_state_dict(src.state_dict())
    model = model.to(where, dtype).train()
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    batch = {"left": left.to(where, dtype), "right": right.to(where, dtype),
             "disp_gt": gt.to(where, dtype)}
    branches = ReluBranches(model, card)
    with float32_exact(model):
        res = make_train_step(model)(state, batch, t=t.to(where), noise=noise.to(where, dtype))
    branches.remove()
    return {"loss": float(res["loss"]), "branches": branches,
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "params": {k: p.detach() for k, p in model.named_parameters()},
            "stats": {k: v for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def train_step_gaps(card: dict, cpu: dict) -> dict:
    """``card``'s step against ``cpu``'s (``train_step_run``, the CPU's
    aligned to the card's branches): the loss, every gradient (relative L2
    a tensor; a gradient that vanishes in exact arithmetic, under
    ``VANISH`` of the largest on the CPU, must vanish on the card), the
    BatchNorm running statistics and the parameters after Adam (over the
    elements whose gradient ``RESOLVE`` resolves), each the worst tensor's;
    the branches both steps took checked by the rule at ``BRANCH_GAP``."""
    branches = cpu["branches"]
    if len(branches.seen) != len(branches.card):
        raise AssertionError(f"the CPU step passed {len(branches.seen)} ReLU sites, the "
                             f"card's {len(branches.card)}")
    if len(branches.flips) > BRANCH_SHARE * branches.size:
        raise AssertionError(f"{len(branches.flips)} ReLU inputs of {branches.size} take "
                             f"another branch on the card than on the CPU")
    cg, gg = cpu["grads"], card["grads"]
    tiny = VANISH * max(float(g.norm()) for g in cg.values())
    worst = dict(loss=abs(card["loss"] / cpu["loss"] - 1), grad=0.0, stat=0.0, param=0.0)
    names, unresolved = {}, 0
    for k, g in cg.items():
        q = gg[k]
        if not torch.isfinite(q).all():
            raise AssertionError(f"card gradient of {k} is not finite")
        if float(g.norm()) <= tiny:
            if float(q.norm()) > tiny * 1e3:
                raise AssertionError(f"{k}: vanishing on the CPU, {q.norm()} on the card")
            continue
        resolved = g.abs() > RESOLVE * g.pow(2).mean().sqrt()
        unresolved += int((~resolved).sum())
        for key, val in (("grad", rel_l2(q, g)),
                         ("param", rel_l2(card["params"][k].cpu()[resolved],
                                          cpu["params"][k][resolved]))):
            if val > worst[key]:
                worst[key], names[key] = val, k
    for k, v in cpu["stats"].items():
        worst["stat"] = max(worst["stat"], rel_l2(card["stats"][k], v))
    worst["tensors"], worst["unresolved_elements"] = names, unresolved
    worst["relu_inputs"], worst["branch_flips"] = branches.size, branches.flips
    return worst


def train_step_agreement(dev) -> dict:
    """Phase 10 (b): one ACV SceneFlow step on the card against the same
    step on the CPU, at the parity tests' size (B=2, 32×64, max_disp 64),
    float32 and float64 (``train_step_run``, ``train_step_gaps``).  The
    card runs first and records its ReLU branches; the CPU step takes them
    where rounding alone decides (``ReluBranches``), and the flips are
    listed."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        card = train_step_run(dev, dtype)
        worst = train_step_gaps(card, train_step_run("cpu", dtype, card["branches"].seen))
        tag = "float32" if dtype == torch.float32 else "float64"
        tol, flips = TRAIN_TOL[tag], worst["branch_flips"]
        log(f"  ACV train step, card against CPU, {tag}: loss {worst['loss']:.2e} (tol "
            f"{tol['loss']:g}), gradients {worst['grad']:.2e} (tol {tol['grad']:g}), BatchNorm "
            f"statistics {worst['stat']:.2e} (tol {tol['stat']:g}), parameters after Adam "
            f"{worst['param']:.2e} (tol {tol['param']:g}, {worst['unresolved_elements']} "
            f"unresolved elements left out); worst tensor, relative L2 ({worst['tensors']}); "
            f"{len(flips)} of {worst['relu_inputs']} ReLU inputs took the card's branch on the "
            f"CPU ({[(f['site'], f['at'], f['card'], f['cpu']) for f in flips]})")
        if any(worst[k] > tol[k] for k in tol):
            raise AssertionError(f"the {tag} train step on the card disagrees with the CPU")
        out[tag] = worst
    return out


def write_kitti(root: str, pairs: int, h: int, w: int, seed: int = 0) -> str:
    """``pairs`` stereo pairs in the KITTI 2015 layout under ``root``
    (image_2, image_3 PNGs, disp_occ_0 16-bit PNGs of disparity × 256, a
    tenth 0 = invalid), the right image the left shifted 4 px; returns the
    list file's path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    lines = []
    for k in range(pairs):
        name = f"{k:06d}_10.png"
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "training", "image_2", name))
        Image.fromarray(np.roll(img, -4, axis=1)).save(os.path.join(root, "training", "image_3",
                                                                   name))
        disp = 4.0 + rng.uniform(0.0, 0.5, (h, w))
        disp[rng.uniform(size=(h, w)) < 0.1] = 0.0
        Image.fromarray((disp * 256).astype(np.uint16)).save(
            os.path.join(root, "training", "disp_occ_0", name))
        lines.append(" ".join(f"training/{d}/{name}" for d in ("image_2", "image_3",
                                                               "disp_occ_0")))
    path = os.path.join(root, "train.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def calibrated_igev_checkpoint(ckpt_dir: str, trainlist: str, datapath: str, dev) -> None:
    """A checkpoint of a random IGEV-Stereo (``random_igev``, seed 0)
    calibrated by ``calibrate_igev`` on the KITTI15 training set's first
    crop, for ``--init_from``."""
    from diffuvolume_tpu_torch.data.kitti import KITTIDataset
    from diffuvolume_tpu_torch.tools.random_weights import calibrate_igev, random_igev
    from diffuvolume_tpu_torch.train.checkpoint import save_checkpoint

    s = KITTIDataset(datapath, trainlist, training=True, seed=1)[0]
    model = random_igev(MAIN_DISP, True, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        calibrate_igev(model, torch.from_numpy(s["left"])[None].to(dev),
                       torch.from_numpy(s["right"])[None].to(dev))
    save_checkpoint(ckpt_dir, 0, model)


def recipe_run(name: str, argv: list, counters: dict, batch: int, check_every_grad: bool,
               crop: tuple, card: str) -> dict:
    """``cli/train.run`` with ``argv``: the launch counts set to 0 at its
    first step, the device's peak memory from its start; each step's loss
    finite and its time (synchronised); after the first and the last step
    every parameter has a finite gradient; with ``check_every_grad`` none
    is all zeros and every parameter and BatchNorm statistic moved from the
    first step's start, else some of each moved."""
    from diffuvolume_tpu_torch.cli import train as train_cli

    marks, snap, checked = [], {}, []

    def check_grads(state):
        for k, p in state.model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"{name}: {k} has no finite gradient")
            if check_every_grad and not p.grad.abs().sum() > 0:
                raise AssertionError(f"{name}: {k}'s gradient is all zeros")
        checked.append(state.step)

    def on_start(state):
        snap.update({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    steps = []

    def on_step(state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"{name}: step {state.step} loss {loss}")
        steps.append(loss)
        if state.step == 1:
            check_grads(state)

    torch.cuda.reset_peak_memory_stats()
    result = train_cli.run(train_cli.parse_args(argv), on_start=on_start, on_step=on_step)
    state = result["state"]
    check_grads(state)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = {k: not torch.equal(v.detach(), snap[k].to(v.device))
             for k, v in state.model.state_dict().items() if v.is_floating_point()}
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    params = [k for k, _ in state.model.named_parameters()]
    # With check_every_grad every parameter and statistic moves.  Else some
    # may not: IGEV's rollout runs its upsampling BatchNorms frozen, and
    # under the KITTI15 clip a gradient element far below Adam's eps moves
    # its float32 parameter by less than its rounding.
    need = all if check_every_grad else any
    if not need(moved[k] for k in params) or not need(moved[k] for k in stats):
        raise AssertionError(f"{name}: parameters or BatchNorm statistics did not move")
    dts = np.diff(marks) * 1e3
    after = dts[1:] if len(dts) > 1 else dts
    rec = dict(steps=len(steps), losses=steps, step_ms=dts.tolist(),
               step_ms_median=float(np.median(after)), step_ms_p10=float(np.percentile(after, 10)),
               step_ms_p90=float(np.percentile(after, 90)),
               pairs_per_s=batch * len(after) / (after.sum() / 1e3), peak_gib=peak,
               grads_checked_at_steps=checked, params_moved=sum(moved[k] for k in params),
               not_moved=[k for k in params + stats if not moved[k]][:8],
               params=len(params), stats_moved=sum(moved[k] for k in stats), stats=len(stats),
               launches=launches, crop=list(crop), batch=batch, card=card,
               best_d1=result["best_d1"])
    log(f"  {name}: {len(steps)} steps at {crop[0]}×{crop[1]}, batch {batch}; losses "
        f"{', '.join(f'{x:.3f}' for x in steps)}; step {rec['step_ms_median']:.1f} ms median "
        f"(p10 {rec['step_ms_p10']:.1f}, p90 {rec['step_ms_p90']:.1f}; first "
        f"{dts[0]:.1f}) after the first, {rec['pairs_per_s']:.3f} training pairs/s, peak "
        f"{peak:.2f} GiB allocated; {rec['params_moved']}/{len(params)} parameters and "
        f"{rec['stats_moved']}/{len(stats)} BatchNorm statistics moved (not: "
        f"{rec['not_moved']}); {card}")
    return rec


def training_phase(dev, counters: dict, card: str) -> dict:
    """Phase 10: (a) the wrappers refuse tracked inputs; (b) one ACV train
    step on the card against the CPU; (c) ``cli/train.py`` with the ACV
    SceneFlow recipe (``acvnet_ddim``, stage ``full``) over a synthetic
    SceneFlow set of 540×960 pairs, the random 256×512 crop, batch 4,
    float32, ``ACV_TRAIN_STEPS`` steps, then the epoch's DDIM-5 evaluation
    (``--eval_freq 1 --eval_max_images 1``, a random baseline checkpoint)
    on the kernels with phase 5's launch counts for its one pair and no
    launch in the steps; the checkpoint loaded by ``cli/evaluate`` and
    evaluated on the card; (d) the KITTI12 recipe (PCWNet, 256×512, batch
    1) and the KITTI15 recipe (IGEV-Stereo, 320×736, ``--bf16``, 22 GRU
    iterations, batch 1, warm-started from a calibrated random IGEV),
    ``OTHER_TRAIN_STEPS`` steps each, and the KITTI12 recipe with
    ``--model gwcnet-g`` (``PCWG_TRAIN_STEPS`` steps), over a synthetic
    KITTI set."""
    import tempfile

    from diffuvolume_tpu_torch.cli import evaluate
    from diffuvolume_tpu_torch.data.kitti import KITTIDataset
    from diffuvolume_tpu_torch.data.sceneflow import SceneFlowDataset
    from diffuvolume_tpu_torch.tools.random_weights import random_acv
    from diffuvolume_tpu_torch.train.checkpoint import checkpoint_path, latest_step

    out = {"refusals": grad_refusals(dev, counters), "card_vs_cpu": train_step_agreement(dev)}
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        sf_root, kitti_root = os.path.join(root, "sceneflow"), os.path.join(root, "kitti")
        pairs = ACV_TRAIN_BATCH * ACV_TRAIN_STEPS
        write_sceneflow(sf_root, pairs, EVAL_H, EVAL_W)
        base = os.path.join(root, "baseline.ckpt")
        torch.save({"model": random_acv(MAIN_DISP, False, torch.Generator().manual_seed(0))
                    .state_dict()}, base)
        logdir = os.path.join(root, "acv")
        rec = recipe_run("ACV SceneFlow recipe (acvnet_ddim, stage full, float32)", [
            "--datapath", sf_root, "--model", "acvnet_ddim", "--stage", "full",
            "--batch_size", str(ACV_TRAIN_BATCH), "--epochs", "1", "--maxdisp", str(MAIN_DISP),
            "--eval_freq", "1", "--eval_max_images", "1", "--eval_baseline_ckpt", base,
            "--logdir", logdir, "--summary_freq", "100", "--device", str(dev)],
            counters, ACV_TRAIN_BATCH, True, SceneFlowDataset.TRAIN_CROP, card)
        want = {k: expected_launches(packed=True).get(k, 0) for k in counters}
        if rec["launches"] != want:
            raise AssertionError(f"the training run's launches {rec['launches']} != one eval "
                                 f"pair's {want} (the steps launch none)")
        if rec["steps"] < ACV_TRAIN_STEPS or not 0.0 <= rec["best_d1"] <= 1.0:
            raise AssertionError(f"{rec['steps']} steps, epoch eval D1 {rec['best_d1']}")
        log(f"  epoch evaluation: D1 {rec['best_d1']:.4f} on 1 pair; launches {want} "
            f"(phase 5's a pair), none in the steps")
        ckpt = checkpoint_path(logdir, latest_step(logdir))
        loaded = evaluate.load_model(ckpt, "acv", True, MAIN_DISP, 0, dev)
        ev = evaluate.run(evaluate.parse_args([
            "--backbone", "acv", "--datapath", sf_root, "--baseline_ckpt", base, "--ddim_ckpt",
            ckpt, "--maxdisp", str(MAIN_DISP), "--max_images", "1", "--device", str(dev)]))
        if not all(math.isfinite(v) for v in ev["final"].values()):
            raise AssertionError(f"cli/evaluate on the trained checkpoint: {ev['final']}")
        n_params = sum(p.numel() for p in loaded.parameters())
        log(f"  {os.path.basename(ckpt)} loaded by cli/evaluate ({n_params} parameters) and "
            f"evaluated on the card: FINAL {ev['final']}")
        rec["evaluate_final"] = ev["final"]
        runs["acv_sceneflow"] = rec

        trainlist = write_kitti(kitti_root, OTHER_TRAIN_STEPS, KITTI_H, KITTI_W)
        common = ["--datapath", kitti_root, "--trainlist", trainlist, "--batch_size", "1",
                  "--epochs", "1", "--maxdisp", str(MAIN_DISP), "--summary_freq", "100",
                  "--device", str(dev)]
        runs["pcw_kitti12"] = recipe_run("PCW KITTI12 recipe (pcwnet_ddim, float32)", common + [
            "--dataset", "kitti12", "--model", "pcwnet_ddim",
            "--logdir", os.path.join(root, "pcw")], counters, 1, False,
            KITTIDataset.TRAIN_CROP, card)
        g_list = os.path.join(kitti_root, "train_gwcnet_g.txt")
        with open(trainlist) as f, open(g_list, "w") as g:
            g.writelines(f.readlines()[:PCWG_TRAIN_STEPS])
        runs["gwcnet_g_kitti12"] = recipe_run(
            "gwcnet-g KITTI12 recipe (PCWNet without the concat volume, float32)",
            [g_list if a == trainlist else a for a in common] + [
                "--dataset", "kitti12", "--model", "gwcnet-g",
                "--logdir", os.path.join(root, "gwcnet_g")], counters, 1, False,
            KITTIDataset.TRAIN_CROP, card)
        saved = KITTIDataset.TRAIN_CROP
        KITTIDataset.TRAIN_CROP = IGEV_TRAIN_CROP
        try:
            # Warm-started (--init_from) from a random IGEV calibrated on the
            # first training crop: at the initialisation alone the random GRU
            # walks the disparity hundreds of px off, the gradients' global
            # norm overflows float32, and the clip zeroes every update.
            init = os.path.join(root, "igev_init")
            calibrated_igev_checkpoint(init, trainlist, kitti_root, dev)
            runs["igev_kitti15"] = recipe_run(
                "IGEV KITTI15 recipe (igev_ddim, --bf16, 22 GRU iterations)", common + [
                    "--dataset", "kitti15", "--model", "igev_ddim", "--bf16", "--iters",
                    str(IGEV_TRAIN_ITERS), "--lr", "2e-4", "--init_from", init,
                    "--logdir", os.path.join(root, "igev")], counters, 1, False,
                IGEV_TRAIN_CROP, card)
        finally:
            KITTIDataset.TRAIN_CROP = saved
        for key in ("pcw_kitti12", "gwcnet_g_kitti12", "igev_kitti15"):
            if any(runs[key]["launches"].values()):
                raise AssertionError(f"{key}'s steps launched kernels: {runs[key]['launches']}")
    out["recipes"] = runs
    return out


# Phase 11: IGEV's reference-faithful evaluation, data parallelism, the
# training step's profile.
QUIRK_TIMED_PAIRS = 3
BENCH_TRAIN_STEPS = 5
# Phase 11 (c)'s float32 layer check: each BatchNorm's output, statistics and
# gradients through _GlobalBatchNorm against float64, worst relative L2 over
# the layers: some 80 float32 ulps (both forms read 4e-8–4e-7 on the CPU);
# the variance divided by n − 1, or the input rounded to bfloat16, reads
# 1.6e-2 or 2.6e-3 there.
BN_LAYER_TOL = 1e-5


def igev_quirk_agreement(dev) -> dict:
    """Phase 11 (b): IGEV's folded path with ``quirk=True`` at 64×192,
    ``max_disp`` 64, 32 GRU iterations a rollout, the port on the card
    against the port on the CPU, float32, with ``agree``'s bounds and flip
    rule; the models from ``calibrate_igev_drift`` as phase 4's IGEV
    check's."""
    import dataclasses

    from diffuvolume_tpu_torch.diffusion.ddim import KITTI15_DDIM
    from diffuvolume_tpu_torch.eval.pipeline import igev_prep
    from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
    from diffuvolume_tpu_torch.tools.random_weights import calibrate_igev_drift, random_igev_pair

    (h, w), md = IGEV_ITERS_HW, IGEV_ITERS_DISP
    rng = np.random.default_rng(4)
    left = rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
    right = np.roll(left, -3, axis=2)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    gen = torch.Generator().manual_seed(1)
    bm, _ = random_igev_pair(md, gen)
    _, dm = random_igev_pair(md, gen)
    for m in (bm, dm):
        calibrate_igev_drift(m, lt, rt, iters=IGEV_ITERS)
    cfg = dataclasses.replace(KITTI15_DDIM, max_disp=md, num_bins=md // 4)
    shape = (1, md // 4, h // 4, w // 4)
    steps = (cfg.sampling_steps, *shape)
    ns = {"init": rng.standard_normal(shape).astype(np.float32),
          "z": rng.standard_normal(steps).astype(np.float32),
          "replace": rng.standard_normal(steps).astype(np.float32)}
    bg, dg = copy.deepcopy(bm).to(dev), copy.deepcopy(dm).to(dev)
    name = "igev folded path, quirk=True, 32 GRU iterations"
    return agree(name,
                 lambda: sampled(igev_prep, fold_igev, bm, dm, left, right, cfg,
                                 torch.device("cpu"), ns, True, iters=IGEV_ITERS, quirk=True),
                 lambda: sampled(igev_prep, fold_igev, bg, dg, left, right, cfg, dev, ns, True,
                                 iters=IGEV_ITERS, quirk=True))


def decoder_sum_hooks(model, seen: dict) -> list:
    """Forward hooks that keep, into ``seen``, the two terms of each
    ``HourglassACV`` decoder sum (``relu(conv5(c4) + redir2(c2))``,
    ``relu(conv6(c5) + redir1(x))``) and the gradient of the first."""
    from diffuvolume_tpu_torch.models.layers import HourglassACV

    def keep(key, o):
        seen[key] = o.detach().double().cpu()
        if key[1] in ("conv5", "conv6") and o.requires_grad:
            o.register_hook(lambda g: seen.__setitem__(key + ("grad",), g.double().cpu()))

    return [getattr(m, part).register_forward_hook(lambda mod, i, o, k=(name, part): keep(k, o))
            for name, m in model.named_modules() if isinstance(m, HourglassACV)
            for part in ("conv5", "redir2", "conv6", "redir1")]


def relu_flips(sums: dict) -> list:
    """The elements of the hourglasses' decoder sums whose ReLU takes the
    other branch in the DDP float32 step than in the plain one, with both
    pre-activations, the float64 step's, and the gradient there over the
    gradient's RMS."""
    a, d, r = (sums[k] for k in (("plain", torch.float32), ("ddp", torch.float32),
                                 ("plain", torch.float64)))
    flips = []
    for hg in sorted({k[0] for k in a}):
        for first, second in (("conv5", "redir2"), ("conv6", "redir1")):
            pa, pd, pr = (x[hg, first] + x[hg, second] for x in (a, d, r))
            grad = a[hg, first, "grad"]
            rms = float(grad.pow(2).mean().sqrt())
            for ix in ((pa > 0) != (pd > 0)).nonzero().tolist():
                ix = tuple(ix)
                flips.append({"sum": f"{hg} {first}+{second}", "at": ix, "plain": float(pa[ix]),
                              "ddp": float(pd[ix]), "float64": float(pr[ix]),
                              "grad_over_rms": max(abs(float(grad[ix])),
                                                   abs(float(d[hg, first, "grad"][ix]))) / rms})
    return flips


def batch_norm_layer_agreement(bn_inputs: dict, dp) -> dict:
    """Phase 11 (c)'s float32 layer check: each BatchNorm of the step, on the
    input it saw in the plain float32 step and a seeded output gradient,
    through ``_GlobalBatchNorm`` over the group ``dp`` and through PyTorch's
    training BatchNorm (cuDNN), each against the float64 BatchNorm of the
    same input.  The output, the batch mean and biased variance and the
    gradients of the input, weight and bias: ``_GlobalBatchNorm``'s worst
    relative L2 over the layers is held to ``BN_LAYER_TOL``, PyTorch's is
    recorded beside it."""
    import torch.nn.functional as F

    from diffuvolume_tpu_torch.models.layers import _GlobalBatchNorm

    gen = torch.Generator(device=next(iter(bn_inputs.values()))[1].device).manual_seed(9)
    keys = ("y", "mean", "var", "gx", "gw", "gb")
    worst = {"global": dict.fromkeys(keys, 0.0), "torch": dict.fromkeys(keys, 0.0)}
    for name, (m, x) in bn_inputs.items():
        dims = [0, *range(2, x.dim())]
        gy = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        outs = {}
        for form, dtype in (("global", torch.float32), ("torch", torch.float32),
                            ("float64", torch.float64)):
            xi = x.to(dtype).clone().requires_grad_()
            w = m.weight.detach().to(dtype).requires_grad_()
            b = m.bias.detach().to(dtype).requires_grad_()
            if form == "global":
                y, mean, var = _GlobalBatchNorm.apply(xi, w, b, m.eps, dp.sum)
            else:
                y = F.batch_norm(xi, None, None, w, b, True, 0.0, m.eps)
                var, mean = torch.var_mean(xi.detach(), dims, unbiased=False)
            y.backward(gy.to(dtype))
            outs[form] = dict(y=y.detach(), mean=mean.detach(), var=var.detach(), gx=xi.grad,
                              gw=w.grad, gb=b.grad)
        for form in ("global", "torch"):
            for k in keys:
                worst[form][k] = max(worst[form][k], rel_l2(outs[form][k], outs["float64"][k]))
    log(f"  float32 BatchNorm layers ({len(bn_inputs)}, the plain float32 step's inputs) against "
        f"float64, worst relative L2, _GlobalBatchNorm over NCCL / PyTorch's: " + ", ".join(
            f"{k} {worst['global'][k]:.2e} / {worst['torch'][k]:.2e}" for k in keys)
        + f" (tol {BN_LAYER_TOL:g})")
    bad = [k for k in keys if worst["global"][k] > BN_LAYER_TOL]
    if bad:
        raise AssertionError(f"_GlobalBatchNorm in float32 disagrees with float64: {bad}")
    return worst


def ddp_step_agreement(dev) -> dict:
    """Phase 11 (c): one ACV SceneFlow step through ``parallel/ddp.py`` at
    world size 1 over NCCL (BatchNorm over the global batch, the loss's
    count and the gradients summed over the ranks) against the plain step,
    both on the card, at phase 10 (b)'s shapes, weights and draws (the
    ground truth's valid counts unequal by row), without TF32, in float64
    and float32 with phase 10 (b)'s tolerances.  Float64: every quantity of
    the two steps.  Float32: the loss, the statistics and the parameters
    after Adam; the gradients are recorded (worst and median leaf, each
    step's against the float64 step's beside them): a ReLU whose input lies
    within rounding of 0 takes the other branch in one step (one element of
    the 32768 in an ACV hourglass's decoder sum at these weights and draws,
    PERF.md §6, PR 13) and moves every gradient behind it in the backward
    by up to 4.4e-2.  ``_GlobalBatchNorm``'s float32 numerics are held by
    ``batch_norm_layer_agreement`` on every BatchNorm's input of the step.
    The collectives are counted: BatchNorm's sums, the loss's count, the
    gradients."""
    import torch.distributed as dist

    from diffuvolume_tpu_torch.eval.pipeline import float32_exact
    from diffuvolume_tpu_torch.models.acv import ACVNet
    from diffuvolume_tpu_torch.models.layers import _FlaxRunningStats
    from diffuvolume_tpu_torch.parallel import ddp
    from diffuvolume_tpu_torch.tools.random_weights import (calibrate_heads, random_acv,
                                                            tame_residual_branches)
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    b, h, w, md = TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_DISP
    g = torch.Generator().manual_seed(5)
    left = torch.randn((b, h, w, 3), generator=g) * 0.3
    right = torch.roll(left, -3, dims=2)
    gt = torch.rand((b, h, w), generator=g) * (md + 8) + 0.5
    gt[:, :, :3] = 0.0
    gt[1, :, :11] = 0.0  # unequal valid counts by row
    t = torch.randint(0, 1000, (1,), generator=g).expand(b)
    noise = torch.randn((b, md // 4, h // 4, w // 4), generator=g)
    src = tame_residual_branches(random_acv(md, True, torch.Generator().manual_seed(11)))
    calibrate_heads(src, left, right)
    calls = {"all_reduce": 0}
    real = dist.all_reduce

    def counted(*a, **k):
        calls["all_reduce"] += 1
        return real(*a, **k)

    dp = ddp.init(0, 1, dev, f"tcp://localhost:{ddp.free_port()}")
    runs, bn_inputs, sums = {}, {}, {}
    try:
        for dtype in (torch.float64, torch.float32):
            for label in ("plain", "ddp"):
                model = ACVNet(md, True)
                model.load_state_dict(src.state_dict())
                model = model.to(dev, dtype).train()
                hooks = decoder_sum_hooks(model, sums.setdefault((label, dtype), {}))
                if label == "ddp":
                    ddp.sync_batch_norm(model, dp)
                    dp.broadcast_parameters(model)
                    dist.all_reduce = counted
                elif dtype == torch.float32:  # each BatchNorm's input, for the layer check
                    hooks += [m.register_forward_pre_hook(
                        lambda m, i, k=k: bn_inputs.__setitem__(k, (m, i[0].detach().clone())))
                        for k, m in model.named_modules() if isinstance(m, _FlaxRunningStats)]
                state = TrainState(model, make_optimizer(model),
                                   milestone_lr_schedule(1e-3, "10:2", 1))
                batch = {"left": left.to(dev, dtype), "right": right.to(dev, dtype),
                         "disp_gt": gt.to(dev, dtype)}
                try:
                    with float32_exact(model):
                        res = make_train_step(model, dp=dp if label == "ddp" else None)(
                            state, batch, t=t.to(dev), noise=noise.to(dev, dtype))
                finally:
                    dist.all_reduce = real
                    for hk in hooks:
                        hk.remove()
                runs[label, dtype] = (model, float(res["loss"]))
        layers = batch_norm_layer_agreement(bn_inputs, dp)
    finally:
        ddp.shutdown()

    def gaps(par, plain, ref) -> dict:
        (q, q_loss), (p, p_loss), (r, _) = par, plain, ref
        qp, pp, rp = dict(q.named_parameters()), dict(p.named_parameters()), dict(
            r.named_parameters())
        tiny = VANISH * max(float(x.grad.norm()) for x in rp.values())
        out = dict(loss=abs(q_loss / p_loss - 1), stat=0.0, param=0.0, grad_ddp_vs_float64=0.0,
                   grad_plain_vs_float64=0.0)
        per_leaf = {}
        for k, x in rp.items():
            if float(x.grad.norm()) <= tiny:
                if float(qp[k].grad.norm()) > tiny * 1e3:
                    raise AssertionError(f"{k}: vanishing in the plain step, not through DDP")
                continue
            per_leaf[k] = rel_l2(qp[k].grad, pp[k].grad)
            out["grad_ddp_vs_float64"] = max(out["grad_ddp_vs_float64"], rel_l2(qp[k].grad, x.grad))
            out["grad_plain_vs_float64"] = max(out["grad_plain_vs_float64"],
                                               rel_l2(pp[k].grad, x.grad))
            resolved = pp[k].grad.abs() > RESOLVE * pp[k].grad.pow(2).mean().sqrt()
            out["param"] = max(out["param"], rel_l2(qp[k].detach()[resolved],
                                                    pp[k].detach()[resolved]))
        out["grad_leaf"] = max(per_leaf, key=per_leaf.get)
        out["grad"] = per_leaf[out["grad_leaf"]]
        out["grad_median"] = float(np.median(list(per_leaf.values())))
        qs, ps = q.state_dict(), p.state_dict()
        for k, v in ps.items():
            if k.endswith(("running_mean", "running_var")):
                out["stat"] = max(out["stat"], rel_l2(qs[k], v))
        return out

    ref = runs["plain", torch.float64]
    out = {"float64": gaps(runs["ddp", torch.float64], ref, ref),
           "float32": gaps(runs["ddp", torch.float32], runs["plain", torch.float32], ref)}
    n_bn = sum(isinstance(m, _FlaxRunningStats) for m in runs["ddp", torch.float64][0].modules())
    for tag, worst in out.items():
        tol = TRAIN_TOL[tag]
        held = ("loss", "stat", "param") + (("grad",) if tag == "float64" else ())
        log(f"  ACV train step through parallel/ddp.py at world size 1 (NCCL) against the "
            f"plain step, {tag}: loss {worst['loss']:.2e} (tol {tol['loss']:g}), gradients "
            f"worst leaf {worst['grad']:.2e} ({worst['grad_leaf']}), median leaf "
            f"{worst['grad_median']:.2e} (" + (f"tol {tol['grad']:g}" if tag == "float64" else
                                                "recorded: a ReLU's mask") + "; against the "
            f"float64 plain step: DDP {worst['grad_ddp_vs_float64']:.2e}, plain "
            f"{worst['grad_plain_vs_float64']:.2e}), BatchNorm statistics {worst['stat']:.2e} "
            f"(tol {tol['stat']:g}), parameters after Adam {worst['param']:.2e} "
            f"(tol {tol['param']:g})")
        bad = [k for k in held if worst[k] > tol[k]]
        if bad:
            raise AssertionError(f"the {tag} data-parallel step at world size 1 disagrees with "
                                 f"the plain one: {bad}")
    out["batch_norm_layers"] = layers
    out["float32"]["relu_flips"] = flips = relu_flips(sums)
    log(f"  ReLU flips between the two float32 steps in the hourglasses' decoder sums: "
        f"{len(flips)}" + "".join(
            f"; {f['sum']} at {f['at']}: plain {f['plain']:.3e}, DDP {f['ddp']:.3e}, float64 "
            f"{f['float64']:.3e}, its gradient {f['grad_over_rms']:.1f}× the sum's gradient's RMS"
            for f in flips[:4]))
    out["all_reduce_calls"], out["batch_norms"] = calls["all_reduce"], n_bn
    log(f"  {calls['all_reduce']} all-reduces in the two data-parallel steps over {n_bn} "
        f"BatchNorms")
    if calls["all_reduce"] < 2 * (3 * n_bn + 2):
        raise AssertionError(f"{calls['all_reduce']} all-reduces: the data-parallel step skipped "
                             f"collectives ({n_bn} BatchNorms)")
    return out


def train_profile() -> dict:
    """Phase 11 (d): ``tools/bench_train.py --profile``, the ACV SceneFlow
    step at 256×512, batch 4, float32, by kernel group: the plain step, then
    the same step through ``parallel/ddp.py`` at world size 1 (``--ddp``)."""
    from diffuvolume_tpu_torch.tools import bench_train

    out = {}
    for label, extra in (("plain", []), ("ddp", ["--ddp"])):
        rec = out[label] = bench_train.main(["--steps", str(BENCH_TRAIN_STEPS), "--profile",
                                            *extra])
        if not (rec["profile"]["device_ms"] > 0 and math.isfinite(rec["last_loss"])):
            raise AssertionError(f"bench_train {label}: {rec}")
    plain, dp = out["plain"], out["ddp"]
    log(f"  the training step through parallel/ddp.py at world size 1 against the plain step: "
        f"{dp['step_ms_median']:.2f} / {plain['step_ms_median']:.2f} ms (median), peak memory "
        f"{dp['peak_mem_bytes'] / 2**30:.3f} / {plain['peak_mem_bytes'] / 2**30:.3f} GiB, "
        f"device busy {dp['profile']['device_ms']:.2f} / {plain['profile']['device_ms']:.2f} ms "
        f"a step; by group (ddp / plain ms):")
    groups = dict.fromkeys([*plain["profile"]["groups_ms"], *dp["profile"]["groups_ms"]])
    for g in groups:
        log(f"    {dp['profile']['groups_ms'].get(g, 0.0):10.3f} "
            f"{plain['profile']['groups_ms'].get(g, 0.0):10.3f}  {g}")
    return out


def phase_11(dev, counters: dict, runs: dict, card: str) -> dict:
    """Phase 11: (a) the quirk path at full width (into ``runs``; its
    launches a pair asserted equal to phase 8's folded path's), (b) card
    against CPU, (c) DDP at world size 1, (d) the training step's
    profile."""
    t0 = time.perf_counter()
    log(f"   (a) IGEV quirk=True at {IGEV_H}×{IGEV_W}, {IGEV_ITERS} GRU iterations, folded, "
        f"bfloat16; {card}")
    quirk = runs["igev_quirk_folded"] = igev_path(dev, counters, packed=True,
                                                  pairs=QUIRK_TIMED_PAIRS, quirk=True)
    if quirk["launches_per_pair"] != runs["igev_folded"]["launches_per_pair"]:
        raise AssertionError(f"quirk launches {quirk['launches_per_pair']} != phase 8's "
                             f"{runs['igev_folded']['launches_per_pair']}")
    log("   (b) IGEV quirk=True on the card against the CPU")
    out = {"quirk_agreement": igev_quirk_agreement(dev)}
    log("   (c) one ACV train step through parallel/ddp.py at world size 1 (NCCL)")
    out["ddp"] = ddp_step_agreement(dev)
    log("   (d) tools/bench_train.py --profile, plain and --ddp")
    out["bench_train"] = train_profile()
    out["elapsed_s"] = time.perf_counter() - t0
    log(f"  phase 11: {out['elapsed_s']:.1f} s")
    return out


# Phase 12: the cost volume's rows split over SPLIT_RANKS processes on
# cuda:0 (gloo: NCCL takes one rank a device), against the unsplit run on
# the card.  The split sums each conv in another order than the unsplit
# run (other shapes, other algorithms and tile plans), so in float32 the
# two meet at the float32 floor, not bit for bit: at 512×960 the unsplit
# float32 forward is itself 3.6e-3 px (max) and 1.4e-4 px (mean) from the
# float64 forward on the same card, and 1.2e-3 px from itself run twice
# (PERF.md §6), above the 1e-3 px the split was first held to.  So the
# float32 split is held to that floor, measured in the same run: its
# distance to the float64 forward within SPLIT_FLOOR_MARGIN of the unsplit
# float32 forward's, in max and in mean (measured: max 0.80–1.09×, mean
# 1.00×), and its distance to the unsplit forward within SPLIT_F32_PX or
# (1 + SPLIT_FLOOR_MARGIN["max"]) × the floor's max, whichever is larger:
# the triangle inequality's bound through the float64 forward, since
# nothing ties the two float32 forwards' roundings to each other.
# bfloat16 takes phase 4's flip rule against the unsplit forward: a pixel
# may move past SPLIT_BF16_PX on at most FLIP_SHARE of the pixels, the
# rest within SPLIT_BF16_MEAN_PX on average.
SPLIT_RANKS = 2
# Each module path's kernels under the split (phase 12 (a)): each rank
# launches each as often as the unsplit forward does.
SPLIT_FORWARD_KERNELS = {"acv": ("gwc_volume", "concat_volume", "conv3d_packed", "fused_head"),
                         "pcw": ("gwc_volume_packed", "conv3d_packed", "fused_head"),
                         "igev": ("gwc_volume", "conv3d_fold_small")}
SPLIT_FORWARD_ROWS = {"acv": "rows 2, 3, 15, 1", "pcw": "rows 16, 15, 1", "igev": "rows 2, 14"}
SPLIT_FORWARD_HW = {"acv": (MAIN_H, MAIN_W), "pcw": (PCW_H, PCW_W), "igev": (IGEV_H, IGEV_W)}
# Phase 12 (b)-(c): the PCW and IGEV steps in float64 on the 1 × 2 grid,
# case → (model, H, W, the bands' rows at H/4, seed); IGEV's uneven case
# cuts its 40 rows 24 / 16 (edges on multiples of 8).
SPLIT_MODEL_STEPS = {"pcw": ("pcw", 64, 64, (8, 8), 21),
                     "gwcnet_g": ("gwcnet-g", 64, 64, (8, 8), 24),
                     "igev": ("igev", 64, 64, (8, 8), 22),
                     "igev_uneven": ("igev", 160, 64, (24, 16), 23)}
SPLIT_IGEV_ITERS = 3
SPLIT_F32_PX = 1e-3
SPLIT_FLOOR_MARGIN = {"max": 1.5, "mean": 1.1}
SPLIT_BF16_PX, SPLIT_BF16_MEAN_PX = 0.1, 5e-3
SPLIT_STEPS = 2
SPLIT_TRAIN_H, SPLIT_TRAIN_W = 256, 512  # the ACV SceneFlow recipe's crop
SPLIT_TIMEOUT_S = 300


def kernel_counters() -> dict:
    """Every kernel wrapper by the name the ``kernels`` line gives it; each
    carries its launch count."""
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2
    from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
    from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
    from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
    from diffuvolume_tpu_torch.ops.kernels import fused_head as kf
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg
    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    return {"fused_head": kf.fused_upsample_softargmin, "gwc_volume": kg.gwc_volume,
            "concat_volume": kc.concat_volume, "dhw_mul": kc.dhw_mul,
            "conv3d_fold_p": kconv.conv3d_fold_p, "conv3d_fold_x2": kconv.conv3d_fold_x2,
            "conv3d_fold_s2": kconv.conv3d_fold_s2, "conv3d_fold_up": kup.conv3d_fold_up,
            "conv1x1_fold_p": kconv.conv1x1_fold_p, "pack": kl.pack, "unpack": kl.unpack,
            "gwc_volume_packed": kg.gwc_volume_packed, "depthwise_hw_p": kd.depthwise_hw_p,
            "depthwise_hw_p2": kd.depthwise_hw_p2,
            "fused_uncertainty_at": kf.fused_uncertainty_at, "unpack_hwdc": kl.unpack_hwdc,
            "conv3d_fold_small": kconv.conv3d_fold_small,
            "conv3d_packed": kconv.conv3d_packed, "conv2d_flat": k2.conv2d_flat}


def split_inputs(dev) -> dict:
    """Phase 12's inputs, made once and handed to every process: (a) each
    module path's baseline with seeded weights and its images: ACV at
    512×960 (tamed, heads calibrated to logit std 3, seed 0;
    ``tests/test_torch_parallel.py``'s taming and calibration), PCW at
    384×1248 (``calibrate_pcw``, seed 0), IGEV at 384×1248 with RAW images
    (``calibrate_igev_drift`` over its 32 GRU iterations, seed 0); (b)
    phase 10 (b)'s ACV step at 32×64 (weights, images, ground truth with
    valid counts unequal by row and by band, timestep, noise) and the
    full-width step's batch (256×512, batch 4, images from seed 1); the PCW
    and IGEV steps' weights and batches (``SPLIT_MODEL_STEPS``)."""
    from diffuvolume_tpu_torch.tools.random_weights import (calibrate_heads, calibrate_igev_drift,
                                                            calibrate_pcw, random_acv,
                                                            random_igev, random_pcw,
                                                            tame_residual_branches)

    g = torch.Generator().manual_seed(0)
    left = torch.randn((1, MAIN_H, MAIN_W, 3), generator=g) * 0.3
    model = tame_residual_branches(random_acv(MAIN_DISP, False, g)).to(dev)
    forward = {}
    with torch.no_grad():
        calibrate_heads(model, left.to(dev), torch.roll(left, -3, dims=2).to(dev))
        forward["acv"] = {"state": {k: v.cpu() for k, v in model.state_dict().items()},
                          "left": left}
        g = torch.Generator().manual_seed(0)
        left = torch.randn((1, PCW_H, PCW_W, 3), generator=g) * 0.3
        model = random_pcw(MAIN_DISP, False, g).to(dev)
        calibrate_pcw(model, left.to(dev), torch.roll(left, -3, dims=2).to(dev))
        forward["pcw"] = {"state": {k: v.cpu() for k, v in model.state_dict().items()},
                          "left": left}
        g = torch.Generator().manual_seed(0)
        left = torch.rand((1, IGEV_H, IGEV_W, 3), generator=g) * 255.0
        model = random_igev(MAIN_DISP, False, g).to(dev)
        calibrate_igev_drift(model, left.to(dev), torch.roll(left, -3, dims=2).to(dev),
                             iters=IGEV_ITERS)
        forward["igev"] = {"state": {k: v.cpu() for k, v in model.state_dict().items()},
                           "left": left}
    b, h, w, md = TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_DISP
    g = torch.Generator().manual_seed(5)
    s_left = torch.randn((b, h, w, 3), generator=g) * 0.3
    gt = torch.rand((b, h, w), generator=g) * (md + 8) + 0.5
    gt[:, :, :3] = 0.0
    gt[1, :, :11] = 0.0
    gt[:, h // 2:, :7] = 0.0  # and unequal by band
    t = torch.randint(0, 1000, (1,), generator=g).expand(b)
    noise = torch.randn((b, md // 4, h // 4, w // 4), generator=g)
    src = tame_residual_branches(random_acv(md, True, torch.Generator().manual_seed(11)))
    calibrate_heads(src, s_left, torch.roll(s_left, -3, dims=2))
    g = torch.Generator().manual_seed(1)
    big = torch.randn((ACV_TRAIN_BATCH, SPLIT_TRAIN_H, SPLIT_TRAIN_W, 3), generator=g) * 0.3
    return {"forward": forward,
            "step_state": src.state_dict(), "step_left": s_left, "step_gt": gt,
            "t": t, "noise": noise, "big_left": big,
            "big_gt": torch.rand((ACV_TRAIN_BATCH, SPLIT_TRAIN_H, SPLIT_TRAIN_W), generator=g)
            * 149.0 + 1.0,
            "model_steps": {case: model_step_inputs(case) for case in SPLIT_MODEL_STEPS}}


def model_step_inputs(case: str) -> dict:
    """``SPLIT_MODEL_STEPS[case]``'s inputs from its seed: the DDIM model's
    weights (PCW: ``random_pcw`` and ``calibrate_pcw``; gwcnet-g the same
    without diffusion or the concat volume; IGEV: ``random_igev`` and
    ``calibrate_igev``, RAW images), the batch with ground truth whose valid
    counts differ by band, the timestep and the noise; float64, on the
    CPU."""
    from diffuvolume_tpu_torch.tools.random_weights import (calibrate_igev, calibrate_pcw,
                                                            random_igev, random_pcw)

    kind, h, w, _, seed = SPLIT_MODEL_STEPS[case]
    g = torch.Generator().manual_seed(seed)
    pcw = kind in ("pcw", "gwcnet-g")
    if pcw:
        left = torch.randn((1, h, w, 3), generator=g, dtype=torch.float64) * 0.3
        model = random_pcw(TRAIN_DISP, kind == "pcw", g, use_concat_volume=kind == "pcw")
    else:
        left = torch.rand((1, h, w, 3), generator=g, dtype=torch.float64) * 255.0
        model = random_igev(TRAIN_DISP, True, g)
    right = torch.roll(left, -3, dims=2)
    with torch.no_grad():
        (calibrate_pcw if pcw else calibrate_igev)(model, left.float(), right.float())
    gt = torch.rand((1, h, w), generator=g, dtype=torch.float64) * (TRAIN_DISP + 8) + 0.5
    gt[:, :h // 3, :5] = 0.0
    gt[:, h // 3:, :9] = 0.0
    t = torch.randint(0, 1000, (1,), generator=g)
    noise = torch.randn((1, TRAIN_DISP // 4, h // 4, w // 4), generator=g, dtype=torch.float64)
    return {"state": model.state_dict(), "batch": {"left": left, "right": right, "disp_gt": gt},
            "t": t, "noise": noise}


def split_forward(inputs: dict, kind: str, dtype, dev, counters: dict, mesh=None,
                  warm: bool = True):
    """``kind``'s module path eval forward in ``dtype`` (ACV at 512×960, PCW
    at 384×1248 and IGEV at 384×1248 with ``IGEV_ITERS`` GRU iterations;
    ACV's and PCW's 3-D convs routed by ``route_conv3d``), inside
    ``volume_sharding(mesh)`` when given: one warm-up (unless ``warm`` is
    false), then one forward with the launch counts set to 0 just before
    and read just after.  In
    float64 (the reference) the path runs unrouted, and its kernels, which
    take float32 and bfloat16, run their plain versions on the card.
    Returns ``(disp on the CPU, launches)``."""
    import torch.nn.functional as F

    import diffuvolume_tpu_torch.models.acv as acv_module
    import diffuvolume_tpu_torch.models.igev.extractor as igev_extractor
    import diffuvolume_tpu_torch.models.igev.model as igev_module
    import diffuvolume_tpu_torch.models.pcw as pcw_module
    from diffuvolume_tpu_torch.eval.pipeline import float32_exact
    from diffuvolume_tpu_torch.models.layers import route_conv3d
    from diffuvolume_tpu_torch.ops.cost_volume import (build_gwc_volume, concat_volume_mul,
                                                       gwc_volume_slot)
    from diffuvolume_tpu_torch.ops.kernels.fused_head import fused_upsample_softargmin_plain
    from diffuvolume_tpu_torch.parallel.volume_sharding import volume_sharding

    exact = dtype == torch.float64
    model = {"acv": acv_module.ACVNet, "pcw": pcw_module.PCWNet,
             "igev": igev_module.IGEVStereo}[kind](MAIN_DISP, False)
    model.load_state_dict(inputs["forward"][kind]["state"])
    if kind != "igev" and not exact:
        model = route_conv3d(model)
    model = model.to(dev, dtype).eval()
    left = inputs["forward"][kind]["left"].to(dev, torch.float64 if exact else torch.float32)
    right = torch.roll(left, -3, dims=2)

    def small_f64(x, w):
        return F.conv3d(x, w, padding=1)

    plain = {} if not exact else {
        "acv": {acv_module: {"gwc_volume": build_gwc_volume, "concat_volume": concat_volume_mul,
                             "fused_upsample_softargmin": fused_upsample_softargmin_plain}},
        "pcw": {pcw_module: {"gwc_volume_packed": gwc_volume_slot,
                             "fused_upsample_softargmin": fused_upsample_softargmin_plain}},
        "igev": {igev_module: {"gwc_volume": build_gwc_volume, "conv3x3x3_small": small_f64},
                 igev_extractor: {"conv3x3x3_small": small_f64}},
    }[kind]
    kept = [(mod, k, getattr(mod, k)) for mod, fs in plain.items() for k in fs]
    for mod, fs in plain.items():
        for k, f in fs.items():
            setattr(mod, k, f)

    def run():
        if kind == "igev":
            return igev_module.igev_forward(model, left, right, iters=IGEV_ITERS)
        return model(left, right)[0]

    try:
        with torch.no_grad(), float32_exact(model), volume_sharding(mesh):
            if warm:
                run()
                torch.cuda.synchronize()
            for f in counters.values():
                f.launches = 0
            disp = run()
            torch.cuda.synchronize()
            launches = {k: f.launches for k, f in counters.items()}
    finally:
        for mod, k, f in kept:
            setattr(mod, k, f)
    return disp.double().cpu(), launches


def px_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    err = (got - want).abs()
    return dict(max=float(err.max()), mean=float(err.mean()))


def split_step(inputs: dict, dev, mesh=None) -> dict:
    """Phase 10 (b)'s ACV step in float64 at 32×64 (split over ``mesh``'s
    volume axis when given): the loss, gradients, statistics and
    parameters after Adam, on the CPU."""
    from diffuvolume_tpu_torch.models.acv import ACVNet
    from diffuvolume_tpu_torch.parallel import ddp
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    dt = torch.float64
    model = ACVNet(TRAIN_DISP, True)
    model.load_state_dict(inputs["step_state"])
    model = model.to(dev, dt).train()
    if mesh is not None:
        ddp.sync_batch_norm(model, mesh)
        mesh.broadcast_parameters(model)
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    left = inputs["step_left"].to(dev, dt)
    batch = {"left": left, "right": torch.roll(left, -3, dims=2),
             "disp_gt": inputs["step_gt"].to(dev, dt)}
    res = make_train_step(model, dp=mesh)(state, batch, t=inputs["t"].to(dev),
                                          noise=inputs["noise"].to(dev, dt))
    return {"loss": float(res["loss"]),
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
            "stats": {k: v.cpu() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {k: p.detach().cpu() for k, p in model.named_parameters()}}


def model_split_step(inputs: dict, case: str, dev, mesh=None) -> dict:
    """``SPLIT_MODEL_STEPS[case]``: the KITTI12 step (PCW or gwcnet-g, Adam)
    or the KITTI15 step (IGEV, ``SPLIT_IGEV_ITERS`` GRU iterations, clip + AdamW)
    in float64 on the card (split over ``mesh``'s volume axis when given):
    the loss, gradients, statistics and parameters after the step, on the
    CPU."""
    from diffuvolume_tpu_torch.models.igev.model import IGEVStereo
    from diffuvolume_tpu_torch.models.pcw import PCWNet
    from diffuvolume_tpu_torch.parallel import ddp
    from diffuvolume_tpu_torch.train.loop import (TrainState, make_igev_train_step,
                                                  make_optimizer, make_train_step)
    from diffuvolume_tpu_torch.train.loss import KITTI12_WEIGHTS
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule, one_cycle_schedule

    kind = SPLIT_MODEL_STEPS[case][0]
    x = inputs["model_steps"][case]
    dt = torch.float64
    model = {"pcw": lambda: PCWNet(TRAIN_DISP, True),
             "gwcnet-g": lambda: PCWNet(TRAIN_DISP, False, use_concat_volume=False),
             "igev": lambda: IGEVStereo(TRAIN_DISP, True)}[kind]()
    model.load_state_dict(x["state"])
    model = model.to(dev, dt).train()
    if mesh is not None:
        ddp.sync_batch_norm(model, mesh)
        mesh.broadcast_parameters(model)
    if kind != "igev":
        state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
        step = make_train_step(model, KITTI12_WEIGHTS, dp=mesh)
    else:
        state = TrainState(model, make_optimizer(model, "adamw", 1e-5),
                           one_cycle_schedule(2e-4, 50), grad_clip=1.0)
        step = make_igev_train_step(model, iters=SPLIT_IGEV_ITERS, dp=mesh)
    batch = {k: v.to(dev) for k, v in x["batch"].items()}
    res = step(state, batch, t=x["t"].to(dev), noise=x["noise"].to(dev))
    return {"loss": float(res["loss"]),
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
            "stats": {k: v.cpu() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {k: p.detach().cpu() for k, p in model.named_parameters()},
            "rows": int(res["pred"].shape[1])}


def split_step_times(inputs: dict, dev, mesh=None) -> dict:
    """The ACV SceneFlow step at 256×512, batch 4, float32 (``SPLIT_TRAIN_*``;
    the JAX
    package's initialisation from seed 0, PyTorch's default precision as
    the CLI runs): one warm-up step, then ``SPLIT_STEPS`` steps each ended
    by a synchronise; ms a step and this process's peak memory."""
    from diffuvolume_tpu_torch.models import build_model
    from diffuvolume_tpu_torch.parallel import ddp
    from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    model = build_model("acvnet_ddim", max_disp=MAIN_DISP)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(dev).train()
    if mesh is not None:
        ddp.sync_batch_norm(model, mesh)
        mesh.broadcast_parameters(model)
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    left = inputs["big_left"].to(dev)
    batch = {"left": left, "right": torch.roll(left, -3, dims=2),
             "disp_gt": inputs["big_gt"].to(dev)}
    step = make_train_step(model, dp=mesh)
    draws = torch.Generator(device=dev).manual_seed(2)
    times = []
    for i in range(1 + SPLIT_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step(state, batch, draws)["loss"]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"a non-finite split-step loss: {float(loss)}")
    ms = times[1:]
    return dict(step_ms=ms, step_ms_median=float(np.median(ms)),
                step_ms_p10=float(np.percentile(ms, 10)),
                step_ms_p90=float(np.percentile(ms, 90)),
                peak_mem_bytes=torch.cuda.max_memory_allocated(), last_loss=float(loss))


def split_rank(rank: int, port: int, tmp: str) -> None:
    """One process of phase 12's 1 × ``SPLIT_RANKS`` grid on cuda:0 over
    gloo: (a) each module path's split forward in float32 and bfloat16,
    (b) the ACV split step in float64 and the full-width float32 step's
    times, the PCW and IGEV split steps in float64, (c) IGEV's uneven one;
    its results to ``tmp``."""
    sys.path.insert(0, HERE)
    from diffuvolume_tpu_torch.parallel import ddp

    dev = torch.device("cuda:0")
    mesh = ddp.init(rank, SPLIT_RANKS, dev, f"tcp://localhost:{port}", backend="gloo",
                    n_volume=SPLIT_RANKS)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"))
        counters = kernel_counters()
        out = {"backend": mesh.backend, "host_staging": mesh.host_staging}
        clock = Clock(out)
        for kind in SPLIT_FORWARD_KERNELS:
            for dtype in (torch.float32, torch.bfloat16):
                out["forward", kind, dtype_tag(dtype)] = split_forward(
                    inputs, kind, dtype, dev, counters, mesh)
            torch.cuda.empty_cache()
            clock(f"forwards_{kind}")
        out["step_float64"] = split_step(inputs, dev, mesh)
        out["step_float32_times"] = split_step_times(inputs, dev, mesh)
        clock("acv_steps")
        for case in SPLIT_MODEL_STEPS:
            out["model_step", case] = model_split_step(inputs, case, dev, mesh)
        clock("model_steps")
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        ddp.shutdown()


class Clock:
    """Seconds since the last reading, by label, into ``out["times_s"]``."""

    def __init__(self, out: dict):
        self.times = out.setdefault("times_s", {})
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.times[label] = round(now - self.t, 2)
        self.t = now


def spawn_split_ranks(tmp: str) -> list:
    """``split_rank`` in ``SPLIT_RANKS`` spawned processes, joined within
    ``SPLIT_TIMEOUT_S`` (killed past it); each must exit 0."""
    import multiprocessing

    from diffuvolume_tpu_torch.parallel import ddp

    port = ddp.free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=split_rank, args=(r, port, tmp)) for r in range(SPLIT_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPLIT_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode for p in procs):
        raise AssertionError(f"phase 12's ranks failed: exit codes {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(SPLIT_RANKS)]


def split_step_gaps(got: dict, want: dict) -> dict:
    """Phase 11 (c)'s measures of a step against another: the loss, the
    worst leaf's gradient (a vanishing one held to its bound), the
    statistics and the parameters over the resolved elements."""
    tiny = VANISH * max(float(g.norm()) for g in want["grads"].values())
    out = dict(loss=abs(got["loss"] / want["loss"] - 1), grad=0.0, stat=0.0, param=0.0)
    for k, g in want["grads"].items():
        if float(g.norm()) <= tiny:
            if float(got["grads"][k].norm()) > tiny * 1e3:
                raise AssertionError(f"{k}: vanishing in the plain step, not when split")
            continue
        out["grad"] = max(out["grad"], rel_l2(got["grads"][k], g))
        resolved = g.abs() > RESOLVE * g.pow(2).mean().sqrt()
        out["param"] = max(out["param"], rel_l2(got["params"][k][resolved],
                                                want["params"][k][resolved]))
    for k, v in want["stats"].items():
        out["stat"] = max(out["stat"], rel_l2(got["stats"][k], v))
    return out


def check_split_forward(kind: str, whole: dict, again: torch.Tensor, exact: torch.Tensor,
                        ranks: list, faults: list) -> dict:
    """Phase 12 (a) for ``kind``: each rank's launches against the unsplit
    forward's, the float32 split against the float32 floor measured in the
    run, the bfloat16 split under phase 4's flip rule; faults appended to
    ``faults``.  Returns the records by dtype."""
    out = {}
    for tag, (want, want_launches) in whole.items():
        used = {k: v for k, v in want_launches.items() if v}
        if not all(used.get(k) for k in SPLIT_FORWARD_KERNELS[kind]):
            faults.append(f"the unsplit {kind} {tag} forward skipped a kernel of "
                          f"{SPLIT_FORWARD_ROWS[kind]}: {used}")
        for r, rank in enumerate(ranks):
            if rank["forward", kind, tag][1] != want_launches:
                faults.append(f"rank {r}'s {kind} {tag} launches {rank['forward', kind, tag][1]} "
                              f"!= the unsplit forward's {want_launches}")
        got = torch.cat([r["forward", kind, tag][0] for r in ranks], dim=1)
        rec = out[tag] = dict(split_vs_unsplit=px_gap(got, want),
                              split_vs_float64=px_gap(got, exact),
                              unsplit_vs_float64=px_gap(want, exact),
                              rows_a_rank=[r["forward", kind, tag][0].shape[1] for r in ranks],
                              launches_a_rank=used)
        if tag == "float32":
            floor = rec["unsplit_vs_float64"]
            rec["unsplit_run_to_run"] = px_gap(again, want)
            bound = max(SPLIT_F32_PX, (1 + SPLIT_FLOOR_MARGIN["max"]) * floor["max"])
            log(f"  (a) {kind} split forward, float32: against the unsplit forward max |Δ| "
                f"{rec['split_vs_unsplit']['max']:.3e} px (bound {bound:.3e}: {SPLIT_F32_PX:g} or "
                f"{1 + SPLIT_FLOOR_MARGIN['max']:g}× the float32 floor's max), mean "
                f"{rec['split_vs_unsplit']['mean']:.3e}; against the float64 forward max / mean: "
                f"split {rec['split_vs_float64']['max']:.3e} / "
                f"{rec['split_vs_float64']['mean']:.3e}, unsplit (the floor) "
                f"{floor['max']:.3e} / {floor['mean']:.3e} (margin {SPLIT_FLOOR_MARGIN}); the "
                f"unsplit forward run twice: max {rec['unsplit_run_to_run']['max']:.3e}")
            if rec["split_vs_unsplit"]["max"] > bound:
                faults.append(f"the {kind} split float32 forward is "
                              f"{rec['split_vs_unsplit']['max']:.3e} px from the unsplit one "
                              f"(bound {bound:.3e})")
            for k, m in SPLIT_FLOOR_MARGIN.items():
                if rec["split_vs_float64"][k] > m * floor[k]:
                    faults.append(f"the {kind} split float32 forward's {k} distance to float64 "
                                  f"{rec['split_vs_float64'][k]:.3e} is past {m}× the floor's "
                                  f"{floor[k]:.3e}")
        else:
            err = (got - want).abs()
            moved = err > SPLIT_BF16_PX
            rec.update(moved_share=float(moved.double().mean()),
                       rest_mean_px=float(err[~moved].mean()))
            log(f"  (a) {kind} split forward, bfloat16: {rec['moved_share']:.4%} of pixels past "
                f"{SPLIT_BF16_PX:g} px from the unsplit forward (at most {FLIP_SHARE:.1%}), the "
                f"rest mean |Δ| {rec['rest_mean_px']:.3e} px (tol {SPLIT_BF16_MEAN_PX:g}), max "
                f"{rec['split_vs_unsplit']['max']:.3e}; against the float64 forward max / mean: "
                f"split {rec['split_vs_float64']['max']:.3e} / "
                f"{rec['split_vs_float64']['mean']:.3e}, unsplit "
                f"{rec['unsplit_vs_float64']['max']:.3e} / {rec['unsplit_vs_float64']['mean']:.3e}")
            if rec["moved_share"] > FLIP_SHARE or rec["rest_mean_px"] > SPLIT_BF16_MEAN_PX:
                faults.append(f"the {kind} split bfloat16 forward departs from the unsplit one "
                              f"past phase 4's flip rule: {rec}")
        log(f"      each rank's launches a forward: {used}, as the unsplit forward's; rows a "
            f"rank {rec['rows_a_rank']}")
    return out


def check_split_step(name: str, got: list, want: dict, faults: list) -> dict:
    """A float64 split step (each rank's ``got``) against one process's
    ``want``, phase 11 (c)'s tolerances; every rank's parameters equal."""
    for r in got[1:]:
        for k, v in got[0]["params"].items():
            if not torch.equal(r["params"][k], v):
                faults.append(f"the ranks' parameters differ after the {name}: {k}")
                break
    gaps = split_step_gaps(got[0], want)
    tol = TRAIN_TOL["float64"]
    log(f"  {name}, float64, against one process: loss {gaps['loss']:.2e} (tol "
        f"{tol['loss']:g}), gradients {gaps['grad']:.2e} ({tol['grad']:g}), statistics "
        f"{gaps['stat']:.2e} ({tol['stat']:g}), parameters after the step {gaps['param']:.2e} "
        f"({tol['param']:g})")
    bad = [k for k in tol if gaps[k] > tol[k]]
    if bad:
        faults.append(f"the {name} in float64 disagrees with one process: {bad}")
    return gaps


def phase_12(dev, counters: dict, runs: dict, card: str) -> dict:
    """Phase 12: the split over 2 processes on cuda:0 against the unsplit
    runs on the card, (a) ACV's, PCW's and IGEV's module path forwards
    (ACV's and PCW's routed) in float32 and bfloat16, each rank's launches
    equal to the unsplit forward's; (b) the ACV, PCW and IGEV steps in
    float64 at a small size, and ACV's full-width float32 step's times
    beside the plain step's; (c) IGEV's step with uneven bands."""
    import tempfile

    t0 = time.perf_counter()
    out = {}
    clock = Clock(out)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = split_inputs(dev)
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        clock("inputs")
        whole, again, exact = {}, {}, {}
        for kind in SPLIT_FORWARD_KERNELS:
            whole[kind] = {dtype_tag(dt): split_forward(inputs, kind, dt, dev, counters)
                           for dt in (torch.float32, torch.bfloat16)}
            again[kind], _ = split_forward(inputs, kind, torch.float32, dev, counters,
                                           warm=False)
            exact[kind], _ = split_forward(inputs, kind, torch.float64, dev, counters,
                                           warm=False)
            torch.cuda.empty_cache()
            clock(f"forwards_{kind}")
        plain_step = split_step(inputs, dev)
        plain_times = split_step_times(inputs, dev)
        clock("acv_steps")
        plain_models = {case: model_split_step(inputs, case, dev) for case in SPLIT_MODEL_STEPS}
        torch.cuda.empty_cache()
        clock("model_steps")
        ranks = spawn_split_ranks(tmp)
        clock("ranks")
    log(f"  {SPLIT_RANKS} processes on cuda:0, backend {ranks[0]['backend']}, halo rows "
        f"staged in {'host' if ranks[0]['host_staging'] else 'device'} memory; {card}; "
        f"seconds: {out['times_s']}, rank 0's {ranks[0]['times_s']}")
    faults = []
    for kind in SPLIT_FORWARD_KERNELS:
        launches = {k: sum(r["forward", kind, t][1][k] for r in ranks for t in whole[kind])
                    for k in counters}
        runs[f"{kind}_module_split"] = dict(
            launches=launches, launches_per_pair=ranks[0]["forward", kind, "float32"][1])
        h, w = SPLIT_FORWARD_HW[kind]
        log(f"  (a) {kind} module path, {h}×{w}, {h // 4} rows at H/4")
        out[f"forward_{kind}"] = check_split_forward(kind, whole[kind], again[kind], exact[kind],
                                                     ranks, faults)
    out["step_float64"] = check_split_step(
        f"(b) split ACV step ({TRAIN_H}×{TRAIN_W}, 1 × {SPLIT_RANKS} grid)",
        [r["step_float64"] for r in ranks], plain_step, faults)
    times = out["step_float32"] = {"plain": plain_times,
                                   "split": [r["step_float32_times"] for r in ranks]}
    log(f"  (b) the float32 step at {SPLIT_TRAIN_H}×{SPLIT_TRAIN_W}, batch {ACV_TRAIN_BATCH}, "
        f"{SPLIT_STEPS} steps "
        f"(one card shared by {SPLIT_RANKS} gloo processes: not a scaling figure): split "
        + "; ".join(f"rank {r} {t['step_ms_median']:.2f} ms (p10 {t['step_ms_p10']:.2f}, p90 "
                    f"{t['step_ms_p90']:.2f}), peak {t['peak_mem_bytes'] / 2**30:.3f} GiB"
                    for r, t in enumerate(times["split"]))
        + f"; plain {plain_times['step_ms_median']:.2f} ms (p10 {plain_times['step_ms_p10']:.2f}"
        f", p90 {plain_times['step_ms_p90']:.2f}), peak "
        f"{plain_times['peak_mem_bytes'] / 2**30:.3f} GiB")
    for case, (kind, h, w, bands, _) in SPLIT_MODEL_STEPS.items():
        got = [r["model_step", case] for r in ranks]
        rows = [g["rows"] for g in got]
        if rows != [4 * b for b in bands]:
            faults.append(f"the {case} step's ranks hold {rows} rows, not {bands} at H/4")
        label = "(c) uneven" if case.endswith("uneven") else "(b)"
        out[f"step_{case}"] = check_split_step(
            f"{label} split {kind.upper()} step ({h}×{w}, {h // 4} rows at H/4 cut "
            f"{' / '.join(map(str, bands))})", got, plain_models[case], faults)
    out["elapsed_s"] = time.perf_counter() - t0
    log(f"  phase 12: {out['elapsed_s']:.1f} s")
    if faults:
        raise AssertionError("; ".join(faults))
    return out


KERNEL_META = {  # name → (source, TPU kernel file:line, its function)
    "fused_head": ("diffuvolume_tpu_torch/csrc/fused_head.cu",
                   "diffuvolume_tpu/ops/pallas/fused_head.py:83", "fused_upsample_softargmin"),
    "gwc_volume": ("diffuvolume_tpu_torch/csrc/gwc_volume.cu",
                   "diffuvolume_tpu/ops/pallas/gwc_volume.py:67", "gwc_volume_pallas"),
    "concat_volume": ("diffuvolume_tpu_torch/csrc/concat_volume.cu",
                      "diffuvolume_tpu/ops/pallas/conv3d.py:903", "pack_concat_k"),
    "dhw_mul": ("diffuvolume_tpu_torch/csrc/concat_volume.cu",
                "diffuvolume_tpu/ops/pallas/conv3d.py:1048", "packed_dhw_mul_k"),
    "conv3d_fold_p": ("diffuvolume_tpu_torch/csrc/conv3d_fold.cu",
                      "diffuvolume_tpu/ops/pallas/conv3d.py:508", "conv3d_fold_p"),
    "conv3d_fold_x2": ("diffuvolume_tpu_torch/csrc/conv3d_fold.cu",
                       "diffuvolume_tpu/ops/pallas/conv3d.py:1307", "conv3d_fold_x2"),
    "conv3d_fold_s2": ("diffuvolume_tpu_torch/csrc/conv3d_fold.cu",
                       "diffuvolume_tpu/ops/pallas/conv3d.py:1439", "conv3d_fold_s2"),
    "conv3d_fold_up": ("diffuvolume_tpu_torch/csrc/conv3d_up.cu",
                       "diffuvolume_tpu/ops/pallas/conv3d.py:1641", "conv3d_fold_up"),
    "conv1x1_fold_p": ("diffuvolume_tpu_torch/csrc/conv3d_fold.cu",
                       "diffuvolume_tpu/ops/pallas/conv3d.py:1879", "conv1x1_fold_p"),
    "pack": ("diffuvolume_tpu_torch/csrc/layout.cu",
             "diffuvolume_tpu/ops/pallas/conv3d.py:675", "pack_padded_k"),
    "unpack": ("diffuvolume_tpu_torch/csrc/layout.cu",
               "diffuvolume_tpu/ops/pallas/conv3d.py:1140", "unpack_padded_k"),
    "gwc_volume_packed": ("diffuvolume_tpu_torch/csrc/gwc_volume.cu",
                          "diffuvolume_tpu/ops/pallas/gwc_volume.py:132", "gwc_volume_packed"),
    "depthwise_hw_p2": ("diffuvolume_tpu_torch/csrc/depthwise_hw.cu",
                        "diffuvolume_tpu/ops/pallas/conv3d.py:792", "depthwise_hw_p"),
    "fused_uncertainty_at": ("diffuvolume_tpu_torch/csrc/fused_head.cu",
                             "diffuvolume_tpu/ops/pallas/fused_head.py:195",
                             "fused_uncertainty_at"),
    "unpack_hwdc": ("diffuvolume_tpu_torch/csrc/layout.cu",
                    "diffuvolume_tpu/ops/pallas/conv3d.py:1178", "unpack_hwdc_k"),
    "conv3d_fold_small": ("diffuvolume_tpu_torch/csrc/conv3d_fold.cu",
                          "diffuvolume_tpu/ops/pallas/conv3d.py:301", "conv3d_fold"),
    "conv3d_packed": ("diffuvolume_tpu_torch/csrc/conv3d_fold.cu",
                      "diffuvolume_tpu/ops/pallas/conv3d.py:131", "conv3d_packed"),
    "conv2d_flat": ("diffuvolume_tpu_torch/csrc/conv2d_flat.cu",
                    "diffuvolume_tpu/ops/pallas/conv2d.py:54", "conv2d_flat"),
}


def census_fewer(runs: dict, base: str, run: str, want: dict) -> dict:
    """Assert that ``run``'s census has exactly ``want`` fewer of each op
    than ``base``'s (``conv_5d_dense``: cuDNN's dense 3-D convs); return the
    differences, with the 5-D copies ``run`` adds."""
    a, b = runs[base]["census"], runs[run]["census"]

    def count(c, k):
        return c["conv_5d"].get("dense", 0) if k == "conv_5d_dense" else c[k]
    fewer = {k: count(a, k) - count(b, k) for k in want}
    rec = dict(fewer=fewer, expected=want, copy_5d_added=b["copy_5d"] - a["copy_5d"])
    log(f"  census against {base}: fewer {fewer} (expected {want}); 5-D copies added "
        f"{rec['copy_5d_added']}")
    if fewer != want:
        raise AssertionError(f"{run}'s census is not {want} below {base}'s: {fewer}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "diffuvolume_tpu_torch")):
        print(f"chip_smoke: no diffuvolume_tpu_torch package beside {__file__}; nothing was "
              f"run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from diffuvolume_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    starts = {}  # phase → its start, seconds into the run
    dev = torch.device("cuda:0")
    # Phase 3's plain versions and library yardsticks compute float32 convs
    # and matmuls outside the pipelines: TF32 off for them, PyTorch's
    # defaults back before phase 4, where the pipelines set their own
    # precision (eval/pipeline.py float32_exact).
    tf32_defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    starts["1"] = time.perf_counter() - t_start
    log("== 1. card")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    starts["2"] = time.perf_counter() - t_start
    log("== 2. build")
    path, build_s = _build.build()
    _build.library()
    log(f"  {path.name}: {build_s:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    starts["3"] = time.perf_counter() - t_start
    log("== 3. kernels against their plain versions (every path's shapes)")
    ncdhw = kernel_checks(dev)
    checks = {**ncdhw, **head_checks(dev), **volume_cl_checks(dev), **front_checks(dev),
              **pcw_mul_checks(dev),
              **conv_checks(dev, CONV_CASES, "ACV", iters=10), **layout_checks(dev)}
    checks["pcw_convs"] = conv_checks(dev, PCW_CONV_CASES, "PCW", iters=10)
    checks["gwcnet_g_convs"] = conv_checks(dev, GWCNET_G_CONV_CASES, "gwcnet-g (its volume "
                                           "convs at C_in 48; the rest as PCW's)", iters=10)
    igev = igev_volume_checks(dev)
    checks["igev_convs"] = conv_checks(dev, IGEV_CONV_CASES, "IGEV folded", iters=10)
    small = conv_checks(dev, IGEV_SMALL_CASES, "IGEV module", iters=10)
    checks["igev_volumes"] = {"gwc_volume": igev["gwc_volume"]}
    checks["unpack_hwdc"], checks["conv3d_fold_small"] = igev["unpack_hwdc"], small[
        "conv3d_fold_small"]
    checks["conv2d_flat"] = refine_checks(dev)
    checks["pcw_refine_downsamples"] = conv_checks(
        dev, REFINE_DOWN_CASES, "PCW folded refinement's 1×1 downsamples", iters=10)
    packed_checks = {m: conv_checks(dev, cases, f"{m.upper()} module, routed", iters=10)
                     for m, cases in PACKED_CASES.items()}
    errs = {t: max(p["conv3d_packed"]["errs"][t] for p in packed_checks.values())
            for t in ("float32", "bfloat16")}
    checks["conv3d_packed"] = mixed(
        [c for p in packed_checks.values() for c in p["conv3d_packed"]["shapes"]], errs)
    checks["conv3d_packed"]["pair_totals_ms"] = {m: p["conv_pair_totals_ms"]
                                                 for m, p in packed_checks.items()}
    t_checks = time.perf_counter() - t_start
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults

    starts["4"] = time.perf_counter() - t_start
    log("== 4. small input: each pipeline on the card against the CPU (float32)")
    agreement = small_agreement(dev)

    counters = kernel_counters()
    runs = {}
    starts["5"] = time.perf_counter() - t_start
    log("== 5. ACV main path: two-pass DDIM-5, 512×960, B=1, bfloat16, folded (packed=True)")
    runs["acv_folded"] = main_path(dev, counters, packed=True, pairs=TIMED_PAIRS)
    starts["6"] = time.perf_counter() - t_start
    log("== 6. ACV module path (packed=False), same inputs")
    runs["acv_module"] = main_path(dev, counters, packed=False, pairs=MODULE_TIMED_PAIRS)
    log("   ACV module path after route_conv3d (row 15), same inputs")
    runs["acv_module_routed"] = main_path(dev, counters, packed=False,
                                          pairs=ROUTED_TIMED_PAIRS["acv"], routed=True)
    census = {"acv_module_routed": census_fewer(runs, "acv_module", "acv_module_routed", {
        "conv_5d_dense": routed_launches("acv")["conv3d_packed"]})}
    starts["7"] = time.perf_counter() - t_start
    log(f"== 7. PCW path: two-pass KITTI12 DDIM-3, {PCW_H}×{PCW_W}, B=1, bfloat16, folded; then "
        f"gwcnet-g")
    pcw_keep = {}
    runs["pcw_folded"] = pcw_path(dev, counters, packed=True, pairs=PCW_TIMED_PAIRS,
                                  keep=pcw_keep.setdefault("folded", {}))
    log("   PCW folded path with the module refinement (cuDNN), same inputs")
    runs["pcw_folded_module_refine"] = pcw_path(dev, counters, packed=True,
                                                pairs=PCW_MODULE_REFINE_TIMED_PAIRS,
                                                refine_module=True)
    ops = runs["pcw_folded"]["refine_ops"]
    census["pcw_folded"] = census_fewer(runs, "pcw_folded_module_refine", "pcw_folded", {
        k: ops[k] * (1 + PCW_STEPS) for k in ("batch_norm_4d", "conv_4d")})
    log("   PCW module path (packed=False), same inputs")
    runs["pcw_module"] = pcw_path(dev, counters, packed=False, pairs=PCW_MODULE_TIMED_PAIRS,
                                  keep=pcw_keep.setdefault("module", {}))
    log("   PCW module path after route_conv3d (row 15), same inputs")
    runs["pcw_module_routed"] = pcw_path(dev, counters, packed=False,
                                         pairs=ROUTED_TIMED_PAIRS["pcw"], routed=True)
    census["pcw_module_routed"] = census_fewer(runs, "pcw_module", "pcw_module_routed", {
        "conv_5d_dense": routed_launches("pcw")["conv3d_packed"]})
    log("   gwcnet-g (PCWNet without the concat volume) and its DDIM model, folded, the same "
        "images")
    finals = {}
    runs["gwcnet_g_folded"] = pcw_path(dev, counters, packed=True, pairs=PCWG_TIMED_PAIRS,
                                       concat=False, keep=finals.setdefault("folded", {}))
    log("   gwcnet-g module path (packed=False), same inputs")
    runs["gwcnet_g_module"] = pcw_path(dev, counters, packed=False,
                                       pairs=PCWG_MODULE_TIMED_PAIRS, concat=False,
                                       keep=finals.setdefault("module", {}))
    agreement["gwcnet-g folded against module, 384×1248"] = fold_vs_module(dev, finals)
    agreement["pcw bfloat16 folded against module, 384×1248"] = bf16_path_gap(
        "PCW 384×1248", pcw_keep["folded"], pcw_keep["module"])
    starts["8"] = time.perf_counter() - t_start
    log(f"== 8. IGEV path: two-pass KITTI15 DDIM-2, {IGEV_H}×{IGEV_W}, {IGEV_ITERS} GRU "
        f"iterations a rollout, B=1, bfloat16, folded")
    runs["igev_folded"] = igev_path(dev, counters, packed=True, pairs=IGEV_TIMED_PAIRS)
    log("   IGEV module path (packed=False), same inputs")
    runs["igev_module"] = igev_path(dev, counters, packed=False, pairs=IGEV_MODULE_TIMED_PAIRS)
    log("   IGEV module path after route_conv3d (row 15), same inputs")
    runs["igev_module_routed"] = igev_path(dev, counters, packed=False,
                                           pairs=ROUTED_TIMED_PAIRS["igev"], routed=True)
    census["igev_module_routed"] = census_fewer(runs, "igev_module", "igev_module_routed", {
        "conv_5d_dense": routed_launches("igev")["conv3d_packed"]})
    starts["9"] = time.perf_counter() - t_start
    log(f"== 9. the evaluation entry point: cli/evaluate (ACV DDIM-5, random weights, "
        f"{EVAL_PAIRS} synthetic SceneFlow pairs {EVAL_H}×{EVAL_W} cropped to "
        f"{MAIN_H}×{MAIN_W}, float32), then tools/bench.py")
    runs["acv_evaluate_cli"] = evaluate_phase(dev, counters, card)
    starts["10"] = time.perf_counter() - t_start
    log("== 10. training: the wrappers refuse tracked inputs, one ACV step on the card "
        "against the CPU, then cli/train.py: the ACV SceneFlow recipe at 256×512, batch 4, "
        "with its epoch evaluation; PCW KITTI12 (pcwnet_ddim and gwcnet-g) and IGEV KITTI15")
    t_train = time.perf_counter()
    training = training_phase(dev, counters, card)
    training["elapsed_s"] = time.perf_counter() - t_train
    log(f"  training phase: {training['elapsed_s']:.1f} s")
    acv_train = training["recipes"]["acv_sceneflow"]
    runs["acv_train_cli"] = dict(launches=acv_train["launches"], launches_per_pair={
        k: v / 1 for k, v in acv_train["launches"].items()})
    starts["11"] = time.perf_counter() - t_start
    log("== 11. IGEV's reference-faithful evaluation (quirk=True), data parallelism, the "
        "training step's profile")
    later = phase_11(dev, counters, runs, card)
    starts["12"] = time.perf_counter() - t_start
    log("== 12. the cost volume's rows split over 2 processes on cuda:0 (gloo): the ACV, PCW "
        "and IGEV module path forwards and training steps, against the unsplit runs")
    split = phase_12(dev, counters, runs, card)

    kernels = []
    for name, (source, replaces, tpu_fn) in KERNEL_META.items():
        c = checks[name]
        launches = {path: r["launches"][name] for path, r in runs.items()}
        if not sum(launches.values()):
            raise AssertionError(f"{name} was launched on no path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_kernel": f"{replaces.split(':')[0]}:{tpu_fn}",
            "launches": sum(launches.values()), "launches_by_path": launches,
            "launches_per_pair": {path: r["launches_per_pair"][name] for path, r in runs.items()},
            "max_abs_err": c["errs"]["float32"],
            "max_abs_err_bf16": c["errs"]["bfloat16"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": c["library_ms"], "timed_dtype": c["dtype"],
            **({"ms_by_path": c["ms_by_path"]} if "ms_by_path" in c else {}),
        })
    kind = torch.cuda.get_device_name(0)
    elapsed = time.perf_counter() - t_start
    log(f"== done in {elapsed:.1f} s (phases 1-3: {t_checks:.1f} s)")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_s": build_s, "kernels": kernels, "kernel_checks": checks,
                   "ncdhw_volume_checks": {k: ncdhw[k] for k in ("concat_volume", "dhw_mul")},
                   "agreement": agreement, "runs": runs, "census_against": census,
                   "training": training, "phase_11": later, "phase_12": split,
                   "elapsed_s": elapsed, "phase_start_s": starts}, f,
                  indent=1)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
