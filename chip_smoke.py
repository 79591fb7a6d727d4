"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any fault exits non-zero; nothing runs without a CUDA device):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from ``diffuvolume_tpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at every
     shape the main path gives it, in float32 (TF32 off) and bfloat16:
     max-abs error against the stated tolerance, kernel / plain times (CUDA
     events), the time of one PyTorch call computing the same function where
     there is one, and the bound (bytes or operations over the H100's peak
     rates); the convs with the epilogue the path gives each shape, and
     their total over one pair's launches;
  4. agreement on a small input: the whole two-pass pipeline on the card
     against the same pipeline on the CPU (plain versions), float32, same
     seeded weights and injected draws, on the folded path and on the module
     path;
  5. the main path: ACV two-pass DDIM-5 at 512×960, batch 1, bfloat16 model,
     folded path (``packed=True``), weights and images from a fixed seed;
     one warm-up pair, 30 timed pairs (pairs/s with median and spread),
     per-pair kernel launch counts (asserted), an op census of one pair (no
     3-D BatchNorm, no 3-D conv but the depthwise patch convs), output
     finite in [0, 191];
  6. the module path (``packed=False``) the same way, 5 timed pairs;
  7. one ``kernels`` JSON line, the card line, and the result line.
Everything printed is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
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
TIMED_PAIRS = 30
MODULE_TIMED_PAIRS = 5
FULL, HALF, QUARTER = (D4, H4, W4), (D4 // 2, H4 // 2, W4 // 2), (D4 // 4, H4 // 4, W4 // 4)


def log(*args):
    print(*args, flush=True)


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
    from diffuvolume_tpu_torch.ops.kernels import fused_head as kf
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(dev)

    bf16_ulp = 2.0 ** -7  # one bfloat16 ulp, relative, at worst
    out = {}
    hw_out = MAIN_H * MAIN_W

    # -- fused head: cost (1, 48, 128, 240) → (512, 960), 192 bins
    log("fused_upsample_softargmin  cost (1,48,128,240) → (1,512,960), D=192")
    cost32 = randn(1, D4, H4, W4) * 3.0
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        cost = cost32.to(dt)
        disp, unc = kf.fused_upsample_softargmin(cost, MAIN_DISP, (MAIN_H, MAIN_W))
        pd, pu = kf.fused_upsample_softargmin_plain(cost, MAIN_DISP, (MAIN_H, MAIN_W))
        torch.cuda.synchronize()
        tag = str(dt).split(".")[1]
        errs[tag] = max(check(f"{tag} disp", disp, pd, 1e-4, 1e-4),
                        check(f"{tag} unc", unc, pu, 1e-4, 1e-4))
    ms = time_ms(lambda: kf.fused_upsample_softargmin(cost32, MAIN_DISP, (MAIN_H, MAIN_W)), 50)
    plain_ms = time_ms(lambda: kf.fused_upsample_softargmin_plain(
        cost32, MAIN_DISP, (MAIN_H, MAIN_W)), 5)
    nbytes = cost32.numel() * 4 + 2 * hw_out * 4
    ops = hw_out * (9 * D4 + 13 * MAIN_DISP + 2)
    out["fused_head"] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound=bound(nbytes, ops),
                             library_ms=None, dtype="float32")

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
    ms = time_ms(lambda: kg.gwc_volume(lb, rb, D4, GROUPS), 20)
    plain_ms = time_ms(lambda: plain.build_gwc_volume(lb, rb, D4, GROUPS), 3)
    cpg = FEAT_C // GROUPS
    pairs_dw = sum(max(W4 - d, 0) for d in range(D4))
    nbytes = 2 * lb.numel() * 2 + GROUPS * D4 * H4 * W4 * 2
    ops = GROUPS * H4 * pairs_dw * 2 * cpg
    out["gwc_volume"] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound=bound(nbytes, ops),
                             library_ms=None, dtype="bfloat16")

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
    ms = time_ms(lambda: kc.concat_volume(clb, crb, D4, attb), 20)
    plain_ms = time_ms(lambda: plain.concat_volume_mul(clb, crb, D4, attb), 3)
    vol_elems = 2 * CAT_C * D4 * H4 * W4
    nbytes = 2 * clb.numel() * 2 + attb.numel() * 2 + vol_elems * 2
    out["concat_volume"] = dict(errs=errs, ms=ms, plain_ms=plain_ms,
                                bound=bound(nbytes, vol_elems), library_ms=None,
                                dtype="bfloat16")

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
    ms = time_ms(lambda: kc.dhw_mul(volb, attb, noiseb), 20)
    plain_ms = time_ms(lambda: plain.volume_dhw_mul(volb, attb, noiseb), 3)
    # The library: one bfloat16 einsum on the same three inputs (two bf16
    # roundings, so within 2⁻⁶ relative of the kernel's one).  For scale
    # only, bf16 torch.mul with the att ⊙ noise map already formed.
    def library():
        return torch.einsum("bcdhw,bdhw,bdhw->bcdhw", volb, attb, noiseb)
    check("bfloat16 library einsum", library(), kc.dhw_mul(volb, attb, noiseb), 0.0, 2.0 ** -6)
    library_ms = time_ms(library, 20)
    mapb = attb * noiseb
    mul_ms = time_ms(lambda: torch.mul(volb, mapb[:, None]), 20)
    nbytes = 2 * volb.numel() * 2 + 2 * attb.numel() * 2
    ops = attb.numel() + volb.numel()
    out["dhw_mul"] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound=bound(nbytes, ops),
                          library_ms=library_ms, library_mul_ms=mul_ms, dtype="bfloat16")
    del volb, mapb
    for k, v in out.items():
        lib = "" if v["library_ms"] is None else f", library {v['library_ms']:.4f} ms"
        log(f"  {k}: {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms{lib}, "
            f"bound {v['bound'][0]:.4f} ms by {v['bound'][1]}, {v['dtype']})")
    log(f"  dhw_mul for scale: bf16 torch.mul with the map formed {mul_ms:.4f} ms")
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


def volume_cl_checks(dev) -> dict:
    """Phase 3, rows 3-4 in their channels-last forms (the folded path's)."""
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
        cases.append(dict(
            label=label, per_pair=1,
            ms=time_ms(lambda: kc.concat_volume(clb, crb, D4, a, channels_last=True), 20),
            plain_ms=time_ms(lambda: plain.concat_volume_mul(clb, crb, D4, a, True), 3),
            library_ms=None, bound_ms=b_ms, ops_ms=0.0))
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
    out["dhw_mul"] = mixed([dict(
        label="(1,48,128,240,64)", per_pair=STEPS,
        ms=time_ms(lambda: kc.dhw_mul(volb, attb, noiseb, channels_last=True), 20),
        plain_ms=time_ms(lambda: plain.volume_dhw_mul(volb, attb, noiseb, True), 3),
        library_ms=time_ms(library, 20), bound_ms=b_ms, ops_ms=0.0)], errs)
    for k, v in out.items():
        lib = "" if v["library_ms"] is None else f", library {v['library_ms']:.4f} ms"
        log(f"  {k} (channels-last): {v['ms']:.4f} ms per launch (plain {v['plain_ms']:.4f} ms"
            f"{lib}, bound {v['bound'][0]:.4f} ms by {v['bound'][1]})")
    return out


class ConvCase(NamedTuple):
    """One main-path conv shape: its wrapper (row), kind ("p" 3×3×3 stride
    1, "s2" stride 2, "k1" 1×1×1, "up" transposed), channels, input (D, H,
    W), launches per pair and the epilogue the path gives it.  ``real_cin``:
    the input channels that carry data when the slot holds zero fill."""
    row: str
    label: str
    kind: str
    cin: int
    cout: int
    dhw: tuple
    per_pair: int
    residual: bool = False
    relu: bool = True
    bias: bool = True
    real_cin: int | None = None


# The conv launches of one main-path pair: 6 aggregation passes (baseline +
# 5 DDIM steps; each: the dres0_0 wide entry; dres0_1, dres1_0 and
# classif2_0 at 32→32; dres1_1 + residual; the 32→1 head; 2 hourglasses)
# and 2 attention chains (baseline + DDIM prep; each: the dres1_att_0 wide
# entry; dres1_att_1, no ReLU; classif_att_0; the head; 1 hourglass).  An
# hourglass: conv1 s2, conv2, conv3 s2, conv4, the redir2 / redir1 1×1s (no
# ReLU), the transposed conv5 and conv6 (+ redir, ReLU).
CONV_CASES = [
    ConvCase("conv3d_fold_p", "32→32", "p", 32, 32, FULL, 20),
    ConvCase("conv3d_fold_p", "32→32, no ReLU", "p", 32, 32, FULL, 2, relu=False),
    ConvCase("conv3d_fold_p", "32→32 + residual, no ReLU", "p", 32, 32, FULL, 6,
             residual=True, relu=False),
    ConvCase("conv3d_fold_p", "32→1 head, no bias or ReLU", "p", 32, 1, FULL, 8,
             relu=False, bias=False),
    ConvCase("conv3d_fold_p", "64→64 half", "p", 64, 64, HALF, 14),
    ConvCase("conv3d_fold_p", "128→128 quarter", "p", 128, 128, QUARTER, 14),
    ConvCase("conv3d_fold_x2", "64→32", "p", 64, 32, FULL, 6),
    ConvCase("conv3d_fold_x2", "40 in a 48 slot→32", "p", 48, 32, FULL, 2, real_cin=GROUPS),
    ConvCase("conv3d_fold_s2", "32→64 full→half", "s2", 32, 64, FULL, 14),
    ConvCase("conv3d_fold_s2", "64→128 half→quarter", "s2", 64, 128, HALF, 14),
    ConvCase("conv1x1_fold_p", "32→32, no ReLU", "k1", 32, 32, FULL, 14, relu=False),
    ConvCase("conv1x1_fold_p", "64→64 half, no ReLU", "k1", 64, 64, HALF, 14, relu=False),
    ConvCase("conv3d_fold_up", "128→64 quarter→half + residual", "up", 128, 64, QUARTER, 14,
             residual=True),
    ConvCase("conv3d_fold_up", "64→32 half→full + residual", "up", 64, 32, HALF, 14,
             residual=True),
]


def case_inputs(case: ConvCase, dev, dtype, seed: int) -> dict:
    """A case's operands from ``seed`` (the same values in every dtype,
    rounded): x, w, bias (float32, or None), res (or None), and geometry.
    Channels past ``real_cin`` are zero in x and w, as pack and the fold
    leave them."""
    ks = 1 if case.kind == "k1" else 3
    stride = 2 if case.kind == "s2" else 1
    if case.kind == "up":
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
    return dict(x=x.to(dev, dtype), w=w.to(dev, dtype), bias=bias.to(dev) if case.bias else None,
                res=None if res is None else res.to(dev, dtype), ks=ks, stride=stride, out_dhw=o)


def case_calls(case: ConvCase, op: dict):
    """``(kernel call, plain call)`` of a case on the operands ``op``, with
    the case's epilogue."""
    from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
    from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup

    x, w, bias, res, relu = op["x"], op["w"], op["bias"], op["res"], case.relu
    if case.kind == "up":
        return (lambda: kup.conv3d_fold_up(x, w, bias, residual=res, relu=relu),
                lambda: kup.conv3d_up_plain(x, w, bias, res, relu))
    fn = getattr(kconv, case.row)
    if case.row == "conv3d_fold_p":
        kernel = lambda: fn(x, w, bias, residual=res, relu=relu)  # noqa: E731
    else:
        kernel = lambda: fn(x, w, bias, relu=relu)  # noqa: E731
    return kernel, lambda: kconv.conv3d_fold_plain(x, w, bias, op["stride"], res, relu)


# float32: the FMA kernel against cuDNN's float32 conv (TF32 off), summation
# order only.  bfloat16: the same float32 sums of the same bf16 products,
# each rounded once: one bf16 ulp (2⁻⁷ relative) at most.
CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -7)}


def conv_checks(dev) -> dict:
    """Phase 3, rows 5-9: the fold-conv kernels at every main-path shape
    (``CONV_CASES``), each with the epilogue the path gives it."""
    import torch.nn.functional as F

    rows: dict[str, tuple[dict, list]] = {}
    for i, case in enumerate(CONV_CASES):
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
        ms = time_ms(kernel, 20)
        plain_ms = time_ms(plain, 3)
        # The library: cuDNN on channels-last bf16 operands, with the case's
        # bias (no residual, no ReLU); never called by the port.
        ks, stride = op["ks"], op["stride"]
        x_cl = op["x"].permute(0, 4, 1, 2, 3)
        bias, bias_b = op["bias"], None if op["bias"] is None else op["bias"].bfloat16()
        if case.kind == "up":
            w_lib = op["w"].permute(3, 4, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)

            def library():
                return F.conv_transpose3d(x_cl, w_lib, bias_b, stride=2, padding=1,
                                          output_padding=1)
            lib_ref = F.conv_transpose3d(x_cl.float(), w_lib.float(), bias, stride=2,
                                         padding=1, output_padding=1)
        else:
            w_lib = op["w"].permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)

            def library():
                return F.conv3d(x_cl, w_lib, bias_b, stride=stride, padding=(ks - 1) // 2)
            lib_ref = F.conv3d(x_cl.float(), w_lib.float(), bias, stride=stride,
                               padding=(ks - 1) // 2)
        lib_err = float((library().float() - lib_ref).abs().max())
        library_ms = time_ms(library, 20)
        # The bound counts the function the path needs: the real input
        # channels, not the slot's zero fill.
        o = op["out_dhw"]
        out_vox, in_vox = o[0] * o[1] * o[2], d * h * w
        cin_f = case.real_cin or cin
        taps = 27 / 8 if case.kind == "up" else ks ** 3
        macs = out_vox * taps * cin_f * cout
        nbytes = (in_vox * cin_f + ks ** 3 * cin_f * cout
                  + out_vox * cout * (2 if case.residual else 1)) * 2
        nbytes += cout * 4 if case.bias else 0
        b_ms, by = bound(nbytes, 2 * macs, BF16_TC_OPS_PER_S)
        log(f"  bf16 {ms:.4f} ms (plain {plain_ms:.4f}, library {library_ms:.4f} ms [max |Δ| "
            f"to its float32 {lib_err:.2e}], bound {b_ms:.4f} ms by {by}); "
            f"{case.per_pair} per pair")
        rows[case.row][1].append(dict(
            label=case.label, cin=cin, real_cin=cin_f, cout=cout, in_dhw=[d, h, w],
            out_dhw=list(o), residual=case.residual, relu=case.relu, bias=case.bias,
            per_pair=case.per_pair, errs=e, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library_max_abs_vs_f32=lib_err, bound_ms=b_ms, bound_by=by,
            ops_ms=2 * macs / BF16_TC_OPS_PER_S * 1e3, macs=macs, bytes=nbytes))
        del op, x_cl, w_lib, lib_ref
    cases = [c for _, rec in rows.values() for c in rec]
    totals = {k: sum(c[k] * c["per_pair"] for c in cases)
              for k in ("ms", "bound_ms", "library_ms", "plain_ms")}
    log(f"  one pair's conv launches: kernels {totals['ms']:.2f} ms, bound "
        f"{totals['bound_ms']:.2f} ms, library {totals['library_ms']:.2f} ms, plain "
        f"{totals['plain_ms']:.2f} ms")
    out = {row: mixed(rec, errs) for row, (errs, rec) in rows.items()}
    out["conv_pair_totals_ms"] = totals
    return out


def layout_checks(dev) -> dict:
    """Phase 3, rows 11-12: pack (NCDHW → NDHWC, slot fill) and unpack."""
    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    g = torch.Generator().manual_seed(4)
    out = {}
    # (label, C, c_slot, (D, H, W), per pair): the patch volume into its
    # 48-channel slot (one per attention chain) and the hourglass bottleneck
    # after the attention block (one per hourglass).
    for name, cases in (("pack", [("40→48 slot, full", GROUPS, 48, FULL, 2),
                                   ("128, quarter", 128, 128, QUARTER, 14)]),
                        ("unpack", [("128, quarter", 128, 128, QUARTER, 14)])):
        errs, rec = {}, []
        for label, c, c_slot, (d, h, w), per_pair in cases:
            log(f"{name} {label}: C {c}, (D,H,W) ({d},{h},{w})")
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
            else:
                def library():
                    return xb.permute(0, 4, 1, 2, 3).contiguous()
            nbytes = (c + c_slot) * d * h * w * 2
            b_ms, _ = bound(nbytes, 0)
            rec.append(dict(label=label, c=c, c_slot=c_slot, dhw=[d, h, w], per_pair=per_pair,
                            ms=time_ms(lambda: fn(xb), 50),
                            plain_ms=time_ms(lambda: ref(xb), 10),
                            library_ms=time_ms(library, 50), bound_ms=b_ms, ops_ms=0.0))
            r = rec[-1]
            log(f"  bf16 {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                f"{r['library_ms']:.4f}, bound {b_ms:.4f} ms by bytes); {per_pair} per pair")
        out[name] = mixed(rec, errs)
    return out


def small_agreement(dev) -> dict:
    """Phase 4: the pipeline on the card against the CPU, float32, 32×64,
    max_disp 64, on both paths.  The tolerance is the one the CPU parity test
    calibrated against the JAX package (tests/test_torch_pipeline.py)."""
    from diffuvolume_tpu_torch.diffusion import DDIMConfig
    from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference
    from diffuvolume_tpu_torch.tools.random_weights import calibrate_heads, random_pair

    h, w, md = 32, 64, 64
    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, h, w, 3)).astype(np.float32) * 0.3
    right = np.roll(left, -3, axis=2)
    cfg = DDIMConfig(max_disp=md, num_bins=md // 4)
    shape = (cfg.sampling_steps, 1, md // 4, h // 4, w // 4)
    ns = {"z": rng.standard_normal(shape).astype(np.float32),
          "replace": rng.uniform(size=shape).astype(np.float32)}
    bm, dm = random_pair(md, torch.Generator().manual_seed(0))
    calibrate_heads(bm, torch.from_numpy(left), torch.from_numpy(right), target_std=10.0)
    dm.load_state_dict(bm.state_dict(), strict=False)
    bg, dg = copy.deepcopy(bm).to(dev), copy.deepcopy(dm).to(dev)
    out = {}
    for packed in (True, False):
        name = "folded" if packed else "module"
        cpu_final, cpu_base = acv_ddim_inference(bm, dm, left, right, cfg, device="cpu",
                                                 noise_source=ns, packed=packed)
        final, base = acv_ddim_inference(bg, dg, left, right, cfg, device=dev,
                                         noise_source=ns, packed=packed)
        torch.cuda.synchronize()
        e_base = (base.cpu() - cpu_base).abs()
        e_final = (final.cpu() - cpu_final).abs()
        res = dict(baseline_max=float(e_base.max()), final_max=float(e_final.max()),
                   final_mean=float(e_final.mean()))
        log(f"  {name} path: baseline max |Δ| {res['baseline_max']:.3e} px (tol 1e-2); "
            f"final max |Δ| {res['final_max']:.3e} px (tol 0.1), mean "
            f"{res['final_mean']:.3e} px (tol 5e-3)")
        if not (res["baseline_max"] < 1e-2 and res["final_max"] < 0.1
                and res["final_mean"] < 5e-3):
            raise AssertionError(f"the {name} pipeline on the card disagrees with the CPU")
        out[name] = res
    return out


def expected_launches(packed: bool) -> dict:
    """Launches per pair: 6 aggregation passes (baseline + 5 DDIM steps) and
    2 attention chains (baseline + DDIM prep).  The convs are
    ``CONV_CASES``; an aggregation pass has 2 pack + 2 unpack, an attention
    chain 2 pack + 1 unpack."""
    out = {"fused_head": 6, "gwc_volume": 2, "concat_volume": 2, "dhw_mul": STEPS}
    folded = {"pack": 16, "unpack": 14}
    for case in CONV_CASES:
        folded[case.row] = folded.get(case.row, 0) + case.per_pair
    out.update({k: (v if packed else 0) for k, v in folded.items()})
    return out


def op_census(fn) -> dict:
    """The 5-D BatchNorm and 5-D convolution ATen calls ``fn`` makes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {"batch_norm_5d": 0, "conv_5d": {}}

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
            return func(*args, **(kwargs or {}))

    with Census():
        fn()
    return seen


def main_path(dev, counters, packed: bool, pairs: int) -> dict:
    """Phases 5 and 6: ACV two-pass DDIM-5 at 512×960, bfloat16 model."""
    from diffuvolume_tpu_torch.diffusion import DDIMConfig, ddim_sample, make_schedule
    from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference, acv_prep
    from diffuvolume_tpu_torch.models.acv_fold import fold_acv
    from diffuvolume_tpu_torch.tools.random_weights import seeded_main_path

    bm, dm, left, right = seeded_main_path(dev, MAIN_H, MAIN_W, MAIN_DISP)
    if packed:  # folded once, as a caller running many pairs does
        bm, dm = fold_acv(bm), fold_acv(dm)
    cfg = DDIMConfig(max_disp=MAIN_DISP, num_bins=D4)

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return acv_ddim_inference(bm, dm, left, right, cfg, device=dev, generator=gen,
                                  packed=packed)

    pair(100)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    times = []
    for i in range(pairs):
        t0 = time.perf_counter()
        final, base = pair(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    # One more pair split into its stages, and one under the op census (not
    # counted above).
    with torch.no_grad():
        t0 = time.perf_counter()
        b_disp, b_lat, entry = acv_prep(bm, dm, left, right, cfg, packed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sched = make_schedule(1000, device=dev)
        ddim_sample(sched, cfg, lambda lat, t: dm.denoise(entry, lat, t, (MAIN_H, MAIN_W)),
                    b_disp, b_lat, generator=torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    census = op_census(lambda: pair(200))

    per_pair = {k: v / pairs for k, v in launches.items()}
    expected = expected_launches(packed)
    fin = final.float()
    ms_sorted = sorted(t * 1e3 for t in times)
    res = dict(
        pair_s=times, pairs_per_s=pairs / sum(times),
        pair_ms_median=float(np.median(ms_sorted)), pair_ms_min=ms_sorted[0],
        pair_ms_max=ms_sorted[-1], pair_ms_p10=float(np.percentile(ms_sorted, 10)),
        pair_ms_p90=float(np.percentile(ms_sorted, 90)),
        prep_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3 / STEPS,
        peak_mem_bytes=peak, launches=launches, launches_per_pair=per_pair, census=census,
        out_shape=list(fin.shape), out_min=float(fin.min()), out_max=float(fin.max()),
        finite=bool(torch.isfinite(fin).all()),
    )
    log(f"  {pairs} pairs: {res['pairs_per_s']:.4f} pairs/s (total work over total "
        f"time); ms per pair median {res['pair_ms_median']:.2f}, p10 {res['pair_ms_p10']:.2f}, "
        f"p90 {res['pair_ms_p90']:.2f}, min {res['pair_ms_min']:.2f}, "
        f"max {res['pair_ms_max']:.2f}")
    log(f"  prep {res['prep_ms']:.1f} ms, per DDIM step {res['step_ms']:.1f} ms, "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches per pair: {per_pair}")
    log(f"  expected:          {expected}")
    log(f"  op census of one pair: {census}")
    log(f"  output {tuple(fin.shape)} in [{res['out_min']:.3f}, {res['out_max']:.3f}], "
        f"finite={res['finite']}")
    if per_pair != expected:
        raise AssertionError(f"launch counts {per_pair} != {expected}")
    if packed and (census["batch_norm_5d"] or set(census["conv_5d"]) - {"depthwise"}):
        raise AssertionError(f"the folded path ran a 3-D BatchNorm or a non-depthwise 3-D "
                             f"conv: {census}")
    if not (res["finite"] and res["out_min"] >= 0.0 and res["out_max"] <= MAIN_DISP - 1
            and tuple(fin.shape) == (1, MAIN_H, MAIN_W)):
        raise AssertionError("main-path output is not a finite (1,512,960) map in [0,191]")
    return res


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
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from diffuvolume_tpu_torch.ops.kernels import _build
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
    from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
    from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
    from diffuvolume_tpu_torch.ops.kernels import layout as kl
    from diffuvolume_tpu_torch.ops.kernels.fused_head import fused_upsample_softargmin
    from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 1. card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    log("== 2. build")
    path, build_s = _build.build()
    _build.library()
    log(f"  {path.name}: {build_s:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    log("== 3. kernels against their plain versions (main-path shapes)")
    ncdhw = kernel_checks(dev)
    checks = {**ncdhw, **volume_cl_checks(dev), **conv_checks(dev), **layout_checks(dev)}

    log("== 4. small input: pipeline on the card against the CPU (float32)")
    agreement = small_agreement(dev)

    counters = {"fused_head": fused_upsample_softargmin, "gwc_volume": gwc_volume,
                "concat_volume": kc.concat_volume, "dhw_mul": kc.dhw_mul,
                "conv3d_fold_p": kconv.conv3d_fold_p, "conv3d_fold_x2": kconv.conv3d_fold_x2,
                "conv3d_fold_s2": kconv.conv3d_fold_s2, "conv3d_fold_up": kup.conv3d_fold_up,
                "conv1x1_fold_p": kconv.conv1x1_fold_p, "pack": kl.pack, "unpack": kl.unpack}
    log("== 5. main path: ACV two-pass DDIM-5, 512×960, B=1, bfloat16, folded (packed=True)")
    run = main_path(dev, counters, packed=True, pairs=TIMED_PAIRS)
    log("== 6. module path (packed=False), same inputs")
    module_run = main_path(dev, counters, packed=False, pairs=MODULE_TIMED_PAIRS)

    kernels = []
    for name, (source, replaces, tpu_fn) in KERNEL_META.items():
        c = checks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_kernel": f"{replaces.split(':')[0]}:{tpu_fn}",
            "launches": run["launches"][name],
            "launches_per_pair": run["launches_per_pair"][name],
            "max_abs_err": c["errs"]["float32"],
            "max_abs_err_bf16": c["errs"]["bfloat16"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": c["library_ms"], "timed_dtype": c["dtype"],
        })
    kind = torch.cuda.get_device_name(0)
    elapsed = time.perf_counter() - t_start
    log(f"== done in {elapsed:.1f} s")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_s": build_s, "kernels": kernels, "kernel_checks": checks,
                   "ncdhw_volume_checks": {k: ncdhw[k] for k in ("concat_volume", "dhw_mul")},
                   "agreement": agreement, "main_path": run, "module_path": module_run,
                   "elapsed_s": elapsed}, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
