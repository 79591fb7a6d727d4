"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any fault exits non-zero; nothing runs without a CUDA device):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from ``diffuvolume_tpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, in float32 (TF32 off) and bfloat16: max-abs error against
     the stated tolerance, kernel / plain times (CUDA events), the time of
     one PyTorch call computing the same function where there is one, and the
     bound (bytes or operations over the H100's peak rates);
  4. agreement on a small input: the whole two-pass pipeline on the card
     against the same pipeline on the CPU (plain versions), float32, same
     seeded weights and injected draws;
  5. the main path: ACV two-pass DDIM-5 at 512×960, batch 1, bfloat16 model,
     weights and images from a fixed seed; one warm-up pair, 30 timed pairs
     (pairs/s with median and spread), per-pair kernel launch counts
     (asserted), output finite in [0, 191];
  6. one ``kernels`` JSON line, the card line, and the result line.
Everything printed is also written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_H, MAIN_W, MAIN_DISP = 512, 960, 192
D4, H4, W4 = MAIN_DISP // 4, MAIN_H // 4, MAIN_W // 4
FEAT_C, GROUPS, CAT_C = 320, 40, 32
STEPS = 5
TIMED_PAIRS = 30


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
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


def small_agreement(dev) -> dict:
    """Phase 4: the pipeline on the card against the CPU, float32, 32×64,
    max_disp 64.  The tolerance is the one the CPU parity test calibrated
    against the JAX package (tests/test_torch_pipeline.py)."""
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
    cpu_final, cpu_base = acv_ddim_inference(bm, dm, left, right, cfg, device="cpu",
                                             noise_source=ns)
    bg, dg = copy.deepcopy(bm).to(dev), copy.deepcopy(dm).to(dev)
    final, base = acv_ddim_inference(bg, dg, left, right, cfg, device=dev, noise_source=ns)
    torch.cuda.synchronize()
    e_base = (base.cpu() - cpu_base).abs()
    e_final = (final.cpu() - cpu_final).abs()
    res = dict(baseline_max=float(e_base.max()), final_max=float(e_final.max()),
               final_mean=float(e_final.mean()))
    log(f"  baseline max |Δ| {res['baseline_max']:.3e} px (tol 1e-2); final max |Δ| "
        f"{res['final_max']:.3e} px (tol 0.1), mean {res['final_mean']:.3e} px (tol 5e-3)")
    if not (res["baseline_max"] < 1e-2 and res["final_max"] < 0.1 and res["final_mean"] < 5e-3):
        raise AssertionError("the pipeline on the card disagrees with the CPU")
    return res


def main_path(dev, counters) -> dict:
    """Phase 5: ACV two-pass DDIM-5 at 512×960, bfloat16 model."""
    from diffuvolume_tpu_torch.diffusion import DDIMConfig, ddim_sample, make_schedule
    from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference, acv_prep
    from diffuvolume_tpu_torch.tools.random_weights import seeded_main_path

    bm, dm, left, right = seeded_main_path(dev, MAIN_H, MAIN_W, MAIN_DISP)
    cfg = DDIMConfig(max_disp=MAIN_DISP, num_bins=D4)

    def pair(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        return acv_ddim_inference(bm, dm, left, right, cfg, device=dev, generator=gen)

    pair(100)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    times = []
    for i in range(TIMED_PAIRS):
        t0 = time.perf_counter()
        final, base = pair(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    # One more pair split into its stages (not counted above).
    with torch.no_grad():
        t0 = time.perf_counter()
        b_disp, b_lat, entry = acv_prep(bm, dm, left, right, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sched = make_schedule(1000, device=dev)
        ddim_sample(sched, cfg, lambda lat, t: dm.denoise(entry, lat, t, (MAIN_H, MAIN_W)),
                    b_disp, b_lat, generator=torch.Generator(device=dev).manual_seed(7))
        torch.cuda.synchronize()
        t2 = time.perf_counter()

    per_pair = {k: v / TIMED_PAIRS for k, v in launches.items()}
    expected = {"fused_head": 6, "gwc_volume": 2, "concat_volume": 2, "dhw_mul": STEPS}
    fin = final.float()
    ms_sorted = sorted(t * 1e3 for t in times)
    res = dict(
        pair_s=times, pairs_per_s=TIMED_PAIRS / sum(times),
        pair_ms_median=float(np.median(ms_sorted)), pair_ms_min=ms_sorted[0],
        pair_ms_max=ms_sorted[-1], pair_ms_p10=float(np.percentile(ms_sorted, 10)),
        pair_ms_p90=float(np.percentile(ms_sorted, 90)),
        prep_ms=(t1 - t0) * 1e3, step_ms=(t2 - t1) * 1e3 / STEPS,
        peak_mem_bytes=peak, launches=launches, launches_per_pair=per_pair,
        out_shape=list(fin.shape), out_min=float(fin.min()), out_max=float(fin.max()),
        finite=bool(torch.isfinite(fin).all()),
    )
    log(f"  {TIMED_PAIRS} pairs: {res['pairs_per_s']:.4f} pairs/s (total work over total "
        f"time); ms per pair median {res['pair_ms_median']:.2f}, p10 {res['pair_ms_p10']:.2f}, "
        f"p90 {res['pair_ms_p90']:.2f}, min {res['pair_ms_min']:.2f}, "
        f"max {res['pair_ms_max']:.2f}")
    log(f"  prep {res['prep_ms']:.1f} ms, per DDIM step {res['step_ms']:.1f} ms, "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches per pair: {per_pair} (expected {expected})")
    log(f"  output {tuple(fin.shape)} in [{res['out_min']:.3f}, {res['out_max']:.3f}], "
        f"finite={res['finite']}")
    if per_pair != expected:
        raise AssertionError(f"launch counts {per_pair} != {expected}")
    if not (res["finite"] and res["out_min"] >= 0.0 and res["out_max"] <= MAIN_DISP - 1
            and tuple(fin.shape) == (1, MAIN_H, MAIN_W)):
        raise AssertionError("main-path output is not a finite (1,512,960) map in [0,191]")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from diffuvolume_tpu_torch.ops.kernels import _build
    from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume, dhw_mul
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
    checks = kernel_checks(dev)

    log("== 4. small input: pipeline on the card against the CPU (float32)")
    agreement = small_agreement(dev)

    log("== 5. main path: ACV two-pass DDIM-5, 512×960, B=1, bfloat16")
    counters = {"fused_head": fused_upsample_softargmin, "gwc_volume": gwc_volume,
                "concat_volume": concat_volume, "dhw_mul": dhw_mul}
    run = main_path(dev, counters)

    meta = {  # source, TPU kernel file:line, its function
        "fused_head": ("diffuvolume_tpu_torch/csrc/fused_head.cu",
                       "diffuvolume_tpu/ops/pallas/fused_head.py:83",
                       "fused_upsample_softargmin"),
        "gwc_volume": ("diffuvolume_tpu_torch/csrc/gwc_volume.cu",
                       "diffuvolume_tpu/ops/pallas/gwc_volume.py:67", "gwc_volume_pallas"),
        "concat_volume": ("diffuvolume_tpu_torch/csrc/concat_volume.cu",
                          "diffuvolume_tpu/ops/pallas/conv3d.py:903", "pack_concat_k"),
        "dhw_mul": ("diffuvolume_tpu_torch/csrc/concat_volume.cu",
                    "diffuvolume_tpu/ops/pallas/conv3d.py:1048", "packed_dhw_mul_k"),
    }
    kernels = []
    for name, (source, replaces, tpu_fn) in meta.items():
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
                   "agreement": agreement,
                   "main_path": run, "elapsed_s": elapsed}, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
