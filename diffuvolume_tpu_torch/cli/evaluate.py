"""Evaluation CLI: the reference's test_sceneflow_ddim.py / KITTI12 test.py /
KITTI15 evaluate_stereo.py two-model DDIM evaluation, on the card.

Counterpart of ``diffuvolume_tpu/cli/evaluate.py``, with its arguments and
its printed lines, plus ``--device``:

    python -m diffuvolume_tpu_torch.cli.evaluate --backbone acv --datapath DIR \\
        --baseline_ckpt BASE.ckpt --ddim_ckpt DDIM.ckpt [--device cpu]

It runs on ``cuda:0`` unless ``--device`` says otherwise, and never falls
back to the CPU.  A reference checkpoint (``.ckpt``, ``.pth`` or ``.pt``)
loads with ``load_state_dict``: its ``model`` entry, the ``module.`` prefix
stripped, the reference's diffusion buffers dropped (the port recomputes
them).  Without one, the models are drawn from ``tools/random_weights.py``
with ``--seed``.  Both models run the folded path, folded once.  The DDIM
draws come from a ``torch.Generator`` on the device, seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import time

import torch

from diffuvolume_tpu_torch.data.zoo import fetch_dataset
from diffuvolume_tpu_torch.diffusion import KITTI12_DDIM, KITTI15_DDIM, SCENEFLOW_DDIM
from diffuvolume_tpu_torch.eval.metrics import metrics_batch
from diffuvolume_tpu_torch.eval.pipeline import (
    acv_ddim_inference,
    baseline_inference,
    igev_ddim_inference,
    pcw_ddim_inference,
)
from diffuvolume_tpu_torch.models import build_model
from diffuvolume_tpu_torch.models.acv_fold import fold_acv
from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
from diffuvolume_tpu_torch.tools.random_weights import random_acv, random_igev, random_pcw
from diffuvolume_tpu_torch.utils.device import resolve_device
from diffuvolume_tpu_torch.utils.meters import AverageMeterDict
from diffuvolume_tpu_torch.utils.padding import InputPadder

# backbone → (baseline registry name, DDIM registry name, sampler preset,
# pipeline, random weights, fold)
BACKBONES = {
    "acv": ("acvnet", "acvnet_ddim", SCENEFLOW_DDIM, acv_ddim_inference, random_acv, fold_acv),
    "pcw": ("gwcnet-gc", "pcwnet_ddim", KITTI12_DDIM, pcw_ddim_inference, random_pcw, fold_pcw),
    "igev": ("igev", "igev_ddim", KITTI15_DDIM, igev_ddim_inference, random_igev, fold_igev),
}

# The reference's diffusion buffers, registered in its state dicts but
# recomputed by the port (diffusion/schedule.py make_schedule).
_BUFFER_RE = re.compile(
    r"^(betas|alphas_cumprod|alphas_cumprod_prev|sqrt_alphas_cumprod|"
    r"sqrt_one_minus_alphas_cumprod|log_one_minus_alphas_cumprod|"
    r"sqrt_recip_alphas_cumprod|sqrt_recipm1_alphas_cumprod|posterior_variance|"
    r"posterior_log_variance_clipped|posterior_mean_coef1|posterior_mean_coef2)$"
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiffuVolume DDIM evaluation (PyTorch/CUDA)")
    p.add_argument("--backbone", choices=list(BACKBONES), default="acv")
    p.add_argument("--dataset", default="sceneflow")
    p.add_argument("--datapath", required=True)
    p.add_argument("--testlist", default=None)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--baseline_ckpt", default=None, help="reference .ckpt / .pth / .pt")
    p.add_argument("--ddim_ckpt", default=None)
    p.add_argument("--iters", type=int, default=32, help="IGEV GRU iterations")
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--baseline_only", action="store_true",
        help="evaluate the frozen baseline alone, no DDIM refinement "
        "(the reference's KITTI15/evaluate_stereo_origin.py)",
    )
    p.add_argument("--device", default=None, help="cuda:N (default cuda:0) or cpu")
    return p.parse_args(argv)


def load_model(path: str | None, backbone: str, diffusion: bool, max_disp: int,
               seed: int, device: torch.device):
    """An eval-mode model on ``device``: from a reference checkpoint, or,
    for ``path`` None, seeded random weights (with the JAX CLI's warning)."""
    base_name, ddim_name, _, _, random_model, _ = BACKBONES[backbone]
    if path is None:
        print("WARNING: no checkpoint; using random init")
        model = random_model(max_disp, diffusion, torch.Generator().manual_seed(seed))
    elif path.endswith((".ckpt", ".pth", ".pt")):
        model = build_model(ddim_name if diffusion else base_name, max_disp=max_disp)
        sd = torch.load(path, map_location="cpu")
        sd = sd.get("model", sd)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        model.load_state_dict({k: v for k, v in sd.items() if not _BUFFER_RE.match(k)})
    else:
        raise ValueError(f"unsupported checkpoint: {path}")
    return model.to(device).eval()


def eval_dataset(args):
    """The dataset ``args`` name, in test mode; the list file goes to the
    datasets that are driven by one."""
    kw = {"list_filename": args.testlist} if args.dataset in (
        "sceneflow", "kitti12", "kitti15", "kitti", "kitti1215") else {}
    return fetch_dataset(args.dataset, args.datapath, training=False, **kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, on_pair=None) -> dict:
    """Evaluate as ``main`` does.  ``on_pair(i, final, gt, mask, metrics)``,
    if given, is called for each image with ground truth (its tensors on
    the device).  Returns ``{"final": the means, "pairs_per_s": float or
    None, "device": str}``."""
    dev = resolve_device(args.device)
    dataset = eval_dataset(args)
    _, _, cfg, pipeline, _, fold = BACKBONES[args.backbone]
    cfg = dataclasses.replace(cfg, max_disp=args.maxdisp, num_bins=args.maxdisp // 4)
    baseline = fold(load_model(args.baseline_ckpt, args.backbone, False, args.maxdisp,
                               args.seed, dev))
    ddim = None if args.baseline_only else fold(
        load_model(args.ddim_ckpt, args.backbone, True, args.maxdisp, args.seed, dev))
    iters = {"iters": args.iters} if args.backbone == "igev" else {}
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    meter = AverageMeterDict()
    n = len(dataset) if args.max_images == 0 else min(args.max_images, len(dataset))
    t_total, t_count = 0.0, 0
    for i in range(n):
        s = dataset[i]
        left = torch.from_numpy(s["left"])[None].to(dev)
        right = torch.from_numpy(s["right"])[None].to(dev)
        padder = None
        if left.shape[1] % 32 or left.shape[2] % 32:
            # zero-shot datasets (ETH3D/Middlebury) come in odd sizes; pad to
            # /32 like KITTI15/evaluate_stereo.py:85-86 and unpad the output.
            padder = InputPadder(left.shape, divis_by=32)
            left, right = padder.pad(left, right)
        _sync(dev)
        t0 = time.perf_counter()
        if args.baseline_only:
            final = baseline_inference(baseline, left, right, device=dev, **iters)
        else:
            final, _ = pipeline(baseline, ddim, left, right, cfg, device=dev,
                                generator=generator, **iters)
        if padder is not None:
            final = padder.unpad(final)
        _sync(dev)
        if i > 0:  # the first pair builds the kernels and warms the caches
            t_total += time.perf_counter() - t0
            t_count += 1
        if "disp_gt" in s:
            gt = torch.from_numpy(s["disp_gt"])[None].to(dev)
            mask = (gt > 0) & (gt < args.maxdisp)
            if "valid" in s:
                # Zero-shot loaders carry the reference-defined validity
                # (Middlebury/ETH3D nocc masks, sparse KITTI GT): intersect
                # it as the reference validate_* loops do
                # (KITTI15/evaluate_stereo.py:52,220).
                mask = mask & torch.from_numpy(s["valid"])[None].to(dev)
            m = metrics_batch(final, gt, mask)
            if on_pair is not None:
                on_pair(i, final, gt, mask, m)
            meter.update({k: float(v[0]) for k, v in m.items() if k != "weight"})
        if i % 20 == 0:
            print(f"[{i}/{n}] {meter.mean()}")
    final_means = meter.mean()
    print("FINAL:", final_means)
    # Reference-defined zero-shot headline metric (validate_eth3d uses
    # D1 = err>1px over nocc; validate_middlebury uses err>2px —
    # KITTI15/evaluate_stereo.py:54,220).
    headline = {"eth3d": ("Thres1", "D1(>1px, nocc)"),
                "middlebury": ("Thres2", "D1(>2px)")}
    for prefix, (key, label) in headline.items():
        if args.dataset.startswith(prefix) and key in final_means:
            print(f"HEADLINE {args.dataset} {label}: "
                  f"{100 * final_means[key]:.3f}%")
    pairs_per_s = t_count / t_total if t_count else None
    if t_count:
        print(f"throughput: {pairs_per_s:.3f} pairs/s")
    return {"final": final_means, "pairs_per_s": pairs_per_s, "device": str(dev)}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
