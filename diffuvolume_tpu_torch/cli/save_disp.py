"""Disparity-map export CLI (the reference's save_disp_sceneflow.py /
save_disp_sceneflow_kitti12.py / KITTI15 save_disp.py): run the two-model
DDIM pipeline and write 16-bit KITTI-format PNGs or PFMs.

Counterpart of ``diffuvolume_tpu/cli/save_disp.py``, with its arguments plus
``--device``; the models load as in ``cli/evaluate.py``:

    python -m diffuvolume_tpu_torch.cli.save_disp --backbone acv --datapath DIR \\
        --baseline_ckpt BASE.ckpt --ddim_ckpt DDIM.ckpt --outdir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from diffuvolume_tpu_torch.cli.evaluate import BACKBONES, load_model, eval_dataset
from diffuvolume_tpu_torch.data.readers import write_pfm
from diffuvolume_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Save DDIM disparity predictions")
    p.add_argument("--backbone", choices=list(BACKBONES), default="acv")
    p.add_argument("--dataset", default="sceneflow")
    p.add_argument("--datapath", required=True)
    p.add_argument("--testlist", default=None)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--baseline_ckpt", default=None)
    p.add_argument("--ddim_ckpt", default=None)
    p.add_argument("--outdir", default="./predictions")
    p.add_argument("--format", choices=["png16", "pfm"], default="png16")
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda:N (default cuda:0) or cpu")
    return p.parse_args(argv)


def save_png16(path: str, disp: np.ndarray):
    """KITTI submission format: uint16 PNG, disparity × 256."""
    from PIL import Image

    arr = np.clip(disp * 256.0, 0, 65535).astype(np.uint16)
    Image.fromarray(arr).save(path)  # uint16: mode I;16


def main(argv=None) -> list[str]:
    """Write one file a pair; returns their paths."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    dataset = eval_dataset(args)
    _, _, cfg, pipeline, _, fold = BACKBONES[args.backbone]
    cfg = dataclasses.replace(cfg, max_disp=args.maxdisp, num_bins=args.maxdisp // 4)
    baseline = fold(load_model(args.baseline_ckpt, args.backbone, False, args.maxdisp, 0, dev))
    ddim = fold(load_model(args.ddim_ckpt, args.backbone, True, args.maxdisp, 0, dev))
    generator = torch.Generator(device=dev).manual_seed(0)

    written = []
    n = len(dataset) if args.max_images == 0 else min(args.max_images, len(dataset))
    for i in range(n):
        s = dataset[i]
        left = torch.from_numpy(s["left"])[None].to(dev)
        right = torch.from_numpy(s["right"])[None].to(dev)
        final, _ = pipeline(baseline, ddim, left, right, cfg, device=dev, generator=generator)
        disp = final[0].cpu().numpy()
        # strip eval-time padding (top / right, KITTI convention)
        top = int(s.get("top_pad", 0))
        right_pad = int(s.get("right_pad", 0))
        if top or right_pad:
            disp = disp[top:, : disp.shape[1] - right_pad or None]
        name = os.path.basename(s.get("filename", f"{i:06d}.png"))
        out = os.path.join(args.outdir, os.path.splitext(name)[0])
        if args.format == "png16":
            out += ".png"
            save_png16(out, disp)
        else:
            out += ".pfm"
            write_pfm(out, disp)
        written.append(out)
        print(f"[{i + 1}/{n}] wrote {out}")
    return written


if __name__ == "__main__":
    main()
