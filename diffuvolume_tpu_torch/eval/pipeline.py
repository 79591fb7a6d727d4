"""Two-model DDIM inference for the ACVNet backbone.

Counterpart of ``diffuvolume_tpu/eval/pipeline.py:acv_ddim_inference``: pass 1
runs the frozen baseline for an initial disparity; pass 2 feeds it to the
DiffuVolume model as conditioning and runs the short DDIM loop.  As in the
JAX package's packed pipeline, the prep builds the DDIM model's concat
volume once, without attention, and each denoise step pays only the
attention × noise multiply.
"""

from __future__ import annotations

import torch

from diffuvolume_tpu_torch.diffusion import DDIMConfig, ddim_sample, make_schedule
from diffuvolume_tpu_torch.diffusion.codec import encode_disparity_volume
from diffuvolume_tpu_torch.models.acv import ACVNet, ConcatEntry
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume
from diffuvolume_tpu_torch.ops.regression import resize_bilinear
from diffuvolume_tpu_torch.utils.device import resolve_device


def _check_on(model: ACVNet, dev: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
        raise ValueError(f"model is on {p.device}, inference asked for {dev}")


@torch.no_grad()
def acv_prep(baseline_model: ACVNet, ddim_model: ACVNet, left: torch.Tensor,
             right: torch.Tensor, cfg: DDIMConfig):
    """Pass 1 and the sampler's inputs: ``(baseline_disp (B,H,W), baseline_latent
    (B,D,H4,W4), ConcatEntry)``."""
    h4, w4 = left.shape[1] // 4, left.shape[2] // 4
    baseline_disp = baseline_model(left, right)[-1]
    cl, cr, att = ddim_model.build_cost_volume(left, right)
    entry = ConcatEntry(concat_volume(cl, cr, cfg.num_bins), att)
    # Conditioning: clamp → bilinear ↓4 → /4.
    disp_q = resize_bilinear(
        baseline_disp.clamp(0.0, cfg.max_disp - 1), (h4, w4), 1, 2) / 4.0
    baseline_latent = encode_disparity_volume(disp_q, cfg.num_bins, cfg.scale)
    return baseline_disp, baseline_latent, entry


@torch.no_grad()
def acv_ddim_inference(
    baseline_model: ACVNet,
    ddim_model: ACVNet,
    left,
    right,
    cfg: DDIMConfig = DDIMConfig(),
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    noise_source: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full two-pass DiffuVolume inference.

    Args:
      baseline_model / ddim_model: eval-mode ``ACVNet``s (``diffusion`` off /
        on), already on ``device``.
      left, right: ``(B, H, W, 3)`` normalised images (tensors or arrays).
      device: where to run; default ``cuda:0``.  ``"cpu"`` runs the plain
        versions of the kernels.
      generator: the DDIM draws' ``torch.Generator`` on ``device``.
      noise_source: injected draws for ``ddim_sample``.

    Returns ``(final_disp (B,H,W), baseline_disp (B,H,W))``, float32.
    """
    dev = resolve_device(device)
    for model in (baseline_model, ddim_model):
        _check_on(model, dev)
    left = torch.as_tensor(left, device=dev, dtype=torch.float32)
    right = torch.as_tensor(right, device=dev, dtype=torch.float32)
    out_hw = (left.shape[1], left.shape[2])
    baseline_disp, baseline_latent, entry = acv_prep(
        baseline_model, ddim_model, left, right, cfg)
    sched = make_schedule(1000, device=dev)

    def denoise_fn(latent, t):
        return ddim_model.denoise(entry, latent, t, out_hw)

    final, _ = ddim_sample(sched, cfg, denoise_fn, baseline_disp, baseline_latent,
                           generator=generator, noise_source=noise_source)
    return final, baseline_disp.float()
