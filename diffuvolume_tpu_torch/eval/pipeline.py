"""Two-model DDIM inference for the ACVNet backbone.

Counterpart of ``diffuvolume_tpu/eval/pipeline.py:acv_ddim_inference``: pass 1
runs the frozen baseline for an initial disparity; pass 2 feeds it to the
DiffuVolume model as conditioning and runs the short DDIM loop.  As in the
JAX package's packed pipeline, the prep builds the DDIM model's concat
volume once, without attention, and each denoise step pays only the
attention × noise multiply.

``packed=True`` (the default) runs both passes on the folded path
(``models/acv_fold.py``: BatchNorm folded into the 3-D conv kernels,
channels-last volumes), the counterpart of the JAX package's
``acv_prep_fast`` / ``acv_denoise_fast``; ``packed=False`` runs the module
path.  A shape the folded path cannot take raises; it does not switch path.
Folding costs a few hundred small device ops: a caller that runs many pairs
passes ``fold_acv(model)`` for each model, folded once.
"""

from __future__ import annotations

import torch

from diffuvolume_tpu_torch.diffusion import DDIMConfig, ddim_sample, make_schedule
from diffuvolume_tpu_torch.diffusion.codec import encode_disparity_volume
from diffuvolume_tpu_torch.models.acv import ACVNet, ConcatEntry
from diffuvolume_tpu_torch.models.acv_fold import FoldedACV, fold_acv
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume
from diffuvolume_tpu_torch.ops.regression import resize_bilinear
from diffuvolume_tpu_torch.utils.device import resolve_device


def _check_on(model: ACVNet, dev: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
        raise ValueError(f"model is on {p.device}, inference asked for {dev}")


def _on_path(model: ACVNet | FoldedACV, packed: bool) -> ACVNet | FoldedACV:
    """The model that runs ``packed``'s path: a ``FoldedACV`` as it is, an
    ``ACVNet`` folded on the folded path and as it is on the module path."""
    if isinstance(model, FoldedACV):
        if not packed:
            raise TypeError("a FoldedACV runs only the folded path (packed=True)")
        return model
    return fold_acv(model) if packed else model


@torch.no_grad()
def acv_prep(baseline_model: ACVNet | FoldedACV, ddim_model: ACVNet | FoldedACV,
             left: torch.Tensor, right: torch.Tensor, cfg: DDIMConfig, packed: bool = True):
    """Pass 1 and the sampler's inputs: ``(baseline_disp (B,H,W), baseline_latent
    (B,D,H4,W4), ConcatEntry)``; the entry's volume is channels-last when
    ``packed``."""
    h4, w4 = left.shape[1] // 4, left.shape[2] // 4
    baseline_model, ddim_model = (_on_path(m, packed) for m in (baseline_model, ddim_model))
    baseline_disp = baseline_model(left, right)[-1]
    cl, cr, att = ddim_model.build_cost_volume(left, right)
    entry = ConcatEntry(concat_volume(cl, cr, cfg.num_bins, channels_last=packed), att)
    # Conditioning: clamp → bilinear ↓4 → /4.
    disp_q = resize_bilinear(
        baseline_disp.clamp(0.0, cfg.max_disp - 1), (h4, w4), 1, 2) / 4.0
    baseline_latent = encode_disparity_volume(disp_q, cfg.num_bins, cfg.scale)
    return baseline_disp, baseline_latent, entry


@torch.no_grad()
def acv_ddim_inference(
    baseline_model: ACVNet | FoldedACV,
    ddim_model: ACVNet | FoldedACV,
    left,
    right,
    cfg: DDIMConfig = DDIMConfig(),
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    noise_source: dict | None = None,
    packed: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full two-pass DiffuVolume inference.

    Args:
      baseline_model / ddim_model: eval-mode ``ACVNet``s (``diffusion`` off /
        on), already on ``device``; on the folded path also their
        ``fold_acv`` results, folded once for many calls (an ``ACVNet`` is
        folded in each call).
      left, right: ``(B, H, W, 3)`` normalised images (tensors or arrays).
      device: where to run; default ``cuda:0``.  ``"cpu"`` runs the plain
        versions of the kernels.
      generator: the DDIM draws' ``torch.Generator`` on ``device``.
      noise_source: injected draws for ``ddim_sample``.
      packed: the folded path (BatchNorm folded into the port's 3-D conv
        kernels, channels-last volumes); ``False`` runs the module path.

    Returns ``(final_disp (B,H,W), baseline_disp (B,H,W))``, float32.
    """
    dev = resolve_device(device)
    baseline_model, ddim_model = (_on_path(m, packed) for m in (baseline_model, ddim_model))
    for model in (baseline_model, ddim_model):
        _check_on(model.model if packed else model, dev)
    left = torch.as_tensor(left, device=dev, dtype=torch.float32)
    right = torch.as_tensor(right, device=dev, dtype=torch.float32)
    out_hw = (left.shape[1], left.shape[2])
    baseline_disp, baseline_latent, entry = acv_prep(
        baseline_model, ddim_model, left, right, cfg, packed)
    sched = make_schedule(1000, device=dev)

    def denoise_fn(latent, t):
        return ddim_model.denoise(entry, latent, t, out_hw)

    final, _ = ddim_sample(sched, cfg, denoise_fn, baseline_disp, baseline_latent,
                           generator=generator, noise_source=noise_source)
    return final, baseline_disp.float()
