"""Two-model DDIM inference for the ACVNet, PCWNet and IGEV-Stereo backbones.

Counterpart of ``diffuvolume_tpu/eval/pipeline.py:acv_ddim_inference``,
``pcw_ddim_inference`` and ``igev_ddim_inference``: pass 1 runs the frozen
baseline for an initial disparity; pass 2 feeds it to the DiffuVolume model
as conditioning and runs the short DDIM loop.  As in the JAX package's
packed pipelines, the prep builds the DDIM model's volume once (ACV: the
concat volume without attention; PCW: the fused multi-scale combine volume;
IGEV: the encode and the lookup pyramid), and each denoise step pays only
what its noise changes (ACV, PCW: the multiply into the volume and the
aggregation; IGEV: the multiply into the GEV and one GRU rollout).

``packed=True`` (the default) runs both passes on the folded path
(``models/acv_fold.py``, ``models/pcw_fold.py``, ``models/igev/gev_fold.py``:
BatchNorm folded into the 3-D conv kernels, channels-last volumes), the
counterpart of the JAX package's ``acv_prep_fast`` / ``acv_denoise_fast``,
``pcw_prep_fast`` / ``pcw_denoise_fast`` and ``gev_tower_packed``;
``packed=False`` runs the module path.  A shape the folded path cannot take
raises; it does not switch path.  Folding costs a few hundred small device
ops: a caller that runs many pairs passes ``fold_acv(model)`` /
``fold_pcw(model)`` / ``fold_igev(model)`` for each model, folded once.

Two paths behind the JAX package's environment switches are reached
through the models passed in, with no argument here: ``fold_pcw(model)``
(with ``packed=True``) runs a bfloat16 PCW's refinement net on the folded
2-D conv kernel (``DIFFU_PCW_REFINE_FLAT=1``; ``refine_flat=False`` keeps
the module refinement), and models passed through
``models/layers.py:route_conv3d`` (with ``packed=False``) run the module
path's eligible 3×3×3 convs on ``conv3d_packed`` (``DIFFU_PALLAS_CONV3D=1``).

Precision.  A call with float32 models computes in float32 on the card as
the JAX reference does: each entry point turns TF32 off for cuDNN's convs
(the 2-D trunks, the module paths' 3-D convs) and for matmuls for the
call, and gives the caller's settings back on return (``float32_exact``);
a bfloat16 call leaves them as the caller set them.  The port's own kernels
never use TF32.
"""

from __future__ import annotations

import contextlib

import torch

from diffuvolume_tpu_torch.diffusion import DDIMConfig, ddim_sample, make_schedule
from diffuvolume_tpu_torch.diffusion.codec import encode_disparity_volume
from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM, KITTI15_DDIM
from diffuvolume_tpu_torch.models.acv import ACVNet, ConcatEntry
from diffuvolume_tpu_torch.models.acv_fold import FoldedACV, fold_acv
from diffuvolume_tpu_torch.models.igev.gev_fold import FoldedIGEV, fold_igev
from diffuvolume_tpu_torch.models.igev.model import (
    IGEVEntry,
    IGEVStereo,
    igev_encode,
    igev_forward,
)
from diffuvolume_tpu_torch.models.pcw import PCWEntry, PCWNet
from diffuvolume_tpu_torch.models.pcw_fold import FoldedPCW, fold_pcw
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume
from diffuvolume_tpu_torch.ops.regression import resize_bilinear
from diffuvolume_tpu_torch.utils.device import resolve_device
from diffuvolume_tpu_torch.utils.spans import INFER, PREP, span

_FOLDS = {FoldedACV: fold_acv, FoldedPCW: fold_pcw, FoldedIGEV: fold_igev}


def _check_on(model, dev: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
        raise ValueError(f"model is on {p.device}, inference asked for {dev}")


def _on_path(model, packed: bool, folded: type):
    """The model that runs ``packed``'s path: a fold (``folded``) as it is,
    a model folded on the folded path and as it is on the module path."""
    if isinstance(model, folded):
        if not packed:
            raise TypeError(f"a {folded.__name__} runs only the folded path (packed=True)")
        return model
    return _FOLDS[folded](model) if packed else model


def _param_dtype(model) -> torch.dtype:
    return next(getattr(model, "model", model).parameters()).dtype


@contextlib.contextmanager
def float32_exact(*models):
    """Within: cuDNN convs and matmuls without TF32 if any of ``models``
    (modules or their folds) holds float32 weights; the caller's two
    settings are restored on exit.  Other cuDNN settings are not touched."""
    if not any(_param_dtype(m) == torch.float32 for m in models):
        yield
        return
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _baseline_latent(baseline_disp: torch.Tensor, cfg: DDIMConfig, h4: int, w4: int):
    """Conditioning: clamp → bilinear ↓4 → /4 → the encoded latent."""
    disp_q = resize_bilinear(
        baseline_disp.clamp(0.0, cfg.max_disp - 1), (h4, w4), 1, 2) / 4.0
    return encode_disparity_volume(disp_q, cfg.num_bins, cfg.scale)


def _inputs(models, folded: type, packed: bool, left, right, device):
    dev = resolve_device(device)
    models = [_on_path(m, packed, folded) for m in models]
    for model in models:
        _check_on(model.model if packed else model, dev)
    left = torch.as_tensor(left, device=dev, dtype=torch.float32)
    right = torch.as_tensor(right, device=dev, dtype=torch.float32)
    return dev, models, left, right


def _sample(sampling: dict, baseline_disp, baseline_latent, cfg, dev, generator,
            noise_source):
    final, _ = ddim_sample(make_schedule(1000, device=dev), cfg, baseline_disp=baseline_disp,
                           baseline_latent=baseline_latent, generator=generator,
                           noise_source=noise_source, **sampling)
    return final, baseline_disp.float()


# The reference-faithful IGEV eval clamps its re-encode to [0, 47] whatever
# max_disp is (the reference's igev_stereo_ddim.py:266-276 hard-codes it).
REF_REENCODE_MAX = 47.0


def sampler_args(ddim_model, entry, out_hw: tuple[int, int], quirk: bool = False) -> dict:
    """``ddim_sample``'s model arguments for a pipeline's DDIM model and
    entry: ``denoise_fn``, the model's ``denoise`` at ``out_hw``; with
    ``quirk`` (IGEV's reference-faithful eval, an ``IGEVEntry``) the call
    ``denoise_ref`` carrying ``coords1`` from ``init_disp``, and the
    reference's re-encode of the residual (clamp to ``[0, 47]`` px, bilinear
    ↓4, ÷4, plus ``init_disp``, clamp to ``[0, 47]`` again)."""
    if not quirk:
        return dict(denoise_fn=lambda latent, t: ddim_model.denoise(entry, latent, t, out_hw))
    init_disp = entry.enc.init_disp
    h4, w4 = init_disp.shape[1:]

    def reencode_fn(disp):
        dq = resize_bilinear(disp.clamp(0.0, REF_REENCODE_MAX), (h4, w4), 1, 2) / 4.0
        return (dq + init_disp).clamp(0.0, REF_REENCODE_MAX)

    return dict(denoise_fn=lambda latent, t, c1: ddim_model.denoise_ref(entry, latent, t, c1),
                reencode_fn=reencode_fn, denoise_aux_init=init_disp)


@torch.no_grad()
def acv_prep(baseline_model: ACVNet | FoldedACV, ddim_model: ACVNet | FoldedACV,
             left: torch.Tensor, right: torch.Tensor, cfg: DDIMConfig, packed: bool = True):
    """Pass 1 and the sampler's inputs: ``(baseline_disp (B,H,W), baseline_latent
    (B,D,H4,W4), ConcatEntry)``; the entry's volume is channels-last when
    ``packed``."""
    baseline_model, ddim_model = (_on_path(m, packed, FoldedACV)
                                  for m in (baseline_model, ddim_model))
    with span(PREP):
        baseline_disp = baseline_model(left, right)[-1]
        cl, cr, att = ddim_model.build_cost_volume(left, right)
        entry = ConcatEntry(concat_volume(cl, cr, cfg.num_bins, channels_last=packed), att)
        baseline_latent = _baseline_latent(baseline_disp, cfg, left.shape[1] // 4,
                                           left.shape[2] // 4)
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
        kernels, channels-last volumes); ``False`` runs the module path (its
        eligible 3×3×3 convs on ``conv3d_packed`` when the models went
        through ``route_conv3d``).

    Returns ``(final_disp (B,H,W), baseline_disp (B,H,W))``, float32.
    """
    with span(INFER):
        dev, (baseline_model, ddim_model), left, right = _inputs(
            (baseline_model, ddim_model), FoldedACV, packed, left, right, device)
        with float32_exact(baseline_model, ddim_model):
            baseline_disp, baseline_latent, entry = acv_prep(
                baseline_model, ddim_model, left, right, cfg, packed)
            return _sample(sampler_args(ddim_model, entry, (left.shape[1], left.shape[2])),
                           baseline_disp, baseline_latent, cfg, dev, generator, noise_source)


@torch.no_grad()
def pcw_prep(baseline_model: PCWNet | FoldedPCW, ddim_model: PCWNet | FoldedPCW,
             left: torch.Tensor, right: torch.Tensor, cfg: DDIMConfig = KITTI12_DDIM,
             packed: bool = True):
    """Pass 1 and the sampler's inputs (``_pcw_stages``'s prep): ``(baseline_disp
    (B,H,W), baseline_latent (B,D,H4,W4), PCWEntry)``; the entry's combine
    volume is channels-last when ``packed``."""
    baseline_model, ddim_model = (_on_path(m, packed, FoldedPCW)
                                  for m in (baseline_model, ddim_model))
    with span(PREP):
        baseline_disp = baseline_model(left, right)[-1]
        combine, _, fl, fr = ddim_model.build_cost_volume(left, right)
        baseline_latent = _baseline_latent(baseline_disp, cfg, left.shape[1] // 4,
                                           left.shape[2] // 4)
    return baseline_disp, baseline_latent, PCWEntry(combine, fl, fr)


@torch.no_grad()
def pcw_ddim_inference(
    baseline_model: PCWNet | FoldedPCW,
    ddim_model: PCWNet | FoldedPCW,
    left,
    right,
    cfg: DDIMConfig = KITTI12_DDIM,
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    noise_source: dict | None = None,
    packed: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass DiffuVolume inference for the PCWNet backbone (the reference's
    KITTI12 contract: the frozen PCWNet pass, then the DDIM-3 model with the
    KITTI12 sampler variant, ``KITTI12_DDIM``).

    Arguments as ``acv_ddim_inference``'s, with ``PCWNet``s (``diffusion``
    off / on) or their ``fold_pcw`` results (a bfloat16 model's refinement
    net on ``conv2d_flat`` too).  The
    folded path needs H, W and
    ``max_disp`` to be multiples of 32 (three stride-2 levels below 1/4);
    it raises on any other shape.

    Returns ``(final_disp (B,H,W), baseline_disp (B,H,W))``, float32.
    """
    with span(INFER):
        dev, (baseline_model, ddim_model), left, right = _inputs(
            (baseline_model, ddim_model), FoldedPCW, packed, left, right, device)
        with float32_exact(baseline_model, ddim_model):
            baseline_disp, baseline_latent, entry = pcw_prep(
                baseline_model, ddim_model, left, right, cfg, packed)
            return _sample(sampler_args(ddim_model, entry, (left.shape[1], left.shape[2])),
                           baseline_disp, baseline_latent, cfg, dev, generator, noise_source)


@torch.no_grad()
def igev_prep(baseline_model: IGEVStereo | FoldedIGEV, ddim_model: IGEVStereo | FoldedIGEV,
              left: torch.Tensor, right: torch.Tensor, cfg: DDIMConfig = KITTI15_DDIM,
              packed: bool = True, iters: int = 32, quirk: bool = False):
    """Pass 1 and the sampler's inputs (``_igev_stages``): the baseline's
    encode, ``iters`` GRU updates and upsampling; the DDIM model's encode
    (once) and lookup pyramid (band mode; with ``quirk`` the low band the
    reference-faithful rollout samples).  Returns ``(baseline_disp (B,H,W),
    baseline_latent (B,D,H4,W4), IGEVEntry)``."""
    baseline_model, ddim_model = (_on_path(m, packed, FoldedIGEV)
                                  for m in (baseline_model, ddim_model))
    with span(PREP):
        baseline_disp = igev_forward(baseline_model, left, right, iters)
        enc, pyramid = igev_encode(ddim_model, left, right, "lowband" if quirk else "band")
        baseline_latent = _baseline_latent(baseline_disp, cfg, left.shape[1] // 4,
                                           left.shape[2] // 4)
    return baseline_disp, baseline_latent, IGEVEntry(enc, pyramid, iters)


@torch.no_grad()
def igev_ddim_inference(
    baseline_model: IGEVStereo | FoldedIGEV,
    ddim_model: IGEVStereo | FoldedIGEV,
    left,
    right,
    cfg: DDIMConfig = KITTI15_DDIM,
    *,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    noise_source: dict | None = None,
    packed: bool = True,
    iters: int = 32,
    quirk: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass DiffuVolume inference for the IGEV-Stereo backbone (the
    reference's KITTI15 contract, ``evaluate_stereo.py:88-99``: the frozen
    IGEV-Stereo with ``iters`` GRU updates, then the DDIM-2 model with the
    KITTI15 sampler variant, ``KITTI15_DDIM``: no uncertainty term, hard
    clamp to the baseline, fresh q-sample replacement).

    Arguments as ``acv_ddim_inference``'s, with ``IGEVStereo``s
    (``diffusion`` off / on) or their ``fold_igev`` results, and RAW images
    in [0, 255].  The folded path needs H, W and ``max_disp`` to be multiples
    of 32; it raises on any other shape.  ``quirk=True`` evaluates with the
    reference's own semantics, for the released checkpoints: the residual
    rollout carrying ``coords1`` across the DDIM steps
    (``igev_rollout_ref_eval``, the ``lowband`` correlation), the noise's
    reshape scramble, the re-encode offset by ``init_disp``
    (``sampler_args``); the baseline pass is the same.

    Returns ``(final_disp (B,H,W), baseline_disp (B,H,W))``, float32.
    """
    with span(INFER):
        dev, (baseline_model, ddim_model), left, right = _inputs(
            (baseline_model, ddim_model), FoldedIGEV, packed, left, right, device)
        with float32_exact(baseline_model, ddim_model):
            baseline_disp, baseline_latent, entry = igev_prep(
                baseline_model, ddim_model, left, right, cfg, packed, iters, quirk)
            return _sample(sampler_args(ddim_model, entry, (left.shape[1], left.shape[2]), quirk),
                           baseline_disp, baseline_latent, cfg, dev, generator, noise_source)


@torch.no_grad()
def igev_baseline_inference(model: IGEVStereo | FoldedIGEV, left, right, *, iters: int = 32,
                            device: str | torch.device | None = None,
                            packed: bool = True) -> torch.Tensor:
    """The frozen IGEV-Stereo alone (``baseline_inference`` with ``iters``):
    RAW ``(B, H, W, 3)`` images → ``(B, H, W)`` float32."""
    with span(INFER):
        dev, (model,), left, right = _inputs((model,), FoldedIGEV, packed, left, right, device)
        with float32_exact(model):
            return igev_forward(model, left, right, iters)


_BASELINE_FOLDS = ((ACVNet, FoldedACV), (PCWNet, FoldedPCW), (IGEVStereo, FoldedIGEV))


@torch.no_grad()
def baseline_inference(model, left, right, *, iters: int | None = None,
                       device: str | torch.device | None = None,
                       packed: bool = True) -> torch.Tensor:
    """The frozen baseline alone, one pass, no diffusion (the reference's
    baseline-only evaluation: KITTI15/evaluate_stereo_origin.py; SceneFlow
    and KITTI12 evaluate ``model_origin`` alone).  Counterpart of the JAX
    package's ``baseline_inference``.

    Args:
      model: an eval-mode ``ACVNet``, ``PCWNet`` or ``IGEVStereo``
        (``diffusion`` off), already on ``device``, or its fold.
      left, right: ``(B, H, W, 3)`` images (normalised; RAW for IGEV).
      iters: IGEV's GRU iterations (32 when None); ACV and PCW take none.
      device: where to run; default ``cuda:0``.
      packed: the folded path; ``False`` the module path.

    Returns ``(B, H, W)`` float32.
    """
    kind = next(((m, f) for m, f in _BASELINE_FOLDS if isinstance(model, (m, f))), None)
    if kind is None:
        raise TypeError(f"no baseline pass for a {type(model).__name__}")
    if kind[1] is FoldedIGEV:
        return igev_baseline_inference(model, left, right, iters=32 if iters is None else iters,
                                       device=device, packed=packed)
    if iters is not None:
        raise ValueError(f"a {kind[0].__name__} takes no GRU iterations")
    with span(INFER):
        dev, (model,), left, right = _inputs((model,), kind[1], packed, left, right, device)
        with float32_exact(model):
            return model(left, right)[-1].float()
