"""Seeded random-weight ACVNets, PCWNets and IGEV-Stereos for runs without
the released checkpoints.

At random initialisation the networks' logits reach ±1e5 (ACV's attention
head ±1e8; PCW's 1e7–1e9): the softmaxes are one-hot and the sampler's
renewal branches flip on rounding noise, so two correct implementations
disagree by pixels.  ``calibrate_heads`` / ``calibrate_pcw`` rescale the
head kernels the eval path uses so that the logits on given images have a
chosen spread (and, for PCW, the refinement residual a chosen size), which
makes a disparity comparison between implementations meaningful.
``calibrate_igev`` does the same for IGEV's classifier and sets the GRU's
step size, so that the disparity stays where the lookups are exact;
``calibrate_igev_drift`` bounds the whole rollout's move, for runs at 32
iterations.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffuvolume_tpu_torch.models.acv import ACVNet
from diffuvolume_tpu_torch.models.igev.model import (
    IGEVStereo,
    igev_encode,
    igev_rollout,
    track_disparity,
)
from diffuvolume_tpu_torch.models.layers import BasicBlock
from diffuvolume_tpu_torch.models.pcw import PCWNet


def _draw_batchnorm(model: nn.Module, generator: torch.Generator) -> None:
    """BatchNorm weight and running variance uniform in [0.5, 1.5), bias and
    running mean normal with std 0.1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                m.bias.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=generator) + 0.5)


def random_acv(max_disp: int, diffusion: bool, generator: torch.Generator) -> ACVNet:
    """An eval-mode ``ACVNet`` on the CPU in float32, every weight and
    BatchNorm statistic drawn from ``generator``: the JAX package's
    initialisation, then ``_draw_batchnorm``."""
    model = ACVNet(max_disp=max_disp, diffusion=diffusion).init_weights(generator)
    _draw_batchnorm(model, generator)
    return model.eval()


def random_pair(max_disp: int, generator: torch.Generator) -> tuple[ACVNet, ACVNet]:
    """``(baseline, ddim)`` models where the DDIM model shares the baseline's
    weights and draws only its time embedding, so that its disparity lands
    near the baseline's and the renewal filter keeps some pixels."""
    baseline = random_acv(max_disp, False, generator)
    ddim = random_acv(max_disp, True, generator)
    ddim.load_state_dict(baseline.state_dict(), strict=False)
    return baseline, ddim


@torch.no_grad()
def seeded_main_path(device, h: int = 512, w: int = 960, max_disp: int = 192):
    """The main path's inputs from seed 0: ``(baseline, ddim, left, right)``,
    the models from ``random_pair`` in bfloat16 on ``device`` with heads
    calibrated to logit std 10 on the images, the images ``(1, h, w, 3)``
    float32 with std 0.3, the right shifted 3 px."""
    g = torch.Generator().manual_seed(0)
    left = (torch.randn((1, h, w, 3), generator=g) * 0.3).to(device)
    right = torch.roll(left, -3, dims=2)
    baseline, ddim = random_pair(max_disp, g)
    baseline = baseline.to(device, torch.bfloat16)
    ddim = ddim.to(device, torch.bfloat16)
    calibrate_heads(baseline, left, right, target_std=10.0)
    ddim.load_state_dict(baseline.state_dict(), strict=False)
    return baseline, ddim, left, right


@torch.no_grad()
def calibrate_heads(model: ACVNet, left: torch.Tensor, right: torch.Tensor,
                    target_std: float = 3.0) -> ACVNet:
    """Scale the attention head's and the disparity head's (``classif2``)
    kernels so that, on ``left``/``right`` ``(B, H, W, 3)``, each head's
    logits have standard deviation ``target_std``."""
    for head in (model.classif_att_, model.classif2):
        seen = []
        hook = head.register_forward_hook(lambda m, i, o: seen.append(o.float().std()))
        try:
            model(left, right)
        finally:
            hook.remove()
        head[2].weight.mul_(target_std / float(seen[0]))
    return model


# PCW's trunk stacks 34 residual blocks; at the JAX package's initialisation
# each add multiplies the activations' spread, so on a 64×64 float32 input
# the gw features reach std 1e6–7e7, the concat features 4e8, the combine
# volume 8e13 and the head's logits 1e15: far past where bfloat16's 8 bits
# and the float32 sums of the 3-D convs leave a comparison anything to say.
# The rule that tames it: each residual branch's last BatchNorm weight
# (``conv2``) is scaled by this, so a block adds a tenth of its input's
# spread; the same input then gives features of std 1–11, a combine volume
# of std 2.3 and logits of std 32 before calibration.
PCW_RESIDUAL_BN_SCALE = 0.1


@torch.no_grad()
def tame_residual_branches(model: nn.Module) -> nn.Module:
    """Each 2-D residual block's ``conv2`` BatchNorm weight times
    ``PCW_RESIDUAL_BN_SCALE``, in place (``random_pcw``'s rule, for any
    model built of ``BasicBlock``s); returns ``model``."""
    for m in model.modules():
        if isinstance(m, BasicBlock):
            m.conv2[1].weight.mul_(PCW_RESIDUAL_BN_SCALE)
    return model


def random_pcw(max_disp: int, diffusion: bool, generator: torch.Generator,
               use_concat_volume: bool = True) -> PCWNet:
    """An eval-mode ``PCWNet`` on the CPU in float32, every weight and
    BatchNorm statistic drawn from ``generator``: the JAX package's
    initialisation, ``_draw_batchnorm``, then each 2-D residual block's
    ``conv2`` BatchNorm weight times ``PCW_RESIDUAL_BN_SCALE``."""
    model = PCWNet(max_disp=max_disp, diffusion=diffusion,
                   use_concat_volume=use_concat_volume).init_weights(generator)
    _draw_batchnorm(model, generator)
    return tame_residual_branches(model).eval()


@torch.no_grad()
def calibrate_pcw(model: PCWNet, left: torch.Tensor, right: torch.Tensor,
                  logit_std: float = 10.0, residual_std: float = 1.0) -> PCWNet:
    """Scale ``classif3``'s head so that its logits on ``left``/``right``
    have standard deviation ``logit_std``, then ``refinenet3.conv8`` so that
    the refinement residual has ``residual_std`` px."""
    for conv, target in ((model.classif3[2], logit_std),
                         (model.refinenet3.conv8, residual_std)):
        seen = []
        hook = conv.register_forward_hook(lambda m, i, o: seen.append(o.float().std()))
        try:
            model(left, right)
        finally:
            hook.remove()
        conv.weight.mul_(target / float(seen[0]))
    return model


def random_pcw_pair(max_disp: int, generator: torch.Generator,
                    use_concat_volume: bool = True) -> tuple[PCWNet, PCWNet]:
    """``(baseline, ddim)`` PCWNets (``gwcnet-gc`` and ``pcwnet_ddim``; without
    ``use_concat_volume`` ``gwcnet-g`` and ``pcwnet_ddim`` without the
    concat volume); the DDIM model shares the baseline's weights and draws
    only its time embedding."""
    baseline = random_pcw(max_disp, False, generator, use_concat_volume)
    ddim = random_pcw(max_disp, True, generator, use_concat_volume)
    ddim.load_state_dict(baseline.state_dict(), strict=False)
    return baseline, ddim


@torch.no_grad()
def seeded_pcw_path(device, h: int = 384, w: int = 1248, max_disp: int = 192,
                    use_concat_volume: bool = True):
    """The PCW path's inputs from seed 0: ``(baseline, ddim, left, right)``,
    the models from ``random_pcw_pair`` (with or without the concat volume)
    in bfloat16 on ``device``, calibrated by ``calibrate_pcw`` on the images
    (logit std 10, residual 1 px), the images ``(1, h, w, 3)`` float32 with
    std 0.3, the right shifted 3 px."""
    g = torch.Generator().manual_seed(0)
    left = (torch.randn((1, h, w, 3), generator=g) * 0.3).to(device)
    right = torch.roll(left, -3, dims=2)
    baseline, ddim = random_pcw_pair(max_disp, g, use_concat_volume)
    baseline = baseline.to(device, torch.bfloat16)
    ddim = ddim.to(device, torch.bfloat16)
    calibrate_pcw(baseline, left, right)
    ddim.load_state_dict(baseline.state_dict(), strict=False)
    return baseline, ddim, left, right


def random_igev(max_disp: int, diffusion: bool, generator: torch.Generator) -> IGEVStereo:
    """An eval-mode ``IGEVStereo`` on the CPU in float32, every weight and
    BatchNorm statistic drawn from ``generator``."""
    model = IGEVStereo(max_disp=max_disp, diffusion=diffusion).init_weights(generator)
    _draw_batchnorm(model, generator)
    return model.eval()


def random_igev_pair(max_disp: int, generator: torch.Generator) -> tuple[IGEVStereo, IGEVStereo]:
    """``(baseline, ddim)`` IGEV-Stereos; the DDIM model shares the
    baseline's weights and draws only its time embedding."""
    baseline = random_igev(max_disp, False, generator)
    ddim = random_igev(max_disp, True, generator)
    ddim.load_state_dict(baseline.state_dict(), strict=False)
    return baseline, ddim


@torch.no_grad()
def calibrate_igev(model: IGEVStereo, left: torch.Tensor, right: torch.Tensor,
                   logit_std: float = 10.0, step_std: float = 0.5) -> IGEVStereo:
    """Scale the classifier so that its logits on ``left``/``right`` (RAW
    ``(B, H, W, 3)``) have standard deviation ``logit_std``, then
    ``update_block.disp_head.conv2`` so that the first GRU update moves the
    disparity by ``step_std`` quarter-res px (std).  Uncalibrated, the
    random GRU walks the disparity out of the band lookup's exact domain,
    [−1, 52] quarter-res px at 384×1248."""
    feat_l, match_l, match_r, _, _ = model.trunk(left, right)
    _, cost = model.gev_tower(match_l, match_r, feat_l)
    model.classifier.weight.mul_(logit_std / float(cost.float().std()))
    enc, pyramid = igev_encode(model, left, right)
    conv = model.update_block.disp_head.conv2
    seen = []
    hook = conv.register_forward_hook(lambda m, i, o: seen.append(o.float().std()))
    try:
        igev_rollout(model, enc, pyramid, 1)
    finally:
        hook.remove()
    conv.weight.mul_(step_std / float(seen[0]))
    conv.bias.mul_(step_std / float(seen[0]))
    return model


@torch.no_grad()
def calibrate_igev_drift(model: IGEVStereo, left: torch.Tensor, right: torch.Tensor,
                         iters: int = 32, max_drift: float = 0.5,
                         logit_std: float = 10.0) -> IGEVStereo:
    """``calibrate_igev``, then scale ``update_block.disp_head.conv2`` until
    an ``iters``-update rollout on ``left``/``right`` moves no pixel's
    quarter-res disparity more than ``max_drift`` from its start.  The
    initial disparity lies in ``[0, D/4 − 1]``, so at W ≥ 160 and
    ``max_drift`` ≤ 1 every update reads the band lookup inside its exact
    domain (``geometry.band_exact_domain``); ``calibrate_igev``'s first-step
    rule alone lets the random GRU walk several px in 32 updates."""
    calibrate_igev(model, left, right, logit_std=logit_std)
    conv = model.update_block.disp_head.conv2
    enc, pyramid = igev_encode(model, left, right)
    for _ in range(8):
        with track_disparity(model) as track:
            igev_rollout(model, enc, pyramid, iters)
        if track.max_drift <= max_drift:
            break
        scale = 0.5 * max_drift / track.max_drift
        conv.weight.mul_(scale)
        conv.bias.mul_(scale)
    return model


@torch.no_grad()
def seeded_igev_path(device, h: int = 384, w: int = 1248, max_disp: int = 192):
    """The IGEV path's inputs from seed 0: ``(baseline, ddim, left, right)``,
    the models from ``random_igev_pair`` in bfloat16 on ``device``,
    calibrated by ``calibrate_igev`` on the images, the images ``(1, h, w,
    3)`` RAW in [0, 255), the right the left shifted 3 px."""
    g = torch.Generator().manual_seed(0)
    left = (torch.rand((1, h, w, 3), generator=g) * 255.0).to(device)
    right = torch.roll(left, -3, dims=2)
    baseline, ddim = random_igev_pair(max_disp, g)
    baseline = baseline.to(device, torch.bfloat16)
    ddim = ddim.to(device, torch.bfloat16)
    calibrate_igev(baseline, left, right)
    ddim.load_state_dict(baseline.state_dict(), strict=False)
    return baseline, ddim, left, right
