"""Seeded random-weight ACVNets for runs without the released checkpoints.

At random initialisation the network's logits reach ±1e5 (the attention
head's ±1e8): the softmaxes are one-hot and the sampler's renewal branches
flip on rounding noise, so two correct implementations disagree by pixels.
``calibrate_heads`` rescales the two head kernels the eval path uses so that
the logits on given images have a chosen spread, which makes a disparity
comparison between implementations meaningful.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffuvolume_tpu_torch.models.acv import ACVNet


def random_acv(max_disp: int, diffusion: bool, generator: torch.Generator) -> ACVNet:
    """An eval-mode ``ACVNet`` on the CPU in float32, every weight and
    BatchNorm statistic drawn from ``generator``: the JAX package's
    initialisation, then BatchNorm weight and running variance uniform in
    [0.5, 1.5), bias and running mean normal with std 0.1."""
    model = ACVNet(max_disp=max_disp, diffusion=diffusion).init_weights(generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
                m.bias.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=generator) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=generator) + 0.5)
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
