"""The DDIM sampler and the two-pass pipeline of DiffuVolume, plain PyTorch.

A rewrite of the reference's sampling loop (SceneFlow ``acv_ddim.py``
``ddim_sample``; KITTI12 ``pwcnet_ddim.py``): the cosine schedule in
float64, the disparity's two-hot encoding, per step the renewal filter
(``|disp − baseline| < consistency_tau`` and ``unc < uncertainty_tau``,
resized to the latent and accumulated), the DDIM update, the replacement
of unrenewed latent pixels (uniform draws, or a q-sample of the baseline's
latent, compounded), and the weighted ensemble over ``[baseline,
step_1..N]``.  All of it in float32.  The draws are given, never drawn:
``noise`` holds ``init`` ``(B, D, H4, W4)`` (for ``init_mode`` "noise"),
``z`` and ``replace`` ``(steps, B, D, H4, W4)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

T = 1000


def cumprod_alphas(timesteps: int = T) -> np.ndarray:
    """The cosine schedule's ᾱ_t in float64 (betas clipped to [0, 0.999])."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    f = np.cos((x / timesteps + 0.008) / 1.008 * np.pi * 0.5) ** 2
    f = f / f[0]
    betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    return np.cumprod(1 - betas)


def _at(values: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    v = torch.as_tensor(values.astype(np.float32), device=t.device)[t.long()]
    return v.reshape(-1, *([1] * (ndim - 1)))


def q_sample(x0, t, eps):
    acp = cumprod_alphas()
    return _at(np.sqrt(acp), t, x0.ndim) * x0 + _at(np.sqrt(1 - acp), t, x0.ndim) * eps


def encode(disp, bins, scale):
    """``(B, H, W)`` disparity in bin units → the ``(B, bins, H, W)`` two-hot
    volume mapped to ``[-scale, scale]``; a pixel whose floor is the last
    bin is one-hot there."""
    k = torch.arange(bins, device=disp.device, dtype=disp.dtype)[:, None, None]
    w = (1 - (k - disp[:, None]).abs()).clamp_min(0)
    last = (disp.floor() == bins - 1)[:, None]
    onehot = torch.zeros_like(w)
    onehot[:, -1] = 1
    return (torch.where(last, onehot, w) * 2 - 1) * scale


def resize(x, hw):
    """Bilinear resize of ``(B, H, W)`` with half-pixel centres."""
    return F.interpolate(x[:, None], hw, mode="bilinear", align_corners=False)[:, 0]


def latent_of(disp, cfg, hw4):
    """The conditioning: clamp to ``[0, max_disp − 1]``, ↓4, ÷4, encode."""
    return encode(resize(disp.clamp(0, cfg["max_disp"] - 1), hw4) / 4, cfg["num_bins"],
                  cfg["scale"])


def coefficients(steps: int, eta: float):
    """Per step ``(t, t_next, sigma, c, sqrt(ᾱ_next))`` computed in float64."""
    acp = cumprod_alphas()
    times = list(reversed(np.linspace(-1, T - 1, steps + 1).astype(np.int64).tolist()))
    out = []
    for t, tn in zip(times[:-1], times[1:]):
        a, an = acp[t], acp[max(tn, 0)]
        sigma = eta * np.sqrt((1 - a / an) * (1 - an) / (1 - a))
        c = np.sqrt(max(1 - an - sigma ** 2, 0.0))
        out.append((t, tn, np.float32(sigma), np.float32(c), np.float32(np.sqrt(an))))
    return out


def sample(cfg, denoise, baseline, base_latent, noise, hw):
    """The DDIM loop: ``(final (B, H, W), [step disparities])``.
    ``denoise(latent, t (B,)) → (disp, unc, transformed)``."""
    acp = cumprod_alphas()
    b, _, h4, w4 = base_latent.shape
    latent = base_latent if cfg["init_mode"] == "baseline" else noise["init"]
    clip = cfg["reencode_clip_max"]
    clip = cfg["max_disp"] - 1 if clip is None else clip
    mask = torch.zeros(b, h4, w4, device=baseline.device)
    src = base_latent
    steps = []
    n = cfg["sampling_steps"]
    for i, (t, tn, sigma, c, san) in enumerate(coefficients(n, cfg["eta"])):
        tv = torch.full((b,), t, device=baseline.device, dtype=torch.int64)
        disp, unc, x_t = denoise(latent, tv)
        x0 = encode(resize(disp.clamp(0, clip), (h4, w4)) / 4, cfg["num_bins"], cfg["scale"])
        x0 = x0.clamp(-cfg["scale"], cfg["scale"])
        if cfg["invert_from"] == "latent":
            x_t = latent
        eps = (np.float32(np.sqrt(1 / acp[t])) * x_t - x0) / np.float32(np.sqrt(1 / acp[t] - 1))
        gap = (disp - baseline).abs()
        if cfg["renewal"]:
            keep = gap < cfg["consistency_tau"]
            if cfg["use_uncertainty"]:
                keep = keep & (unc < cfg["uncertainty_tau"])
            grown = (mask + resize(keep.float(), (h4, w4))).clamp(0, 1)
            if not (cfg["skip_mask_update_on_last"] and i == n - 1):
                mask = grown
        if cfg["hard_clamp_tau"] is not None:
            disp = torch.where(gap < cfg["hard_clamp_tau"], disp, baseline)
        updated = x0 * san + c * eps + sigma * noise["z"][i]
        if cfg["replace_mode"] == "uniform":
            repl = noise["replace"][i]
        else:
            repl = q_sample(src, tv, noise["replace"][i])
            if cfg["replace_mode"] == "qsample_compound" and tn >= 0:
                src = repl
        if cfg["renewal"]:
            updated = torch.where(mask[:, None] == 0, repl, updated)
        latent = x0 if tn < 0 else updated
        steps.append(disp)
    if not cfg["use_ensemble"]:
        return steps[-1], steps
    w = cfg["ensemble_weights"]
    final = w[0] * baseline
    for wi, s in zip(w[1:], steps):
        final = final + wi * s
    return final, steps


@torch.no_grad()
def two_pass(base_net, ddim_net, cfg, left, right, noise):
    """Pass 1 (the baseline network), then the DDIM model's loop:
    ``(final, baseline, steps)``, each ``(B, H, W)`` float32."""
    hw = tuple(left.shape[1:3])
    baseline = base_net(left, right)[0]
    entry = ddim_net.entry(left, right)
    base_latent = latent_of(baseline, cfg, (hw[0] // 4, hw[1] // 4))
    final, steps = sample(cfg, lambda lat, t: ddim_net.denoise(entry, lat, t, hw), baseline,
                          base_latent, noise, hw)
    return final, baseline, steps
