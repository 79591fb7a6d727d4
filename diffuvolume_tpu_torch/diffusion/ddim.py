"""DDIM sampler with renewal confidence filtering and step ensembling.

Counterpart of ``diffuvolume_tpu/diffusion/ddim.py``: the same
``DDIMConfig`` and presets, with the ``lax.scan`` written as a Python loop and
the noise drawn from an explicit ``torch.Generator``.  The backbone enters
only through ``denoise_fn(latent, t) -> (disp, unc, transformed)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from diffuvolume_tpu_torch.diffusion import schedule as sched_lib
from diffuvolume_tpu_torch.diffusion.codec import encode_disparity_volume
from diffuvolume_tpu_torch.ops.regression import resize_bilinear
from diffuvolume_tpu_torch.utils.spans import DDIM_STEP, H2D, span


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    """Per-backbone DDIM sampling configuration (defaults: SceneFlow/ACVNet).

    Field meanings are those of the JAX package's ``DDIMConfig``:
    ``init_mode`` "baseline" | "noise"; renewal keeps pixels with
    ``|pred - baseline| < consistency_tau`` and (if ``use_uncertainty``)
    ``unc < uncertainty_tau``; ``replace_mode`` "uniform" | "qsample" |
    "qsample_compound"; ``ensemble_weights`` over ``[baseline, step_1..N]``;
    ``invert_from`` "transformed" (reference-faithful) | "latent".
    """

    sampling_steps: int = 5
    eta: float = 1.0
    scale: float = 1.0
    renewal: bool = True
    use_ensemble: bool = True
    init_mode: str = "baseline"
    consistency_tau: float = 1.0
    uncertainty_tau: float = 3.0
    use_uncertainty: bool = True
    skip_mask_update_on_last: bool = False
    hard_clamp_tau: float | None = None
    replace_mode: str = "uniform"
    ensemble_weights: Sequence[float] = (0.5, 0.0, 0.0, 0.0, 0.2, 0.3)
    max_disp: int = 192
    num_bins: int = 48
    reencode_clip_max: float | None = None
    invert_from: str = "transformed"


def _draw(kind: str, shape, like: torch.Tensor, generator: torch.Generator):
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=like.device,
                           dtype=like.dtype)
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=like.dtype)


def ddim_sample(
    sched: sched_lib.DiffusionSchedule,
    cfg: DDIMConfig,
    denoise_fn: Callable,
    baseline_disp: torch.Tensor,
    baseline_latent: torch.Tensor,
    generator: torch.Generator | None = None,
    reencode_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    denoise_aux_init=None,
    noise_source: dict | None = None,
    return_masks: bool = False,
):
    """Run the short DDIM trajectory and return ``(final (B,H,W), step_disps
    (steps,B,H,W))``, and with ``return_masks`` a third item: per step the
    decisions the sampler took at a threshold, ``{name: (statistic (B,H,W),
    threshold)}``, each decision ``statistic < threshold``: ``"renew_gap"``
    ``|disp − baseline|`` against ``consistency_tau`` and ``"renew_unc"``
    against ``uncertainty_tau`` (the renewal mask is their conjunction),
    ``"clamp_gap"`` against ``hard_clamp_tau``.  Two runs can so tell a
    decision that flipped at its threshold from a difference elsewhere.

    ``denoise_fn(latent (B,D,H4,W4), t (B,)) -> (disp, unc[, transformed])``,
    or ``(latent, t, aux) -> (disp, unc, transformed, new_aux)`` when
    ``denoise_aux_init`` is given.  ``noise_source`` may hold ``"init"``
    ``(B,D,H4,W4)``, ``"z"`` and ``"replace"`` ``(steps,B,D,H4,W4)`` to inject
    the draws; missing keys are drawn from ``generator`` in the order init,
    then per step z, replace.  With no generator, one seeded with 0 on the
    latent's device is used.
    """
    # The diffusion algebra runs in float32 whatever the backbone dtype.
    baseline_disp = baseline_disp.float()
    baseline_latent = baseline_latent.float()
    dev = baseline_latent.device
    b, d, h4, w4 = baseline_latent.shape
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    coefs = sched_lib.ddim_step_coefficients(
        sched.num_timesteps, cfg.sampling_steps, cfg.eta
    )
    noise_source = noise_source or {}

    def injected(key, i=None):
        x = noise_source.get(key)
        if x is None:
            return None
        x = torch.as_tensor(x if i is None else x[i])
        return x.to(device=dev, dtype=torch.float32)

    if cfg.init_mode == "baseline":
        latent = baseline_latent
    elif cfg.init_mode == "noise":
        latent = injected("init")
        if latent is None:
            latent = _draw("normal", baseline_latent.shape, baseline_latent,
                           generator)
    else:
        raise ValueError(cfg.init_mode)

    if reencode_fn is None:
        clip_max = (cfg.reencode_clip_max if cfg.reencode_clip_max is not None
                    else cfg.max_disp - 1)

        def reencode_fn(disp):
            disp_c = disp.clamp(0.0, clip_max)
            return resize_bilinear(disp_c, (h4, w4), h_axis=1, w_axis=2) / 4.0

    mask = torch.zeros((b, h4, w4), device=dev)
    replace_src = baseline_latent
    aux = denoise_aux_init
    step_disps, decisions = [], []
    for i in range(cfg.sampling_steps):
        with span(DDIM_STEP):
            time, time_next = (int(v) for v in coefs["pairs"][i])
            sigma = float(coefs["sigma"][i])
            c = float(coefs["c"][i])
            sqrt_alpha_next = float(coefs["sqrt_alpha_next"][i])
            t_vec = torch.full((b,), time, dtype=torch.int32, device=dev)

            if denoise_aux_init is not None:
                out = denoise_fn(latent, t_vec, aux)
                aux = out[3]
            else:
                out = denoise_fn(latent, t_vec)
            disp, unc = out[0].float(), out[1].float()

            x_start = encode_disparity_volume(reencode_fn(disp), cfg.num_bins, cfg.scale)
            x_start = x_start.clamp(-cfg.scale, cfg.scale)

            if cfg.invert_from == "transformed":
                if len(out) < 3:
                    raise ValueError(
                        "invert_from='transformed' needs denoise_fn to return the "
                        "time-embedded [0,1]-rescaled volume as a 3rd output"
                    )
                x_t = out[2].float()
            elif cfg.invert_from == "latent":
                x_t = latent
            else:
                raise ValueError(cfg.invert_from)
            pred_noise = sched_lib.predict_noise_from_start(sched, x_t, t_vec, x_start)

            gap = (disp - baseline_disp).abs()
            taken = {}
            if cfg.renewal:
                taken["renew_gap"] = (gap, cfg.consistency_tau)
                if cfg.use_uncertainty:
                    taken["renew_unc"] = (unc, cfg.uncertainty_tau)
                keep = torch.stack([stat < tau for stat, tau in taken.values()]).all(0)
                m = resize_bilinear(keep.float(), (h4, w4), h_axis=1, w_axis=2)
                new_mask = (mask + m).clamp(0.0, 1.0)
                if not (cfg.skip_mask_update_on_last and i == cfg.sampling_steps - 1):
                    mask = new_mask

            if cfg.hard_clamp_tau is not None:
                taken["clamp_gap"] = (gap, cfg.hard_clamp_tau)
                disp = torch.where(gap < cfg.hard_clamp_tau, disp, baseline_disp)
            decisions.append(taken)

            z = injected("z", i)
            if z is None:
                z = _draw("normal", latent.shape, latent, generator)
            updated = x_start * sqrt_alpha_next + c * pred_noise + sigma * z

            r_inj = injected("replace", i)
            if cfg.replace_mode == "uniform":
                replacement = r_inj if r_inj is not None else _draw(
                    "uniform", latent.shape, latent, generator)
            elif cfg.replace_mode in ("qsample", "qsample_compound"):
                eps = r_inj if r_inj is not None else _draw(
                    "normal", latent.shape, latent, generator)
                replacement = sched_lib.q_sample(sched, replace_src, t_vec, eps)
                if cfg.replace_mode == "qsample_compound" and time_next >= 0:
                    replace_src = replacement
            else:
                raise ValueError(cfg.replace_mode)
            if cfg.renewal:
                updated = torch.where(mask[:, None] == 0, replacement, updated)

            latent = x_start if time_next < 0 else updated
            step_disps.append(disp)

    steps = torch.stack(step_disps)
    if not cfg.use_ensemble:
        final = steps[-1]
    else:
        with span(H2D):
            w = torch.tensor(list(cfg.ensemble_weights), dtype=torch.float32, device=dev)
        if w.shape[0] != cfg.sampling_steps + 1:
            raise ValueError("ensemble weights cover [baseline, step_1..step_N]")
        stacked = torch.cat([baseline_disp[None], steps], dim=0)
        final = torch.einsum("s...,s->...", stacked, w)
    return (final, steps, decisions) if return_masks else (final, steps)


# Reference presets.
SCENEFLOW_DDIM = DDIMConfig()

KITTI12_DDIM = DDIMConfig(
    sampling_steps=3,
    init_mode="noise",
    consistency_tau=1.0,
    uncertainty_tau=1.0,
    skip_mask_update_on_last=True,
    replace_mode="qsample_compound",
    ensemble_weights=(0.9, 0.0, 0.0, 0.1),
)

KITTI15_DDIM = DDIMConfig(
    sampling_steps=2,
    init_mode="noise",
    consistency_tau=5.0,
    use_uncertainty=False,
    hard_clamp_tau=3.0,
    replace_mode="qsample",
    ensemble_weights=(0.6, 0.1, 0.3),
    # The reference clips its re-encode input to 47 full-res px
    # (igev_stereo_ddim.py:268) because its eval loop tracks a residual
    # disparity; igev_ddim_inference(quirk=True) passes that re-encode
    # (eval/pipeline.py sampler_args).  The default absolute rollout
    # takes the clamp → ↓4 → /4 re-encode.
)
