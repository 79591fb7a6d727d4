"""Diffusion schedule and forward/inverse process algebra.

Counterpart of ``diffuvolume_tpu/diffusion/schedule.py``.  The buffers are
computed in float64 with numpy (the reference's torch.float64 cosine
schedule) and stored as float32 tensors; the DDIM step scalars stay float64
on the host until the last cast (see ``ddim_step_coefficients``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffuvolume_tpu_torch.utils.spans import H2D, span


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine beta schedule, clipped to [0, 0.999] (float64)."""
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed diffusion buffers, float32 tensors of shape ``(T,)``."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def make_schedule(
    timesteps: int = 1000,
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> DiffusionSchedule:
    betas = cosine_beta_schedule(timesteps)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    arrays = dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.clip(posterior_variance, 1e-20, None)),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
    )
    buffers = {}
    for k, v in arrays.items():
        with span(H2D):
            buffers[k] = torch.as_tensor(v.astype(np.float32), device=device).to(dtype)
    return DiffusionSchedule(**buffers)


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather ``a[t]`` for ``t`` of shape ``(B,)``, shaped to broadcast
    against an ``ndim``-dimensional batch tensor."""
    return a[t.long()].reshape(t.shape[0], *([1] * (ndim - 1)))


def q_sample(
    sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Forward diffusion: ``x_t = sqrt(ᾱ_t)·x_0 + sqrt(1-ᾱ_t)·ε``."""
    a = extract(sched.sqrt_alphas_cumprod, t, x_start.ndim)
    b = extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
    return a * x_start + b * noise


def predict_noise_from_start(
    sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
    x0: torch.Tensor,
) -> torch.Tensor:
    """Invert q_sample for the noise:
    ``ε̂ = (sqrt(1/ᾱ_t)·x_t − x̂_0) / sqrt(1/ᾱ_t − 1)``."""
    recip = extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim)
    recipm1 = extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)
    return (recip * x_t - x0) / recipm1


def ddim_time_pairs(total_timesteps: int, sampling_steps: int) -> np.ndarray:
    """The reversed ``(t, t_next)`` pairs of the DDIM trajectory, ``(steps, 2)``
    int32; the last ``t_next`` is -1."""
    times = np.linspace(-1, total_timesteps - 1, sampling_steps + 1)
    times = list(reversed(times.astype(np.int64).tolist()))
    return np.asarray(list(zip(times[:-1], times[1:])), dtype=np.int32)


def ddim_step_coefficients(
    total_timesteps: int, sampling_steps: int, eta: float = 1.0
) -> dict[str, np.ndarray]:
    """Per-step DDIM scalars, computed on the host in float64.

    ``sigma = η·sqrt((1-ᾱ/ᾱ')·(1-ᾱ')/(1-ᾱ))`` and ``c = sqrt(1-ᾱ'-σ²)``.  Near
    t=T-1 the term ``1-ᾱ'-σ²`` is about 2e-8, which float32 evaluates slightly
    negative, and the square root then gives NaN.
    """
    betas = cosine_beta_schedule(total_timesteps)
    acp = np.cumprod(1.0 - betas)
    pairs = ddim_time_pairs(total_timesteps, sampling_steps)
    alpha = acp[pairs[:, 0]]
    alpha_next = acp[np.maximum(pairs[:, 1], 0)]
    sigma = eta * np.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
    c = np.sqrt(np.maximum(1 - alpha_next - sigma**2, 0.0))
    return {
        "pairs": pairs,
        "sigma": sigma.astype(np.float32),
        "c": c.astype(np.float32),
        "sqrt_alpha_next": np.sqrt(alpha_next).astype(np.float32),
    }
