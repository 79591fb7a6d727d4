"""Shared helpers of the port's parity tests (``test_torch_*.py``).

The port's seeded random-weight ACVNets, PCWNets and IGEV-Stereos are turned
into the JAX package's variables with the JAX package's own
``convert_acv_state_dict`` / ``convert_pcw_state_dict`` /
``convert_igev_state_dict``, so both sides run the same weights.  Tensors
cross between the two as numpy arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffuvolume_tpu.tools.convert_torch import convert_acv_state_dict
from diffuvolume_tpu.tools.convert_torch_igev import convert_igev_state_dict
from diffuvolume_tpu.tools.convert_torch_pcw import convert_pcw_state_dict
from diffuvolume_tpu_torch.models.igev.model import IGEVStereo
from diffuvolume_tpu_torch.models.pcw import PCWNet
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_heads,
    calibrate_igev,
    calibrate_pcw,
    random_acv,
    random_igev_pair,
    random_pcw_pair,
)
from diffuvolume_tpu_torch.tools.weights import (
    igev_state_dict_from_jax,
    pcw_state_dict_from_jax,
)


def to_jax_variables(model) -> dict:
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    convert = (convert_pcw_state_dict if isinstance(model, PCWNet)
               else convert_igev_state_dict if isinstance(model, IGEVStereo)
               else convert_acv_state_dict)
    return convert(sd, diffusion=model.diffusion)


def pcw_pair(max_disp: int, left: np.ndarray, right: np.ndarray, seed: int = 0):
    """``(baseline, ddim)`` port PCWNets from ``random_pcw_pair``, calibrated
    on the images (logit std 10, residual 1 px), the DDIM model sharing the
    baseline's weights."""
    bm, dm = random_pcw_pair(max_disp, torch.Generator().manual_seed(seed))
    calibrate_pcw(bm, torch.from_numpy(left), torch.from_numpy(right))
    dm.load_state_dict(bm.state_dict(), strict=False)
    return bm, dm


def pcw_from_jax(variables, max_disp: int, diffusion: bool) -> PCWNet:
    """A fresh port PCWNet loaded from the JAX package's variables through
    ``tools/weights.py:pcw_rules``."""
    model = PCWNet(max_disp, diffusion)
    model.load_state_dict(pcw_state_dict_from_jax(variables, diffusion))
    return model.eval()


def igev_pair(max_disp: int, left: np.ndarray, right: np.ndarray, seed: int = 0):
    """``(baseline, ddim)`` port IGEV-Stereos from ``random_igev_pair``, the
    baseline calibrated on the RAW images (logit std 10, GRU step 0.5
    quarter px), the DDIM model sharing its weights."""
    bm, dm = random_igev_pair(max_disp, torch.Generator().manual_seed(seed))
    calibrate_igev(bm, torch.from_numpy(left), torch.from_numpy(right))
    dm.load_state_dict(bm.state_dict(), strict=False)
    return bm, dm


def igev_from_jax(variables, max_disp: int, diffusion: bool) -> IGEVStereo:
    """A fresh port IGEVStereo loaded from the JAX package's variables
    through ``tools/weights.py:igev_rules``."""
    model = IGEVStereo(max_disp, diffusion)
    model.load_state_dict(igev_state_dict_from_jax(variables, diffusion))
    return model.eval()


def raw_pair(seed: int, b: int, h: int, w: int, shift: int = 3):
    """RAW ``(B, H, W, 3)`` float32 images in [0, 255); the right is the
    left shifted by ``shift`` pixels."""
    left = np.random.default_rng(seed).uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    return left, np.roll(left, -shift, axis=2)


def stereo_pair(seed: int, b: int, h: int, w: int, shift: int = 3):
    """Normalised ``(B, H, W, 3)`` float32 images; the right is the left
    shifted by ``shift`` pixels."""
    left = np.random.default_rng(seed).standard_normal((b, h, w, 3)).astype(np.float32) * 0.3
    return left, np.roll(left, -shift, axis=2)


def calibrated_pair(max_disp: int, left: np.ndarray, right: np.ndarray, seed: int = 0):
    """``(baseline, ddim)`` port models with calibrated heads (logit std 3)."""
    g = torch.Generator().manual_seed(seed)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    models = []
    for diffusion in (False, True):
        models.append(calibrate_heads(random_acv(max_disp, diffusion, g), lt, rt))
    return tuple(models)


def nhwc(x: torch.Tensor) -> np.ndarray:
    """Port NCHW / NCDHW tensor → the JAX package's channels-last array."""
    x = x.detach().cpu().numpy()
    return np.moveaxis(x, 1, -1)


def nchw(x) -> torch.Tensor:
    """The JAX package's channels-last array → the port's NCHW / NCDHW tensor."""
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(x), -1, 1)))


def jax_normal_draws(key, steps: int, shape) -> dict:
    """The JAX ``ddim_sample``'s draws for ``init_mode="noise"`` and a
    Gaussian replacement (KITTI12, KITTI15): split off the init key, then
    per step the z and the replacement eps, in the order it makes them."""
    rng, k_init = jax.random.split(key)
    zs, rs = [], []
    for k in jax.random.split(rng, steps):
        kz, kr = jax.random.split(k)
        zs.append(np.array(jax.random.normal(kz, shape, jnp.float32)))
        rs.append(np.array(jax.random.normal(kr, shape, jnp.float32)))
    return {"init": np.array(jax.random.normal(k_init, shape, jnp.float32)),
            "z": np.stack(zs), "replace": np.stack(rs)}


def jax_uniform_draws(key, steps: int, shape) -> dict:
    """The JAX ``ddim_sample``'s draws for a uniform replacement (the ACV
    SceneFlow sampler): split off the init key, then per step the z and the
    replacement, in the order it makes them."""
    rng, _ = jax.random.split(key)
    zs, rs = [], []
    for k in jax.random.split(rng, steps):
        kz, kr = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(kz, shape, jnp.float32)))
        rs.append(np.asarray(jax.random.uniform(kr, shape, jnp.float32)))
    return {"z": np.stack(zs), "replace": np.stack(rs)}
