"""Port parity for the whole slice: two-pass ACV DDIM-5 inference at 32×64,
max_disp 64, float32 on the CPU (the configuration of
tests/golden_pipelines.py's ACV run).

Weights: the port's seeded random models.  The DDIM model shares the
baseline's weights (only its time embedding is its own) and the heads are
calibrated to logit std 10, so that the renewal filter keeps some pixels
and replaces others (at unscaled random weights the logits reach ±1e5 and
every comparison is noise).  The JAX draws of ``ddim_sample`` are made from
the same key in the order it makes them and injected into the port.

Every test runs on both of the port's paths (``packed=True``, the folded
path of ``models/acv_fold.py``; ``packed=False``, the module path) against
the same JAX run.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.diffusion import DDIMConfig as JDDIMConfig
from diffuvolume_tpu.eval.pipeline import _stages
from diffuvolume_tpu.models.acv import ACVNet as JACV
from diffuvolume_tpu_torch.diffusion import DDIMConfig
from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference, acv_prep
from diffuvolume_tpu_torch.models.acv_fold import fold_acv
from diffuvolume_tpu_torch.tools.random_weights import calibrate_heads, random_pair
from torch_parity import nhwc, stereo_pair, to_jax_variables

H, W, MD = 32, 64, 64
CFG = DDIMConfig(max_disp=MD, num_bins=MD // 4)


def jax_draws(key, cfg, shape):
    """The per-step z and uniform replacement draws of the JAX
    ``ddim_sample`` (ddim.py: split → step keys → split per step)."""
    rng, _ = jax.random.split(key)
    zs, rs = [], []
    for k in jax.random.split(rng, cfg.sampling_steps):
        kz, kr = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(kz, shape, jnp.float32)))
        rs.append(np.asarray(jax.random.uniform(kr, shape, jnp.float32)))
    return {"z": np.stack(zs), "replace": np.stack(rs)}


@pytest.fixture(scope="module")
def jax_run():
    left, right = stereo_pair(0, 1, H, W)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    bm, dm = random_pair(MD, torch.Generator().manual_seed(0))
    # The models share classif2: calibrating the baseline's sets both.
    calibrate_heads(bm, lt, rt, target_std=10.0)
    dm.load_state_dict(bm.state_dict(), strict=False)

    jcfg = JDDIMConfig(max_disp=MD, num_bins=MD // 4)
    jb, jdm = JACV(max_disp=MD, diffusion=False), JACV(max_disp=MD, diffusion=True)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    # The two stages acv_ddim_inference runs, with their flags' defaults.
    prep, sample = _stages(jb, jdm, jcfg, True, True)
    key = jax.random.PRNGKey(3)
    jbase, jlat, jac = prep(bv, dv, left, right)
    jfinal = sample(dv, jac, jbase, jlat, key)
    return dict(left=lt, right=rt, bm=bm, dm=dm, ns=jax_draws(key, jcfg, jlat.shape),
                jbase=np.asarray(jbase), jlat=np.asarray(jlat), jac=np.asarray(jac),
                jfinal=np.asarray(jfinal))


@pytest.fixture(scope="module", params=[True, False], ids=["packed", "module"])
def run(request, jax_run):
    r = dict(jax_run, packed=request.param)
    r["final"], r["base"] = acv_ddim_inference(
        r["bm"], r["dm"], r["left"].numpy(), r["right"].numpy(), CFG, device="cpu",
        noise_source=r["ns"], packed=r["packed"])
    return r


def test_prep_stage_matches(run):
    """Pass 1 and the sampler's inputs, tightly: the baseline disparity
    (measured 2.5e-3 to 4.0e-3 px over torch thread counts 1–8; bound 1e-2),
    the encoded latent (3.8e-4; 2e-3), and the attention-filtered volume
    (1e-4 of its largest value)."""
    base, latent, entry = acv_prep(run["bm"], run["dm"], run["left"], run["right"], CFG,
                                   run["packed"])
    np.testing.assert_allclose(base.numpy(), run["jbase"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(latent.numpy(), run["jlat"], rtol=0, atol=2e-3)
    if run["packed"]:  # the folded path's volume is channels-last already
        ac = (entry.volume * entry.att[..., None]).numpy()
    else:
        ac = nhwc(entry.att[:, None] * entry.volume)
    assert np.abs(ac - run["jac"]).max() <= 1e-4 * np.abs(run["jac"]).max()


def test_final_disparity_matches(run):
    """The ensembled DDIM-5 output, against a bound calibrated before it was
    set.  The loop re-encodes each step's disparity, so float32 rounding
    grows over the steps: against the JAX package, with the port at torch
    thread counts 1–8, max 3.4e-3 to 9.5e-3 px and mean 2.7e-4 to 6.3e-4 px;
    between the port's own thread counts (other draws) up to 2.6e-2 / 2.0e-3
    px.  No renewal branch flipped in any of these; a flipped branch moves a
    block by pixels.  Bound: 0.1 px on every pixel, 5e-3 px on the mean."""
    final, jfinal = run["final"].numpy(), run["jfinal"]
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    err = np.abs(final - jfinal)
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())
    np.testing.assert_allclose(run["base"].numpy(), run["jbase"], rtol=0, atol=1e-2)


@torch.no_grad()
def test_renewal_takes_both_branches(run):
    """At the first step some pixels pass the renewal test and most do not,
    so the comparison above covers both branches."""
    base, latent, entry = acv_prep(run["bm"], run["dm"], run["left"], run["right"], CFG,
                                   run["packed"])
    denoise = (fold_acv(run["dm"]) if run["packed"] else run["dm"]).denoise
    disp, unc, _ = denoise(entry, latent, torch.tensor([999], dtype=torch.int32), (H, W))
    keep = ((disp - base).abs() < CFG.consistency_tau) & (unc < CFG.uncertainty_tau)
    assert 0.0 < keep.float().mean().item() < 0.5


def test_entry_point_refuses_missing_card(run):
    """With no device given the entry point runs on the card; without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acv_ddim_inference(run["bm"], run["dm"], run["left"].numpy(), run["right"].numpy(), CFG,
                           packed=run["packed"])
