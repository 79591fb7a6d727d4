"""Port parity for the IGEV slice as a whole, float32 on the CPU, at the JAX
tests' size: 64×96, ``max_disp`` 64, 2 GRU iterations.

* ``FoldedIGEV`` (every 3-D conv of the GEV tower on the kernels' plain
  versions, BatchNorm folded) and the module path against the JAX package's
  module-path encode: the GEV within 1e-4 of its largest value, the initial
  disparity within 2e-3 px (as ``tests/test_torch_fold_pipeline.py`` holds
  the folded ACV model).
* ``igev_ddim_inference`` (KITTI15 DDIM-2, band lookups) on both of the
  port's paths against the JAX ``igev_ddim_inference`` (its module path on
  the CPU, ``quirk=False``), with the JAX draws injected: 0.1 px max and
  5e-3 px mean on the output, 1e-2 px on the baseline, the bounds of
  ``tests/test_torch_pipeline.py``.

Weights: the port's seeded random IGEV-Stereos (``random_igev_pair``, the
classifier and the GRU's step calibrated; baseline and DDIM model from two
seeds), turned into the JAX package's variables by its converter.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from diffuvolume_tpu.diffusion.ddim import KITTI15_DDIM as J_KITTI15
from diffuvolume_tpu.eval.pipeline import igev_ddim_inference as j_igev_inference
from diffuvolume_tpu.models.igev.model import IGEVStereo as JIGEV
from diffuvolume_tpu_torch.diffusion import ddim_sample, make_schedule
from diffuvolume_tpu_torch.diffusion.ddim import KITTI15_DDIM
from diffuvolume_tpu_torch.eval.pipeline import (
    igev_baseline_inference,
    igev_ddim_inference,
    igev_prep,
)
from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
from diffuvolume_tpu_torch.models.igev.geometry import GeoPyramid
from torch_parity import igev_pair, jax_normal_draws, nhwc, raw_pair, to_jax_variables

H, W, MD, ITERS = 64, 96, 64, 2
D4, H4, W4 = MD // 4, H // 4, W // 4
CFG = dataclasses.replace(KITTI15_DDIM, max_disp=MD, num_bins=D4)


@pytest.fixture(scope="module")
def setup():
    left, right = raw_pair(3, 1, H, W)
    # The DDIM model from its own seed: its disparity then lies within the
    # hard clamp's 3 px of the baseline's at some pixels only.
    bm, _ = igev_pair(MD, left, right, seed=1)
    _, dm = igev_pair(MD, left, right, seed=2)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    jb, jd = JIGEV(max_disp=MD, diffusion=False), JIGEV(max_disp=MD, diffusion=True)
    enc = jax.jit(lambda v, l, r: jd.apply(v, l, r, False, method=JIGEV.encode))(
        dv, left, right)
    key = jax.random.PRNGKey(5)
    jcfg = dataclasses.replace(J_KITTI15, max_disp=MD, num_bins=D4)
    jfinal, jbase = j_igev_inference(jb, jd, bv, dv, left, right, key, cfg=jcfg, iters=ITERS)
    return dict(
        left=torch.from_numpy(left), right=torch.from_numpy(right), bm=bm, dm=dm,
        gev=np.moveaxis(np.asarray(enc["gev"]), 1, 3), init=np.asarray(enc["init_disp"]),
        match_l=np.asarray(enc["match_l"]),
        ns=jax_normal_draws(key, J_KITTI15.sampling_steps, (1, D4, H4, W4)),
        jfinal=np.asarray(jfinal), jbase=np.asarray(jbase))


@torch.no_grad()
@pytest.mark.parametrize("packed", [True, False], ids=["folded", "module"])
def test_encode_matches_jax_module_path(setup, packed):
    """The GEV ``(B, H4, W4, D, 8)`` within 1e-4 of its largest value, the
    initial disparity within 2e-3 px, the match descriptors within 1e-4 of
    theirs."""
    s = setup
    model = fold_igev(s["dm"]) if packed else s["dm"]
    enc = model.encode(s["left"], s["right"])
    assert enc.gev.shape == (1, H4, W4, D4, 8)
    assert np.abs(enc.gev.numpy() - s["gev"]).max() <= 1e-4 * np.abs(s["gev"]).max()
    np.testing.assert_allclose(enc.init_disp.numpy(), s["init"], rtol=0, atol=2e-3)
    assert np.abs(nhwc(enc.match_l) - s["match_l"]).max() <= 1e-4 * np.abs(s["match_l"]).max()


@torch.no_grad()
def test_folded_baseline_forward(setup):
    """The frozen IGEV-Stereo alone on the folded tower: the JAX pipeline's
    baseline within 1e-2 px."""
    s = setup
    pred = igev_baseline_inference(fold_igev(s["bm"]), s["left"].numpy(), s["right"].numpy(),
                                   iters=ITERS, device="cpu")
    assert pred.shape == (1, H, W)
    np.testing.assert_allclose(pred.numpy(), s["jbase"], rtol=0, atol=1e-2)


def test_folded_path_refuses_unsupported_shape(setup):
    """H/4 = 12 is not a multiple of 8: the folded tower raises, nothing
    switches to the module path."""
    f = fold_igev(setup["dm"])
    m = torch.zeros((1, 96, 12, 24))
    with pytest.raises(ValueError, match="multiples of 8"):
        f.gev_tower(m, m, [None] * 4)


@pytest.fixture(scope="module", params=[True, False], ids=["folded", "module"])
def run(request, setup):
    r = dict(setup, packed=request.param)
    r["final"], r["base"] = igev_ddim_inference(
        r["bm"], r["dm"], r["left"].numpy(), r["right"].numpy(), CFG, device="cpu",
        noise_source=r["ns"], packed=r["packed"], iters=ITERS)
    return r


def test_final_disparity_matches(run):
    """The KITTI15 DDIM-2 output (ensemble 0.6 baseline + 0.1 step 1 + 0.3
    step 2, each step hard-clamped to the baseline) and the baseline,
    against the JAX pipeline with the same draws."""
    final, jfinal = run["final"].numpy(), run["jfinal"]
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    err = np.abs(final - jfinal)
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())
    np.testing.assert_allclose(run["base"].numpy(), run["jbase"], rtol=0, atol=1e-2)


@torch.no_grad()
def test_prep_entry_and_clamp_branches(run):
    """The prep holds the DDIM model's encode once and its band pyramid;
    the sampler's decisions (``return_masks``) cover both sides of the hard
    clamp at every step, so the comparison above covers both branches, and
    the renewal's statistic is the clamp's."""
    r = run
    base, latent, entry = igev_prep(r["bm"], r["dm"], r["left"], r["right"], CFG, r["packed"],
                                    ITERS)
    assert isinstance(entry.pyramid, GeoPyramid) and len(entry.pyramid.band_levels) == 2
    assert entry.enc.gev.shape == (1, H4, W4, D4, 8) and latent.shape == (1, D4, H4, W4)
    np.testing.assert_allclose(base.numpy(), r["jbase"], rtol=0, atol=1e-2)
    dm = fold_igev(r["dm"]) if r["packed"] else r["dm"]
    final, _, decisions = ddim_sample(
        make_schedule(1000), CFG, lambda lat, t: dm.denoise(entry, lat, t, (H, W)), base, latent,
        noise_source=r["ns"], return_masks=True)
    np.testing.assert_allclose(final.numpy(), r["final"].numpy(), rtol=0, atol=1e-6)
    assert len(decisions) == CFG.sampling_steps
    for step in decisions:
        assert set(step) == {"renew_gap", "clamp_gap"}
        gap, tau = step["clamp_gap"]
        near = gap < tau
        assert tau == CFG.hard_clamp_tau and near.any() and not near.all()
        assert step["renew_gap"][0] is gap


def test_entry_point_refuses_missing_card(run):
    """With no device given the entry point runs on the card; without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        igev_ddim_inference(run["bm"], run["dm"], run["left"].numpy(), run["right"].numpy(),
                            CFG, packed=run["packed"], iters=ITERS)
