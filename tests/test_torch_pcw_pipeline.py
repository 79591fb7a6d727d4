"""Port parity for the PCW slice as a whole and the folded fronts, float32 on
the CPU, 64×64 at max_disp 192.

* ``FoldedPCW`` (``build_cost_volume``, ``denoise``, the baseline forward)
  against the JAX package's PCW module path, within 2e-3 as
  ``tests/test_torch_fold_pipeline.py`` holds the folded ACV path.
* The folded ACV front (the GWC volume in its 48 slot, then the two patch
  stencils) against the JAX package's module path patch volume.
* ``pcw_ddim_inference`` (KITTI12 DDIM-3) on both of the port's paths
  against the JAX ``pcw_ddim_inference`` (its module path on the CPU), with
  the JAX draws injected: within the bounds of ``tests/test_torch_pipeline.py``
  (0.1 px max and 5e-3 px mean on the output, 1e-2 px on the baseline).

Weights: the port's seeded random PCWNets (``random_pcw_pair``, trunk tamed,
heads calibrated), turned into the JAX package's variables by its converter.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.diffusion.ddim import KITTI12_DDIM as J_KITTI12
from diffuvolume_tpu.eval.pipeline import pcw_ddim_inference as j_pcw_inference
from diffuvolume_tpu.models.acv import ACVNet as JACV
from diffuvolume_tpu.models.pcw import PCWNet as JPCW
from diffuvolume_tpu.ops.cost_volume import build_gwc_volume as j_gwc
from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM
from diffuvolume_tpu_torch.eval.pipeline import pcw_ddim_inference, pcw_prep
from diffuvolume_tpu_torch.models.acv_fold import fold_acv
from diffuvolume_tpu_torch.models.pcw import PCWEntry
from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
from diffuvolume_tpu_torch.ops.kernels.depthwise import depthwise_hw_p
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume_packed
from torch_parity import calibrated_pair, nchw, nhwc, pcw_from_jax, pcw_pair, stereo_pair
from torch_parity import jax_normal_draws, to_jax_variables

H, W, MD = 64, 64, 192


@pytest.fixture(scope="module")
def setup():
    left, right = stereo_pair(8, 1, H, W)
    bm, dm = pcw_pair(MD, left, right, seed=4)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    jb, jd = JPCW(max_disp=MD, diffusion=False), JPCW(max_disp=MD, diffusion=True)
    combine, _, fl, fr = jax.jit(lambda v, l, r: jd.apply(
        v, l, r, train=False, method=JPCW.build_cost_volume))(dv, left, right)
    rng = np.random.default_rng(12)
    latent = rng.uniform(-1, 1, (1, MD // 4, H // 4, W // 4)).astype(np.float32)
    t = np.asarray([500], np.int32)
    jden = jax.jit(lambda v, c, a, b, lt, tt: jd.apply(
        v, c, a, b, lt, tt, (H, W), method=JPCW.denoise))(dv, combine, fl, fr, latent, t)
    jpred = jax.jit(lambda v, l, r: jb.apply(v, l, r, train=False))(bv, left, right)[0][0]
    key = jax.random.PRNGKey(5)
    jfinal, jbase = j_pcw_inference(jb, jd, bv, dv, left, right, key)
    return dict(
        left=torch.from_numpy(left), right=torch.from_numpy(right), bm=bm, dm=dm,
        fb=fold_pcw(pcw_from_jax(bv, MD, False)), fd=fold_pcw(pcw_from_jax(dv, MD, True)),
        combine=np.array(combine), fl={k: nchw(v) for k, v in fl.items()},
        fr={k: nchw(v) for k, v in fr.items()}, latent=latent, t=t,
        jden=[np.asarray(x) for x in jden], jpred=np.asarray(jpred),
        ns=jax_normal_draws(key, J_KITTI12.sampling_steps, latent.shape),
        jfinal=np.asarray(jfinal), jbase=np.asarray(jbase))


@torch.no_grad()
def test_folded_build_cost_volume(setup):
    """The combine volume within 1e-4 of its largest value."""
    s = setup
    combine, _, _, _ = s["fd"].build_cost_volume(s["left"], s["right"])
    assert combine.shape == (1, MD // 4, H // 4, W // 4, 32)
    err = np.abs(combine.numpy() - s["combine"]).max()
    assert err <= 1e-4 * np.abs(s["combine"]).max()


@torch.no_grad()
def test_folded_denoise(setup):
    """One denoise step on the same channels-last volume: disparity,
    uncertainty and the transformed latent within 2e-3."""
    s = setup
    entry = PCWEntry(torch.from_numpy(s["combine"]), s["fl"], s["fr"])
    got = s["fd"].denoise(entry, torch.from_numpy(s["latent"]), torch.from_numpy(s["t"]),
                          (H, W))
    for name, a, b in zip(("disp", "unc", "noise"), got, s["jden"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-3, err_msg=name)


@torch.no_grad()
def test_folded_baseline_forward(setup):
    pred = setup["fb"](setup["left"], setup["right"])
    np.testing.assert_allclose(pred[0].numpy(), setup["jpred"], rtol=2e-3, atol=2e-3)


def test_folded_path_refuses_unsupported_shape(setup):
    """H/4 = 12 is not a multiple of 8: the folded path raises, nothing
    switches to the module path."""
    x = torch.zeros((1, 48, 60, 3))
    with pytest.raises(ValueError, match="multiples of 8"):
        setup["fd"].build_cost_volume(x, x)
    with pytest.raises(ValueError, match="multiples of 8"):
        setup["fd"].aggregate(torch.zeros((1, 48, 12, 16, 32)), {}, {}, (48, 64))


@torch.no_grad()
def test_folded_acv_front_matches_module_path():
    """The ACV attention chain's front on the folded path, the GWC volume
    in its 48-channel slot then the ``patch`` and ``patch_l1/2/3`` stencils
    from ``fold_acv``, against the JAX module path's patch volume on the
    same trunk features: 1e-4 of its largest value; the slot's fill zero."""
    h, w, md = 32, 64, 64
    left, right = stereo_pair(9, 1, h, w)
    _, dm = calibrated_pair(md, left, right, seed=6)
    jm, dv = JACV(max_disp=md, diffusion=True), to_jax_variables(dm)

    def patch_volume(m, fl, fr):
        g = j_gwc(fl, fr, md // 4, 40)
        g = m.patch(g, False)
        return jnp.concatenate([m.patch_l1(g[..., :8], False), m.patch_l2(g[..., 8:24], False),
                                m.patch_l3(g[..., 24:40], False)], axis=-1)

    feat_l, feat_r = dm.trunk(torch.from_numpy(left), torch.from_numpy(right))
    want = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, method=patch_volume))(
        dv, nhwc(feat_l), nhwc(feat_r)))
    f = fold_acv(dm)
    vol = gwc_volume_packed(feat_l, feat_r, md // 4, 40, f.att_slot)
    got = depthwise_hw_p(depthwise_hw_p(vol, *f.patch), *f.patch_l123)
    assert got.shape == (1, md // 4, h // 4, w // 4, 48) and not got[..., 40:].any()
    assert np.abs(got[..., :40].numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module", params=[True, False], ids=["packed", "module"])
def run(request, setup):
    r = dict(setup, packed=request.param)
    r["final"], r["base"] = pcw_ddim_inference(
        r["bm"], r["dm"], r["left"].numpy(), r["right"].numpy(), device="cpu",
        noise_source=r["ns"], packed=r["packed"])
    return r


def test_final_disparity_matches(run):
    """The KITTI12 DDIM-3 output (ensemble 0.9 baseline + 0.1 last step)
    and the baseline, against the JAX pipeline with the same draws."""
    final, jfinal = run["final"].numpy(), run["jfinal"]
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    err = np.abs(final - jfinal)
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())
    np.testing.assert_allclose(run["base"].numpy(), run["jbase"], rtol=0, atol=1e-2)


@torch.no_grad()
def test_prep_entry(run):
    """The prep's combine volume is channels-last on the folded path and
    NCDHW on the module path, and both hold the same values."""
    base, latent, entry = pcw_prep(run["bm"], run["dm"], run["left"], run["right"],
                                   KITTI12_DDIM, run["packed"])
    vol = entry.volume.numpy() if run["packed"] else nhwc(entry.volume)
    assert vol.shape == (1, MD // 4, H // 4, W // 4, 32)
    np.testing.assert_allclose(base.numpy(), run["jbase"], rtol=0, atol=1e-2)
    assert latent.shape == (1, MD // 4, H // 4, W // 4)


def test_entry_point_refuses_missing_card(run):
    """With no device given the entry point runs on the card; without one it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcw_ddim_inference(run["bm"], run["dm"], run["left"].numpy(), run["right"].numpy(),
                           packed=run["packed"])


@torch.no_grad()
def test_renewal_takes_both_branches(run):
    """At the first step, on the injected initial noise, a few pixels pass
    the renewal test and most do not, so the comparison above covers both
    branches.  At random weights the DDIM model's disparity lies tens of px
    from the baseline's, so few pass: 16 of 4096 on both paths."""
    base, _, entry = pcw_prep(run["bm"], run["dm"], run["left"], run["right"], KITTI12_DDIM,
                              run["packed"])
    denoise = (fold_pcw(run["dm"]) if run["packed"] else run["dm"]).denoise
    disp, unc, _ = denoise(entry, torch.from_numpy(run["ns"]["init"]),
                           torch.tensor([999], dtype=torch.int32), (H, W))
    keep = ((disp - base).abs() < KITTI12_DDIM.consistency_tau) & (
        unc < KITTI12_DDIM.uncertainty_tau)
    assert 0.0 < keep.float().mean().item() < 0.5
