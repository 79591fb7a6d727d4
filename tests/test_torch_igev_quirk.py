"""IGEV's reference-faithful evaluation (``quirk=True``) against the JAX
package's, float32 on the CPU.

* ``fold_reference_noise``: equal to the JAX package's (1e-7), and not
  the per-pixel multiply fed the scrambled noise (pool-then-multiply keeps
  cross terms out);
* the ``lowband`` and ``rsamp`` pyramids and lookups, and ``geo_lookup``
  with ``noise_eff``: within 1e-5 of the JAX package's (absolute and
  relative); ``lowband`` equal to ``volume`` (1e-5) where the reference
  eval samples it;
* ``igev_rollout_ref_eval`` on the port's own encode, against the JAX
  rollout fed that encode: the full-resolution residual and the carried
  ``coords1`` within 1e-3 px;
* ``igev_ddim_inference(quirk=True)`` on both of the port's paths against
  the JAX ``quirk=True`` sampling stage (one compile) fed the port's
  folded baseline disparity and the same draws, at
  ``tests/test_torch_igev_pipeline.py``'s size and weights (64×96,
  ``max_disp`` 64, 2 GRU iterations): 0.1 px max and 5e-3 px mean; each
  path's baseline pass is its non-quirk one (equal), which that file holds
  to the JAX package within 1e-2 px.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuvolume_tpu.diffusion.ddim import KITTI15_DDIM as J_KITTI15
from diffuvolume_tpu.eval.pipeline import _igev_stages
from diffuvolume_tpu.models.igev import geometry as jgeo
from diffuvolume_tpu.models.igev.model import IGEVStereo as JIGEV
from diffuvolume_tpu.models.igev.model import igev_rollout_ref_eval as j_rollout_ref
from diffuvolume_tpu_torch.diffusion.ddim import KITTI15_DDIM
from diffuvolume_tpu_torch.eval.pipeline import (
    igev_baseline_inference,
    igev_ddim_inference,
    igev_prep,
)
from diffuvolume_tpu_torch.models.igev import geometry as tgeo
from diffuvolume_tpu_torch.models.igev.gev_fold import fold_igev
from diffuvolume_tpu_torch.models.igev.model import igev_encode, igev_rollout_ref_eval
from torch_parity import igev_pair, jax_normal_draws, nhwc, raw_pair, to_jax_variables

H, W, MD, ITERS = 64, 96, 64, 2
D4, H4, W4 = MD // 4, H // 4, W // 4
CFG = dataclasses.replace(KITTI15_DDIM, max_disp=MD, num_bins=D4)
LOOKUP_TOL = 1e-5
ROLLOUT_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread: under the suite's parallel workers
    its default pool contends with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lookup_inputs(seed, b=2, h=4, w=40, d=16, c=8, cm=16):
    rng = np.random.default_rng(seed)
    ml = rng.standard_normal((b, h, w, cm)).astype(np.float32)
    mr = rng.standard_normal((b, h, w, cm)).astype(np.float32)
    gev = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    return rng, ml, mr, gev


def port_pyramid(ml, mr, gev, **kw):
    return tgeo.build_geo_pyramid(torch.from_numpy(ml).permute(0, 3, 1, 2),
                                  torch.from_numpy(mr).permute(0, 3, 1, 2),
                                  torch.from_numpy(np.moveaxis(gev, 1, 3)), 2, **kw)


def close(got, want, tol=LOOKUP_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_fold_reference_noise_matches_jax():
    """The scramble and the separately pooled noise, ``(B, H, W, L, D)``;
    the lookup with it is not the per-pixel multiply of the scrambled
    noise (level 1 differs by the cross terms)."""
    rng, ml, mr, gev = lookup_inputs(17, w=8)
    b, d, h, w = 2, 16, 4, 8
    noisy = rng.uniform(0.1, 1.0, (b, d, h, w)).astype(np.float32)
    eff = tgeo.fold_reference_noise(torch.from_numpy(noisy), 2)
    assert eff.shape == (b, h, w, 2, d)
    close(eff.numpy(), jgeo.fold_reference_noise(jnp.asarray(noisy), 2), 1e-7)
    disp = torch.from_numpy(rng.uniform(-2.0, d + 1.0, (b, h, w)).astype(np.float32))
    coords = torch.arange(w, dtype=torch.float32).expand(b, h, w)
    pyr = port_pyramid(ml, mr, gev, corr_mode="volume")
    ref = tgeo.geo_lookup(pyr, disp, coords, noise_eff=eff)
    scrambled = eff[..., 0, :].permute(0, 3, 1, 2)  # level-0 rows, (B, D, H, W)
    pixel = tgeo.geo_lookup(tgeo.premultiply(pyr, scrambled), disp, coords)
    jc = 9 * 8
    np.testing.assert_allclose(ref[..., :jc].numpy(), pixel[..., :jc].numpy(), rtol=1e-5,
                               atol=1e-5)
    level1 = slice(jc + 9, 2 * jc + 9)
    assert not np.allclose(ref[..., level1].numpy(), pixel[..., level1].numpy(), atol=1e-4)


@pytest.mark.parametrize("mode", ["lowband", "rsamp"])
def test_pyramid_and_lookup_match_jax(mode):
    """Both new modes' pyramids and 162-channel-order lookups against the
    JAX package's at disparities across and beyond the bins."""
    rng, ml, mr, gev = lookup_inputs(11)
    b, h, w, d = 2, 4, 40, 16
    kw = dict(corr_mode=mode, band=32) if mode == "lowband" else dict(corr_mode=mode)
    tp = port_pyramid(ml, mr, gev, **kw)
    jp = jgeo.build_geo_pyramid(jnp.asarray(ml), jnp.asarray(mr), jnp.asarray(gev), 2, **kw)
    if mode == "lowband":
        assert tp.band_mode == jp.band_mode == "low" and tp.band_offs == jp.band_offs
        assert [x.shape for x in tp.band_levels] == [(b, h, w, 32), (b, h, w, 16)]
        for x, y in zip(tp.band_levels, jp.band_levels):
            close(x.numpy(), y)
    else:
        assert [x.shape for x in tp.match_r_levels] == [(b, h, w, 16), (b, h, w // 2, 16)]
        for x, y in zip(tp.match_r_levels, jp.match_r_levels):
            close(x.numpy(), y)
    init = rng.uniform(0.0, d - 1.0, (b, h, w)).astype(np.float32)
    resid = rng.uniform(-2.0, 2.0, (b, h, w)).astype(np.float32)
    coords = init + resid  # the reference eval's (coords1, flow)
    got = tgeo.geo_lookup(tp, torch.from_numpy(resid), torch.from_numpy(coords))
    want = jgeo.geo_lookup(jp, jnp.asarray(resid), jnp.asarray(coords), radius=4)
    assert got.shape == (b, h, w, 162)
    close(got.numpy(), want)


def test_noise_eff_lookup_matches_jax():
    """``geo_lookup(noise_eff=...)`` on the low band, against the JAX
    package's, at the reference eval's positions."""
    rng, ml, mr, gev = lookup_inputs(23)
    b, h, w, d = 2, 4, 40, 16
    noisy = rng.uniform(0.0, 1.0, (b, d, h, w)).astype(np.float32)
    teff = tgeo.fold_reference_noise(torch.from_numpy(noisy))
    jeff = jgeo.fold_reference_noise(jnp.asarray(noisy))
    tp = port_pyramid(ml, mr, gev, corr_mode="lowband", band=32)
    jp = jgeo.build_geo_pyramid(jnp.asarray(ml), jnp.asarray(mr), jnp.asarray(gev), 2,
                                corr_mode="lowband", band=32)
    init = rng.uniform(0.0, d - 1.0, (b, h, w)).astype(np.float32)
    resid = rng.uniform(-3.0, 3.0, (b, h, w)).astype(np.float32)
    got = tgeo.geo_lookup(tp, torch.from_numpy(resid), torch.from_numpy(init + resid),
                          noise_eff=teff)
    want = jgeo.geo_lookup(jp, jnp.asarray(resid), jnp.asarray(init + resid), radius=4,
                           noise_eff=jeff)
    close(got.numpy(), want)


def test_lowband_equals_volume_in_quirk_regime():
    """Correlation positions ``init_disp·2⁻ⁱ + dx`` with ``init_disp`` in
    ``[0, D)``: the low band of 32 columns gives the dense lookup."""
    rng, ml, mr, gev = lookup_inputs(21, b=1)
    init = rng.uniform(0.0, 15.0, (1, 4, 40)).astype(np.float32)
    resid = rng.uniform(-2.0, 2.0, (1, 4, 40)).astype(np.float32)
    args = torch.from_numpy(resid), torch.from_numpy(init + resid)
    low = tgeo.geo_lookup(port_pyramid(ml, mr, gev, corr_mode="lowband", band=32), *args)
    vol = tgeo.geo_lookup(port_pyramid(ml, mr, gev, corr_mode="volume"), *args)
    close(low.numpy(), vol.numpy())


def test_build_geo_pyramid_refuses_unknown_mode():
    _, ml, mr, gev = lookup_inputs(1)
    with pytest.raises(ValueError, match="corr_mode"):
        port_pyramid(ml, mr, gev, corr_mode="dense")


@pytest.fixture(scope="module")
def setup():
    """``tests/test_torch_igev_pipeline.py``'s images and weights."""
    left, right = raw_pair(3, 1, H, W)
    bm, _ = igev_pair(MD, left, right, seed=1)
    _, dm = igev_pair(MD, left, right, seed=2)
    return dict(left=left, right=right, bm=bm, dm=dm, dv=to_jax_variables(dm),
                jd=JIGEV(max_disp=MD, diffusion=True))


def jax_enc(enc) -> dict:
    """The port's encode as the JAX package's ``enc`` dict (channels last)."""
    return {"match_l": nhwc(enc.match_l), "match_r": nhwc(enc.match_r),
            "gev": np.moveaxis(enc.gev.numpy(), 3, 1), "init_disp": enc.init_disp.numpy(),
            "net_list": [nhwc(x) for x in enc.net_list],
            "inp_list": [tuple(nhwc(x) for x in z) for z in enc.inp_list],
            "stem_2x": nhwc(enc.stem_2x)}


@torch.no_grad()
def test_rollout_ref_eval_matches_jax(setup):
    """One reference-faithful rollout from ``coords1 = init_disp + 0.5`` on
    the port's encode: the upsampled residual and the new ``coords1``
    against the JAX rollout given the same encode, latent and timestep."""
    s = setup
    enc, pyr = igev_encode(s["dm"], torch.from_numpy(s["left"]), torch.from_numpy(s["right"]),
                           "lowband")
    rng = np.random.default_rng(9)
    noisy = rng.standard_normal((1, D4, H4, W4)).astype(np.float32)
    t = np.array([500], np.int32)
    c1 = enc.init_disp + 0.5
    resid, c1_new = igev_rollout_ref_eval(s["dm"], enc, pyr, ITERS, c1, torch.from_numpy(noisy),
                                          torch.from_numpy(t))

    def run(v, e, c, n, tt):
        p = jgeo.build_geo_pyramid(e["match_l"], e["match_r"], e["gev"], 2, corr_mode="lowband")
        return j_rollout_ref(s["jd"], v, e, p, ITERS, c, n, tt)

    jresid, jc1 = jax.jit(run)(s["dv"], jax_enc(enc), c1.numpy(), noisy, t)
    assert resid.shape == (1, H, W) and c1_new.shape == (1, H4, W4)
    assert float((c1_new - c1).abs().max()) > 0.0
    np.testing.assert_allclose(resid.numpy(), np.asarray(jresid), rtol=0, atol=ROLLOUT_TOL)
    np.testing.assert_allclose(c1_new.numpy(), np.asarray(jc1), rtol=0, atol=ROLLOUT_TOL)


@pytest.fixture(scope="module")
def jax_quirk(setup):
    """The JAX ``quirk=True`` sampling stage, fed the port's baseline
    disparity: one compile."""
    s = setup
    base = igev_baseline_inference(s["bm"], s["left"], s["right"], iters=ITERS, device="cpu")
    jcfg = dataclasses.replace(J_KITTI15, max_disp=MD, num_bins=D4)
    jb = JIGEV(max_disp=MD, diffusion=False)
    _, sample = _igev_stages(jb, s["jd"], jcfg, ITERS, True, "band", False)
    key = jax.random.PRNGKey(5)
    final = sample(s["dv"], s["left"], s["right"], base.numpy(), key)
    return dict(base=base, jfinal=np.asarray(final),
                ns=jax_normal_draws(key, J_KITTI15.sampling_steps, (1, D4, H4, W4)))


@pytest.mark.parametrize("packed", [True, False], ids=["folded", "module"])
def test_quirk_inference_matches_jax(setup, jax_quirk, packed):
    """``igev_ddim_inference(quirk=True)``: the output against the JAX
    package's with the same draws, the baseline the non-quirk pass's."""
    s, j = setup, jax_quirk
    final, base = igev_ddim_inference(s["bm"], s["dm"], s["left"], s["right"], CFG,
                                      device="cpu", noise_source=j["ns"], packed=packed,
                                      iters=ITERS, quirk=True)
    assert final.shape == (1, H, W) and torch.isfinite(final).all()
    plain = igev_baseline_inference(s["bm"], s["left"], s["right"], iters=ITERS, device="cpu",
                                    packed=packed)
    np.testing.assert_array_equal(base.numpy(), plain.numpy())
    err = np.abs(final.numpy() - j["jfinal"])
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())


@torch.no_grad()
def test_quirk_prep_builds_the_low_band(setup):
    """The quirk prep's pyramid is the low band of absolute positions, its
    first ``W/4`` columns at level 0; its latent is the baseline's."""
    s = setup
    base, latent, entry = igev_prep(s["bm"], fold_igev(s["dm"]), torch.from_numpy(s["left"]),
                                    torch.from_numpy(s["right"]), CFG, True, ITERS, quirk=True)
    assert entry.pyramid.band_mode == "low" and entry.pyramid.band_offs == (0, 0)
    assert [x.shape for x in entry.pyramid.band_levels] == [(1, H4, W4, W4),
                                                            (1, H4, W4, W4 // 2)]
    assert latent.shape == (1, D4, H4, W4) and base.shape == (1, H, W)
