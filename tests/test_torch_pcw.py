"""Port parity for PCWNet's module path, float32 on the CPU, 64×64 at
max_disp 192 (the size of the JAX package's own PCW test,
``tests/test_pallas_conv3d.py``): ``PCWNet.build_cost_volume``,
``.refine``, ``.denoise`` and the baseline eval forward against the JAX
package's ``PCWNet``; the warp and the signed-correlation volume against
the JAX functions; ``tools/weights.py:pcw_rules`` against the JAX package's
converter.

Weights: the port's seeded random PCWNets (``random_pcw_pair``, trunk tamed,
heads calibrated), turned into the JAX package's variables by its
``convert_pcw_state_dict`` and carried back into a fresh port model by
``pcw_rules``.  The JAX side's Pallas heads run in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.models.pcw import PCWNet as JPCW
from diffuvolume_tpu.ops.cost_volume import (
    build_signed_correlation_volume as j_signed_corr,
)
from diffuvolume_tpu.ops.sampling import warp_right_to_left as j_warp
from diffuvolume_tpu_torch.models.pcw import PCWEntry
from diffuvolume_tpu_torch.ops.cost_volume import build_signed_correlation_volume
from diffuvolume_tpu_torch.ops.sampling import warp_right_to_left
from diffuvolume_tpu_torch.tools.weights import pcw_state_dict_from_jax
from torch_parity import nchw, nhwc, pcw_from_jax, pcw_pair, stereo_pair, to_jax_variables

H, W, MD = 64, 64, 192


def _close_rel(got: np.ndarray, want: np.ndarray, rel: float):
    """Max error within ``rel`` of the reference's largest magnitude."""
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    left, right = stereo_pair(7, 1, H, W)
    bm, dm = pcw_pair(MD, left, right, seed=3)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    jb, jd = JPCW(max_disp=MD, diffusion=False), JPCW(max_disp=MD, diffusion=True)
    combine, cost0, fl, fr = jax.jit(lambda v, l, r: jd.apply(
        v, l, r, train=False, method=JPCW.build_cost_volume))(dv, left, right)
    rng = np.random.default_rng(11)
    latent = rng.uniform(-1, 1, (1, MD // 4, H // 4, W // 4)).astype(np.float32)
    pred3 = rng.uniform(0, 40, (1, H, W)).astype(np.float32)
    t = np.asarray([300], np.int32)
    jden = jax.jit(lambda v, c, a, b, lt, tt: jd.apply(
        v, c, a, b, lt, tt, (H, W), method=JPCW.denoise))(dv, combine, fl, fr, latent, t)
    jref = jax.jit(lambda v, p, a, b: jd.apply(
        v, p, a, b, (H, W), False, method=JPCW.refine))(dv, pred3, fl, fr)
    jpred = jax.jit(lambda v, l, r: jb.apply(v, l, r, train=False))(bv, left, right)[0][0]
    return dict(
        left=torch.from_numpy(left), right=torch.from_numpy(right), bm=bm, dm=dm, bv=bv, dv=dv,
        pb=pcw_from_jax(bv, MD, False), pd=pcw_from_jax(dv, MD, True),
        combine=np.asarray(combine), cost0=np.asarray(cost0),
        fl={k: np.asarray(v) for k, v in fl.items()}, fr={k: np.asarray(v) for k, v in fr.items()},
        latent=latent, pred3=pred3, t=t, jden=[np.asarray(x) for x in jden],
        jref=np.asarray(jref), jpred=np.asarray(jpred))


def _jax_features(s, side):
    return {k: nchw(v) for k, v in s[side].items()}


@pytest.mark.parametrize("diffusion", [False, True])
def test_pcw_rules_invert_the_converter(setup, diffusion):
    """JAX variables → ``pcw_rules`` → exactly the state dict the JAX
    converter started from, every key of the port's model."""
    model = setup["dm" if diffusion else "bm"]
    sd = pcw_state_dict_from_jax(setup["dv" if diffusion else "bv"], diffusion)
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(sd[k].to(v.dtype), v), k


@torch.no_grad()
def test_build_cost_volume(setup):
    """The trunk's features, cost0 and the fused combine volume within 1e-4
    of their largest magnitude (the JAX package's own bound for its packed
    build)."""
    s = setup
    combine, cost0, fl, fr = s["pd"].build_cost_volume(s["left"], s["right"])
    for k, v in fl.items():
        _close_rel(nhwc(v), s["fl"][k], 1e-4)
        _close_rel(nhwc(fr[k]), s["fr"][k], 1e-4)
    _close_rel(nhwc(cost0), s["cost0"], 1e-4)
    _close_rel(nhwc(combine), s["combine"], 1e-4)


@torch.no_grad()
def test_refine(setup):
    """The warp-correlation refinement on the same disparity and features:
    2e-3 px."""
    s = setup
    got = s["pd"].refine(torch.from_numpy(s["pred3"]), _jax_features(s, "fl"),
                         _jax_features(s, "fr"), (H, W))
    np.testing.assert_allclose(got.numpy(), s["jref"], rtol=2e-3, atol=2e-3)


@torch.no_grad()
def test_denoise(setup):
    """One denoise step on the same combine volume, latent and t: the
    refined disparity, the uncertainty scored against it and the
    transformed latent within 2e-3."""
    s = setup
    entry = PCWEntry(nchw(s["combine"]), _jax_features(s, "fl"), _jax_features(s, "fr"))
    got = s["pd"].denoise(entry, torch.from_numpy(s["latent"]), torch.from_numpy(s["t"]),
                          (H, W))
    for name, a, b in zip(("disp", "unc", "noise"), got, s["jden"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-3, err_msg=name)


@torch.no_grad()
def test_baseline_forward(setup):
    """The baseline eval forward (pass 1 of the pipeline): 2e-3 px."""
    pred = setup["pb"](setup["left"], setup["right"])
    assert len(pred) == 1 and pred[0].shape == (1, H, W)
    np.testing.assert_allclose(pred[0].numpy(), setup["jpred"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b,c,h,w,dmax", [(1, 3, 6, 8, 3.0), (2, 5, 9, 16, 12.0)])
def test_warp_right_to_left(b, c, h, w, dmax):
    """The reference's coordinate quirk and the ones-warp mask, against the
    JAX warp: 1e-5."""
    rng = np.random.default_rng(h)
    right = rng.standard_normal((b, h, w, c)).astype(np.float32)
    disp = rng.uniform(0, dmax, (b, h, w)).astype(np.float32)
    want = np.asarray(j_warp(jnp.asarray(right), jnp.asarray(disp)))
    got = warp_right_to_left(nchw(right), torch.from_numpy(disp))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w,max_offset", [(30, 24), (20, 24), (12, 4)])
def test_signed_correlation_volume(w, max_offset):
    """Every signed shift, including those beyond the width (all zero):
    1e-6."""
    rng = np.random.default_rng(w)
    left, right = (rng.standard_normal((1, 5, w, 8)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_signed_corr(jnp.asarray(left), jnp.asarray(right), max_offset))
    got = build_signed_correlation_volume(nchw(left), nchw(right), max_offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
