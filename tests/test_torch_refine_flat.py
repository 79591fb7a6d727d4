"""Port parity for PCWNet's folded refinement net (``fold_pcw(...,
refine_flat=True)``, every 3×3 conv on ``conv2d_flat``, TPU row 18), float32
on the CPU.

* ``conv2d_flat_plain`` against the Pallas ``conv2d_flat`` in interpret mode
  at the JAX test's six (C_in, C_out, dilation) cases
  (``tests/test_pallas_conv3d.py:212-229``): 1e-4 absolute + 1e-4 relative,
  as that test holds the kernel against XLA.
* The folded refinement against the JAX ``_refine_flat`` (interpret mode)
  and against the port's ``PCWNet.refine`` at 64×64: 2e-3, the bound
  ``tests/test_torch_pcw_pipeline.py`` holds the folded PCW path to (BatchNorm
  folded in float32 reorders the sums).
* ``pcw_ddim_inference`` with ``fold_pcw(..., refine_flat=True)`` against the
  JAX ``pcw_ddim_inference`` with the JAX draws injected: 0.1 px max and 5e-3
  px mean on the output, 1e-2 px on the baseline.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.diffusion.ddim import KITTI12_DDIM as J_KITTI12
from diffuvolume_tpu.eval.pipeline import pcw_ddim_inference as j_pcw_inference
from diffuvolume_tpu.models.pcw import PCWNet as JPCW
from diffuvolume_tpu.models.pcw import _refine_flat as j_refine_flat
from diffuvolume_tpu.ops.pallas.conv2d import conv2d_flat as j_conv2d_flat
from diffuvolume_tpu_torch.eval.pipeline import pcw_ddim_inference
from diffuvolume_tpu_torch.models.pcw_fold import (
    REFINE_SLOT,
    fold_pcw,
    fold_refine,
    refine_flat,
)
from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
from diffuvolume_tpu_torch.ops.kernels.conv2d import conv2d_flat, conv2d_flat_on, conv2d_flat_plain
from torch_parity import jax_normal_draws, nchw, pcw_pair, stereo_pair, to_jax_variables

H, W, MD = 64, 64, 192


@pytest.mark.parametrize("c,co,d", [(128, 128, 1), (128, 96, 2), (96, 96, 8),
                                    (64, 64, 16), (146, 128, 1), (32, 1, 1)])
def test_conv2d_flat_plain_matches_pallas(c, co, d):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 20, c)).astype(np.float32)
    k = rng.standard_normal((3, 3, c, co)).astype(np.float32) * 0.1
    b = rng.standard_normal((co,)).astype(np.float32)
    want = np.asarray(j_conv2d_flat(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                    dilation=d, tile_h=8, interpret=True))
    got = conv2d_flat(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), conv2d_flat_plain(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), d).numpy())


def test_conv2d_flat_refuses_bad_operands():
    """A 5×5 kernel, a dilation of 0 or past the kernel's staging, a bias in
    the wrong dtype: raised before any dispatch, on the CPU too."""
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="must agree"):
        conv2d_flat(x, torch.zeros((5, 5, 8, 8)))
    for d in (0, 65):
        with pytest.raises(ValueError, match="dilation"):
            conv2d_flat(x, torch.zeros((3, 3, 8, 8)), dilation=d)
    with pytest.raises(ValueError, match="float32"):
        conv2d_flat(x, torch.zeros((3, 3, 8, 8)), torch.zeros(8, dtype=torch.float64))


@pytest.mark.parametrize("c,co", [(16, 8), (24, 1), (160, 128)])
def test_conv2d_flat_is_the_one_plane_3d_conv(c, co):
    """Row 18 at dilation 1 is the stride-1 3×3×3 conv (rows 5, 6, 14, 15)
    on a one-plane volume with the weight in its middle kd tap: the planes
    above and below are padding.  The card runs both on one kernel
    (``csrc/conv_hopper.cuh`` ``conv_s1``); here their plain versions agree
    to float32 summation order."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 7, 9, c)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, c, co)).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.standard_normal((co,)).astype(np.float32))
    k3 = torch.zeros((3, 3, 3, c, co))
    k3[1] = k
    want = kconv.conv3d_fold_plain(x[:, None], k3, b)[:, 0]
    np.testing.assert_allclose(conv2d_flat_plain(x, k, b, 1).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tc", [kconv.TC_MMA, kconv.TC_WGMMA])
def test_forced_tensor_core_forms_take_the_plain_version_on_the_cpu(tc):
    """``conv2d_flat_on`` and ``conv3d_fold_p_on`` (the timing entries that
    force a tensor-core form) check their operands as the plain entries do,
    compute the plain version on a CPU tensor and count no launch."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 16, 32)).astype(np.float32) * 0.1)
    before = conv2d_flat.launches, kconv.conv3d_fold_p.launches
    np.testing.assert_array_equal(conv2d_flat_on(tc, x, k, None, 2).numpy(),
                                  conv2d_flat_plain(x, k, None, 2).numpy())
    x3 = torch.from_numpy(rng.standard_normal((1, 3, 5, 6, 16)).astype(np.float32))
    k3 = torch.from_numpy(rng.standard_normal((3, 3, 3, 16, 32)).astype(np.float32) * 0.1)
    res = torch.from_numpy(rng.standard_normal((1, 3, 5, 6, 32)).astype(np.float32))
    pm = torch.from_numpy(rng.random((1, 5, 6, 32)).astype(np.float32))
    np.testing.assert_array_equal(
        kconv.conv3d_fold_p_on(tc, x3, k3, None, residual=res, act="mish", post_mul=pm).numpy(),
        kconv.conv3d_fold_plain(x3, k3, None, 1, res, "mish", pm).numpy())
    assert (conv2d_flat.launches, kconv.conv3d_fold_p.launches) == before
    with pytest.raises(ValueError, match="dilation"):
        conv2d_flat_on(tc, x, k, None, 65)
    with pytest.raises(ValueError, match="3×3×3"):
        kconv.conv3d_fold_p_on(tc, x3, k3[:1, :1, :1].contiguous())
    with pytest.raises(ValueError, match="act"):
        kconv.conv3d_fold_p_on(tc, x3, k3, act="gelu")


@pytest.fixture(scope="module")
def setup():
    left, right = stereo_pair(8, 1, H, W)
    bm, dm = pcw_pair(MD, left, right, seed=4)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    jb, jd = JPCW(max_disp=MD, diffusion=False), JPCW(max_disp=MD, diffusion=True)
    trunk = jax.jit(lambda v, x: jd.apply(
        v, x, method=lambda m, y: m.feature_extraction(y, False)))
    fl, fr = trunk(dv, left), trunk(dv, right)
    pred3 = np.random.default_rng(13).uniform(0, 60, (1, H, W)).astype(np.float32)
    jref = j_refine_flat(jd, dv, jnp.asarray(pred3), fl, fr, (H, W), interpret=True)
    key = jax.random.PRNGKey(5)
    jfinal, jbase = j_pcw_inference(jb, jd, bv, dv, left, right, key)
    return dict(left=left, right=right, bm=bm, dm=dm, pred3=pred3,
                fl={k: nchw(v) for k, v in fl.items()}, fr={k: nchw(v) for k, v in fr.items()},
                jref=np.asarray(jref), jfinal=np.asarray(jfinal), jbase=np.asarray(jbase),
                ns=jax_normal_draws(key, J_KITTI12.sampling_steps, (1, MD // 4, H // 4, W // 4)))


@torch.no_grad()
def test_folded_refinement_matches_jax_and_module(setup):
    """``FoldedPCW.aggregate``'s refinement on the same prediction and
    features: against the JAX ``_refine_flat`` and the port's module
    ``PCWNet.refine``."""
    s = setup
    f = fold_pcw(s["dm"], refine_flat=True)
    pred3 = torch.from_numpy(s["pred3"])
    x = s["dm"].refine_input(pred3, s["fl"], s["fr"], (H, W))
    assert x.shape == (1, 146, H, W)
    got = refine_flat(f.refine, x, pred3, f.act).numpy()
    module = s["dm"].refine(pred3, s["fl"], s["fr"], (H, W)).numpy()
    assert got.shape == (1, H, W) and np.isfinite(got).all()
    np.testing.assert_allclose(got, s["jref"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, module, rtol=2e-3, atol=2e-3)
    # The refinement's residual is not zero at these weights, so the
    # comparison says something about the convs.
    assert np.abs(got - s["pred3"]).max() > 0.1


@torch.no_grad()
def test_fold_refine_layout(setup):
    """conv1's weight is zero-padded from 146 to the 160-channel slot; the
    eleven 3×3 convs keep the net's dilations; conv8 has no bias."""
    fr = fold_refine(setup["dm"].refinenet3)
    w1 = fr.convs[0].w
    assert w1.shape == (3, 3, REFINE_SLOT, 128) and not w1[:, :, 146:].any()
    dils = [c.dil for c in fr.convs] + [c.dil for b in fr.blocks for c in (b.conv1, b.conv2)]
    assert dils == [1, 1, 2, 4, 8, 8, 16, 16, 1, 1] and fr.conv8.dil == 1
    assert fr.conv8.b is None and fr.conv8.w.shape == (3, 3, 32, 1)
    assert [tuple(b.down_w.shape) for b in fr.blocks] == [(128, 96), (96, 64), (64, 32)]


@torch.no_grad()
def test_pipeline_with_flat_refinement(setup):
    """The whole KITTI12 DDIM-3 slice with the folded refinement against the
    JAX pipeline (its module path on the CPU), the same draws."""
    s = setup
    bf, df = fold_pcw(s["bm"], refine_flat=True), fold_pcw(s["dm"], refine_flat=True)
    final, base = pcw_ddim_inference(bf, df, s["left"], s["right"], device="cpu",
                                     noise_source=s["ns"])
    final = final.numpy()
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    err = np.abs(final - s["jfinal"])
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())
    np.testing.assert_allclose(base.numpy(), s["jbase"], rtol=0, atol=1e-2)
