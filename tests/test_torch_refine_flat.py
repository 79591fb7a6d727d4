"""Port parity for PCWNet's folded refinement net (``fold_pcw``'s default
for a bfloat16 model, ``refine_flat=True`` for float32: every 3×3 conv on
``conv2d_flat``, TPU row 18, with Mish and the residual in its epilogue), on
the CPU.

* ``conv2d_flat_plain`` against the Pallas ``conv2d_flat`` in interpret mode
  at the JAX test's six (C_in, C_out, dilation) cases
  (``tests/test_pallas_conv3d.py:212-229``): 1e-4 absolute + 1e-4 relative,
  as that test holds the kernel against XLA; and with a residual and an
  activation, against the Pallas conv's result + residual → act composed by
  hand, in float32 and bfloat16 (one rounding: 1e-2).
* The folded refinement against the JAX ``_refine_flat`` (interpret mode)
  and against the port's ``PCWNet.refine`` at 64×64: 2e-3, the bound
  ``tests/test_torch_pcw_pipeline.py`` holds the folded PCW path to (BatchNorm
  folded in float32 reorders the sums).
* ``pcw_ddim_inference`` with ``fold_pcw(..., refine_flat=True)`` against the
  JAX ``pcw_ddim_inference`` with the JAX draws injected: 0.1 px max and 5e-3
  px mean on the output, 1e-2 px on the baseline.
* ``fold_pcw``'s default by dtype, and the bfloat16 pipeline with the
  folded refinement against the same with the module refinement.
"""

import copy

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
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import apply_act
from torch_parity import jax_normal_draws, nchw, pcw_pair, stereo_pair, to_jax_variables

H, W, MD = 64, 64, 192


F32, BF16 = torch.float32, torch.bfloat16


def _case(c, co, d, act=None, dtype=F32):
    tail = "" if act is None else f"-{act}-{str(dtype)[6:]}"
    return pytest.param(c, co, d, act, dtype, id=f"{c}-{co}-{d}{tail}")


@pytest.mark.parametrize("c,co,d,act,dtype", [
    _case(128, 128, 1), _case(128, 96, 2), _case(96, 96, 8), _case(64, 64, 16),
    _case(146, 128, 1), _case(32, 1, 1),
    # + residual → act in the epilogue
    _case(32, 32, 1, "mish"), _case(32, 1, 16, "relu"), _case(32, 32, 16, "mish", BF16),
    _case(32, 1, 1, "mish", BF16), _case(32, 32, 1, "relu", BF16),
])
def test_conv2d_flat_plain_matches_pallas(c, co, d, act, dtype):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 16, 20, c)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((3, 3, c, co)).astype(np.float32) * 0.1).to(dtype)
    b = torch.from_numpy(rng.standard_normal((co,)).astype(np.float32))
    want = torch.from_numpy(np.array(j_conv2d_flat(
        jnp.asarray(x.float().numpy()), jnp.asarray(k.float().numpy()), jnp.asarray(b.numpy()),
        dilation=d, tile_h=8, interpret=True)))
    res = None
    if act is not None:
        res = torch.from_numpy(rng.standard_normal((2, 16, 20, co)).astype(np.float32)).to(dtype)
        want = apply_act(want + res.float(), act)
    got = conv2d_flat(x, k, b, d, residual=res, act=act)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == F32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want.to(dtype).float().numpy(),
                               rtol=tol, atol=tol)
    assert torch.equal(got, conv2d_flat_plain(x, k, b, d, residual=res, act=act))
    assert torch.equal(got, conv2d_flat_on(kconv.TC_MMA, x, k, b, d, residual=res, act=act))


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
    for res in (torch.zeros((1, 4, 4, 16)), torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="residual"):
            conv2d_flat(x, torch.zeros((3, 3, 8, 8)), residual=res)
    with pytest.raises(ValueError, match="act"):
        conv2d_flat(x, torch.zeros((3, 3, 8, 8)), act="gelu")


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread: under the suite's parallel workers
    its default pool contends with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert [tuple(b.down_w.shape) for b in fr.blocks] == [(1, 1, 1, 128, 96), (1, 1, 1, 96, 64),
                                                         (1, 1, 1, 64, 32)]


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


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("refine_flat", [None, True, False])
def test_fold_pcw_folds_the_refinement_of_a_bfloat16_model(setup, dtype, refine_flat):
    """``fold_pcw``'s default follows the model's dtype: a bfloat16 model's
    refinement is folded, a float32 model's stays the module's (cuDNN);
    ``refine_flat`` forces either."""
    m = setup["dm"] if dtype == F32 else copy.deepcopy(setup["dm"]).to(dtype)
    folded = fold_pcw(m, refine_flat=refine_flat)
    want = dtype == BF16 if refine_flat is None else refine_flat
    assert (folded.refine is not None) == want
    if want:
        assert folded.refine.convs[0].w.dtype == dtype


@torch.no_grad()
def test_bfloat16_pipeline_takes_the_folded_refinement(setup):
    """A bfloat16 model folded by ``fold_pcw`` runs its refinement on
    ``conv2d_flat`` and agrees with the same pipeline on the module
    refinement, the same draws, to bfloat16's rounding: the two round each
    layer differently."""
    s = setup
    bm, dm = (copy.deepcopy(s[k]).to(BF16) for k in ("bm", "dm"))
    outs = {}
    for flat in (None, False):
        fb, fd = fold_pcw(bm, refine_flat=flat), fold_pcw(dm, refine_flat=flat)
        assert (fd.refine is not None) == (flat is None)
        final, base = pcw_ddim_inference(fb, fd, s["left"], s["right"], device="cpu",
                                         noise_source=s["ns"])
        outs[flat] = final.numpy(), base.numpy()
    (final, base), (m_final, m_base) = outs[None], outs[False]
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    # 0.49 / 0.035 px on the output and 0.094 / 0.014 on the baseline (max /
    # mean); dropping the epilogue's Mish or residual moves the means 1.8-5 px.
    err, base_err = np.abs(final - m_final), np.abs(base - m_base)
    assert 0 < err.max() < 2.0 and err.mean() < 0.1, (err.max(), err.mean())
    assert base_err.max() < 0.5 and base_err.mean() < 0.05, (base_err.max(), base_err.mean())
