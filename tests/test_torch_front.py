"""Port parity for the kernels of the ACV prep front and the PCW path, float32
on the CPU: each plain version against the JAX package's Pallas kernel in
interpret mode.

* ``gwc_volume_packed`` (the GWC volume in the conv slot, with the concat
  halves and ``mask_ref``) against the Pallas ``gwc_volume_packed``;
* ``depthwise_hw_p`` (the patch stencils) against the Pallas
  ``depthwise_hw_p``;
* ``fused_uncertainty_at`` against the Pallas ``fused_uncertainty_at``;
* the Mish epilogue of the fold convs against the Pallas convs with
  ``mish=True``; the one-map ``dhw_mul`` against ``packed_dhw_mul_k``.

The JAX side's packed outputs are read back with ``unpack_padded_k``; the
port takes and gives plain channels-last volumes.  Tolerance 1e-4 absolute
and relative (float32 summation order) unless a test says otherwise.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.ops.pallas import conv3d as pc
from diffuvolume_tpu.ops.pallas.fused_head import fused_uncertainty_at as j_unc_at
from diffuvolume_tpu.ops.pallas.gwc_volume import gwc_volume_packed as j_gwc_packed
from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
from diffuvolume_tpu_torch.ops.kernels import fused_head as kf
from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg
from torch_parity import nchw

TOL = dict(rtol=1e-4, atol=1e-4)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


# -- row 16: the GWC volume in the conv slot ----------------------------------

@pytest.mark.parametrize("c,g,cc,mask_ref,port_slot", [
    (80, 40, 0, False, 48),     # the ACV attention chain's 40 groups in a 48 slot
    (80, 40, 12, True, 64),     # PCW: 40 groups + 12 + 12 concat, reference side masked
    (80, 40, 12, False, 64),    # the concat halves without the reference mask
])
def test_gwc_volume_packed_matches_pallas(c, g, cc, mask_ref, port_slot):
    """D = 12 > W/2 so the ``w < d`` masks cover much of the volume; the
    JAX kernel's 64-channel slot is read back and cut to the port's."""
    b, d, h, w, th = 1, 12, 8, 20, 8
    fl, fr, kl, kr = _arrays(c + cc + mask_ref, (b, h, w, c), (b, h, w, c), (b, h, w, max(cc, 1)),
                             (b, h, w, max(cc, 1)))
    cat = dict(cat_l=jnp.asarray(kl), cat_r=jnp.asarray(kr)) if cc else {}
    pk = j_gwc_packed(jnp.asarray(fl), jnp.asarray(fr), d, g, tile_h=th, interpret=True,
                      c_slot=64, mask_ref=mask_ref, **cat)
    want = np.asarray(pc.unpack_padded_k(pk, d, h, w, 64, tile_h=th, interpret=True))
    got = kg.gwc_volume_packed(nchw(fl), nchw(fr), d, g, port_slot,
                               cat_l=nchw(kl) if cc else None, cat_r=nchw(kr) if cc else None,
                               mask_ref=mask_ref)
    assert got.shape == (b, d, h, w, port_slot)
    np.testing.assert_allclose(got.numpy(), want[..., :port_slot], **TOL)
    assert not got[..., g + 2 * cc:].any()


def test_gwc_volume_packed_default_slot():
    """The slot defaults to the smallest multiple of 16 holding G + 2cc."""
    fl, kl = _arrays(3, (1, 16, 2, 9), (1, 4, 2, 9))
    assert kg.gwc_volume_packed(_t(fl), _t(fl), 5, 8).shape == (1, 5, 2, 9, 16)
    assert kg.gwc_volume_packed(_t(fl), _t(fl), 5, 8, cat_l=_t(kl),
                                cat_r=_t(kl)).shape == (1, 5, 2, 9, 16)
    with pytest.raises(ValueError, match="both concat halves"):
        kg.gwc_volume_packed(_t(fl), _t(fl), 5, 8, cat_l=_t(kl))


# -- row 10: the patch stencils -------------------------------------------------

def test_depthwise_hw_p_matches_pallas():
    """The attention chain's two stencils: ``patch`` (all 40 channels,
    dilation 1), then ``patch_l1/l2/l3`` (dilations 1, 2, 3); the port's
    48-channel slot against the JAX kernel's 64-lane slots.  H and W edges
    reached by every dilation; D planes never mix."""
    b, d, h, w = 1, 8, 16, 20
    x, kp, k1, k2, k3 = _arrays(5, (b, d, h, w, 40), (3, 3, 40), (3, 3, 8), (3, 3, 16),
                                (3, 3, 16))
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=8, interpret=True, c_slot=64)
    wp = np.zeros((1, 3, 3, 128), np.float32)
    wl = np.zeros((3, 3, 3, 128), np.float32)
    for phi in range(2):
        wp[0, :, :, phi * 64:phi * 64 + 40] = kp
        for gi, (k, lo, hi) in enumerate(((k1, 0, 8), (k2, 8, 24), (k3, 24, 40))):
            wl[gi, :, :, phi * 64 + lo:phi * 64 + hi] = k
    pk = pc.depthwise_hw_p(pk, jnp.asarray(wp), (1,), w_real=w, h_real=h, tile_h=8,
                           interpret=True)
    pk = pc.depthwise_hw_p(pk, jnp.asarray(wl), (1, 2, 3), w_real=w, h_real=h, tile_h=8,
                           interpret=True)
    want = np.asarray(pc.unpack_padded_k(pk, d, h, w, 40, tile_h=8, interpret=True))

    x48 = _t(np.pad(x, ((0, 0),) * 4 + ((0, 8),)))
    w1 = _t(np.pad(kp, ((0, 0), (0, 0), (0, 8))))
    w2 = _t(np.pad(np.concatenate([k1, k2, k3], -1), ((0, 0), (0, 0), (0, 8))))
    dil2 = (1,) * 8 + (2,) * 16 + (3,) * 16 + (1,) * 8
    got = kd.depthwise_hw_p(kd.depthwise_hw_p(x48, w1, (1,) * 48), w2, dil2)
    np.testing.assert_allclose(got[..., :40].numpy(), want, **TOL)
    assert not got[..., 40:].any()


def test_depthwise_hw_p_refuses_bad_operands():
    x = torch.zeros((1, 2, 4, 5, 8))
    with pytest.raises(ValueError, match="must agree"):
        kd.depthwise_hw_p(x, torch.zeros((3, 3, 4)), (1,) * 8)
    with pytest.raises(ValueError, match="positive"):
        kd.depthwise_hw_p(x, torch.zeros((3, 3, 8)), (0,) * 8)


# -- row 17: the uncertainty at a query ------------------------------------------

@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("sizes", [((12, 4, 8), (48, 16, 32)), ((48, 4, 6), (192, 16, 24))])
def test_fused_uncertainty_at_matches_pallas(align_corners, sizes):
    (d4, h4, w4), (dfull, h, w) = sizes
    (cost,) = _arrays(d4 + h, (1, d4, h4, w4))
    cost *= 3.0
    q = np.random.default_rng(d4).uniform(0, dfull - 1, (1, h, w)).astype(np.float32)
    want = np.asarray(j_unc_at(jnp.asarray(cost), jnp.asarray(q), dfull, (h, w),
                               align_corners=align_corners, interpret=True))
    got = kf.fused_uncertainty_at(_t(cost), _t(q), dfull, (h, w), align_corners)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- rows 5-8: the Mish epilogue ----------------------------------------------------

@pytest.mark.parametrize("c,co,d,h,w,residual", [(32, 32, 8, 8, 10, True),
                                                  (64, 64, 4, 8, 9, False)])
def test_conv3d_fold_p_mish_matches_pallas(c, co, d, h, w, residual):
    """Inputs at std 3 so the epilogue sees both of Mish's tails."""
    x, k, b, r = _arrays(17, (1, d, h, w, c), (3, 3, 3, c, co), (co,), (1, d, h, w, co))
    x, k = x * 3.0, k * 0.1
    th = 4
    out = pc.conv3d_fold_p(
        pc.pack_padded(jnp.asarray(x), th), jnp.asarray(k), jnp.asarray(b), mish=True,
        residual=pc.pack_padded(jnp.asarray(r), th) if residual else None,
        w_real=w, h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, co, th))
    got = kconv.conv3d_fold_p(_t(x), _t(k), _t(b), residual=_t(r) if residual else None,
                              act="mish")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv3d_fold_s2_mish_matches_pallas():
    c, d, h, w, th = 32, 16, 8, 20, 4
    x, k, b = _arrays(19, (1, d, h, w, c), (3, 3, 3, c, 2 * c), (2 * c,))
    k = k * 0.1
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=th, interpret=True)
    out = pc.conv3d_fold_s2(pk, jnp.asarray(k), jnp.asarray(b), mish=True, w_real=w, h_real=h,
                            tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded_k(out, d // 2, h // 2, w // 2, 2 * c, tile_h=th // 2,
                                         interpret=True))
    got = kconv.conv3d_fold_s2(_t(x), _t(k), _t(b), act="mish")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv3d_fold_up_mish_matches_pallas():
    """The transposed conv + redir residual + Mish of PCW's hourglasses (the
    JAX kernel stored flipped, as in ``test_torch_fold.py``)."""
    c, d, h, w, th = 64, 8, 4, 10, 4
    co = c // 2
    x, k, b, r = _arrays(23, (1, d, h, w, c), (3, 3, 3, c, co), (co,),
                         (1, 2 * d, 2 * h, 2 * w, co))
    k = k * 0.1
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=th, interpret=True)
    pr = pc.pack_padded_k(jnp.asarray(r), tile_h=2 * th, interpret=True)
    out = pc.conv3d_fold_up(pk, jnp.asarray(k), jnp.asarray(b), mish=True, residual=pr,
                            w_real=w, h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded_k(out, 2 * d, 2 * h, 2 * w, co, tile_h=2 * th,
                                         interpret=True))
    got = kup.conv3d_fold_up(_t(x), _t(k[::-1, ::-1, ::-1]), _t(b), residual=_t(r), act="mish")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mish_epilogue_tails():
    """The one-exp form: x itself above 20, Mish's value elsewhere (against
    x·tanh(softplus(x)) in float64)."""
    y = torch.tensor([-30.0, -8.0, -1.0, 0.0, 0.5, 3.0, 19.9, 20.0, 20.5, 60.0])
    got = kconv.apply_act(y, "mish")
    want = (y.double() * torch.tanh(torch.nn.functional.softplus(y.double()))).float()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="act must be"):
        kconv.conv3d_fold_p(torch.zeros((1, 2, 2, 2, 16)), torch.zeros((3, 3, 3, 16, 16)),
                            act="gelu")


# -- row 4: one map --------------------------------------------------------------------

def test_dhw_mul_one_map_matches_pallas():
    """PCW's step: the noise alone into the 32-channel combine volume
    (``packed_dhw_mul_k(c_slot=32)`` with no second map): exact."""
    b, d, h, w, c = 1, 16, 16, 22, 32
    (x,) = _arrays(29, (b, d, h, w, c))
    noise = np.random.default_rng(30).uniform(size=(b, d, h, w)).astype(np.float32)
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=8, interpret=True)
    out = pc.packed_dhw_mul_k(pk, jnp.asarray(noise), None, c_slot=32, max_disp=d, tile_h=8,
                              interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, c, 8))
    got = kc.dhw_mul(_t(x), _t(noise), None, channels_last=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
