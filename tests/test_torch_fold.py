"""Port parity for the folded path's pieces, float32 on the CPU.

* Each kernel's plain version against the JAX package's Pallas kernel in
  interpret mode, at the small shapes of ``tests/test_pallas_conv3d.py``:
  the JAX side builds its packed-padded inputs with ``pack_padded`` /
  ``pack_padded_k`` and reads its output back with ``unpack_padded``; the
  port takes and gives plain channels-last volumes.  Weights are the JAX
  layout ``(k, k, k, C_in, C_out)`` on both sides, except the transposed
  conv, whose JAX kernel is stored flipped (``tools/weights.py``).
  Tolerance 1e-4 absolute and relative (float32 summation order).
* BatchNorm folding against the port's own eval modules (``ConvBN``,
  ``ConvTransposeBN``, ``HourglassACV``) with drawn BatchNorm statistics.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.ops.cost_volume import build_concat_volume
from diffuvolume_tpu.ops.pallas import conv3d as pc
from diffuvolume_tpu_torch.models import acv_fold
from diffuvolume_tpu_torch.models.layers import ConvTransposeBN, HourglassACV, convbn_3d
from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
from diffuvolume_tpu_torch.ops.kernels import layout as kl
from diffuvolume_tpu_torch.tools.random_weights import random_acv

TOL = dict(rtol=1e-4, atol=1e-4)


def _arrays(seed, *shapes, scale=None):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if scale is not None:
        out = [a * s for a, s in zip(out, scale)]
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the conv kernels' plain versions against the Pallas kernels -------------

@pytest.mark.parametrize("c,co,d,h,w,residual,relu", [
    (32, 32, 8, 11, 17, True, True),
    (64, 64, 4, 9, 10, False, True),
    (128, 128, 3, 8, 9, True, False),
    (32, 1, 8, 6, 9, False, False),     # the classifier head: C_out 1, no bias
])
def test_conv3d_fold_p_matches_pallas(c, co, d, h, w, residual, relu):
    x, k, b, r = _arrays(7, (1, d, h, w, c), (3, 3, 3, c, co), (co,), (1, d, h, w, co),
                         scale=(1, 0.1, 1, 1))
    bias = None if co == 1 else b
    th = 4
    out = pc.conv3d_fold_p(
        pc.pack_padded(jnp.asarray(x), th), jnp.asarray(k),
        None if bias is None else jnp.asarray(bias), relu=relu,
        residual=pc.pack_padded(jnp.asarray(r), th) if residual else None,
        w_real=w, h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, co, th))
    got = kconv.conv3d_fold_p(_t(x), _t(k), None if bias is None else _t(bias),
                              residual=_t(r) if residual else None,
                              act="relu" if relu else None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv3d_fold_x2_matches_pallas():
    """The wide entry, 64 → 32."""
    d, h, w, th = 8, 8, 10, 4
    x, k, b = _arrays(8, (1, d, h, w, 64), (3, 3, 3, 64, 32), (32,), scale=(1, 0.1, 1))
    out = pc.conv3d_fold_x2(pc.pack_padded(jnp.asarray(x), th), jnp.asarray(k),
                            jnp.asarray(b), relu=True, w_real=w, h_real=h, tile_h=th,
                            interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, 32, th))
    got = kconv.conv3d_fold_x2(_t(x), _t(k), _t(b), act="relu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_patch_entry_slot_matches_pallas():
    """The attention chain's entry: 40 channels into a slot with zero fill
    and zero-padded weights (JAX: 64-lane slots, ``acv.py:624-631``; the
    port: a 48-channel slot), then the 64/48 → 32 conv."""
    d, h, w, th = 8, 8, 10, 8
    x40, k40, b = _arrays(9, (1, d, h, w, 40), (3, 3, 3, 40, 32), (32,), scale=(1, 0.1, 1))
    pk = pc.pack_padded_k(jnp.asarray(x40), th, interpret=True, c_slot=64)
    k64 = jnp.pad(jnp.asarray(k40), ((0, 0),) * 3 + ((0, 24), (0, 0)))
    out = pc.conv3d_fold_x2(pk, k64, jnp.asarray(b), relu=True, w_real=w, h_real=h,
                            tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, 32, th))
    slot = kl.pack(_t(np.moveaxis(x40, -1, 1)), 48)
    k48 = np.pad(k40, ((0, 0),) * 3 + ((0, 8), (0, 0)))
    got = kconv.conv3d_fold_x2(slot, _t(k48), _t(b), act="relu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,d,h,w,th", [(32, 16, 8, 20, 4), (64, 16, 8, 20, 4)])
def test_conv3d_fold_s2_matches_pallas(c, d, h, w, th):
    x, k, b = _arrays(41, (1, d, h, w, c), (3, 3, 3, c, 2 * c), (2 * c,), scale=(1, 0.1, 1))
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=th, interpret=True)
    out = pc.conv3d_fold_s2(pk, jnp.asarray(k), jnp.asarray(b), relu=True, w_real=w,
                            h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded_k(out, d // 2, h // 2, w // 2, 2 * c,
                                         tile_h=th // 2, interpret=True))
    got = kconv.conv3d_fold_s2(_t(x), _t(k), _t(b), act="relu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,d,h,w,th", [(64, 16, 8, 10, 4), (128, 4, 4, 6, 2)])
def test_conv3d_fold_up_matches_pallas(c, d, h, w, th):
    """k3 s2 p1 op1 with the residual and ReLU of the hourglass.  The JAX
    kernel is the pre-flipped one; the port's is the transposed conv's own
    tap order: the same array flipped on its three spatial axes."""
    co = c // 2
    x, k, b, r = _arrays(59, (1, d, h, w, c), (3, 3, 3, c, co), (co,),
                         (1, 2 * d, 2 * h, 2 * w, co), scale=(1, 0.1, 1, 1))
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=th, interpret=True)
    pr = pc.pack_padded_k(jnp.asarray(r), tile_h=2 * th, interpret=True)
    out = pc.conv3d_fold_up(pk, jnp.asarray(k), jnp.asarray(b), relu=True, residual=pr,
                            w_real=w, h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded_k(out, 2 * d, 2 * h, 2 * w, co, tile_h=2 * th,
                                         interpret=True))
    got = kup.conv3d_fold_up(_t(x), _t(k[::-1, ::-1, ::-1]), _t(b), residual=_t(r), act="relu")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,d,h,w", [(32, 8, 8, 10), (64, 4, 8, 10)])
def test_conv1x1_fold_p_matches_pallas(c, d, h, w):
    x, k, b = _arrays(61, (1, d, h, w, c), (1, 1, 1, c, c), (c,), scale=(1, 0.3, 1))
    out = pc.conv1x1_fold_p(pc.pack_padded(jnp.asarray(x), 4), jnp.asarray(k),
                            jnp.asarray(b), w_real=w, h_real=h, tile_h=4, interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, c, 4))
    got = kconv.conv1x1_fold_p(_t(x), _t(k), _t(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- layout and channels-last volume steps ------------------------------------

@pytest.mark.parametrize("c_slot", [48, 64])
def test_pack_matches_pallas(c_slot):
    """NCDHW → NDHWC with the slot's extra channels zero: exact against the
    JAX kernel's 64-lane slots (read back with ``unpack_padded``)."""
    (x40,) = _arrays(10, (1, 16, 16, 22, 40))
    pk = pc.pack_padded_k(jnp.asarray(x40), tile_h=8, interpret=True, c_slot=64)
    want = np.asarray(pc.unpack_padded(pk, 16, 16, 22, 64, 8))[..., :c_slot]
    got = kl.pack(_t(np.moveaxis(x40, -1, 1)), c_slot)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_matches_pallas():
    """NDHWC → NCDHW: exact against ``unpack_padded_k`` of the packed volume."""
    (x,) = _arrays(11, (1, 4, 8, 10, 128))
    want = np.asarray(pc.unpack_padded_k(pc.pack_padded(jnp.asarray(x), 4), 4, 8, 10, 128,
                                         tile_h=4, interpret=True))
    got = kl.unpack(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(want, -1, 1))


def _concat_inputs():
    b, d, h, w, c = 1, 16, 16, 22, 32
    cl, cr, att_l, noise = _arrays(12, (b, h, w, c), (b, h, w, c), (b, d, h, w), (b, d, h, w))
    att = np.asarray(jax.nn.softmax(jnp.asarray(att_l), axis=1))
    noise = np.abs(noise)
    return d, cl, cr, att, noise


def test_concat_volume_channels_last_matches_pallas():
    d, cl, cr, att, _ = _concat_inputs()
    for a in (att, None):
        pk = pc.pack_concat_k(jnp.asarray(cl), jnp.asarray(cr),
                              None if a is None else jnp.asarray(a), None, max_disp=d,
                              tile_h=8, interpret=True)
        want = np.asarray(pc.unpack_padded(pk, d, 16, 22, 64, 8))
        got = kc.concat_volume(_t(np.moveaxis(cl, -1, 1)), _t(np.moveaxis(cr, -1, 1)), d,
                               None if a is None else _t(a), channels_last=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_dhw_mul_channels_last_matches_pallas():
    d, cl, cr, att, noise = _concat_inputs()
    pk_cat = pc.pack_concat_k(jnp.asarray(cl), jnp.asarray(cr), None, None, max_disp=d,
                              tile_h=8, interpret=True)
    pk = pc.packed_dhw_mul_k(pk_cat, jnp.asarray(att), jnp.asarray(noise), c_slot=64,
                             max_disp=d, tile_h=8, interpret=True)
    want = np.asarray(pc.unpack_padded(pk, d, 16, 22, 64, 8))
    vol = _t(np.asarray(build_concat_volume(jnp.asarray(cl), jnp.asarray(cr), d)))
    got = kc.dhw_mul(vol, _t(att), _t(noise), channels_last=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# -- BatchNorm folding against the port's own eval modules --------------------

def _draw_bn(module, seed):
    """BatchNorm weight / bias / statistics drawn from ``seed`` (folding an
    identity BatchNorm would test nothing)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                n = m.num_features
                m.weight.copy_(_t(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                m.bias.copy_(_t(rng.standard_normal(n).astype(np.float32) * 0.1))
                m.running_mean.copy_(_t(rng.standard_normal(n).astype(np.float32) * 0.1))
                m.running_var.copy_(_t(rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return module.eval()


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _draw_weights(module, seed, std):
    """Every conv / transposed-conv weight of ``module`` ~ N(0, std²) from a
    seeded numpy generator."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                m.weight.copy_(_t(rng.standard_normal(m.weight.shape).astype(np.float32) * std))
    return module


@torch.no_grad()
@pytest.mark.parametrize("cin,cout,k,stride,eps", [
    (32, 32, 3, 1, 1e-5), (32, 64, 3, 2, 1e-3), (64, 64, 1, 1, 1e-5)])
def test_fold_convbn_matches_module(cin, cout, k, stride, eps):
    """Conv3d → BatchNorm3d (eval, its own eps) against the folded conv."""
    m = _draw_bn(convbn_3d(cin, cout, k, stride, (k - 1) // 2), 1)
    m[1].eps = eps
    _draw_weights(m, 21, 0.1)
    x = _t(_arrays(13, (1, 8, 6, 10, cin))[0])
    want = m(_ncdhw(x))
    fc = acv_fold.fold_convbn(m)
    fn = {(3, 1): kconv.conv3d_fold_p, (3, 2): kconv.conv3d_fold_s2,
          (1, 1): kconv.conv1x1_fold_p}[(k, stride)]
    got = fn(x, *fc)
    np.testing.assert_allclose(_ncdhw(got).numpy(), want.numpy(), **TOL)


@torch.no_grad()
def test_fold_convbn_slot_padding_is_exact():
    """The 40-channel conv with its weights zero-padded to a 48 slot, on the
    zero-filled slot, equals the 40-channel module."""
    m = _draw_weights(_draw_bn(convbn_3d(40, 32, 3, 1, 1), 2), 22, 0.1)
    x = _t(_arrays(14, (1, 40, 4, 6, 8))[0])
    fc = acv_fold.fold_convbn(m, c_slot=48)
    assert fc.w.shape == (3, 3, 3, 48, 32) and not fc.w[:, :, :, 40:].any()
    got = kconv.conv3d_fold_x2(kl.pack(x, 48), *fc)
    np.testing.assert_allclose(_ncdhw(got).numpy(), m(x).numpy(), **TOL)


@torch.no_grad()
def test_fold_deconvbn_matches_module():
    """ConvTranspose3d → BatchNorm3d: the weight is (in, out, k, k, k), so the
    scale lands on dim 1."""
    m = _draw_weights(_draw_bn(ConvTransposeBN(64, 32), 3), 23, 0.1)
    x = _t(_arrays(15, (1, 4, 3, 5, 64))[0])
    fc = acv_fold.fold_deconvbn(m)
    got = kup.conv3d_fold_up(x, *fc)
    np.testing.assert_allclose(_ncdhw(got).numpy(), m(_ncdhw(x)).numpy(), **TOL)


@torch.no_grad()
def test_fold_hourglass_matches_module():
    """The whole hourglass: stride-2 convs, the attention block between the
    layout steps, the transposed convs with their fused redir residuals."""
    hg = _draw_weights(_draw_bn(HourglassACV(32), 4), 24, 0.05)
    x = _t(_arrays(16, (1, 16, 8, 12, 32))[0])
    got = acv_fold.hourglass_folded(acv_fold.fold_hourglass(hg), x)
    np.testing.assert_allclose(_ncdhw(got).numpy(), hg(_ncdhw(x)).numpy(), **TOL)


def test_fold_head_has_no_bias():
    model = random_acv(64, False, torch.Generator().manual_seed(5))
    f = acv_fold.fold_acv(model)
    assert f.classif2_1.b is None and f.classif2_1.w.shape == (3, 3, 3, 32, 1)
    assert f.dres1_att_0.w.shape == (3, 3, 3, 48, 32)
    assert f.dres2.conv5.w.shape == (3, 3, 3, 128, 64)
    assert f.dres0_0.w.dtype == torch.float32 and f.dres0_0.b.dtype == torch.float32


def _tiny_inference(bm, dm, **kw):
    """Two-pass inference at 32×64, max_disp 64, on the CPU."""
    from diffuvolume_tpu_torch.diffusion import DDIMConfig
    from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference

    left, right = _arrays(30, (1, 32, 64, 3), (1, 32, 64, 3), scale=(0.3, 0.3))
    shape = (5, 1, 16, 8, 16)
    ns = {"z": _arrays(31, shape)[0],
          "replace": np.random.default_rng(32).uniform(size=shape).astype(np.float32)}
    return acv_ddim_inference(bm, dm, left, right, DDIMConfig(max_disp=64, num_bins=16),
                              device="cpu", noise_source=ns, **kw)


def test_pipeline_takes_a_fold_once():
    """``fold_acv`` results give the same pair as the models folded inside
    the call; the module path refuses them."""
    bm = random_acv(64, False, torch.Generator().manual_seed(6))
    dm = random_acv(64, True, torch.Generator().manual_seed(8))
    fb, fd = acv_fold.fold_acv(bm), acv_fold.fold_acv(dm)
    final, base = _tiny_inference(bm, dm)
    final_f, base_f = _tiny_inference(fb, fd)
    assert torch.equal(final, final_f) and torch.equal(base, base_f)
    with pytest.raises(TypeError, match="folded path"):
        _tiny_inference(fb, fd, packed=False)


def test_folded_models_are_freed():
    """Nothing keeps a model or its fold alive after the caller lets go."""
    import gc
    import weakref

    bm = random_acv(64, False, torch.Generator().manual_seed(6))
    dm = random_acv(64, True, torch.Generator().manual_seed(8))
    fd = acv_fold.fold_acv(dm)
    _tiny_inference(bm, fd)
    refs = [weakref.ref(o) for o in (bm, dm, fd, fd.dres0_0.w)]
    del bm, dm, fd
    gc.collect()
    assert all(r() is None for r in refs)


def test_folded_path_refuses_unsupported_shape():
    """A shape the two stride-2 levels cannot undo raises; nothing switches
    to the module path."""
    model = random_acv(64, False, torch.Generator().manual_seed(7))
    f = acv_fold.fold_acv(model)
    x = torch.zeros((1, 16, 8, 10, 64))
    with pytest.raises(ValueError, match="multiples of 4"):
        f.aggregate(x, (32, 40))
