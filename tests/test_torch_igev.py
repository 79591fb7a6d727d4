"""Port parity for the IGEV slice's pieces, float32 on the CPU.

* The new kernel forms' plain versions against the JAX package's Pallas
  kernels in interpret mode, at tiny shapes, as ``tests/test_torch_fold.py``
  holds the others: the LeakyReLU + ``post_mul`` epilogue of
  ``conv3d_fold_p``, the k4 transposed conv (``conv3d_fold_up``; the JAX
  kernel pre-flipped, the port's in the transposed conv's own tap order),
  ``unpack_hwdc_k`` and the small-channel ``conv3d_fold``.  1e-4 absolute
  and relative (float32 summation order); the unpack exact.
* The modules against the JAX package's on the same numpy-seeded inputs and
  weights (the port's seeded IGEV-Stereo through the JAX converter), at the
  JAX tests' size (64×96, ``max_disp`` 64): the extractor, the context
  encoder, one update step, ``hat_sample_last2`` / ``linear_sample_1d`` /
  ``context_upsample``, ``DynamicHead(out_bins=48)``, and ``geo_lookup`` in
  band mode against JAX band mode and against volume mode inside the band's
  exact domain.  Tolerances per test, from float32 summation order.
* ``igev_rules``: JAX variables → the port's state dict → the same weights.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.models.igev.geometry import build_geo_pyramid as j_pyramid
from diffuvolume_tpu.models.igev.geometry import geo_lookup as j_lookup
from diffuvolume_tpu.models.igev.model import IGEVStereo as JIGEV
from diffuvolume_tpu.models.layers import DynamicHead as JDynamicHead
from diffuvolume_tpu.ops import sampling as jsampling
from diffuvolume_tpu.ops.pallas import conv3d as pc
from diffuvolume_tpu_torch.models.igev.geometry import build_geo_pyramid, geo_lookup
from diffuvolume_tpu_torch.models.igev.model import IGEVStereo
from diffuvolume_tpu_torch.models.layers import DynamicHead
from diffuvolume_tpu_torch.ops import sampling
from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
from diffuvolume_tpu_torch.ops.kernels import layout as kl
from diffuvolume_tpu_torch.tools.weights import igev_rules, igev_state_dict_from_jax
from torch_parity import igev_from_jax, igev_pair, nchw, nhwc, raw_pair, to_jax_variables

TOL = dict(rtol=1e-4, atol=1e-4)
H, W, MD = 64, 96, 64


def _arrays(seed, *shapes, scale=None):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if scale is not None:
        out = [a * s for a, s in zip(out, scale)]
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the new kernel forms' plain versions against the Pallas kernels ---------

@pytest.mark.parametrize("c,d,h,w", [(16, 8, 8, 10), (32, 8, 4, 9)])
def test_conv3d_fold_p_leaky_post_mul_matches_pallas(c, d, h, w):
    """conv → + bias → LeakyReLU 0.01 → × the attention map broadcast over D
    (the JAX kernel's ``post_mul`` pre-tiled by ``tile_packed_mul``)."""
    x, k, b, att = _arrays(71, (1, d, h, w, c), (3, 3, 3, c, c), (c,), (1, h, w, c),
                           scale=(1, 0.1, 1, 1))
    att = 1.0 / (1.0 + np.exp(-att))
    th = 4
    out = pc.conv3d_fold_p(pc.pack_padded(jnp.asarray(x), th), jnp.asarray(k), jnp.asarray(b),
                           leaky=0.01, post_mul=pc.tile_packed_mul(jnp.asarray(att), 128 // c, th),
                           w_real=w, h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded(out, d, h, w, c, th))
    got = kconv.conv3d_fold_p(_t(x), _t(k), _t(b), act="leaky", post_mul=_t(att))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,d,h,w,th,residual", [(32, 8, 8, 10, 4, False),
                                                   (16, 16, 4, 6, 2, True)])
def test_conv3d_fold_up_k4_matches_pallas(c, d, h, w, th, residual):
    """ConvTranspose3d k4 s2 p1 op0 with bias and LeakyReLU (IGEV's
    conv3_up / conv2_up), once with a residual."""
    co = c // 2
    x, k, b, r = _arrays(73, (1, d, h, w, c), (4, 4, 4, c, co), (co,),
                         (1, 2 * d, 2 * h, 2 * w, co), scale=(1, 0.1, 1, 1))
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=th, interpret=True)
    pr = pc.pack_padded_k(jnp.asarray(r), tile_h=2 * th, interpret=True) if residual else None
    out = pc.conv3d_fold_up(pk, jnp.asarray(k), jnp.asarray(b), residual=pr, leaky=0.01,
                            w_real=w, h_real=h, tile_h=th, interpret=True)
    want = np.asarray(pc.unpack_padded_k(out, 2 * d, 2 * h, 2 * w, co, tile_h=2 * th,
                                         interpret=True))
    got = kup.conv3d_fold_up(_t(x), _t(k[::-1, ::-1, ::-1]), _t(b),
                             residual=_t(r) if residual else None, act="leaky")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv3d_up_k4_matches_conv_transpose3d():
    """The k4 plain version is ``F.conv_transpose3d(stride 2, padding 1,
    output padding 0)`` on the transposed conv's own weight."""
    x, k = _arrays(74, (1, 3, 4, 5, 8), (4, 4, 4, 8, 4))
    want = torch.nn.functional.conv_transpose3d(_t(x).permute(0, 4, 1, 2, 3),
                                                _t(k).permute(3, 4, 0, 1, 2), stride=2, padding=1)
    got = kup.conv3d_fold_up(_t(x), _t(k))
    assert got.shape == (1, 6, 8, 10, 4)
    np.testing.assert_allclose(got.permute(0, 4, 1, 2, 3).numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("co", [8, 1, 16])
def test_unpack_hwdc_matches_pallas(co):
    """Slot → ``(B, H, W, D·co)``: the GEV (8 of 16 channels), the cost (1)
    and the identity case (all 16): exact."""
    d, h, w, th = 16, 8, 16, 8
    (x,) = _arrays(75, (1, d, h, w, 16))
    want = np.asarray(pc.unpack_hwdc_k(pc.pack_padded(jnp.asarray(x), th), d, h, w, co,
                                       tile_h=th, interpret=True))
    got = kl.unpack_hwdc(_t(x), co)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), kl.unpack_hwdc_plain(_t(x), co).numpy())


@pytest.mark.parametrize("c,co,d,bias,relu", [(8, 8, 16, True, True), (16, 16, 8, True, False),
                                              (8, 1, 16, False, False)])
def test_conv3d_fold_small_matches_pallas(c, co, d, bias, relu):
    """Row 14: the 3×3×3 stride-1 conv at C_in 8 / 16 on plain NDHWC (the
    module path's corr_stem, 16-channel hourglass convs, the 8 → 1
    classifier)."""
    x, k, b = _arrays(77, (1, d, 6, 10, c), (3, 3, 3, c, co), (co,), scale=(1, 0.1, 1))
    want = np.asarray(pc.conv3d_fold(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(b) if bias else None, relu=relu, tile_h=4,
                                     interpret=True))
    got = kconv.conv3d_fold_small(_t(x), _t(k), _t(b) if bias else None,
                                  act="relu" if relu else None)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the modules against the JAX package's ------------------------------------

@pytest.fixture(scope="module")
def model():
    left, right = raw_pair(3, 1, H, W)
    _, dm = igev_pair(MD, left, right, seed=1)
    return dict(dm=dm, v=to_jax_variables(dm), jm=JIGEV(max_disp=MD, diffusion=True),
                left=left, right=right)


@torch.no_grad()
def test_extractor_matches_jax(model):
    """The MobileNetV2 trunk with its FPN, the stems and the match
    descriptors, and the context encoder's heads: 1e-4 of each output's
    largest value."""
    m = model
    left_n = 2.0 * (m["left"] / 255.0) - 1.0

    def trunk(mod, x):
        feat = mod.feature(x, False)
        stem_2 = mod._stem(mod.stem_2_ops, x, False)
        stem_4 = mod._stem(mod.stem_4_ops, stem_2, False)
        return feat, stem_2, mod.desc(mod.conv(jnp.concatenate([feat[0], stem_4], -1)))

    feat, stem_2, match = jax.jit(lambda v, x: m["jm"].apply(v, x, method=trunk))(
        m["v"], left_n)
    cnet = jax.jit(lambda v, x: m["jm"].apply(v, x, method=lambda mod, y: mod.cnet(y, False)))(
        m["v"], left_n)
    x = torch.from_numpy(left_n).permute(0, 3, 1, 2).contiguous()
    got_feat = m["dm"].feature(x)
    got = list(zip(got_feat[1:], feat[1:])) + [(m["dm"].stem_2(x), stem_2)]
    feat_l, match_l, _, _, _ = m["dm"].trunk(torch.from_numpy(m["left"]),
                                             torch.from_numpy(m["right"]))
    got += [(match_l, match[:1]), (feat_l[0][:, :48], feat[0])]
    got += [(a, b) for pa, pb in zip(m["dm"].cnet(x), cnet) for a, b in zip(pa, pb)]
    assert len(got) == 12
    for a, b in got:
        b = np.asarray(b)
        assert np.abs(nhwc(a) - b).max() <= 1e-4 * np.abs(b).max()


@torch.no_grad()
def test_update_step_matches_jax(model):
    """One GRU update (all three levels, the motion encoder, the heads) on
    the same hidden states, context biases, lookup features and disparity:
    the states, the mask features and Δdisparity within 1e-4 (2e-4 for Δ)."""
    m = model
    rng = np.random.default_rng(9)
    dims = [(H // 4, W // 4), (H // 8, W // 8), (H // 16, W // 16)]
    net = [np.tanh(rng.standard_normal((1, h, w, 128))).astype(np.float32) for h, w in dims]
    inp = [tuple(rng.standard_normal((1, h, w, 128)).astype(np.float32) for _ in range(3))
           for h, w in dims]
    geo = rng.standard_normal((1, H // 4, W // 4, 162)).astype(np.float32)
    disp = rng.uniform(0, 15, (1, H // 4, W // 4)).astype(np.float32)
    jnet, jmask, jdelta = jax.jit(lambda v, n, i, g, d: m["jm"].apply(
        v, n, i, g, d[..., None], method=JIGEV.update))(m["v"], net, inp, geo, disp)
    pnet, pmask, pdelta = m["dm"].update([nchw(n) for n in net],
                                         [tuple(nchw(c) for c in i) for i in inp],
                                         torch.from_numpy(geo), torch.from_numpy(disp))
    for a, b in zip(pnet, jnet):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), **TOL)
    np.testing.assert_allclose(nhwc(pmask), np.asarray(jmask), **TOL)
    np.testing.assert_allclose(pdelta.numpy(), np.asarray(jdelta)[..., 0], rtol=2e-4, atol=2e-4)


def test_samplers_match_jax():
    """``hat_sample_last2`` (positions past both ends), ``linear_sample_1d``
    and ``context_upsample``: 1e-5."""
    vol, x0, vals, up_l = _arrays(81, (2, 3, 4, 12, 5), (2, 3, 4, 7), (2, 6, 9, 3), (2, 9, 12, 16))
    x0 = x0 * 6.0 + 5.0
    coords = np.random.default_rng(82).uniform(-2, 10, (2, 6, 4)).astype(np.float32)
    low = np.random.default_rng(83).uniform(0, 40, (2, 3, 4)).astype(np.float32)
    up_w = np.asarray(jax.nn.softmax(jnp.asarray(up_l), axis=1))
    pairs = [
        (sampling.hat_sample_last2(_t(vol), _t(x0)), jsampling.hat_sample_last2(vol, x0)),
        (sampling.linear_sample_1d(_t(vals), _t(coords)), jsampling.linear_sample_1d(vals, coords)),
        (sampling.linear_sample_1d(_t(vals), _t(coords), zero_pad=False),
         jsampling.linear_sample_1d(vals, coords, zero_pad=False)),
        (sampling.context_upsample(_t(low), _t(up_w)), jsampling.context_upsample(low, up_w)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_dynamic_head_out_bins_matches_jax():
    """KITTI15's time embedding: d_model 180, the shift resized linearly to
    48 bins (half-pixel centres), added to the noisy volume: 1e-5."""
    head = DynamicHead(180, out_bins=48)
    g = torch.Generator().manual_seed(5)
    for p in head.parameters():
        p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    params = {name: {"kernel": lin.weight.numpy().T, "bias": lin.bias.numpy()}
              for name, lin in (("time1", head.time_mlp[1]), ("time2", head.time_mlp[3]),
                                ("block", head.block_time_mlp[1]))}
    (noisy,) = _arrays(84, (2, 48, 3, 5))
    t = np.asarray([17, 900], np.int32)
    want = JDynamicHead(d_model=180, out_bins=48).apply({"params": params}, noisy, t)
    got = head(_t(noisy), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _lookup_inputs(w=64, lo=0.0, hi=42.0):
    ml, mr, gev = _arrays(85, (1, 4, w, 12), (1, 4, w, 12), (1, 16, 4, w, 8))
    rng = np.random.default_rng(86)
    disp = rng.uniform(lo, hi, (1, 4, w)).astype(np.float32)
    coords = np.broadcast_to(np.arange(w, dtype=np.float32), (1, 4, w)).copy()
    return ml, mr, gev, disp, coords


@pytest.mark.parametrize("mode", ["band", "volume"])
def test_geo_lookup_matches_jax(mode):
    """The 162-channel lookup in the trained order against the JAX
    package's concatenated form, per correlation mode, disparities over the
    whole bin range and past it: 1e-5."""
    ml, mr, gev, disp, coords = _lookup_inputs(lo=-3.0, hi=20.0)
    want = j_lookup(j_pyramid(ml, mr, gev, 2, corr_mode=mode), disp, coords, radius=4)
    pyr = build_geo_pyramid(nchw(ml), nchw(mr), _t(np.moveaxis(gev, 1, 3)), 2, mode)
    got = geo_lookup(pyr, _t(disp), _t(coords), 4)
    assert got.shape == (1, 4, 64, 162)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_geo_lookup_band_matches_volume_in_its_domain():
    """Band mode equals the dense correlation where the band reaches: at
    W/4 = 64 the level-1 band (33 columns) covers quarter-res disparities
    in [0, 42]: 1e-4."""
    ml, mr, gev, disp, coords = _lookup_inputs()
    geo = _t(np.moveaxis(gev, 1, 3))
    out = [geo_lookup(build_geo_pyramid(nchw(ml), nchw(mr), geo, 2, mode), _t(disp),
                      _t(coords), 4) for mode in ("band", "volume")]
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), **TOL)


# -- the weight bridge ---------------------------------------------------------

@torch.no_grad()
@pytest.mark.parametrize("diffusion", [True, False])
def test_igev_rules_round_trip(model, diffusion):
    """Port weights → the JAX converter → ``igev_state_dict_from_jax`` → a
    fresh port model (strict load): every tensor back exactly, the key set
    the model's own (``norm3`` and its ``downsample.1`` alias included)."""
    dm = model["dm"] if diffusion else IGEVStereo(MD, False).init_weights(
        torch.Generator().manual_seed(2)).eval()
    v = model["v"] if diffusion else to_jax_variables(dm)
    back = igev_from_jax(v, MD, diffusion)
    sd = dm.state_dict()
    assert {r[0] for r in igev_rules(diffusion)} | {
        k for k in sd if k.endswith("num_batches_tracked")} == set(sd)
    for k, a in back.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, sd[k]), k
    assert set(igev_state_dict_from_jax(v, diffusion)) == set(sd)
