"""Each CUDA kernel against its plain version on the card, at small shapes.

Marked ``gpu``; without a CUDA device every test skips (the card is looked
for inside the fixture, never at import).  On the card:
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import pytest
import torch

from diffuvolume_tpu_torch.ops import cost_volume as plain
from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
from diffuvolume_tpu_torch.ops.kernels import conv3d_up as kup
from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
from diffuvolume_tpu_torch.ops.kernels import fused_head as kf
from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg
from diffuvolume_tpu_torch.ops.kernels import layout as kl

pytestmark = pytest.mark.gpu

BF16_REL = 2.0 ** -8  # one bfloat16 rounding of a float32 result


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _randn(dev, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [((12, 4, 8), (48, 16, 32)), ((8, 4, 6), (8, 4, 6)),
                                   ((48, 8, 20), (192, 32, 80))])
def test_fused_head(dev, dtype, align_corners, sizes):
    """1e-4 absolute/relative against the float32 plain version on the same
    (rounded) inputs, as the JAX package holds its Pallas head."""
    (d4, h4, w4), (d, h, w) = sizes
    cost = (_randn(dev, 2, d4, h4, w4) * 3).to(dtype)
    disp, unc = kf.fused_upsample_softargmin(cost, d, (h, w), align_corners)
    pd, pu = kf.fused_upsample_softargmin_plain(cost, d, (h, w), align_corners)
    torch.cuda.synchronize()
    torch.testing.assert_close(disp, pd, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(unc, pu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 320, 5, 24, 40, 12), (2, 16, 3, 10, 4, 14)])
def test_gwc_volume(dev, dtype, shape):
    """float32: 1e-5 relative (summation order); bfloat16: one rounding of
    the float32 result.  The second shape has D > W (all-zero planes)."""
    b, c, h, w, g, d = shape
    left, right = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (1, 2))
    got = kg.gwc_volume(left, right, d, g)
    want = plain.build_gwc_volume(left.float(), right.float(), d, g)
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == torch.float32 else BF16_REL
    torch.testing.assert_close(got.float(), want, rtol=rel, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_att", [False, True])
def test_concat_volume(dev, dtype, with_att):
    """Copies and one float32 product per element, rounded once: exact."""
    b, c, d, h, w = 1, 8, 12, 5, 9
    cl, cr = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (3, 4))
    att = torch.softmax(_randn(dev, b, d, h, w, seed=5), 1).to(dtype) if with_att else None
    got = kc.concat_volume(cl, cr, d, att)
    want = plain.concat_volume_mul(cl, cr, d, att)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dhw_mul(dev, dtype):
    """One float32 product per element in the plain version's order: exact."""
    b, c, d, h, w = 2, 16, 6, 5, 7
    vol = _randn(dev, b, c, d, h, w, seed=6).to(dtype)
    m1, m2 = (torch.rand((b, d, h, w), device=dev).to(dtype) for _ in range(2))
    got = kc.dhw_mul(vol, m1, m2)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.volume_dhw_mul(vol, m1, m2))


def test_launch_counts(dev):
    """Each wrapper counts its launches, and only its own."""
    counters = (kf.fused_upsample_softargmin, kg.gwc_volume, kc.concat_volume, kc.dhw_mul)
    before = [f.launches for f in counters]
    x = _randn(dev, 1, 4, 2, 3)
    kf.fused_upsample_softargmin(x, 8, (4, 6))
    assert [f.launches for f in counters] == [before[0] + 1, *before[1:]]


def test_wrappers_refuse_bad_input(dev):
    """Wrong dtype, device mix and non-contiguous input raise instead of
    launching."""
    x = _randn(dev, 1, 4, 2, 3)
    with pytest.raises(TypeError):
        kf.fused_upsample_softargmin(x.half(), 8, (4, 6))
    with pytest.raises(ValueError):
        kc.dhw_mul(_randn(dev, 1, 2, 4, 2, 3), x, x.cpu())
    with pytest.raises(ValueError):
        kf.fused_upsample_softargmin(x.transpose(2, 3), 8, (4, 6))


# -- the folded path's kernels ------------------------------------------------

# float32: the FMA kernel against cuDNN's float32 conv (TF32 off), summation
# order only.  bfloat16: both sum float32 products of the same bf16 inputs and
# round once, so they differ by at most one bf16 ulp (2⁻⁷ relative) plus the
# float32 summation noise.
CONV_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 2.0 ** -7)}


def _conv_inputs(dev, dtype, shape, cin, cout, k, seed):
    b, d, h, w = shape
    x = _randn(dev, b, d, h, w, cin, seed=seed).to(dtype)
    wt = (_randn(dev, k, k, k, cin, cout, seed=seed + 1) * 0.1).to(dtype)
    bias = _randn(dev, cout, seed=seed + 2)
    return x, wt, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,shape,residual,relu", [
    (32, 32, (1, 8, 6, 70), True, True),     # W beyond one 64-wide tile, odd edge
    (64, 64, (2, 4, 5, 9), False, True),     # odd H: the block's second row masked
    (128, 128, (1, 3, 4, 7), True, False),   # two input-channel chunks
    (32, 1, (1, 8, 6, 20), False, False),    # C_out 1: the classifier head
    (64, 32, (1, 4, 4, 12), False, True),    # the wide entry
])
def test_conv3d_fold_p(dev, dtype, cin, cout, shape, residual, relu):
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, cout, 3, seed=10)
    res = _randn(dev, *shape, cout, seed=13).to(dtype) if residual else None
    act = "relu" if relu else None
    got = kconv.conv3d_fold_p(x, wt, bias, residual=res, act=act)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, act)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_fold_x2_zero_filled_slot(dev, dtype):
    """40 real channels packed into a 48-channel slot with zero weights on
    the fill: equal to the 40-channel conv."""
    x40 = _randn(dev, 1, 40, 8, 4, 12, seed=20).to(dtype)
    w40 = (_randn(dev, 3, 3, 3, 40, 32, seed=21) * 0.1).to(dtype)
    w48 = torch.nn.functional.pad(w40, (0, 0, 0, 8))
    bias = _randn(dev, 32, seed=22)
    got = kconv.conv3d_fold_x2(kl.pack(x40, 48), w48, bias, act="relu")
    want = kconv.conv3d_fold_plain(kl.pack_plain(x40), w40, bias, 1, None, "relu")
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,shape", [(32, (1, 8, 8, 130)), (64, (1, 4, 5, 11))])
def test_conv3d_fold_s2(dev, dtype, cin, shape):
    """Stride 2, C_out = 2·C_in; odd H/W give ⌈n/2⌉ outputs."""
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, 2 * cin, 3, seed=30)
    got = kconv.conv3d_fold_s2(x, wt, bias, act="relu")
    want = kconv.conv3d_fold_plain(x, wt, bias, 2, None, "relu")
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 64])
def test_conv1x1_fold_p(dev, dtype, c):
    x, wt, bias = _conv_inputs(dev, dtype, (1, 4, 3, 70), c, c, 1, seed=40)
    got = kconv.conv1x1_fold_p(x, wt, bias)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, None, None)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,shape", [(128, 64, (1, 3, 4, 35)), (64, 32, (2, 2, 3, 5))])
def test_conv3d_fold_up(dev, dtype, cin, cout, shape):
    """Transposed conv to double size, + bias + residual, ReLU; odd input
    sizes so every parity meets an edge."""
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, cout, 3, seed=50)
    b, d, h, w = shape
    res = _randn(dev, b, 2 * d, 2 * h, 2 * w, cout, seed=53).to(dtype)
    got = kup.conv3d_fold_up(x, wt, bias, residual=res, act="relu")
    want = kup.conv3d_up_plain(x, wt, bias, res, "relu")
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,c_slot,shape", [(40, 48, (1, 5, 3, 7)), (128, 128, (2, 3, 4, 9))])
def test_pack_unpack(dev, dtype, c, c_slot, shape):
    """Copies only: exact, and unpack inverts pack on the real channels."""
    x = _randn(dev, shape[0], c, *shape[1:], seed=60).to(dtype)
    pk = kl.pack(x, c_slot)
    torch.cuda.synchronize()
    assert torch.equal(pk, kl.pack_plain(x, c_slot))
    back = kl.unpack(pk)
    torch.cuda.synchronize()
    assert torch.equal(back, kl.unpack_plain(pk))
    assert torch.equal(back[:, :c], x) and not back[:, c:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_att", [False, True])
@pytest.mark.parametrize("c", [8, 32])
def test_concat_volume_channels_last(dev, dtype, with_att, c):
    """W not a multiple of the 32-wide tile, D > W at the low end; one
    16-byte vector a side (C = 8 bf16) and the main path's C = 32: exact."""
    b, d, h, w = 2, 12, 3, 37
    cl, cr = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (3, 4))
    att = torch.softmax(_randn(dev, b, d, h, w, seed=5), 1).to(dtype) if with_att else None
    got = kc.concat_volume(cl, cr, d, att, channels_last=True)
    want = plain.concat_volume_mul(cl, cr, d, att, channels_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 8])
def test_dhw_mul_channels_last(dev, dtype, c):
    """The main path's C = 64 and one 16-byte bf16 vector (C = 8): exact."""
    b, d, h, w = 2, 6, 5, 7
    vol = _randn(dev, b, d, h, w, c, seed=6).to(dtype)
    m1, m2 = (torch.rand((b, d, h, w), device=dev).to(dtype) for _ in range(2))
    got = kc.dhw_mul(vol, m1, m2, channels_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.volume_dhw_mul(vol, m1, m2, channels_last=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channels_last_volume_refuses_partial_vectors(dev, dtype):
    """C = 6 fills no whole 16-byte vector: both channels-last forms raise."""
    cl = _randn(dev, 1, 6, 3, 9).to(dtype)
    with pytest.raises(ValueError, match="16-byte"):
        kc.concat_volume(cl, cl, 4, channels_last=True)
    m = torch.rand((1, 4, 3, 9), device=dev).to(dtype)
    with pytest.raises(ValueError, match="16-byte"):
        kc.dhw_mul(_randn(dev, 1, 4, 3, 9, 6).to(dtype), m, m, channels_last=True)


def test_fold_wrappers_refuse_bad_input(dev):
    """Wrong dtype, non-contiguous input, a CPU/CUDA mix, a bf16 channel
    count the tensor cores cannot step over, a misshapen residual."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 4, 4, 8), 32, 32, 3, seed=70)
    with pytest.raises(TypeError):
        kconv.conv3d_fold_p(x.half(), wt.half(), bias)
    with pytest.raises(TypeError):
        kconv.conv3d_fold_p(x, wt.float(), bias)
    with pytest.raises(ValueError):
        kconv.conv3d_fold_p(x.transpose(2, 3), wt, bias)
    with pytest.raises(ValueError):
        kconv.conv3d_fold_p(x, wt, bias.cpu())
    with pytest.raises(ValueError):
        kconv.conv3d_fold_p(x[..., :24].contiguous(), wt[:, :, :, :24].contiguous(), bias)
    with pytest.raises(ValueError):
        kconv.conv3d_fold_p(x, wt, bias, residual=x[:, :2].contiguous())
    with pytest.raises(ValueError):
        kup.conv3d_fold_up(x, wt, bias, residual=x)
    with pytest.raises(ValueError):
        kl.unpack(x.transpose(1, 2))
    with pytest.raises(ValueError):
        kl.pack(x.permute(0, 4, 1, 2, 3))


def test_fold_launch_counts(dev):
    """Each folded-path wrapper counts its own launches only."""
    counters = (kconv.conv3d_fold_p, kconv.conv3d_fold_x2, kconv.conv3d_fold_s2,
                kconv.conv1x1_fold_p, kup.conv3d_fold_up, kl.pack, kl.unpack)
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 4, 4, 8), 32, 64, 3, seed=80)
    before = [f.launches for f in counters]
    kconv.conv3d_fold_s2(x, wt, bias)
    assert [f.launches for f in counters] == [before[0], before[1], before[2] + 1,
                                              *before[3:]]


# -- the ACV prep front and the PCW path's kernels ---------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,g,cc,h,w,d,slot,mask_ref", [
    (1, 80, 40, 0, 3, 37, 12, 48, False),    # ACV's 40 in 48; W past one 32-wide tile
    (2, 80, 40, 12, 2, 39, 6, 64, True),     # PCW's 1/32 shape class: W = 39, mask_ref
    (1, 80, 40, 12, 2, 39, 6, 64, False),
    (1, 320, 40, 12, 2, 70, 48, 64, True),   # C = 320, D = 48 > W/2
    (1, 24, 8, 4, 3, 9, 12, 32, True),       # cpg 3: no 16-byte product reads; D > W
    (2, 320, 40, 0, 2, 64, 48, 48, False),   # cpg 8 (ACV), B = 2, H·W a multiple of 8
    (1, 320, 40, 12, 3, 78, 12, 64, True),   # PCW 1/16: C = 320, the D split
    (1, 96, 8, 0, 2, 104, 48, 16, False),    # IGEV: cpg 12 in a 16 slot
    (2, 96, 8, 12, 3, 20, 24, 48, True),     # cpg 12 with concat halves; D ≥ W: all masked
    (1, 48, 8, 0, 1, 13, 4, 16, False),      # cpg 6; H·W odd: one element a staged read
    (1, 48, 12, 4, 2, 20, 6, 32, True),      # 12 groups: bf16's last 4 past the paired halves
])
def test_gwc_volume_packed(dev, dtype, b, c, g, cc, h, w, d, slot, mask_ref):
    """The group means: float32 to 1e-5 relative (summation order), bf16 to
    one rounding of the float32 result; the concat channels and the fill
    copied exactly."""
    left, right = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (1, 2))
    cats = {}
    if cc:
        cats = dict(cat_l=_randn(dev, b, cc, h, w, seed=3).to(dtype),
                    cat_r=_randn(dev, b, cc, h, w, seed=4).to(dtype))
    got = kg.gwc_volume_packed(left, right, d, g, slot, mask_ref=mask_ref, **cats)
    want = plain.gwc_volume_slot(left.float(), right.float(), d, g, slot,
                                 mask_ref=mask_ref, **{k: v.float() for k, v in cats.items()})
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == torch.float32 else BF16_REL
    torch.testing.assert_close(got[..., :g].float(), want[..., :g], rtol=rel, atol=1e-6)
    assert torch.equal(got[..., g:].float(), want[..., g:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tw,ds", [(4, 1), (8, 5), (12, 48), (32, 7), (60, 48), (64, 16)])
@pytest.mark.parametrize("mask_ref", [False, True])
def test_gwc_volume_packed_tiles(dev, dtype, tw, ds, mask_ref):
    """Every tile (``gwc_volume_packed_on``) gives the same volume: W tiles
    that do not divide W (the ragged last tile), D split across blocks with
    a ragged last range, and fewer threads than work items (64 positions of
    a 64 slot); both sides of the ``w < d`` diagonal."""
    b, c, g, cc, h, w, d, slot = 1, 320, 40, 12, 2, 78, 48, 64
    left, right = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (5, 6))
    cats = dict(cat_l=_randn(dev, b, cc, h, w, seed=7).to(dtype),
                cat_r=_randn(dev, b, cc, h, w, seed=8).to(dtype))
    want = kg.gwc_volume_packed(left, right, d, g, slot, mask_ref=mask_ref, **cats)
    got = kg.gwc_volume_packed_on((tw, ds), left, right, d, g, slot, mask_ref=mask_ref, **cats)
    ref = plain.gwc_volume_slot(left, right, d, g, slot, mask_ref=mask_ref, **cats)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), ref.float(), rtol=rel, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 48, 128, 240, 48, 0, 48), (1, 48, 96, 312, 64, 12, 48),
                                   (1, 24, 48, 156, 64, 12, 24), (1, 12, 24, 78, 64, 12, 12),
                                   (1, 6, 12, 39, 64, 12, 6), (1, 48, 96, 312, 16, 0, 48)])
def test_gwc_volume_packed_path_shapes(dev, shape):
    """Each path's shape (ACV, PCW 1/4 … 1/32, IGEV) on its plan, bf16,
    against the plain version in bf16 (one ulp)."""
    b, d, h, w, slot, cc, _ = shape
    c, g = (96, 8) if slot == 16 else (320, 40)
    left, right = (_randn(dev, b, c, h, w, seed=s).bfloat16() for s in (9, 10))
    cats = {}
    if cc:
        cats = dict(cat_l=_randn(dev, b, cc, h, w, seed=11).bfloat16(),
                    cat_r=_randn(dev, b, cc, h, w, seed=12).bfloat16())
    got = kg.gwc_volume_packed(left, right, d, g, slot, mask_ref=bool(cc), **cats)
    want = plain.gwc_volume_slot(left, right, d, g, slot, mask_ref=bool(cc), **cats)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-6)


def test_gwc_volume_packed_refuses_bad_operands(dev):
    left = _randn(dev, 1, 80, 2, 9)
    cat = _randn(dev, 1, 12, 2, 9)
    with pytest.raises(ValueError, match="multiple of 16"):
        kg.gwc_volume_packed(left, left, 4, 40, 56)
    with pytest.raises(ValueError, match="multiple of 16"):
        kg.gwc_volume_packed(left, left, 4, 40, 48, cat_l=cat, cat_r=cat)
    with pytest.raises(ValueError, match="concat features"):
        kg.gwc_volume_packed(left, left, 4, 40, cat_l=cat, cat_r=cat[:, :8].contiguous())
    with pytest.raises(ValueError, match="groups"):
        kg.gwc_volume_packed(left, left, 4, 30)


DIL_48 = (1,) * 8 + (2,) * 16 + (3,) * 16 + (1,) * 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dil", [((2, 3, 9, 37, 48), DIL_48), ((1, 4, 5, 7, 48), (1,) * 48),
                                       ((1, 2, 4, 3, 16), (3,) * 8 + (1,) * 8),
                                       ((1, 2, 6, 70, 16), (2,) * 8 + (3,) * 8),
                                       ((2, 1, 2, 5, 32), (3,) * 16 + (1,) * 16),
                                       ((1, 2, 40, 9, 48), DIL_48)])
def test_depthwise_hw_p(dev, dtype, shape, dil):
    """Every dilation reaches past the H and W edges (zero there) and never
    across D; H and W below 2·dil + 1; mixed dilations, one a vector:
    float32 to 1e-4 (summation order), bf16 within one rounding."""
    x = _randn(dev, *shape, seed=7).to(dtype)
    wt = _randn(dev, 3, 3, shape[-1], seed=8)
    got = kd.depthwise_hw_p(x, wt, dil)
    want = kd.depthwise_hw_plain(x, wt, dil)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tw,blocks,wpc", [(1, 1, 1), (5, 3, 1), (16, 7, 2), (37, 40, 2), (48, 2, 1),
                                           (12, 500, 1)])
def test_depthwise_hw_tiles(dev, dtype, tw, blocks, wpc):
    """Every split (``depthwise_hw_p_on`` / ``depthwise_hw_p2_on``: W tiles
    ragged at the end; one block for all columns, a few blocks whose shares
    cross columns, more blocks than rows; one or two warps a channel vector
    for one stencil, one for the fused pair, whose two stages fill the
    block) gives the plan's result bit for bit."""
    x = _randn(dev, 1, 2, 11, 37, 48, seed=20).to(dtype)
    w1, w2 = _randn(dev, 3, 3, 48, seed=21), _randn(dev, 3, 3, 48, seed=22)
    assert torch.equal(kd.depthwise_hw_p_on((tw, wpc, blocks), x, w2, DIL_48),
                       kd.depthwise_hw_p(x, w2, DIL_48))
    assert torch.equal(kd.depthwise_hw_p2_on((tw, 1, blocks), x, w1, (1,) * 48, w2, DIL_48),
                       kd.depthwise_hw_p2(x, w1, (1,) * 48, w2, DIL_48))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dil1,dil2", [
    ((2, 3, 9, 37, 48), (1,) * 48, DIL_48),             # the attention chain
    ((1, 4, 5, 7, 48), (2,) * 48, DIL_48),              # H, W below 2·(dil1 + dil2) + 1
    ((1, 2, 4, 3, 16), (3,) * 8 + (1,) * 8, (1,) * 16),
    ((1, 1, 128, 240, 48), (1,) * 48, DIL_48),          # one plane of the ACV shape
])
def test_depthwise_hw_p2(dev, dtype, shape, dil1, dil2):
    """The fused pair equals two single launches bit for bit, and the plain
    second stencil on the kernel's intermediate within the stencil
    tolerance (in bf16 a plain intermediate may round one ulp apart, which
    the second stencil spreads); in float32 also the plain pair."""
    x = _randn(dev, *shape, seed=9).to(dtype)
    w1, w2 = _randn(dev, 3, 3, shape[-1], seed=10), _randn(dev, 3, 3, shape[-1], seed=11)
    got = kd.depthwise_hw_p2(x, w1, dil1, w2, dil2)
    mid = kd.depthwise_hw_p(x, w1, dil1)
    two = kd.depthwise_hw_p(mid, w2, dil2)
    torch.cuda.synchronize()
    assert torch.equal(got, two)
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), kd.depthwise_hw_plain(mid, w2, dil2).float(),
                               atol=atol, rtol=rtol)
    if dtype == torch.float32:
        torch.testing.assert_close(got, kd.depthwise_hw_plain2(x, w1, dil1, w2, dil2),
                                   atol=atol, rtol=rtol)


def test_depthwise_hw_p_refuses_bad_operands(dev):
    x = _randn(dev, 1, 2, 4, 5, 16).to(torch.bfloat16)
    wt = _randn(dev, 3, 3, 16)
    with pytest.raises(ValueError, match="one dilation each"):
        kd.depthwise_hw_p(x, wt, (1,) * 4 + (2,) * 12)
    with pytest.raises(ValueError, match="one dilation each"):
        kd.depthwise_hw_p2(x, wt, (1,) * 16, wt, (1,) * 4 + (2,) * 12)
    with pytest.raises(TypeError):
        kd.depthwise_hw_p(x, wt.to(torch.bfloat16), (1,) * 16)
    with pytest.raises(ValueError):
        kd.depthwise_hw_p(x.transpose(2, 3), wt, (1,) * 16)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [((12, 4, 8), (48, 16, 32)), ((48, 8, 39), (192, 32, 156))])
def test_fused_uncertainty_at(dev, dtype, align_corners, sizes):
    """1e-4 absolute/relative against the float32 plain version on the same
    (rounded) logits, as the fused head is held."""
    (d4, h4, w4), (d, h, w) = sizes
    cost = (_randn(dev, 2, d4, h4, w4, seed=9) * 3).to(dtype)
    q = torch.rand((2, h, w), device=dev) * (d - 1)
    got = kf.fused_uncertainty_at(cost, q, d, (h, w), align_corners)
    want = kf.fused_uncertainty_at_plain(cost, q, d, (h, w), align_corners)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fused_uncertainty_at_refuses_bad_query(dev):
    cost = _randn(dev, 1, 4, 2, 3)
    with pytest.raises(ValueError, match="query"):
        kf.fused_uncertainty_at(cost, torch.zeros((1, 8, 12), device=dev).half(), 16, (8, 12))
    with pytest.raises(ValueError, match="query"):
        kf.fused_uncertainty_at(cost, torch.zeros((1, 8, 11), device=dev), 16, (8, 12))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "mish"])
@pytest.mark.parametrize("kind,cin,cout,shape", [
    ("p", 32, 32, (1, 8, 6, 70)),
    ("p", 128, 128, (1, 6, 12, 39)),     # PCW's 1/32 level: W = 39, fewer rows than a block
    ("p", 64, 128, (1, 6, 12, 39)),      # the 1/32 volume's part of combine3
    ("s2", 128, 128, (1, 12, 24, 78)),   # conv5: 1/16 → 1/32
    ("k1", 128, 128, (1, 12, 24, 78)),   # redir3
    ("up", 128, 128, (1, 6, 12, 39)),    # conv7: 1/32 → 1/16
    ("up", 64, 32, (1, 3, 4, 9)),
])
def test_conv_epilogues(dev, dtype, act, kind, cin, cout, shape):
    """Mish and no activation on every conv form, with the residual on the
    stride-1 and transposed forms, at PCW's odd shapes; inputs at std 3 so
    Mish's negative tail and its pass-through above 20 are both reached."""
    k = 1 if kind == "k1" else 3
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, cout, k, seed=90)
    x = (x.float() * 3).to(dtype)
    b, d, h, w = shape
    if kind == "up":
        res = _randn(dev, b, 2 * d, 2 * h, 2 * w, cout, seed=91).to(dtype)
        got = kup.conv3d_fold_up(x, wt, bias, residual=res, act=act)
        want = kup.conv3d_up_plain(x, wt, bias, res, act)
    elif kind == "p":
        res = _randn(dev, b, d, h, w, cout, seed=92).to(dtype)
        got = kconv.conv3d_fold_p(x, wt, bias, residual=res, act=act)
        want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, act)
    else:
        fn = kconv.conv3d_fold_s2 if kind == "s2" else kconv.conv1x1_fold_p
        got = fn(x, wt, bias, act=act)
        want = kconv.conv3d_fold_plain(x, wt, bias, 2 if kind == "s2" else 1, None, act)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv_refuses_unknown_act(dev):
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 2, 2, 4), 16, 16, 3, seed=93)
    with pytest.raises(ValueError, match="act must be"):
        kconv.conv3d_fold_p(x, wt, bias, act="gelu")
    with pytest.raises(ValueError, match="act must be"):
        kup.conv3d_fold_up(x, wt, bias, act="swish")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_dhw_mul_one_map(dev, dtype, channels_last):
    """PCW's step multiplies the noise alone: exact, and the same as a map
    of ones for the second."""
    b, c, d, h, w = 1, 32, 6, 5, 7
    shape = (b, d, h, w, c) if channels_last else (b, c, d, h, w)
    vol = _randn(dev, *shape, seed=94).to(dtype)
    m = torch.rand((b, d, h, w), device=dev).to(dtype)
    got = kc.dhw_mul(vol, m, None, channels_last=channels_last)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.volume_dhw_mul(vol, m, None, channels_last))
    assert torch.equal(got, kc.dhw_mul(vol, m, torch.ones_like(m), channels_last=channels_last))


def test_new_launch_counts(dev):
    """The front's wrappers count their own launches only: the GWC volume
    in the slot, the single and the fused stencils, the uncertainty at a
    query."""
    counters = (kg.gwc_volume_packed, kd.depthwise_hw_p, kd.depthwise_hw_p2,
                kf.fused_uncertainty_at, kf.fused_upsample_softargmin, kg.gwc_volume)
    before = [f.launches for f in counters]
    feat = _randn(dev, 1, 16, 2, 9)
    vol = kg.gwc_volume_packed(feat, feat, 4, 8)
    wt = _randn(dev, 3, 3, 16)
    kd.depthwise_hw_p(vol, wt, (1,) * 16)
    kd.depthwise_hw_p2(vol, wt, (1,) * 16, wt, (2,) * 16)
    kd.depthwise_hw_p2(vol, wt, (1,) * 16, wt, (2,) * 16)
    kf.fused_uncertainty_at(_randn(dev, 1, 4, 2, 3), torch.zeros((1, 8, 12), device=dev), 16,
                            (8, 12))
    assert [f.launches for f in counters] == [before[0] + 1, before[1] + 1, before[2] + 2,
                                              before[3] + 1, *before[4:]]


# -- the IGEV path's kernel forms -----------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout,shape,residual", [
    ("p", 16, 16, (1, 8, 6, 70), False),    # corr_stem in its 16 slot; W past one tile
    ("p", 48, 48, (1, 6, 12, 39), False),   # conv3_1 at 1/32: C_in 48 in 16-wide chunks
    ("p", 32, 32, (1, 4, 5, 9), True),
    ("s2", 16, 32, (1, 8, 6, 18), False),   # conv2_0
    ("k1", 16, 16, (1, 4, 3, 70), True),    # agg1_0: the second half + the first as residual
    ("up", 48, 32, (1, 3, 4, 9), False),    # conv3_up, k4
    ("up", 32, 16, (1, 3, 4, 35), True),
])
def test_conv_leaky_post_mul(dev, dtype, kind, cin, cout, shape, residual):
    """LeakyReLU 0.01 then × a (B, H_out, W_out, C_out) map broadcast over D,
    on every conv form, at inputs of std 3 so the negative slope is reached:
    the CONV_TOL bounds."""
    k = {"k1": 1, "up": 4}.get(kind, 3)
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, cout, k, seed=100)
    x = (x.float() * 3).to(dtype)
    b, d, h, w = shape
    o = {"up": (2 * d, 2 * h, 2 * w), "s2": ((d + 1) // 2, (h + 1) // 2, (w + 1) // 2)}.get(
        kind, (d, h, w))
    res = _randn(dev, b, *o, cout, seed=101).to(dtype) if residual else None
    pm = torch.sigmoid(_randn(dev, b, o[1], o[2], cout, seed=102)).to(dtype)
    if kind == "up":
        got = kup.conv3d_fold_up(x, wt, bias, residual=res, act="leaky", post_mul=pm)
        want = kup.conv3d_up_plain(x, wt, bias, res, "leaky", pm)
    elif kind == "s2":
        got = kconv.conv3d_fold_s2(x, wt, bias, act="leaky")
        want = kconv.conv3d_fold_plain(x, wt, bias, 2, None, "leaky")
    else:
        fn = kconv.conv3d_fold_p if kind == "p" else kconv.conv1x1_fold_p
        kw = dict(post_mul=pm) if kind == "p" else {}
        got = fn(x, wt, bias, residual=res, act="leaky", **kw)
        want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, "leaky", pm if kind == "p" else None)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,shape,bias", [
    (48, 32, (1, 6, 12, 39), True),     # conv3_up at IGEV's 1/32 → 1/16
    (16, 16, (2, 3, 5, 7), True),       # odd sizes: every parity meets an edge
    (16, 16, (1, 4, 6, 70), False),     # conv1_up into its 16 slot, no bias; W past a tile
])
def test_conv3d_fold_up_k4(dev, dtype, cin, cout, shape, bias):
    """ConvTranspose3d k4 s2 p1 op0 (8 taps an output) against the plain
    version and ``F.conv_transpose3d``: the CONV_TOL bounds."""
    x, wt, b = _conv_inputs(dev, dtype, shape, cin, cout, 4, seed=110)
    b = b if bias else None
    got = kup.conv3d_fold_up(x, wt, b)
    want = kup.conv3d_up_plain(x, wt, b)
    lib = torch.nn.functional.conv_transpose3d(
        x.float().permute(0, 4, 1, 2, 3), wt.float().permute(3, 4, 0, 1, 2), b, stride=2,
        padding=1).permute(0, 2, 3, 4, 1)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], 2 * shape[3], cout)
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), lib, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,shape,bias,act", [
    (8, 8, (1, 8, 6, 70), False, None),     # corr_stem on the module path
    (16, 16, (1, 4, 5, 9), True, "relu"),   # the hourglass's 16-channel convs
    (8, 1, (2, 6, 4, 20), False, None),     # the 8 → 1 classifier
])
def test_conv3d_fold_small(dev, dtype, cin, cout, shape, bias, act):
    """Row 14 on plain NDHWC at C_in 8 (a zero-filled half chunk, no slot)
    and 16: the CONV_TOL bounds."""
    x, wt, b = _conv_inputs(dev, dtype, shape, cin, cout, 3, seed=120)
    b = b if bias else None
    got = kconv.conv3d_fold_small(x, wt, b, act=act)
    want = kconv.conv3d_fold_plain(x, wt, b, 1, None, act)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv3d_fold_small_refuses_other_widths(dev):
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 2, 3, 4), 32, 8, 3, seed=121)
    with pytest.raises(ValueError, match="8 or 16"):
        kconv.conv3d_fold_small(x, wt, bias)
    x8, w8, _ = _conv_inputs(dev, torch.bfloat16, (1, 2, 3, 4), 8, 8, 3, seed=122)
    with pytest.raises(ValueError, match="multiple of 16"):
        kconv.conv3d_fold_p(x8, w8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_slot,co,shape", [
    (16, 8, (1, 12, 5, 39)),     # the GEV: 8 of 16 channels (one 16-byte vector in bf16)
    (1, 1, (1, 48, 3, 37)),      # the classifier's cost, D past one 32 tile
    (16, 4, (2, 40, 2, 9)),      # one 16-byte float32 vector
    (8, 8, (1, 5, 4, 6)),        # the whole slot
])
def test_unpack_hwdc(dev, dtype, c_slot, co, shape):
    """Copies only: exact."""
    b, d, h, w = shape
    x = _randn(dev, b, d, h, w, c_slot, seed=130).to(dtype)
    got = kl.unpack_hwdc(x, co)
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, d * co)
    assert torch.equal(got, kl.unpack_hwdc_plain(x, co))


def test_igev_launch_counts(dev):
    """The two new wrappers count their own launches only; the k4 form
    counts as ``conv3d_fold_up``."""
    counters = (kconv.conv3d_fold_small, kl.unpack_hwdc, kconv.conv3d_fold_p, kup.conv3d_fold_up)
    before = [f.launches for f in counters]
    x, wt, _ = _conv_inputs(dev, torch.bfloat16, (1, 2, 3, 4), 8, 16, 3, seed=140)
    y = kconv.conv3d_fold_small(x, wt)
    kl.unpack_hwdc(y, 8)
    kup.conv3d_fold_up(y, (_randn(dev, 4, 4, 4, 16, 16, seed=141) * 0.1).to(torch.bfloat16))
    assert [f.launches for f in counters] == [before[0] + 1, before[1] + 1, before[2],
                                              before[3] + 1]


# -- rows 18 and 15: the refinement's dilated 2-D conv, the module paths' packed conv ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,real_cin,cout,shape,d,bias,epilogue", [
    (128, 128, 128, (1, 12, 70), 1, True, False),    # W past one 64 tile, ragged
    (128, 128, 96, (1, 9, 33), 2, True, False),      # C_out 96: three 32 tiles
    (64, 64, 64, (2, 40, 37), 16, True, False),      # d 16: the strip 96 wide, rows all in padding
    (160, 146, 128, (1, 10, 20), 1, True, False),    # the 146-channel input in its 160 slot
    (32, 32, 1, (1, 7, 130), 1, False, False),       # conv8: C_out 1, no bias
    (96, 96, 96, (1, 5, 9), 8, True, False),         # d past H and W
    (24, 24, 16, (1, 6, 11), 4, False, False),       # C_in 24: a zero-filled half chunk
    # the refinement's widths with a residual and Mish in the epilogue
    (160, 146, 128, (1, 12, 70), 1, True, True),
    (128, 128, 128, (1, 20, 40), 4, True, True),
    (128, 128, 96, (1, 20, 40), 8, True, True),
    (96, 96, 64, (1, 40, 37), 16, True, True),
    (64, 64, 32, (2, 9, 33), 2, True, True),
    (32, 32, 1, (1, 7, 130), 1, False, True),        # the head member
])
def test_conv2d_flat(dev, dtype, cin, real_cin, cout, shape, d, bias, epilogue):
    """Row 18 against its plain version: the CONV_TOL bounds; the slot's
    fill channels have zero input and weights."""
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    b, h, w = shape
    x = _randn(dev, b, h, w, cin, seed=150)
    wt = _randn(dev, 3, 3, cin, cout, seed=151) / (9 * real_cin) ** 0.5
    x[..., real_cin:] = 0.0
    wt[:, :, real_cin:] = 0.0
    bv = _randn(dev, cout, seed=152) if bias else None
    x, wt = x.to(dtype), wt.to(dtype)
    res = _randn(dev, b, h, w, cout, seed=153).to(dtype) if epilogue else None
    act = "mish" if epilogue else None
    got = k2.conv2d_flat(x, wt, bv, d, residual=res, act=act)
    want = k2.conv2d_flat_plain(x, wt, bv, d, residual=res, act=act)
    torch.cuda.synchronize()
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv2d_flat_refuses_bad_operands(dev):
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    x = _randn(dev, 1, 4, 6, 146).bfloat16()
    wt = _randn(dev, 3, 3, 146, 32).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        k2.conv2d_flat(x, wt)
    x16, w16 = _randn(dev, 1, 4, 6, 16).bfloat16(), _randn(dev, 3, 3, 16, 32).bfloat16()
    with pytest.raises(TypeError):
        k2.conv2d_flat(x16, w16.float())
    with pytest.raises(ValueError):
        k2.conv2d_flat(x16.transpose(1, 2), w16)
    with pytest.raises(ValueError):
        k2.conv2d_flat(x16, w16, torch.zeros(32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,shape,bias,act", [
    (8, 8, (1, 16, 6, 70), True, "relu"),
    (16, 16, (1, 8, 5, 9), False, None),
    (32, 32, (1, 8, 6, 70), False, None),      # the module paths' 32→32
    (64, 32, (1, 8, 5, 11), True, "relu"),     # dres0_0's 64 → 32
    (128, 128, (2, 2, 4, 13), True, None),
    (128, 64, (1, 6, 3, 39), False, None),     # PCW's combine1 at the 1/8 level's width
])
def test_conv3d_packed(dev, dtype, cin, cout, shape, bias, act):
    """Row 15 at each C_in of its contract, with and without bias and ReLU:
    the CONV_TOL bounds."""
    x, wt, b = _conv_inputs(dev, dtype, shape, cin, cout, 3, seed=160)
    b = b if bias else None
    got = kconv.conv3d_packed(x, wt, b, act=act)
    want = kconv.conv3d_fold_plain(x, wt, b, 1, None, act)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv3d_packed_band_keeps_the_whole_plans_k_splits(dev):
    """A band of rows with one halo row a side, on the whole volume's K
    splits (``plan_shape``), gives the whole's rows bit for bit in
    bfloat16: PCW's 128→128 conv at 1/32 of 384×1248, whose own plan splits
    K five ways on the whole and six on a band."""
    x, wt, _ = _conv_inputs(dev, torch.bfloat16, (1, 6, 12, 39), 128, 128, 3, seed=171)
    whole = kconv.conv3d_packed(x, wt)
    for lo, hi in ((0, 6), (6, 12)):
        pad = torch.zeros_like(x[:, :, :1])
        xb = torch.cat([x[:, :, lo - 1:lo] if lo else pad, x[:, :, lo:hi],
                        x[:, :, hi:hi + 1] if hi < 12 else pad], 2).contiguous()
        got = kconv.conv3d_packed(xb, wt, plan_shape=tuple(x.shape))[:, :, 1:1 + hi - lo]
        torch.cuda.synchronize()
        assert torch.equal(got, whole[:, :, lo:hi])


def test_routed_conv_runs_the_packed_kernel(dev):
    """A routed ``ConvBN`` conv on the card: NCDHW and channels-last inputs
    both launch row 15 once and agree with cuDNN's float32 conv."""
    from diffuvolume_tpu_torch.models import layers

    cb = layers.route_conv3d(layers.convbn_3d(32, 32, 3, 1, 1)).to(dev).eval()
    x = _randn(dev, 1, 32, 8, 6, 20, seed=170)
    want = torch.nn.functional.conv3d(x, cb[0].weight, padding=1)
    for xin in (x, x.contiguous(memory_format=torch.channels_last_3d)):
        before = kconv.conv3d_packed.launches
        got = cb[0](xin)
        torch.cuda.synchronize()
        assert kconv.conv3d_packed.launches == before + 1
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_row_15_and_18_launch_counts(dev):
    """The two new wrappers count their own launches only; row 15 is not
    counted as ``conv3d_fold_p`` though it runs the same kernel."""
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    counters = (kconv.conv3d_packed, k2.conv2d_flat, kconv.conv3d_fold_p, kconv.conv3d_fold_small)
    before = [f.launches for f in counters]
    x, wt, _ = _conv_inputs(dev, torch.bfloat16, (1, 4, 3, 5), 32, 32, 3, seed=180)
    kconv.conv3d_packed(x, wt)
    k2.conv2d_flat(x[:, 0], wt[0])
    assert [f.launches for f in counters] == [before[0] + 1, before[1] + 1, before[2], before[3]]


@torch.no_grad()
def test_routed_pcw_module_path_on_the_card(dev):
    """PCW's module path after ``route_conv3d`` at 64×64: 44 row-15 launches
    a pair (2 volume builds × 8, 4 aggregation passes × 7), and a finite
    output; the routed convs leave channels-last volumes, and the combine
    volume goes back to NCDHW for ``dhw_mul``."""
    from diffuvolume_tpu_torch.eval.pipeline import pcw_ddim_inference
    from diffuvolume_tpu_torch.models.layers import route_conv3d
    from diffuvolume_tpu_torch.tools.random_weights import random_pcw_pair

    models = random_pcw_pair(192, torch.Generator().manual_seed(0))
    bm, dm = (route_conv3d(m).to(dev) for m in models)
    left = _randn(dev, 1, 64, 64, 3, seed=190) * 0.3
    before = kconv.conv3d_packed.launches
    final, _ = pcw_ddim_inference(bm, dm, left, torch.roll(left, -3, 2), device=dev, packed=False,
                                  generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert kconv.conv3d_packed.launches - before == 44
    assert final.shape == (1, 64, 64) and torch.isfinite(final).all()


# -- rows 7 and 8 on conv_hopper.cuh: the tile rules' edges -------------------------

def _epilogue_ref(y, bias, res, act, pm, dtype):
    """``F.conv3d`` / ``F.conv_transpose3d``'s float32 NCDHW result → the
    kernels' epilogue, by hand: + bias, + residual, act, × post_mul, one
    rounding."""
    y = y.permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias
    if res is not None:
        y = y + res.float()
    y = kconv.apply_act(y, act)
    if pm is not None:
        y = y * pm.float()[:, None]
    return y.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,real_cin,cout,shape,act", [
    (32, 32, 64, (1, 6, 9, 78), "mish"),      # W_out 39, odd H_out: rows of a tile
    (64, 64, 128, (1, 5, 8, 156), None),      # W_out 78, odd D: a padding plane
    (32, 32, 64, (1, 4, 6, 312), "relu"),     # W_out 156 over several W tiles
    (128, 128, 128, (1, 12, 24, 78), None),   # PCW 128→128 to (6, 12, 39): split K
    (16, 8, 16, (1, 4, 3, 10), "leaky"),      # IGEV conv1_0: 8 real in 16; fewer rows than a tile
    (32, 32, 48, (1, 4, 6, 18), "leaky"),     # IGEV conv3_0: C_out 48 in a 64-wide tile
])
def test_conv3d_fold_s2_tiles(dev, dtype, cin, real_cin, cout, shape, act):
    """Row 7 at the shapes its tile rules treat apart, against the plain
    version and ``F.conv3d``: the CONV_TOL bounds."""
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, cout, 3, seed=200)
    x[..., real_cin:] = 0
    wt[..., real_cin:, :] = 0
    got = kconv.conv3d_fold_s2(x, wt, bias, act=act)
    want = kconv.conv3d_fold_plain(x, wt, bias, 2, None, act)
    lib = _epilogue_ref(torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3), wt.float().permute(4, 3, 0, 1, 2), stride=2,
        padding=1), bias, None, act, None, dtype)
    torch.cuda.synchronize()
    b, d, h, w = shape
    assert got.shape == (b, (d + 1) // 2, (h + 1) // 2, (w + 1) // 2, cout)
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), lib.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ks,cin,cout,shape,bias,residual,act,post_mul", [
    (3, 128, 128, (1, 6, 12, 39), True, True, "mish", False),   # PCW conv7 at 1/32 → 1/16
    (3, 64, 32, (1, 3, 5, 39), True, True, "relu", False),      # W 39, odd H and D
    (3, 128, 64, (1, 3, 4, 78), True, True, None, True),        # post_mul with a residual
    (3, 64, 32, (2, 3, 3, 7), False, True, "leaky", True),      # two batches, no bias
    (4, 48, 32, (1, 3, 5, 39), True, False, "leaky", True),     # IGEV conv3_up, k4
    (4, 16, 16, (1, 3, 4, 9), False, False, None, False),       # k4 without bias
    (4, 32, 16, (1, 2, 3, 156), True, True, "mish", False),     # k4 over several W tiles
])
def test_conv3d_fold_up_tiles(dev, dtype, ks, cin, cout, shape, bias, residual, act, post_mul):
    """Row 8, every output parity from one block, at the shapes its tile
    rules treat apart and with every epilogue part, against the plain
    version and ``F.conv_transpose3d``: the CONV_TOL bounds."""
    x, wt, b = _conv_inputs(dev, dtype, shape, cin, cout, ks, seed=210)
    b = b if bias else None
    n, d, h, w = shape
    o = (n, 2 * d, 2 * h, 2 * w, cout)
    res = _randn(dev, *o, seed=211).to(dtype) if residual else None
    pm = torch.sigmoid(_randn(dev, n, 2 * h, 2 * w, cout, seed=212)).to(dtype) if post_mul else None
    got = kup.conv3d_fold_up(x, wt, b, residual=res, act=act, post_mul=pm)
    want = kup.conv3d_up_plain(x, wt, b, res, act, pm)
    lib = _epilogue_ref(torch.nn.functional.conv_transpose3d(
        x.float().permute(0, 4, 1, 2, 3), wt.float().permute(3, 4, 0, 1, 2), stride=2, padding=1,
        output_padding=1 if ks == 3 else 0), b, res, act, pm, dtype)
    torch.cuda.synchronize()
    assert got.shape == o
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), lib.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("tc", [kconv.TC_MMA, kconv.TC_WGMMA])
@pytest.mark.parametrize("cin,cout,shape,act", [
    (32, 64, (1, 24, 64, 240), "relu"),    # ACV 32→64, one 120-wide row a tile
    (64, 128, (1, 48, 48, 78), "mish"),    # W_out 39: three rows a tile, two C_out tiles
])
def test_conv3d_fold_s2_tensor_core_forms(dev, tc, cin, cout, shape, act):
    """Row 7 at 64 output channels a tile on each tensor-core form (the
    plan takes the one asked for at a grid of a full wave), against the
    plain version: the bf16 CONV_TOL bounds."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, shape, cin, cout, 3, seed=230)
    assert kconv.s2_plan(x.shape, cout, dev, tc)["wgmma"] == (tc == kconv.TC_WGMMA)
    got = kconv.conv3d_fold_s2_on(tc, x, wt, bias, act=act)
    want = kconv.conv3d_fold_plain(x, wt, bias, 2, None, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("tc", [kconv.TC_MMA, kconv.TC_WGMMA])
@pytest.mark.parametrize("ks,cin,cout,shape,act,post_mul", [
    (3, 128, 64, (1, 12, 32, 60), "relu", False),   # ACV 128→64 + residual
    (3, 128, 128, (1, 12, 12, 39), "mish", True),   # odd W, two C_out tiles, post_mul
    (4, 64, 64, (1, 16, 24, 39), "leaky", False),   # k4
])
def test_conv3d_fold_up_tensor_core_forms(dev, tc, ks, cin, cout, shape, act, post_mul):
    """Row 8 at 64 output channels a tile on each tensor-core form, with a
    residual, against the plain version: the bf16 CONV_TOL bounds."""
    x, wt, b = _conv_inputs(dev, torch.bfloat16, shape, cin, cout, ks, seed=240)
    n, d, h, w = shape
    res = _randn(dev, n, 2 * d, 2 * h, 2 * w, cout, seed=241).to(torch.bfloat16)
    pm = (torch.sigmoid(_randn(dev, n, 2 * h, 2 * w, cout, seed=242)).to(torch.bfloat16)
          if post_mul else None)
    assert kup.up_plan(x.shape, cout, ks, dev, tc)["wgmma"] == (tc == kconv.TC_WGMMA)
    got = kup.conv3d_fold_up_on(tc, x, wt, b, residual=res, act=act, post_mul=pm)
    want = kup.conv3d_up_plain(x, wt, b, res, act, pm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2.0 ** -7)


def test_rows_7_and_8_plans(dev):
    """The host's tile plans at the ACV and PCW shapes: at least two blocks
    an SM, a full wave of blocks (split K counted), and the tiles' positions
    at least 90% used over the plane."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for x_shape, cout in [((1, 48, 128, 240, 32), 64), ((1, 24, 64, 120, 64), 128),
                          ((1, 48, 96, 312, 32), 64), ((1, 24, 48, 156, 64), 128),
                          ((1, 12, 24, 78, 128), 128)]:
        pl = kconv.s2_plan(x_shape, cout, dev)
        _, d, h, w, _ = x_shape
        ho, wo = (h + 1) // 2, (w + 1) // 2
        tiles = pl["nth"] * pl["ntw"]
        assert pl["blocks_per_sm"] >= 2, (x_shape, pl)
        assert pl["blocks"] * pl["splits"] >= sms * pl["blocks_per_sm"], (x_shape, pl)
        assert ho * wo / (tiles * pl["positions"]) >= 0.9, (x_shape, pl)
    for x_shape, cout in [((1, 12, 32, 60, 128), 64), ((1, 24, 64, 120, 64), 32),
                          ((1, 12, 24, 78, 128), 64), ((1, 24, 48, 156, 64), 32),
                          ((1, 6, 12, 39, 128), 128)]:
        pl = kup.up_plan(x_shape, cout, 3, dev)
        _, d, h, w, _ = x_shape
        assert pl["blocks_per_sm"] >= 2, (x_shape, pl)
        assert h * w / (pl["nth"] * pl["ntw"] * pl["positions"]) >= 0.9, (x_shape, pl)


def test_rows_7_and_8_refuse_partial_vectors(dev):
    """bf16 C_out must fill whole 16-byte vectors on rows 7 and 8."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 4, 4, 8), 16, 12, 3, seed=220)
    with pytest.raises(ValueError, match="multiple of 8"):
        kconv.conv3d_fold_s2(x, wt, bias)
    with pytest.raises(ValueError, match="multiple of 8"):
        kup.conv3d_fold_up(x, wt, bias)


# -- float32 pipelines set their own precision -------------------------------------

@pytest.fixture
def card_default_tf32():
    """The card with PyTorch's default switches (cuDNN TF32 on, matmul TF32
    off), whatever an earlier test set; restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@torch.no_grad()
def test_float32_acv_pipeline_matches_the_cpu_without_the_global_switch(card_default_tf32):
    """The f32 ACV pipeline at phase 4's size (32×64, max_disp 64, the same
    seeded weights, images and draws) on the card with cuDNN's TF32 left on
    globally: held to the CPU by ``chip_smoke.agree``'s bounds and flip rule,
    and ``acv_ddim_inference`` gives the staged run's output exactly; the
    caller's switch is still on afterwards.  Run from the repository root
    (``python -m pytest``), which puts ``chip_smoke`` on the path."""
    import copy

    import numpy as np

    import chip_smoke
    from diffuvolume_tpu_torch.diffusion import DDIMConfig
    from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference, acv_prep
    from diffuvolume_tpu_torch.models.acv_fold import fold_acv
    from diffuvolume_tpu_torch.tools.random_weights import calibrate_heads, random_pair

    dev, (h, w, md) = card_default_tf32, (32, 64, 64)
    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, h, w, 3)).astype(np.float32) * 0.3
    right = np.roll(left, -3, axis=2)
    bm, dm = random_pair(md, torch.Generator().manual_seed(0))
    calibrate_heads(bm, torch.from_numpy(left), torch.from_numpy(right), target_std=10.0)
    dm.load_state_dict(bm.state_dict(), strict=False)
    cfg = DDIMConfig(max_disp=md, num_bins=md // 4)
    shape = (1, md // 4, h // 4, w // 4)
    steps = (cfg.sampling_steps, *shape)
    ns = {"z": rng.standard_normal(steps).astype(np.float32),
          "replace": rng.uniform(size=steps).astype(np.float32)}
    bg, dg = copy.deepcopy(bm).to(dev), copy.deepcopy(dm).to(dev)
    runs = {}

    def card():
        runs["staged"] = chip_smoke.sampled(acv_prep, fold_acv, bg, dg, left, right, cfg, dev, ns,
                                            True)
        return runs["staged"]

    chip_smoke.agree("acv folded path, TF32 on globally", lambda: chip_smoke.sampled(
        acv_prep, fold_acv, bm, dm, left, right, cfg, torch.device("cpu"), ns, True), card)
    final, base = acv_ddim_inference(bg, dg, left, right, cfg, device=dev, noise_source=ns)
    torch.cuda.synchronize()
    assert torch.equal(final, runs["staged"][0]) and torch.equal(base, runs["staged"][1])
    assert torch.backends.cudnn.allow_tf32


# -- the stride-1 kernel (rows 5, 6, 14, 15) and row 18 on conv_hopper.cuh ----------

def _conv3d_lib(x, wt, bias, res, act, pm, dtype):
    """``F.conv3d`` in float32 on the same (rounded) operands, with the
    kernels' epilogue by hand."""
    return _epilogue_ref(torch.nn.functional.conv3d(
        x.float().permute(0, 4, 1, 2, 3), wt.float().permute(4, 3, 0, 1, 2), padding=1),
        bias, res, act, pm, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,real_cin,cout,shape,act,residual,post_mul", [
    (128, 128, 128, (1, 6, 12, 39), "mish", True, False),    # PCW 1/32: K split, W 39
    (128, 128, 128, (1, 12, 24, 78), "relu", True, True),    # PCW 1/16: W 78, post_mul
    (128, 128, 128, (1, 12, 32, 60), None, False, False),    # ACV quarter: W 60
    (64, 64, 128, (1, 6, 12, 39), "leaky", True, True),      # combine3's 64→128 part
    (128, 128, 64, (1, 7, 9, 60), "mish", True, True),       # combine1 128→64, odd D and H
    (64, 64, 64, (1, 5, 7, 120), "leaky", False, True),      # the half level's W 120
    (48, 40, 32, (1, 4, 6, 39), "relu", False, False),       # 40 real in the 48 slot
    (8, 8, 16, (1, 3, 5, 78), "leaky", True, True),          # C_in 8: a zero-filled half chunk
    (16, 16, 16, (1, 3, 2, 9), None, True, False),           # fewer rows than a tile
    (32, 32, 1, (1, 4, 6, 39), None, False, False),          # the 32→1 head
    (16, 8, 1, (2, 3, 5, 20), None, False, False),           # IGEV's classifier, two batches
    (48, 48, 48, (1, 6, 12, 39), "leaky", False, True),      # IGEV conv3_1: C_out 48 of 64
])
def test_conv3d_s1_plans(dev, dtype, cin, real_cin, cout, shape, act, residual, post_mul):
    """The stride-1 kernel at the shapes its plan treats apart (narrow W,
    split K, the half tile, zero-filled chunks, narrow C_out), with the
    residual and post_mul through the split's float32 reduction, against
    the plain version and ``F.conv3d``: the CONV_TOL bounds."""
    x, wt, bias = _conv_inputs(dev, dtype, shape, cin, cout, 3, seed=250)
    x[..., real_cin:] = 0
    wt[..., real_cin:, :] = 0
    n = shape[0]
    res = _randn(dev, *shape, cout, seed=251).to(dtype) if residual else None
    pm = (torch.sigmoid(_randn(dev, n, *shape[2:], cout, seed=252)).to(dtype)
          if post_mul else None)
    fn = kconv.conv3d_fold_small if cin in (8, 16) else kconv.conv3d_fold_p
    kw = {} if fn is kconv.conv3d_fold_small else dict(residual=res, post_mul=pm)
    if fn is kconv.conv3d_fold_small:
        res = pm = None
    got = fn(x, wt, bias, act=act, **kw)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, act, pm)
    lib = _conv3d_lib(x, wt, bias, res, act, pm, dtype)
    torch.cuda.synchronize()
    assert got.shape == (*shape, cout)
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), lib.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("act", [None, "relu", "mish", "leaky"])
def test_conv3d_s1_split_k_epilogues(dev, act):
    """PCW's 1/32 128→128 splits K over blocks: every activation, with the
    residual and post_mul, runs in the split's second pass and rounds once
    (inputs at std 3 so Mish's tails and the leaky slope are reached)."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 6, 12, 39), 128, 128, 3, seed=260)
    x = (x.float() * 3).bfloat16()
    assert kconv.s1_plan(x.shape, 128, dev)["splits"] > 1
    res = _randn(dev, 1, 6, 12, 39, 128, seed=261).bfloat16()
    pm = torch.sigmoid(_randn(dev, 1, 12, 39, 128, seed=262)).bfloat16()
    got = kconv.conv3d_fold_p(x, wt, bias, residual=res, act=act, post_mul=pm)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, act, pm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("tc", [kconv.TC_MMA, kconv.TC_WGMMA])
@pytest.mark.parametrize("cin,cout,shape,act", [
    (64, 64, (1, 6, 16, 60), "relu"),      # 64 channels a tile
    (128, 128, (1, 4, 8, 78), "mish"),     # 128: two 64-channel halves a wgmma step
    (32, 64, (1, 5, 9, 39), None),         # the wide entry class, W 39
    (64, 32, (1, 6, 16, 60), "leaky"),     # 32 channels: m64n32k16, 64-byte swizzle
    (32, 32, (1, 3, 5, 20), None),         # 32 channels at a small grid: smaller tiles
])
def test_conv3d_s1_tensor_core_forms(dev, tc, cin, cout, shape, act):
    """The stride-1 kernel on each tensor-core form, with a residual and
    post_mul, against the plain version: the bf16 CONV_TOL bounds."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, shape, cin, cout, 3, seed=270)
    res = _randn(dev, *shape, cout, seed=271).bfloat16()
    pm = torch.sigmoid(_randn(dev, shape[0], *shape[2:], cout, seed=272)).bfloat16()
    assert kconv.s1_plan(x.shape, cout, dev, tc)["wgmma"] == (tc == kconv.TC_WGMMA)
    got = kconv.conv3d_fold_p_on(tc, x, wt, bias, residual=res, act=act, post_mul=pm)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, act, pm)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2.0 ** -7)


def test_stride_1_plans(dev):
    """The host's plans at the main path's shapes: a stage ring that fits
    (at least one block an SM), the tiles' positions at least 85% used over
    the plane, K split at PCW's 1/32 level, wgmma at 64 channels and up
    (32 channels: mma.sync at the largest tile)."""
    for x_shape, cout in [((1, 48, 128, 240, 32), 32), ((1, 48, 128, 240, 64), 32),
                          ((1, 24, 64, 120, 64), 64), ((1, 12, 32, 60, 128), 128),
                          ((1, 48, 96, 312, 32), 32), ((1, 24, 48, 156, 64), 64),
                          ((1, 12, 24, 78, 128), 128), ((1, 6, 12, 39, 128), 128),
                          ((1, 48, 96, 312, 32), 1)]:
        pl = kconv.s1_plan(x_shape, cout, dev)
        _, d, h, w, _ = x_shape
        assert pl["blocks_per_sm"] >= 1 and pl["kh_a_stage"] == 3, (x_shape, pl)
        assert h * w / (pl["nth"] * pl["ntw"] * pl["positions"]) >= 0.85, (x_shape, pl)
        assert pl["wgmma"] == (cout >= 64), (x_shape, pl)
    assert kconv.s1_plan((1, 6, 12, 39, 128), 128, dev)["splits"] > 1


def test_conv1x1_refuses_partial_vectors(dev):
    """Row 9's bf16 C_out must fill whole 16-byte vectors."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, (1, 4, 4, 8), 16, 12, 1, seed=280)
    with pytest.raises(ValueError, match="multiple of 8"):
        kconv.conv1x1_fold_p(x, wt, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("cin,real_cin,cout,shape", [
    (160, 146, 128, (1, 20, 78)),    # conv1's 146 channels in the 160 slot
    (128, 128, 96, (1, 9, 60)),      # conv5.conv1's C_out 96
    (32, 32, 1, (2, 7, 39)),         # conv8: C_out 1, two images
])
def test_conv2d_flat_dilations(dev, dtype, d, cin, real_cin, cout, shape):
    """Row 18 at every dilation the refinement uses and at the wrapper's
    largest (whole-plane stages where a tile's strip fits, always at d ≤ 2;
    one kh tap a stage at d 64; rows and columns past H and W at d 16 and
    64), against the plain version and ``F.conv2d``: the CONV_TOL bounds."""
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    b, h, w = shape
    x = _randn(dev, b, h, w, cin, seed=290)
    wt = _randn(dev, 3, 3, cin, cout, seed=291) / (9 * real_cin) ** 0.5
    x[..., real_cin:] = 0.0
    wt[:, :, real_cin:] = 0.0
    bv = _randn(dev, cout, seed=292) if cout > 1 else None
    x, wt = x.to(dtype), wt.to(dtype)
    got = k2.conv2d_flat(x, wt, bv, d)
    want = k2.conv2d_flat_plain(x, wt, bv, d)
    lib = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1),
                                     bv, padding=d, dilation=d).permute(0, 2, 3, 1).to(dtype)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16 and d in (1, 2, 64):
        assert k2.flat_plan(x.shape, cout, d, dev)["kh_a_stage"] == (3 if d <= 2 else 1)
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), lib.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("tc", [kconv.TC_MMA, kconv.TC_WGMMA])
@pytest.mark.parametrize("cin,cout,shape,d", [
    (128, 128, (1, 24, 70), 1),     # conv2's class: 128 channels, ragged W
    (128, 128, (1, 16, 64), 4),     # conv4's: one kh tap a stage
    (128, 96, (1, 12, 40), 8),      # conv5.conv1: 96 as wgmma 64 + 32 or three 32 tiles
    (96, 96, (1, 20, 70), 2),       # conv5.conv2's class at whole-plane stages
    (96, 64, (1, 10, 33), 16),      # conv6.conv1: 64 channels
])
def test_conv2d_flat_tensor_core_forms(dev, tc, cin, cout, shape, d):
    """Row 18 on each tensor-core form against the plain version: the bf16
    CONV_TOL bounds."""
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    b, h, w = shape
    x = _randn(dev, b, h, w, cin, seed=300).bfloat16()
    wt = (_randn(dev, 3, 3, cin, cout, seed=301) / (9 * cin) ** 0.5).bfloat16()
    bv = _randn(dev, cout, seed=302)
    pl = k2.flat_plan(x.shape, cout, d, dev, tc)
    assert pl["wgmma"] == (tc == kconv.TC_WGMMA)
    assert pl["bn"] == ({96: 32, 64: 64}.get(cout, 128) if tc == kconv.TC_MMA else cout)
    got = k2.conv2d_flat_on(tc, x, wt, bv, d)
    want = k2.conv2d_flat_plain(x, wt, bv, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2.0 ** -7)


# -- rows 1, 17 and 9 in their Hopper designs ------------------------------------

# (B, D4, H4, W4) → (D, H, W), align_corners: 4× on every axis as at ACV
# (taps repeat every 4 bins), PCW's align-corners ratio (47/191 in D: the
# taps never repeat), a D that leaves a lane's bins past the end, 384 bins
# (96 a lane), and H not a multiple of the 4 rows a block walks; W is not a
# multiple of the 64 pixels a block holds.
HEAD_EDGES = [
    ((2, 48, 8, 25), (192, 32, 100), False),
    ((1, 48, 6, 26), (192, 24, 104), True),
    ((1, 24, 5, 17), (100, 20, 67), True),
    ((1, 96, 4, 20), (384, 16, 80), False),
    ((2, 12, 3, 10), (48, 10, 40), False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cost_shape,out,align_corners", HEAD_EDGES)
def test_fused_head_edges(dev, dtype, cost_shape, out, align_corners):
    """Row 1 at the paths' size ratios and the lane split's edges: 1e-4
    absolute + 1e-4 relative against the plain version."""
    d, h, w = out
    cost = (_randn(dev, *cost_shape, seed=310) * 3).to(dtype)
    disp, unc = kf.fused_upsample_softargmin(cost, d, (h, w), align_corners)
    pd, pu = kf.fused_upsample_softargmin_plain(cost, d, (h, w), align_corners)
    torch.cuda.synchronize()
    torch.testing.assert_close(disp, pd, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(unc, pu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cost_shape,out,align_corners", HEAD_EDGES)
def test_fused_uncertainty_at_edges(dev, dtype, cost_shape, out, align_corners):
    """Row 17 at the same shapes, the query drawn over every bin."""
    d, h, w = out
    cost = (_randn(dev, *cost_shape, seed=311) * 3).to(dtype)
    g = torch.Generator().manual_seed(312)
    q = (torch.rand((cost_shape[0], h, w), generator=g) * (d - 1)).to(dev)
    got = kf.fused_uncertainty_at(cost, q, d, (h, w), align_corners)
    want = kf.fused_uncertainty_at_plain(cost, q, d, (h, w), align_corners)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fused_heads_refuse_too_many_bins(dev):
    """Four lanes of 96 bins: max_disp above 384 raises instead of launching."""
    cost = _randn(dev, 1, 97, 2, 3)
    with pytest.raises(ValueError, match="max_disp"):
        kf.fused_upsample_softargmin(cost, 388, (8, 12))
    with pytest.raises(ValueError, match="max_disp"):
        kf.fused_uncertainty_at(cost, torch.zeros((1, 8, 12), device=dev), 388, (8, 12))


@pytest.mark.parametrize("act", [None, "relu", "mish", "leaky"])
@pytest.mark.parametrize("cin,cout,shape,residual", [
    (16, 16, (2, 3, 5, 39), True),      # IGEV's agg1_0 up half; M not a multiple of the tile
    (32, 32, (1, 8, 48, 200), False),   # 76,800 positions: 256-position tiles, a ring that wraps
    (32, 32, (1, 8, 48, 200), True),
    (64, 64, (1, 6, 24, 78), False),    # PCW's 1/8 width
    (128, 128, (1, 5, 12, 39), True),   # one block an SM
    (16, 8, (1, 4, 6, 33), False),      # C_out below the tile's 16
    (32, 24, (1, 4, 6, 33), True),
    (32, 200, (1, 3, 4, 35), True),     # C_out past 128: two passes over the staged tile
])
def test_conv1x1_stream(dev, act, cin, cout, shape, residual):
    """Row 9's bf16 kernel with every epilogue, at C_out tiles and tile
    counts the paths and their edges give: the bf16 CONV_TOL bounds."""
    x, wt, bias = _conv_inputs(dev, torch.bfloat16, shape, cin, cout, 1, seed=320)
    x = (x.float() * 3).bfloat16()
    b, d, h, w = shape
    res = _randn(dev, b, d, h, w, cout, seed=323).bfloat16() if residual else None
    got = kconv.conv1x1_fold_p(x, wt, bias, act=act, residual=res)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, res, act)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv1x1_stream_without_bias(dev):
    """The IGEV skip half: no bias, no activation."""
    x, wt, _ = _conv_inputs(dev, torch.bfloat16, (1, 6, 12, 39), 32, 32, 1, seed=330)
    got = kconv.conv1x1_fold_p(x, wt)
    want = kconv.conv3d_fold_plain(x, wt)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_conv1x1_plans(dev):
    """Row 9's plans: at least two blocks an SM at the ACV and PCW full- and
    half-resolution shapes, every SM busy; 256-position tiles only at 32
    channels and below; one block a tile where the tiles are few."""
    full = kconv.k1_plan((1, 48, 128, 240, 32), 32, False, dev)
    half = kconv.k1_plan((1, 24, 64, 120, 64), 64, False, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for pl in (full, half):
        assert pl["blocks_per_sm"] >= 2 and pl["blocks"] == pl["blocks_per_sm"] * sms, pl
    assert (full["positions"], half["positions"]) == (256, 128)
    small = kconv.k1_plan((1, 6, 12, 39, 32), 32, True, dev)
    assert small["blocks"] == small["tiles"] == -(-6 * 12 * 39 // 128), small


# -- row 3's channels-last concat and rows 11-12's transposer -----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_att", [False, True])
def test_concat_volume_channels_last_acv_shape(dev, dtype, with_att):
    """The ACV main path's shape, 2×(1, 32, 128, 240) → (1, 48, 128, 240,
    64): copies and one float32 product an element rounded once, exact."""
    cl, cr = (_randn(dev, 1, 32, 128, 240, seed=s).to(dtype) for s in (400, 401))
    att = torch.softmax(_randn(dev, 1, 48, 128, 240, seed=402), 1).to(dtype) if with_att else None
    got = kc.concat_volume(cl, cr, 48, att, channels_last=True)
    want = plain.concat_volume_mul(cl, cr, 48, att, channels_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_att", [False, True])
@pytest.mark.parametrize("c", [8, 16, 32, 64])
@pytest.mark.parametrize("d,w", [(12, 37), (48, 20), (7, 60)])
def test_concat_volume_channels_last_edges(dev, dtype, with_att, c, d, w):
    """W not a multiple of the tile (37: tiles of 32, the last part empty),
    D > W (planes whose right half is all zero), a W the tile divides, B =
    2, C a side 8, 16, 32 and 64 (bank groups a quarter-warp: 8 / C·size
    positions): exact."""
    b, h = 2, 3
    cl, cr = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (403, 404))
    att = torch.softmax(_randn(dev, b, d, h, w, seed=405), 1).to(dtype) if with_att else None
    got = kc.concat_volume(cl, cr, d, att, channels_last=True)
    want = plain.concat_volume_mul(cl, cr, d, att, channels_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_att", [False, True])
@pytest.mark.parametrize("force", [(16, 5, 0), (24, 48, 3), (60, 7, 0), (32, 12, 5), (8, 1, 0),
                                   (40, 20, 1)])
def test_concat_volume_channels_last_forced_plans(dev, dtype, with_att, force):
    """Other W tiles, D ranges (1 to all of D) and grids fewer than the
    items (blocks walking several): exact.  Features at an H·W that is no
    whole vector stage by element reads."""
    b, c, d, h, w = 2, 32, 20, 3, 61
    cl, cr = (_randn(dev, b, c, h, w, seed=s).to(dtype) for s in (406, 407))
    att = torch.softmax(_randn(dev, b, d, h, w, seed=408), 1).to(dtype) if with_att else None
    got = kc.concat_volume_cl_on(force, cl, cr, d, att)
    want = plain.concat_volume_mul(cl, cr, d, att, channels_last=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_concat_plan_acv_shape(dev):
    """Row 3's plan at the ACV shape, bf16: a W tile that divides 240, one
    wave of blocks walking the items, within one block's shared memory and
    the kernel's threads."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for att in (False, True):
        p = kc.concat_plan(1, 32, 128, 240, 48, att, torch.bfloat16, dev)
        assert 240 % p["tw"] == 0 and 48 % p["ds"] == 0, p
        assert p["items"] == 128 * (240 // p["tw"]) * (48 // p["ds"]), p
        assert p["threads"] % 32 == 0 and p["threads"] <= 512, p
        assert p["smem_bytes"] <= 232448 and p["blocks_per_sm"] >= 1, p
        assert p["blocks"] == min(p["items"], sms * p["blocks_per_sm"]), p


ACV_BOTTLENECK = (1, 128, 12, 32, 60)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,c_slot,dhw", [
    (1, 128, 128, (12, 32, 60)),    # the ACV folded path's bottleneck
    (1, 40, 48, (4, 6, 10)),        # c_slot > C: the fill
    (1, 16, 16, (3, 5, 7)),         # S not a multiple of 8: element tiles
    (1, 13, 16, (2, 4, 8)),         # C not a multiple of 8, the slot whole
    (2, 24, 32, (3, 4, 8)),         # B = 2
    (2, 12, 12, (5, 3, 3)),         # neither side whole vectors
])
def test_pack_unpack_transposer(dev, dtype, b, c, c_slot, dhw):
    """pack and unpack against the plain versions at the main path's shape
    and the edges the 16-byte form leaves to element tiles: exact, the slot
    fill included; unpack(pack(x)) is x on its channels."""
    x = _randn(dev, b, c, *dhw, seed=410).to(dtype)
    pk = kl.pack(x, c_slot)
    torch.cuda.synchronize()
    assert torch.equal(pk, kl.pack_plain(x, c_slot))
    back = kl.unpack(pk)
    torch.cuda.synchronize()
    assert torch.equal(back, kl.unpack_plain(pk))
    assert torch.equal(back[:, :c], x) and not back[:, c:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_round_trip(dev, dtype):
    """unpack(pack(x)) equals x at the ACV bottleneck."""
    x = _randn(dev, *ACV_BOTTLENECK, seed=411).to(dtype)
    back = kl.unpack(kl.pack(x))
    torch.cuda.synchronize()
    assert torch.equal(back, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_unaligned_views(dev, dtype):
    """Contiguous views at an offset that is no multiple of 16 bytes take
    the element form: exact."""
    b, c, d, h, w = 1, 16, 2, 4, 8
    n = b * c * d * h * w
    flat = _randn(dev, n + 1, seed=412).to(dtype)
    x = flat[1:].view(b, c, d, h, w)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(kl.pack(x, 24), kl.pack_plain(x, 24))
    y = flat[1:].view(b, d, h, w, c)
    got = kl.unpack(y)
    torch.cuda.synchronize()
    assert torch.equal(got, kl.unpack_plain(y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("force", [(1, 0), (2, 0), (4, 0), (8, 0), (2, 3), (4, 1), (8, 5)])
def test_pack_unpack_forced_plans(dev, dtype, force):
    """Every form (element tiles; 2, 4 or 8 lanes a tile column) on the
    plan's grid and on grids smaller than the tiles (warps walking
    several), pack with a slot fill and a ragged last tile: exact."""
    x = _randn(dev, 2, 40, 3, 5, 24, seed=413).to(dtype)
    pk = kl.pack_on(force, x, 48)
    torch.cuda.synchronize()
    assert torch.equal(pk, kl.pack_plain(x, 48))
    back = kl.unpack_on(force, pk)
    torch.cuda.synchronize()
    assert torch.equal(back, kl.unpack_plain(pk))


def test_transpose_plan_acv_bottleneck(dev):
    """rows 11-12's plan at the main path's shape: the 16-byte form, one
    warp a tile in a single wave (every tile's warp resident at once)."""
    b, c, (d, h, w) = 1, 128, ACV_BOTTLENECK[2:]
    s = d * h * w
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n, ldo in ((c, s, c), (s, c, s)):
        p = kl.transpose_plan(b, m, n, ldo, torch.bfloat16, dev)
        assert p["vec"] == 1 and p["lr"] in (2, 4, 8), p
        assert p["tiles"] == -(-ldo // (8 * p["lr"])) * -(-n // (8 * 32 // p["lr"])), p
        assert p["blocks"] * p["threads"] // 32 >= p["tiles"], p
        assert p["blocks"] <= sms * p["blocks_per_sm"], p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 48, 4, 40), (1, 48, 96, 312)])
def test_unpack_hwdc_cost_on_the_transposer(dev, dtype, shape):
    """Row 13's one-channel slot (IGEV's classifier cost) on the
    transposer's 16-byte form, B = 2 and the IGEV shape: exact."""
    b, d, h, w = shape
    x = _randn(dev, b, d, h, w, 1, seed=414).to(dtype)
    got = kl.unpack_hwdc(x, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, kl.unpack_hwdc_plain(x, 1))


def test_row_3_11_12_launch_counts(dev):
    """The forced forms count as their rows, and each wrapper its own
    launches only."""
    counters = (kc.concat_volume, kl.pack, kl.unpack, kl.unpack_hwdc)
    before = [f.launches for f in counters]
    cl = _randn(dev, 1, 8, 2, 9).bfloat16()
    kc.concat_volume(cl, cl, 4, channels_last=True)
    kc.concat_volume_cl_on((8, 2, 0), cl, cl, 4)
    x = _randn(dev, 1, 8, 2, 3, 8)
    kl.unpack(kl.pack_on((2, 0), x))
    kl.unpack_on((1, 0), kl.pack(x))
    assert [f.launches for f in counters] == [before[0] + 2, before[1] + 2, before[2] + 2,
                                              before[3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpg", [1, 8, 12, 16, 5])
@pytest.mark.parametrize("b,h,w,d", [(1, 3, 40, 12), (2, 2, 37, 9), (1, 2, 6, 20)])
def test_gwc_volume_ncdhw_cpg_and_edges(dev, dtype, cpg, b, h, w, d):
    """Row 2 at cpg 1, 8, 12 and 16 (compiled) and 5 (the run-time loop),
    at a W that is a multiple of 8, one that is not (the element form) and
    D > W: against the float32 plain version on the same rounded inputs,
    float32 to 1e-5 relative (summation order), bf16 to one rounding."""
    g = 3
    left, right = (_randn(dev, b, g * cpg, h, w, seed=s).to(dtype) for s in (31, 32))
    got = kg.gwc_volume(left, right, d, g)
    want = plain.build_gwc_volume(left.float(), right.float(), d, g)
    torch.cuda.synchronize()
    rel = 1e-5 if dtype == torch.float32 else BF16_REL
    torch.testing.assert_close(got.float(), want, rtol=rel, atol=1e-6)
    if d > w:
        assert torch.all(got[:, :, w:] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gwc_volume_ncdhw_unaligned_takes_the_element_form(dev, dtype):
    """Features 2 elements past a 16-byte boundary: the plan's element form,
    the same volume as the aligned call."""
    b, c, h, w, g, d = 1, 16, 3, 32, 2, 10
    base = _randn(dev, 2 * b * c * h * w + 2, seed=33).to(dtype)
    left = base[2:2 + b * c * h * w].view(b, c, h, w)
    right = base[2 + b * c * h * w:].view(b, c, h, w)
    assert kg.gwc_plan(b, c, h, w, g, d, dtype, dev, aligned=False)["vec"] == 0
    got = kg.gwc_volume(left, right, d, g)
    want = kg.gwc_volume(left.clone(), right.clone(), d, g)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [(8, 128), (16, 256), (24, 512), (48, 64), (4, 32)])
def test_gwc_volume_ncdhw_forced_tiles(dev, dtype, tile):
    """Every forced item and block size (``gwc_volume_on``) gives the plan's
    volume bit for bit, and counts as ``gwc_volume``."""
    left, right = (_randn(dev, 1, 96, 7, 48, seed=s).to(dtype) for s in (34, 35))
    ref = kg.gwc_volume(left, right, 48, 8)
    before = kg.gwc_volume.launches
    got = kg.gwc_volume_on(tile, left, right, 48, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert kg.gwc_volume.launches == before + 1


@pytest.mark.parametrize("shape", [(320, 40, 48, 128, 240), (96, 8, 48, 96, 312)])
def test_gwc_plan_module_path_shapes(dev, shape):
    """The plan at the ACV and IGEV module paths' shapes: the 16-byte form,
    three steps of 8 disparities an item, blocks of 128 covering every
    item, at least one block an SM, no shared memory."""
    c, g, d, h, w = shape
    p = kg.gwc_plan(1, c, h, w, g, d, torch.bfloat16, dev)
    assert (p["tw"], p["ds"], p["vec"], p["threads"], p["smem_bytes"]) == (8, 24, 1, 128, 0)
    assert p["items"] == g * h * (w // 8) * (d // 24)
    assert p["blocks"] == -(-p["items"] // 128) and p["blocks_per_sm"] >= 1


def test_prefetch_to_device_on_the_card(dev):
    """``data/loader.py`` on a CUDA device: batches come over from pinned
    memory on a side stream, land on the card equal to the host arrays
    after the consumer's stream has waited for them; file names pass
    through."""
    import numpy as np

    from diffuvolume_tpu_torch.data.loader import prefetch_to_device

    g = np.random.default_rng(40)
    batches = [{"left": g.standard_normal((2, 16, 24, 3)).astype(np.float32),
                "disp_gt": g.uniform(0, 9, (2, 16, 24)).astype(np.float32),
                "filenames": [f"a{i}", f"b{i}"]} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), device=dev, size=2))
    assert len(got) == 5
    for m, b in zip(got, batches):
        assert m["filenames"] == b["filenames"]
        for k in ("left", "disp_gt"):
            assert m[k].device == dev
            assert torch.equal(m[k].cpu(), torch.from_numpy(b[k]))


def test_metrics_on_the_card_match_the_cpu(dev):
    """``eval/metrics.py`` on the card against the CPU on the same tensors:
    the float64 masked sums give the same float32 means."""
    from diffuvolume_tpu_torch.eval.metrics import metrics_batch

    gen = torch.Generator().manual_seed(41)
    gt = torch.rand((2, 96, 160), generator=gen) * 90
    est = gt + torch.randn((2, 96, 160), generator=gen) * 40
    mask = (gt > 5) & (gt < 85)
    cpu = metrics_batch(est, gt, mask)
    card = metrics_batch(est.to(dev), gt.to(dev), mask.to(dev))
    for k, v in cpu.items():
        assert torch.allclose(card[k].cpu(), v, rtol=0, atol=1e-5), k


# -- training: the kernels refuse what they cannot differentiate -----------------

def _refusal_calls(dev):
    """Every counted wrapper on float32 CUDA inputs of a shape it takes;
    ``call(track)`` passes its first tensor through ``track``."""
    from diffuvolume_tpu_torch.ops.kernels import conv2d as k2

    def r(*shape):
        return _randn(dev, *shape, seed=sum(shape)) * 0.1

    def conv(fn, cin, cout, k=3, dhw=(4, 4, 8)):
        return lambda g: fn(g(r(1, *dhw, cin)), r(k, k, k, cin, cout), r(cout))

    dil = (1,) * 16
    return {
        "fused_upsample_softargmin": lambda g: kf.fused_upsample_softargmin(
            g(r(1, 4, 2, 3)), 8, (4, 6)),
        "fused_uncertainty_at": lambda g: kf.fused_uncertainty_at(g(r(1, 4, 2, 3)),
                                                                  r(1, 4, 6), 8, (4, 6)),
        "gwc_volume": lambda g: kg.gwc_volume(g(r(1, 8, 2, 8)), r(1, 8, 2, 8), 4, 4),
        "gwc_volume_packed": lambda g: kg.gwc_volume_packed(g(r(1, 80, 3, 37)),
                                                            r(1, 80, 3, 37), 12, 40, 48),
        "concat_volume": lambda g: kc.concat_volume(g(r(1, 4, 2, 8)), r(1, 4, 2, 8), 4),
        "dhw_mul": lambda g: kc.dhw_mul(g(r(1, 4, 4, 2, 8)), r(1, 4, 2, 8), r(1, 4, 2, 8)),
        "conv3d_fold_p": conv(kconv.conv3d_fold_p, 32, 32),
        "conv3d_fold_x2": conv(kconv.conv3d_fold_x2, 64, 32),
        "conv3d_fold_s2": conv(kconv.conv3d_fold_s2, 32, 64),
        "conv1x1_fold_p": conv(kconv.conv1x1_fold_p, 32, 32, k=1),
        "conv3d_fold_small": conv(kconv.conv3d_fold_small, 8, 8),
        "conv3d_packed": conv(kconv.conv3d_packed, 32, 32),
        "conv3d_fold_up": conv(kup.conv3d_fold_up, 32, 32, dhw=(2, 2, 4)),
        "pack": lambda g: kl.pack(g(r(1, 32, 4, 4, 8))),
        "unpack": lambda g: kl.unpack(g(r(1, 4, 4, 8, 32))),
        "unpack_hwdc": lambda g: kl.unpack_hwdc(g(r(1, 4, 4, 8, 16)), 8),
        "depthwise_hw_p": lambda g: kd.depthwise_hw_p(g(r(1, 4, 5, 7, 16)), r(3, 3, 16), dil),
        "depthwise_hw_p2": lambda g: kd.depthwise_hw_p2(g(r(1, 4, 5, 7, 16)), r(3, 3, 16), dil,
                                                        r(3, 3, 16), (2,) * 16),
        "conv2d_flat": lambda g: k2.conv2d_flat(g(r(1, 7, 9, 32)), r(3, 3, 32, 32), r(32)),
    }


def test_wrappers_refuse_inputs_that_require_grad(dev):
    """Each wrapper raises on a CUDA input that requires grad in grad mode,
    before it launches; under ``torch.no_grad`` the same call launches."""
    for name, call in _refusal_calls(dev).items():
        with pytest.raises(RuntimeError, match="no backward"):
            call(lambda t: t.requires_grad_())
        with torch.no_grad():
            call(lambda t: t.requires_grad_())
    torch.cuda.synchronize()


@pytest.mark.parametrize("model_name", ["acvnet_ddim", "pcwnet_ddim", "igev_ddim"])
def test_train_step_on_the_card_reaches_every_parameter(dev, model_name):
    """One training step of each recipe on the card: a finite loss, every
    trainable parameter with a finite gradient, no kernel launched."""
    from diffuvolume_tpu_torch.models import build_model
    from diffuvolume_tpu_torch.train.loop import (TrainState, make_igev_train_step,
                                                  make_optimizer, make_train_step)
    from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

    gen = torch.Generator().manual_seed(0)
    model = build_model(model_name, max_disp=64).init_weights(gen).to(dev).train()
    h, w = (64, 96) if model_name == "igev_ddim" else (64, 64)
    scale = 255.0 if model_name == "igev_ddim" else 0.3
    left = (torch.rand(1, h, w, 3, generator=gen) * scale).to(dev)
    batch = {"left": left, "right": torch.roll(left, -3, dims=2),
             "disp_gt": (torch.rand(1, h, w, generator=gen) * 60 + 1).to(dev)}
    step = (make_igev_train_step(model, iters=2) if model_name == "igev_ddim"
            else make_train_step(model, (0.5, 0.5, 0.5, 0.7, 1.0, 1.3) if model_name ==
                                 "pcwnet_ddim" else (0.5, 0.5, 0.7, 1.0)))
    counters = [f for f in (kf.fused_upsample_softargmin, kg.gwc_volume, kc.dhw_mul,
                            kconv.conv3d_fold_small, kg.gwc_volume_packed)]
    before = [f.launches for f in counters]
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    out = step(state, batch, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    assert torch.isfinite(out["loss"]) and [f.launches for f in counters] == before
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


# -- gwcnet-g: PCWNet without the concat volume -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,w", [(48, 96, 312), (24, 48, 156), (12, 24, 78), (6, 12, 39)])
def test_gwc_volume_packed_gwcnet_g(dev, dtype, d, h, w):
    """Row 16 at gwcnet-g's four scales of 384×1248: the 40 groups alone
    (``cc = 0``) in a 48-channel slot, float32 to 1e-5 relative, bf16 to one
    ulp; the fill zero."""
    left, right = (_randn(dev, 1, 320, h, w, seed=s).to(dtype) for s in (300, 301))
    got = kg.gwc_volume_packed(left, right, d, 40, mask_ref=True)
    want = plain.gwc_volume_slot(left, right, d, 40, 48, mask_ref=True)
    torch.cuda.synchronize()
    assert got.shape == (1, d, h, w, 48) and not got[..., 40:].any()
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rel, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,cout,shape,act", [
    ("conv3d_fold_x2", 32, (1, 48, 96, 312), "mish"),   # dres0_0 at 1/4
    ("conv3d_fold_p", 64, (1, 24, 48, 156), None),      # combine1's volume part at 1/8
    ("conv3d_fold_p", 128, (1, 12, 24, 78), None),      # combine2's at 1/16
    ("conv3d_fold_p", 128, (1, 6, 12, 39), None),       # combine3's at 1/32
])
def test_gwcnet_g_volume_convs(dev, dtype, fn, cout, shape, act):
    """Rows 6 and 5 at C_in 48 (40 data channels, the slot's fill zero in x
    and w) at gwcnet-g's shapes of 384×1248, against the plain version."""
    x, wt, bias = _conv_inputs(dev, dtype, shape, 48, cout, 3, seed=302)
    x[..., 40:] = 0
    wt[..., 40:, :] = 0
    bias = bias if fn == "conv3d_fold_x2" else None
    got = getattr(kconv, fn)(x, wt, bias, act=act)
    want = kconv.conv3d_fold_plain(x, wt, bias, 1, None, act)
    torch.cuda.synchronize()
    atol, rtol = CONV_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@torch.no_grad()
def test_gwcnet_g_folded_pair_matches_module_pair(dev):
    """gwcnet-g and ``pcwnet_ddim(use_concat_volume=False)`` at 64×64,
    float32: the folded pair against the module pair on the card (the same
    draws) within 1e-2 px on the baseline and 0.1 px max, 5e-3 px mean on
    the output; the folded pair launches row 16 8 times and row 6 twice."""
    from diffuvolume_tpu_torch.eval.pipeline import pcw_ddim_inference
    from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
    from diffuvolume_tpu_torch.tools.random_weights import calibrate_pcw, random_pcw_pair

    left = _randn(dev, 1, 64, 64, 3, seed=303) * 0.3
    right = torch.roll(left, -3, 2)
    bm, dm = (m.to(dev) for m in random_pcw_pair(192, torch.Generator().manual_seed(0),
                                                 use_concat_volume=False))
    calibrate_pcw(bm, left, right)
    dm.load_state_dict(bm.state_dict(), strict=False)
    out = {}
    for packed in (True, False):
        models = (fold_pcw(bm), fold_pcw(dm)) if packed else (bm, dm)
        before = kg.gwc_volume_packed.launches, kconv.conv3d_fold_x2.launches
        out[packed] = pcw_ddim_inference(*models, left, right, device=dev, packed=packed,
                                         generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        if packed:
            assert (kg.gwc_volume_packed.launches - before[0],
                    kconv.conv3d_fold_x2.launches - before[1]) == (8, 2)
    (ff, fb), (mf, mb) = out[True], out[False]
    assert torch.isfinite(ff).all() and ff.shape == (1, 64, 64)
    assert (fb - mb).abs().max() < 1e-2
    err = (ff - mf).abs()
    assert err.max() < 0.1 and err.mean() < 5e-3, (float(err.max()), float(err.mean()))
