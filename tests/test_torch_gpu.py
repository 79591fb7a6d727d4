"""Each CUDA kernel against its plain version on the card, at small shapes.

Marked ``gpu``; without a CUDA device every test skips (the card is looked
for inside the fixture, never at import).  On the card:
``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import pytest
import torch

from diffuvolume_tpu_torch.ops import cost_volume as plain
from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
from diffuvolume_tpu_torch.ops.kernels import fused_head as kf
from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

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
