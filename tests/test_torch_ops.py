"""Port parity: regression and cost-volume ops, and each kernel module's
plain version (what its wrapper runs on a CPU tensor) against the JAX
package's Pallas kernel in interpret mode.  float32 throughout."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.ops import cost_volume as jcv
from diffuvolume_tpu.ops import regression as jreg
from diffuvolume_tpu.ops.pallas.fused_head import fused_upsample_softargmin as j_head
from diffuvolume_tpu.ops.pallas.gwc_volume import gwc_volume_pallas
from diffuvolume_tpu_torch.ops import cost_volume as tcv
from diffuvolume_tpu_torch.ops import regression as treg
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume, dhw_mul
from diffuvolume_tpu_torch.ops.kernels.fused_head import fused_upsample_softargmin
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume
from torch_parity import nchw, nhwc

RNG = np.random.default_rng(17)


def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


# ---- regression ----

@pytest.mark.parametrize("in_size,out_size,ac", [
    (12, 48, False), (12, 48, True), (7, 7, False), (48, 12, False), (5, 1, True)])
def test_interp_matrix_matches(in_size, out_size, ac):
    """Same float64 construction, cast once: identical."""
    np.testing.assert_array_equal(treg._interp_matrix(in_size, out_size, ac),
                                  jreg._interp_matrix(in_size, out_size, ac))


@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample_regress_uncertainty_match(align_corners):
    """Matrix resizes + softmax + the two expectations in float32: 1e-4
    absolute/relative, the JAX package's own head tolerance."""
    cost = _randn(2, 8, 4, 6)
    jd_, jp = jreg.upsample_cost_and_regress(jnp.asarray(cost), 32, (16, 24), align_corners)
    ju = jreg.disparity_uncertainty(jp, jd_, 32)
    td_, tp = treg.upsample_cost_and_regress(torch.from_numpy(cost), 32, (16, 24), align_corners)
    tu = treg.disparity_uncertainty(tp, td_, 32)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(td_.numpy(), np.asarray(jd_), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-4)


def test_resize_bilinear_matches():
    """Two matrix products in float32: 1e-6."""
    x = _randn(2, 9, 13)
    j = jreg.resize_bilinear(jnp.asarray(x), (4, 5), 1, 2)
    t = treg.resize_bilinear(torch.from_numpy(x), (4, 5), 1, 2)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


# ---- cost volumes ----

@pytest.mark.parametrize("d", [6, 20])
def test_gwc_volume_plain_matches(d):
    """Products and a group mean in float32: 1e-5 relative, as the JAX
    package holds its own gwc kernel; d=20 > W covers all-zero planes."""
    left, right = _randn(2, 16, 3, 12), _randn(2, 16, 3, 12)  # NCHW
    j = jcv.build_gwc_volume(jnp.asarray(nhwc(torch.from_numpy(left))),
                             jnp.asarray(nhwc(torch.from_numpy(right))), d, 4)
    t = tcv.build_gwc_volume(torch.from_numpy(left), torch.from_numpy(right), d, 4)
    np.testing.assert_allclose(t.numpy(), nchw(j).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask_ref", [False, True])
def test_concat_volume_plain_matches(mask_ref):
    """Copies and zeros only: exact."""
    left, right = _randn(1, 4, 3, 9), _randn(1, 4, 3, 9)
    j = jcv.build_concat_volume(jnp.asarray(np.moveaxis(left, 1, -1)),
                                jnp.asarray(np.moveaxis(right, 1, -1)), 12, mask_ref)
    t = tcv.build_concat_volume(torch.from_numpy(left), torch.from_numpy(right), 12, mask_ref)
    np.testing.assert_array_equal(t.numpy(), nchw(j).numpy())


# ---- kernel modules' plain versions against the JAX kernels ----

@pytest.mark.parametrize("align_corners", [False, True])
def test_fused_head_plain_matches_pallas(align_corners):
    """The head at 1e-4 absolute/relative, the tolerance
    tests/test_pallas_head.py holds the Pallas kernel to."""
    cost = _randn(2, 12, 4, 8)
    jd_, ju = j_head(jnp.asarray(cost), 48, (16, 32), align_corners, interpret=True)
    td_, tu = fused_upsample_softargmin(torch.from_numpy(cost), 48, (16, 32), align_corners)
    np.testing.assert_allclose(td_.numpy(), np.asarray(jd_), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-4)


def test_fused_head_identity_size():
    """in_size == out_size on every axis: the head is a plain softmax
    read-out of the logits."""
    cost = _randn(1, 8, 4, 6)
    disp, unc = fused_upsample_softargmin(torch.from_numpy(cost), 8, (4, 6))
    p = torch.softmax(torch.from_numpy(cost), dim=1)
    d = torch.arange(8.0)[None, :, None, None]
    want = (p * d).sum(1)
    np.testing.assert_allclose(disp.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(unc.numpy(), (p * (d - want[:, None]).abs()).sum(1).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_gwc_plain_matches_pallas():
    """1e-5 relative, as tests/test_pallas_gwc.py."""
    left, right = _randn(1, 32, 4, 16), _randn(1, 32, 4, 16)
    j = gwc_volume_pallas(jnp.asarray(np.moveaxis(left, 1, -1)),
                          jnp.asarray(np.moveaxis(right, 1, -1)), 8, 4, interpret=True)
    t = gwc_volume(torch.from_numpy(left), torch.from_numpy(right), 8, 4)
    np.testing.assert_allclose(t.numpy(), nchw(j).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_noise", [False, True])
def test_concat_and_mul_plain_match_oracle(with_noise):
    """Against ``att·noise·build_concat_volume``, the oracle pack_concat_k is
    held to: without noise the baseline's ``concat_volume(cl, cr, D, att)``,
    with noise the DDIM step's ``dhw_mul(concat_volume(cl, cr, D), att,
    noise)``.  One float32 product per element, taken in a different order
    in the oracle, so 1 ulp: 1e-6 relative.  The scan-invariant volume is a
    copy: exact."""
    b, c, d, h, w = 1, 4, 10, 3, 7
    cl, cr = _randn(b, c, h, w), _randn(b, c, h, w)
    att = np.array(jax.nn.softmax(jnp.asarray(_randn(b, d, h, w)), axis=1))
    noise = RNG.uniform(size=(b, d, h, w)).astype(np.float32)
    m = att * noise if with_noise else att
    vol = jcv.build_concat_volume(jnp.asarray(np.moveaxis(cl, 1, -1)),
                                  jnp.asarray(np.moveaxis(cr, 1, -1)), d)
    want = nchw(jnp.asarray(m)[..., None] * vol).numpy()
    tcl, tcr, tatt = torch.from_numpy(cl), torch.from_numpy(cr), torch.from_numpy(att)
    scan_inv = concat_volume(tcl, tcr, d)
    np.testing.assert_array_equal(scan_inv.numpy(), nchw(vol).numpy())
    if with_noise:
        got = dhw_mul(scan_inv, tatt, torch.from_numpy(noise))
    else:
        got = concat_volume(tcl, tcr, d, tatt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kernel", ["fused_head", "gwc", "concat", "dhw_mul"])
def test_wrappers_take_only_cpu_or_cuda(kernel):
    """A tensor on neither the CPU nor a CUDA device is refused before any
    build or launch: the plain version serves only the CPU."""
    x = torch.empty((1, 8, 2, 3), device="meta")
    calls = {
        "fused_head": lambda: fused_upsample_softargmin(x, 8, (4, 6)),
        "gwc": lambda: gwc_volume(x, x, 2, 4),
        "concat": lambda: concat_volume(x, x, 2),
        "dhw_mul": lambda: dhw_mul(torch.empty((1, 8, 2, 2, 3), device="meta"),
                                   *[torch.empty((1, 2, 2, 3), device="meta")] * 2),
    }
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[kernel]()
