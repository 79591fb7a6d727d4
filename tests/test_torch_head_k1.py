"""Port parity for rows 1, 17 and 9, float32 on the CPU: each plain version
(what the wrappers run on a CPU tensor, and what the card's kernels are held
to) against the JAX package's Pallas kernel in interpret mode.

* ``fused_upsample_softargmin`` and ``fused_uncertainty_at`` at the paths'
  size ratios (4× on every axis as at ACV; PCW's align-corners ratio, where
  the D taps never repeat), both conventions, B = 2, W not a multiple of
  the 64 pixels a block of the card's kernel holds;
* ``conv1x1_fold_p`` at C 16 and 128 with W tails 39 and 78 and each
  activation, and IGEV's agg 1×1 over a concatenation as two launches, the
  second with the first as its residual and LeakyReLU, against the JAX
  package's two launches summed and LeakyReLU'd.

Tolerance 1e-4 absolute and relative (float32 summation order), as the JAX
package holds its Pallas heads and convs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.ops.pallas import conv3d as pc
from diffuvolume_tpu.ops.pallas.fused_head import fused_uncertainty_at as j_unc_at
from diffuvolume_tpu.ops.pallas.fused_head import fused_upsample_softargmin as j_head
from diffuvolume_tpu_torch.ops.kernels import conv3d_fold as kconv
from diffuvolume_tpu_torch.ops.kernels import fused_head as kf

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, D4, H4, W4) → (D, H, W), align_corners.  H is a multiple of the JAX
# kernel's 8-row tile; 12 → 48 bins keeps the paths' 4× (the taps repeat
# every 4 bins without align-corners, never with it: o·11/47 as PCW's
# o·47/191).
HEAD_CASES = [
    ((2, 12, 2, 25), (48, 8, 100), False),   # ACV's ratio, B = 2
    ((2, 12, 2, 25), (48, 8, 100), True),
    ((1, 12, 2, 26), (48, 8, 104), True),    # PCW's convention
    ((1, 12, 2, 26), (48, 8, 104), False),
]


def _cost(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0).astype(np.float32)


@pytest.mark.parametrize("cost_shape,out,align_corners", HEAD_CASES)
def test_fused_head_plain_matches_pallas(cost_shape, out, align_corners):
    d, h, w = out
    cost = _cost(sum(cost_shape), cost_shape)
    jd, ju = j_head(jnp.asarray(cost), d, (h, w), align_corners, interpret=True)
    td, tu = kf.fused_upsample_softargmin(torch.from_numpy(cost), d, (h, w), align_corners)
    assert td.shape == tu.shape == (cost_shape[0], h, w)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)


@pytest.mark.parametrize("cost_shape,out,align_corners", HEAD_CASES)
def test_fused_uncertainty_at_plain_matches_pallas(cost_shape, out, align_corners):
    d, h, w = out
    cost = _cost(sum(cost_shape) + 1, cost_shape)
    q = np.random.default_rng(w).uniform(0, d - 1, (cost_shape[0], h, w)).astype(np.float32)
    want = j_unc_at(jnp.asarray(cost), jnp.asarray(q), d, (h, w), align_corners=align_corners,
                    interpret=True)
    got = kf.fused_uncertainty_at(torch.from_numpy(cost), torch.from_numpy(q), d, (h, w),
                                  align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _conv1x1_pallas(x, k, b, act, tile_h=4):
    """The JAX package's row 9 on a plain (B, D, H, W, C) volume: packed,
    convolved, unpacked."""
    _, d, h, w, c = x.shape
    flags = {None: {}, "relu": dict(relu=True), "leaky": dict(leaky=kconv.LEAKY_SLOPE),
             "mish": dict(mish=True)}[act]
    out = pc.conv1x1_fold_p(pc.pack_padded(jnp.asarray(x), tile_h), jnp.asarray(k),
                            None if b is None else jnp.asarray(b), w_real=w, h_real=h,
                            tile_h=tile_h, interpret=True, **flags)
    return np.asarray(pc.unpack_padded(out, d, h, w, c, tile_h))


@pytest.mark.parametrize("act", [None, "relu", "leaky", "mish"])
@pytest.mark.parametrize("c,shape", [(16, (1, 8, 3, 39)), (128, (1, 2, 4, 78))])
def test_conv1x1_fold_p_plain_matches_pallas(act, c, shape):
    rng = np.random.default_rng(c + shape[-1])
    x = (rng.standard_normal((*shape, c)) * 3.0).astype(np.float32)
    k = (rng.standard_normal((1, 1, 1, c, c)) * 0.3).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    want = _conv1x1_pallas(x, k, b, act)
    got = kconv.conv1x1_fold_p(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                               act=act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("c,shape", [(16, (1, 8, 2, 78)), (32, (1, 4, 3, 39))])
def test_conv1x1_residual_leaky_matches_igev_agg(c, shape):
    """IGEV's agg1_0 (C 16) and agg0_0 (C 32): a 1×1 over concat(up, skip)
    as the skip half's conv, then the up half's with it as residual and
    LeakyReLU (the port), against the JAX package's two convs summed and
    LeakyReLU'd (``gev_packed.py``)."""
    rng = np.random.default_rng(c)
    up, skip = ((rng.standard_normal((*shape, c)) * 3.0).astype(np.float32) for _ in range(2))
    k = (rng.standard_normal((1, 1, 1, 2 * c, c)) * 0.3).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    y = _conv1x1_pallas(up, k[..., :c, :], b, None) + _conv1x1_pallas(skip, k[..., c:, :], None,
                                                                       None)
    want = np.where(y > 0.0, y, kconv.LEAKY_SLOPE * y)
    t = torch.from_numpy
    first = kconv.conv1x1_fold_p(t(skip), t(np.ascontiguousarray(k[..., c:, :])))
    got = kconv.conv1x1_fold_p(t(up), t(np.ascontiguousarray(k[..., :c, :])), t(b), act="leaky",
                               residual=first)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
