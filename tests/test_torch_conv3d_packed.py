"""Port parity for TPU row 15 (``conv3d_packed``) and the module paths routed
onto it (``models/layers.py:route_conv3d``), float32 on the CPU.

* ``conv3d_packed`` (its plain version on the CPU) against the Pallas
  ``conv3d_packed`` in interpret mode at the six shapes of
  ``tests/test_pallas_conv3d.py:24-43``, with and without ReLU: 1e-4
  absolute + 1e-4 relative, as that test holds the kernel against XLA.
* ``route_conv3d`` swaps exactly the convs that the JAX package's dispatch
  sends to ``conv3d_packed`` under ``DIFFU_PALLAS_CONV3D=1``: the JAX models
  are traced (``jax.eval_shape``) with that dispatch emulated and the calls
  recorded, the routed port models run and their calls recorded, on small
  ACV, PCW and IGEV models.  On the CPU the JAX package never takes its
  phase-decomposed transposed convs (TPU only), so the comparison covers
  exactly ``ConvBN`` and IGEV's ``BasicConv``, the sites the port routes.
* The routed ACV module path (two-pass DDIM-5 at 32×64) against the JAX
  ``acv_ddim_inference``: 0.1 px max and 5e-3 px mean on the output, 1e-2 px
  on the baseline (the bounds of ``tests/test_torch_pipeline.py``).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

import diffuvolume_tpu.models.layers as jlayers
import diffuvolume_tpu.ops.pallas.conv3d as jconv
from diffuvolume_tpu.diffusion import DDIMConfig as JDDIMConfig
from diffuvolume_tpu.eval.pipeline import _stages
from diffuvolume_tpu.models.acv import ACVNet as JACV
from diffuvolume_tpu.models.igev.model import IGEVStereo as JIGEV
from diffuvolume_tpu.models.pcw import PCWNet as JPCW
from diffuvolume_tpu_torch.diffusion import DDIMConfig
from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference
from diffuvolume_tpu_torch.models import layers
from diffuvolume_tpu_torch.models.igev.model import igev_encode
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import conv3d_fold_plain, conv3d_packed
from diffuvolume_tpu_torch.tools.random_weights import calibrate_heads, random_pair
from torch_parity import (
    igev_pair,
    jax_uniform_draws,
    pcw_pair,
    raw_pair,
    stereo_pair,
    to_jax_variables,
)

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("c,co,d,h,w", [
    (32, 32, 8, 16, 20),
    (64, 32, 8, 16, 20),
    (64, 64, 4, 16, 12),
    (128, 128, 2, 8, 12),
    (32, 32, 8, 13, 20),  # H not a multiple of the TPU kernel's tile
    (32, 16, 4, 8, 12),   # Co < C
])
@pytest.mark.parametrize("relu", [False, True])
def test_conv3d_packed_matches_pallas(c, co, d, h, w, relu):
    x = RNG.standard_normal((2, d, h, w, c)).astype(np.float32)
    k = RNG.standard_normal((3, 3, 3, c, co)).astype(np.float32) * 0.05
    b = RNG.standard_normal((co,)).astype(np.float32)
    want = np.asarray(jconv.conv3d_packed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                          relu=relu, tile_h=8, interpret=True))
    got = conv3d_packed(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                        act="relu" if relu else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_conv3d_packed_refuses_outside_its_contract():
    x = torch.zeros((1, 4, 3, 5, 24))
    with pytest.raises(ValueError, match="input channels"):
        conv3d_packed(x, torch.zeros((3, 3, 3, 24, 8)))
    with pytest.raises(ValueError, match="act"):
        conv3d_packed(torch.zeros((1, 4, 3, 5, 32)), torch.zeros((3, 3, 3, 32, 8)), act="mish")


def test_plan_keys_follow_the_kernels_plan():
    """The tile plans cross between C and Python as ints in
    ``hopper::Plan``'s field order (``csrc/conv_hopper.cuh``):
    ``_build.PLAN_KEYS`` names each of them, in that order; every plan entry
    point has a ctypes signature ending in the int array."""
    import re
    from pathlib import Path

    from diffuvolume_tpu_torch.ops.kernels import _build

    src = (Path(_build.CSRC) / "conv_hopper.cuh").read_text()
    body = re.search(r"struct Plan \{(.*?)\n\};", src, re.S).group(1)
    fields = [name for line in body.splitlines()
              for name in re.findall(r"(\w+)\s*[,;]", line.split("//")[0])]
    assert len(fields) == len(_build.PLAN_KEYS) == 15
    assert fields[:9] == ["bh", "bmw", "nth", "ntw", "ntn", "splits", "bn", "ck", "mt"]
    assert _build.PLAN_KEYS[:9] == tuple(fields[:9])
    for name in ("dv_conv3d_s1_plan", "dv_conv3d_s2_plan", "dv_conv3d_up_plan",
                 "dv_conv2d_flat_plan"):
        assert _build.PLAN_SIGNATURES[name][-1] is _build.ctypes.c_void_p
        assert f"DV_EXPORT int {name}(" in "".join(
            p.read_text() for p in Path(_build.CSRC).glob("*.cu"))


def _jax_routed(monkeypatch, fn) -> list:
    """Trace ``fn`` with the JAX dispatch of ``DIFFU_PALLAS_CONV3D=1`` on a
    TPU (C_in ≤ 16 on the v2 kernel, else v1 ``conv3d_packed``), both
    kernels replaced by the XLA conv; return the (C_in, C_out, D, H, W) of
    each ``conv3d_packed`` call."""
    calls = []

    def xla(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1, 1), [(1, 1)] * 3,
                                            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))

    def packed(x, k, bias=None, relu=False, tile_h=8, interpret=False):
        calls.append((x.shape[-1], k.shape[-1], *x.shape[1:4]))
        return xla(x, k)

    monkeypatch.setattr(jlayers, "_pallas_conv3d_version", lambda c_in=32: 2 if c_in <= 16 else 1)
    monkeypatch.setattr(jconv, "conv3d_packed", packed)
    monkeypatch.setattr(jconv, "conv3d_fold", lambda x, k, **kw: xla(x, k))
    jax.eval_shape(fn)
    return sorted(calls)


def _port_routed(monkeypatch, fn) -> list:
    """Run ``fn`` (a routed port model's forward) and return the same
    record of its ``conv3d_packed`` calls."""
    calls = []

    def spy(x, w, bias=None, act=None):
        calls.append((x.shape[-1], w.shape[-1], *x.shape[1:4]))
        return conv3d_packed(x, w, bias, act)

    monkeypatch.setattr(layers, "conv3d_packed", spy)
    with torch.no_grad():
        fn()
    return sorted(calls)


def _routed_copy(model):
    """A routed deep copy of ``model``; its state dict is unchanged."""
    before = {k: v.clone() for k, v in model.state_dict().items()}
    routed = layers.route_conv3d(copy.deepcopy(model))
    after = routed.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    return routed


@pytest.mark.parametrize("model", ["acv", "pcw", "igev"])
def test_route_conv3d_swaps_what_jax_routes(monkeypatch, model):
    """The routed shapes, call for call, as the JAX dispatch routes them."""
    if model == "acv":
        h, w, md = 32, 64, 64
        left, right = stereo_pair(0, 1, h, w)
        m = random_pair(md, torch.Generator().manual_seed(0))[0]
        jm, v = JACV(max_disp=md, diffusion=False), to_jax_variables(m)
        want = _jax_routed(monkeypatch, lambda: jm.apply(v, left, right, train=False))
        routed = _routed_copy(m)
        got = _port_routed(monkeypatch, lambda: routed(torch.from_numpy(left),
                                                       torch.from_numpy(right)))
    elif model == "pcw":
        h, w, md = 64, 64, 192
        left, right = stereo_pair(8, 1, h, w)
        m = pcw_pair(md, left, right, seed=4)[0]
        jm, v = JPCW(max_disp=md, diffusion=False), to_jax_variables(m)
        want = _jax_routed(monkeypatch, lambda: jm.apply(v, left, right, train=False))
        routed = _routed_copy(m)
        got = _port_routed(monkeypatch, lambda: routed(torch.from_numpy(left),
                                                       torch.from_numpy(right)))
    else:
        h, w, md = 64, 96, 64
        left, right = raw_pair(3, 1, h, w)
        m = igev_pair(md, left, right, seed=5)[0]
        jm, v = JIGEV(max_disp=md, diffusion=False), to_jax_variables(m)
        want = _jax_routed(monkeypatch, lambda: jm.apply(v, left, right, False,
                                                         method=JIGEV.encode))
        routed = _routed_copy(m)
        got = _port_routed(monkeypatch, lambda: igev_encode(routed, torch.from_numpy(left),
                                                            torch.from_numpy(right)))
    assert want and got == want
    assert not any(isinstance(c, layers.PackedConv3d) for c in m.modules())


def test_packed_conv_keeps_the_depth_rule_and_the_eligibility(monkeypatch):
    """A routed 32-channel conv runs ``conv3d_packed`` at D % 4 == 0 and the
    cuDNN conv elsewhere, with the same result; the ineligible convs (stride
    2, a bias, C_in 40, a bare conv outside ``ConvBN``) are left alone."""
    torch.manual_seed(0)
    with_bias = layers.convbn_3d(32, 32, 3, 1, 1)
    with_bias[0] = nn.Conv3d(32, 32, 3, 1, 1, bias=True)
    net = nn.Sequential(layers.convbn_3d(32, 32, 3, 1, 1), layers.convbn_3d(32, 32, 3, 2, 1),
                        with_bias, layers.convbn_3d(40, 32, 3, 1, 1),
                        nn.Conv3d(32, 32, 3, 1, 1, bias=False))
    plain = copy.deepcopy(net[0][0])
    layers.route_conv3d(net)
    assert [type(m[0]) if isinstance(m, layers.ConvBN) else type(m) for m in net] == [
        layers.PackedConv3d, nn.Conv3d, nn.Conv3d, nn.Conv3d, nn.Conv3d]
    conv = net[0][0].eval()
    calls = []
    monkeypatch.setattr(layers, "conv3d_packed",
                        lambda *a, **k: calls.append(1) or conv3d_packed(*a, **k))
    for d, routed in ((8, True), (6, False)):
        calls.clear()
        x = torch.randn((1, 32, d, 5, 7))
        got = conv(x)
        assert bool(calls) == routed
        torch.testing.assert_close(got, plain(x), rtol=1e-5, atol=1e-5)
        ref = conv3d_fold_plain(x.permute(0, 2, 3, 4, 1), conv.weight.permute(2, 3, 4, 1, 0))
        torch.testing.assert_close(got.permute(0, 2, 3, 4, 1), ref, rtol=1e-5, atol=1e-5)


def test_packed_weight_follows_the_parameter():
    """The kernel-order weight is remade when the parameter changes in
    place, so a routed model can load new weights."""
    conv = layers.route_conv3d(layers.convbn_3d(32, 32, 3, 1, 1))[0].eval()
    x = torch.randn((1, 32, 4, 3, 5))
    conv(x)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    torch.testing.assert_close(conv(x), nn.functional.conv3d(x, conv.weight, padding=1),
                               rtol=1e-5, atol=1e-5)


H, W, MD = 32, 64, 64


@pytest.fixture(scope="module")
def acv_run():
    left, right = stereo_pair(0, 1, H, W)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    bm, dm = random_pair(MD, torch.Generator().manual_seed(0))
    calibrate_heads(bm, lt, rt, target_std=10.0)
    dm.load_state_dict(bm.state_dict(), strict=False)
    jcfg = JDDIMConfig(max_disp=MD, num_bins=MD // 4)
    jb, jdm = JACV(max_disp=MD, diffusion=False), JACV(max_disp=MD, diffusion=True)
    prep, sample = _stages(jb, jdm, jcfg, True, True)
    key = jax.random.PRNGKey(3)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    jbase, jlat, jac = prep(bv, dv, left, right)
    jfinal = sample(dv, jac, jbase, jlat, key)
    return dict(left=left, right=right, bm=layers.route_conv3d(bm),
                dm=layers.route_conv3d(dm),
                ns=jax_uniform_draws(key, jcfg.sampling_steps, jlat.shape),
                jbase=np.asarray(jbase), jfinal=np.asarray(jfinal))


def test_routed_acv_module_path_matches_jax(acv_run, monkeypatch):
    r = acv_run
    calls = []
    monkeypatch.setattr(layers, "conv3d_packed",
                        lambda *a, **k: calls.append(1) or conv3d_packed(*a, **k))
    final, base = acv_ddim_inference(r["bm"], r["dm"], r["left"], r["right"],
                                     DDIMConfig(max_disp=MD, num_bins=MD // 4), device="cpu",
                                     noise_source=r["ns"], packed=False)
    # 2 attention chains × 4 and 6 aggregation passes × 9 routed convs
    assert len(calls) == 2 * 4 + 6 * 9
    final = final.numpy()
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    err = np.abs(final - r["jfinal"])
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())
    np.testing.assert_allclose(base.numpy(), r["jbase"], rtol=0, atol=1e-2)
