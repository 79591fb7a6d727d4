"""Port parity: each ACV layer against its flax module, float32, CPU.

Flax weights come from the JAX package's own init, with every BatchNorm's
scale, bias and running statistics redrawn from a numpy seed so that BN is
not the identity; they reach the port through the rule tables of
``diffuvolume_tpu_torch/tools/weights.py``.  Tolerance: the largest absolute
difference at most 1e-5 (1e-4 for the deep feature trunk) of the largest
reference value — two float32 convolution libraries summing in different
orders.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from diffuvolume_tpu.models import layers as jl
from diffuvolume_tpu_torch.models import layers as tl
from diffuvolume_tpu_torch.tools import weights as tw
from torch_parity import nchw, nhwc

RNG = np.random.default_rng(23)


def _randomize_bn(params, stats):
    """Redraw BN scale/bias/mean/var in place (numpy trees)."""
    for k, v in params.items():
        if k == "bn":
            n = v["scale"].shape[0]
            v["scale"] = RNG.uniform(0.5, 1.5, n).astype(np.float32)
            v["bias"] = (RNG.standard_normal(n) * 0.1).astype(np.float32)
            stats["bn"] = {"mean": (RNG.standard_normal(n) * 0.1).astype(np.float32),
                           "var": RNG.uniform(0.5, 1.5, n).astype(np.float32)}
        elif isinstance(v, dict):
            _randomize_bn(v, stats.setdefault(k, {}))


def jax_init(module, *args, **kw):
    variables = jax.jit(functools.partial(module.init, **kw))(jax.random.PRNGKey(0), *args)
    variables = jax.tree.map(np.array, variables)
    variables.setdefault("batch_stats", {})
    _randomize_bn(variables["params"], variables["batch_stats"])
    return variables


def load(port: nn.Module, variables, rules_fn) -> nn.Module:
    """Load flax ``variables`` into ``port`` (strict) by the rules that
    ``rules_fn(torch_prefix, flax_prefix)`` builds for prefix "m"."""
    wrapped = {c: {"m": variables.get(c, {})} for c in ("params", "batch_stats")}
    sd = tw.state_dict_from_rules(wrapped, rules_fn("m", "m"))
    port.load_state_dict({k.removeprefix("m."): v for k, v in sd.items()})
    return port.eval()


def assert_close(got: torch.Tensor, want, rel: float = 1e-5):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_mish():
    x = RNG.standard_normal(1000).astype(np.float32) * 4
    np.testing.assert_allclose(tl.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.mish(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["2d_s2_relu", "2d_dilated", "3d", "3d_patch_grouped"])
def test_convbn(case):
    """ConvBN: stride, the torch padding rule under dilation, 3-D, and the
    (1,3,3) grouped dilated patch form."""
    if case == "2d_s2_relu":
        x = RNG.standard_normal((2, 11, 13, 5)).astype(np.float32)
        jm = jl.ConvBN(8, 3, 2, 1, act="relu")
        port = nn.Sequential(tl.ConvBN(5, 8, 3, 2, 1), nn.ReLU())
        rules = lambda tp, fn: tw._convbn(f"{tp}.0", fn)  # noqa: E731
    elif case == "2d_dilated":
        x = RNG.standard_normal((1, 12, 12, 6)).astype(np.float32)
        jm = jl.ConvBN(6, 3, 1, 2, 2)  # JAX takes the resolved padding
        port = tl.ConvBN(6, 6, 3, 1, 1, 2)  # the port applies the rule
        rules = tw._convbn
    elif case == "3d":
        x = RNG.standard_normal((1, 4, 6, 8, 5)).astype(np.float32)
        jm = jl.ConvBN(7, 3, 1, 1)
        port = tl.ConvBN(5, 7, 3, 1, 1, dims=3)
        rules = tw._convbn
    else:
        x = RNG.standard_normal((1, 3, 9, 10, 8)).astype(np.float32)
        jm = jl.ConvBN(8, (1, 3, 3), 1, (0, 3, 3), (1, 3, 3), groups=8)
        port = tl.ConvBN(8, 8, (1, 3, 3), 1, (0, 1, 1), (1, 3, 3), groups=8, dims=3)
        rules = tw._convbn
    v = jax_init(jm, jnp.asarray(x), train=False)
    load(port, v, rules)
    want = nchw(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        assert_close(port(nchw(x)), want)


def test_head_conv3d():
    x = RNG.standard_normal((1, 4, 5, 6, 8)).astype(np.float32)
    jm = jl.HeadConv3D()
    v = jax_init(jm, jnp.asarray(x))
    port = load(tl.HeadConv3D(8), v,
                lambda tp, fn: [(f"{tp}.weight", "params", f"{fn}/kernel", tw._conv)])
    with torch.no_grad():
        assert_close(port(nchw(x)), nchw(jm.apply(v, jnp.asarray(x))))


def test_conv_transpose_bn():
    """The flax kernel is stored flipped in conv orientation; the bridge
    un-flips it for nn.ConvTranspose3d."""
    x = RNG.standard_normal((1, 2, 3, 4, 8)).astype(np.float32)
    jm = jl.ConvTransposeBN(4, 3, 2, 1, 1)
    v = jax_init(jm, jnp.asarray(x), train=False)
    port = load(tl.ConvTransposeBN(8, 4), v, lambda tp, fn: (
        [(f"{tp}.0.weight", "params", f"{fn}/kernel", tw._deconv)] + tw._bn(f"{tp}.1", f"{fn}/bn")))
    with torch.no_grad():
        assert_close(port(nchw(x)), nchw(jm.apply(v, jnp.asarray(x), train=False)))


@pytest.mark.parametrize("stride,dilation,downsample", [(2, 1, True), (1, 2, False)])
def test_basic_block(stride, dilation, downsample):
    x = RNG.standard_normal((1, 12, 14, 8 if downsample else 16)).astype(np.float32)
    jm = jl.BasicBlock(16, stride, dilation, downsample)
    v = jax_init(jm, jnp.asarray(x), train=False)
    port = load(tl.BasicBlock(x.shape[-1], 16, stride, 1, dilation, downsample), v,
                lambda tp, fn: tw._basic_block(tp, fn, downsample))
    with torch.no_grad():
        assert_close(port(nchw(x)), nchw(jm.apply(v, jnp.asarray(x), train=False)))


@pytest.mark.parametrize("hw", [(4, 8), (6, 7)])
def test_attention_block(hw):
    """(6, 7) is padded to (8, 8): the −1000 pad mask is exercised."""
    x = RNG.standard_normal((1, 4, *hw, 32)).astype(np.float32)
    jm = jl.AttentionBlock3D(num_heads=16, block=(4, 4, 4))
    v = jax_init(jm, jnp.asarray(x))
    port = load(tl.AttentionBlock3D(32), v, lambda tp, fn: [
        (f"{tp}.qkv_3d.weight", "params", f"{fn}/qkv/kernel", tw._linear),
        (f"{tp}.qkv_3d.bias", "params", f"{fn}/qkv/bias", None),
        (f"{tp}.final1x1.weight", "params", f"{fn}/final1x1/kernel", tw._conv),
        (f"{tp}.final1x1.bias", "params", f"{fn}/final1x1/bias", None)])
    with torch.no_grad():
        assert_close(port(nchw(x)), nchw(jm.apply(v, jnp.asarray(x))))


def test_hourglass():
    """(D, H, W) = (16, 8, 12): the bottleneck (4, 2, 3) is padded in the
    attention block."""
    x = RNG.standard_normal((1, 16, 8, 12, 32)).astype(np.float32)
    jm = jl.HourglassACV(32)
    v = jax_init(jm, jnp.asarray(x), train=False)
    port = load(tl.HourglassACV(32), v, tw._hourglass)
    with torch.no_grad():
        assert_close(port(nchw(x)), nchw(jm.apply(v, jnp.asarray(x), train=False)))


def test_feature_extractor():
    x = RNG.standard_normal((1, 32, 48, 3)).astype(np.float32) * 0.3
    jm = jl.ACVFeatureExtractor()
    v = jax_init(jm, jnp.asarray(x), train=False)
    port = load(tl.ACVFeatureExtractor(), v, tw._feature_extractor)
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (1, 320, 8, 12)
    assert_close(got, nchw(jm.apply(v, jnp.asarray(x), train=False)), rel=1e-4)


def test_time_embedding_and_dynamic_head():
    """The sinusoid's argument reaches 999 rad, where one float32 ulp of the
    frequency (the two libraries' exp may differ by one) moves it by 6e-5:
    1e-4 absolute."""
    t = np.asarray([0, 17, 999], np.int32)
    np.testing.assert_allclose(
        tl.SinusoidalTimeEmbed(48)(torch.from_numpy(t)).numpy(),
        np.asarray(jl.SinusoidalTimeEmbed(48).apply({}, jnp.asarray(t))), rtol=0, atol=1e-4)
    noisy = RNG.standard_normal((3, 48, 2, 5)).astype(np.float32)
    jm = jl.DynamicHead(d_model=48)
    v = jax_init(jm, jnp.asarray(noisy), jnp.asarray(t))
    rules = lambda tp, fn: [  # noqa: E731
        r for tk, fk in (("time_mlp.1", "time1"), ("time_mlp.3", "time2"),
                         ("block_time_mlp.1", "block"))
        for r in ((f"{tp}.{tk}.weight", "params", f"{fn}/{fk}/kernel", tw._linear),
                  (f"{tp}.{tk}.bias", "params", f"{fn}/{fk}/bias", None))]
    port = load(tl.DynamicHead(48), v, rules)
    with torch.no_grad():
        got = port(torch.from_numpy(noisy), torch.from_numpy(t))
    assert_close(got, jm.apply(v, jnp.asarray(noisy), jnp.asarray(t)))


def test_nhwc_nchw_roundtrip():
    x = torch.from_numpy(RNG.standard_normal((1, 3, 4, 5, 6)).astype(np.float32))
    assert torch.equal(nchw(nhwc(x)), x)
