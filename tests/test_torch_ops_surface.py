"""The rest of the JAX package's ``ops`` surface and its two factorised 3-D
conv layers against the port's namesakes, float32 on the CPU, on seeded
numpy inputs: 1e-5 (absolute and relative) unless a case says otherwise.

``ops/regression.py``: ``disparity_regression_nearby``,
``disparity_variance_confidence``, ``disparity_variance``;
``ops/cost_volume.py``: ``build_gwc_volume_norm`` (both norms),
``groupwise_correlation_4d``, ``build_gwc_volume_unfold``,
``build_gwc_volume_v1``, ``build_correlation_volume_ones``,
``patch_aggregation``; ``ops/sampling.py``: ``stereo_bilinear_sample``,
``grid_sample_2d`` (both paddings), ``coords_grid``, ``gauss_blur``,
``spatial_transformer``, ``spatial_transformer_grid``,
``forward_interpolate``; ``models/layers.py``: ``SeparableConvBN3d`` and
``DepthwiseConvBN3d`` with the JAX module's variables carried over by
``tools/weights.py``'s rules (eval, and train mode with the running
statistics after the step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuvolume_tpu.models import layers as jlayers
from diffuvolume_tpu.ops import cost_volume as jcv
from diffuvolume_tpu.ops import regression as jreg
from diffuvolume_tpu.ops import sampling as jsamp
from diffuvolume_tpu_torch.models import layers as tlayers
from diffuvolume_tpu_torch.ops import cost_volume as tcv
from diffuvolume_tpu_torch.ops import regression as treg
from diffuvolume_tpu_torch.ops import sampling as tsamp
from diffuvolume_tpu_torch.tools import weights

TOL = 1e-5
RNG = np.random.default_rng


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread: under the suite's parallel workers
    its default pool contends with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def both(*arrays):
    """Each numpy array as a (torch, jax) pair."""
    return [(torch.from_numpy(a), jnp.asarray(a)) for a in arrays]


def f32(rng, *shape, lo=None, hi=None):
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_disparity_regression_nearby():
    """Edge windows (the argmax at bin 0 and at D − 1) included."""
    rng = RNG(0)
    sim = f32(rng, 2, 12, 5, 7) * 3.0
    sim[0, 0, 0, 0] = sim[0, -1, 0, 1] = 50.0
    (ts, js), = both(sim)
    for step, half in ((1.0, 2), (0.5, 3)):
        close(treg.disparity_regression_nearby(ts, step, half),
              jreg.disparity_regression_nearby(js, step, half))


def test_disparity_variances():
    rng = RNG(1)
    logits = f32(rng, 2, 10, 4, 6)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    disp = f32(rng, 2, 4, 6, lo=0.0, hi=9.0)
    samples = f32(rng, 2, 10, 4, 6, lo=0.0, hi=9.0)
    (tp, jp), (td, jd), (tsm, jsm) = both(prob, disp, samples)
    close(treg.disparity_variance(tp, td, 10), jreg.disparity_variance(jp, jd, 10))
    close(treg.disparity_variance_confidence(tp, tsm, td),
          jreg.disparity_variance_confidence(jp, jsm, jd))


B, H, W, C, G, D = 2, 3, 12, 16, 4, 8


@pytest.mark.parametrize("name,kw", [
    ("build_gwc_volume_norm", {}), ("build_gwc_volume_norm", {"cosine": True}),
    ("build_gwc_volume_unfold", {}), ("build_gwc_volume_v1", {}),
    ("build_correlation_volume_ones", {})])
def test_gwc_variants(name, kw):
    """Channels-last ``(B, H, W, C)`` → ``(B, D, H, W, G)``; ``D`` past
    ``W / 2`` so the double stride's zero planes show."""
    rng = RNG(2)
    (tl, jl), (tr, jr) = both(f32(rng, B, H, W, C), f32(rng, B, H, W, C))
    got = getattr(tcv, name)(tl, tr, D, G, **kw)
    assert got.shape == (B, D, H, W, G)
    close(got, getattr(jcv, name)(jl, jr, D, G, **kw))


def test_groupwise_correlation_4d_and_patch_aggregation():
    rng = RNG(3)
    (t1, j1), (t2, j2) = both(f32(rng, B, D, H, W, C), f32(rng, B, D, H, W, C))
    close(tcv.groupwise_correlation_4d(t1, t2, G), jcv.groupwise_correlation_4d(j1, j2, G))
    (tv, jv), (tw, jw) = both(f32(rng, B, D, H, W, G), f32(rng, B, D, H, W, G))
    close(tcv.patch_aggregation(tv, tw), jcv.patch_aggregation(jv, jw))


def test_stereo_bilinear_sample():
    rng = RNG(4)
    (tv, jv), (tx, jx) = both(f32(rng, 30, 10, 3), f32(rng, 30, 7, lo=-2.0, hi=11.0))
    close(tsamp.stereo_bilinear_sample(tv, tx), jsamp.stereo_bilinear_sample(jv, jx))


@pytest.mark.parametrize("zero_pad", [True, False])
def test_grid_sample_2d(zero_pad):
    rng = RNG(5)
    (ti, ji), (tx, jx), (ty, jy) = both(f32(rng, B, 6, 9, 3), f32(rng, B, 4, 5, lo=-2.0, hi=10.0),
                                        f32(rng, B, 4, 5, lo=-2.0, hi=7.0))
    close(tsamp.grid_sample_2d(ti, tx, ty, zero_pad), jsamp.grid_sample_2d(ji, jx, jy, zero_pad))


def test_coords_grid_and_gauss_blur():
    close(tsamp.coords_grid(2, 5, 7), jsamp.coords_grid(2, 5, 7), 0.0)
    rng = RNG(6)
    (tx, jx), = both(f32(rng, B, 9, 11, 3))
    close(tsamp.gauss_blur(tx), jsamp.gauss_blur(jx))
    close(tsamp.gauss_blur(tx, 3, 0.7), jsamp.gauss_blur(jx, 3, 0.7))


@pytest.mark.parametrize("name", ["spatial_transformer", "spatial_transformer_grid"])
def test_spatial_transformers(name):
    """Samples past both edges of the scanline."""
    rng = RNG(7)
    (tl, jl), (tr, jr), (ts, js) = both(f32(rng, B, H, W, 5), f32(rng, B, H, W, 5),
                                        f32(rng, B, 4, H, W, lo=-3.0, hi=W + 3.0))
    warped, left = getattr(tsamp, name)(tl, tr, ts)
    jw, jleft = getattr(jsamp, name)(jl, jr, js)
    assert warped.shape == left.shape == (B, 4, H, W, 5)
    close(warped, jw)
    close(left, jleft, 0.0)


def test_forward_interpolate():
    flow = f32(RNG(8), 2, 9, 13, lo=-3.0, hi=3.0)
    got = tsamp.forward_interpolate(flow)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    close(got, jsamp.forward_interpolate(flow), 0.0)


@pytest.mark.parametrize("kind,kw", [
    ("separable", dict(kernel_size=3, stride=1, padding=1, use_bn=True, act="relu")),
    ("separable", dict(kernel_size=3, stride=2, padding=1, use_bn=False, act=None)),
    ("depthwise", dict(kernel_size=3, stride=1, padding=1, use_bn=True, act="mish")),
    ("depthwise", dict(kernel_size=3, stride=2, padding=1, use_bn=True, act="leaky_relu"))])
def test_factorised_conv_layers(kind, kw):
    """The JAX module's variables (BatchNorm statistics drawn away from
    their initial values) through ``tools/weights.py``'s rules: the eval
    output, and the train-mode output and running statistics after one
    call (flax's biased variance update)."""
    cin, cout = 8, 12
    jcls = jlayers.SeparableConvBN3d if kind == "separable" else jlayers.DepthwiseConvBN3d
    tcls = tlayers.SeparableConvBN3d if kind == "separable" else tlayers.DepthwiseConvBN3d
    rules_of = (weights.separable_convbn_3d_rules if kind == "separable"
                else weights.depthwise_convbn_3d_rules)
    rng = RNG(9)
    x = f32(rng, 2, 6, 7, 9, cin)
    jm = jcls(features=cout, **kw)
    variables = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if kw["use_bn"]:
        bs, p = variables["batch_stats"]["bn"], variables["params"]["bn"]
        bs["mean"] = f32(rng, cout) * 0.1
        bs["var"] = f32(rng, cout, lo=0.5, hi=1.5)
        p["scale"] = f32(rng, cout, lo=0.5, hi=1.5)
        p["bias"] = f32(rng, cout) * 0.1
    tm = tcls(cin, cout, **kw)
    nested = {coll: {"m": tree} for coll, tree in variables.items()}
    sd = weights.state_dict_from_rules(nested, rules_of("m", "m", kw["use_bn"]))
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = tm.eval()(tx).permute(0, 2, 3, 4, 1)
    close(got, jm.apply(variables, jnp.asarray(x), train=False), 1e-4)
    if not kw["use_bn"]:
        return
    want, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = tm.train()(tx).permute(0, 2, 3, 4, 1)
    close(got, want, 1e-4)
    close(tm[3 if kind == "separable" else 2].running_var, upd["batch_stats"]["bn"]["var"])
    close(tm[3 if kind == "separable" else 2].running_mean, upd["batch_stats"]["bn"]["mean"])
