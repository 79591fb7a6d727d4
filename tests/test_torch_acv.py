"""Port parity: ACVNet build / denoise / eval forward, and the weight bridge.

The port's seeded random-weight models (heads calibrated to logit std 3, so
a disparity comparison means something at random weights) are converted to
the JAX package's variables with its own ``convert_acv_state_dict``; both
sides run float32 on the CPU at 32×64, max_disp 64.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffuvolume_tpu.models.acv import ACVNet as JACV
from diffuvolume_tpu.ops.cost_volume import build_concat_volume
from diffuvolume_tpu.tools.convert_torch import convert_acv_state_dict
from diffuvolume_tpu_torch.models.acv import ACVNet, ConcatEntry
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume
from diffuvolume_tpu_torch.tools.random_weights import random_acv
from diffuvolume_tpu_torch.tools.weights import state_dict_from_jax
from torch_parity import calibrated_pair, nchw, nhwc, stereo_pair, to_jax_variables

H, W, MD = 32, 64, 64


@pytest.fixture(scope="module")
def setup():
    left, right = stereo_pair(0, 1, H, W)
    bm, dm = calibrated_pair(MD, left, right)
    jb, jdm = JACV(max_disp=MD, diffusion=False), JACV(max_disp=MD, diffusion=True)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    ac, attw = jax.jit(lambda v, l, r: jdm.apply(
        v, l, r, train=False, method=JACV.build_cost_volume))(dv, left, right)
    latent = np.random.default_rng(1).uniform(-1, 1, (1, MD // 4, H // 4, W // 4)).astype(np.float32)
    t = np.asarray([799], np.int32)
    jden = jax.jit(lambda v, a, l, tt: jdm.apply(v, a, l, tt, (H, W), method=JACV.denoise))(
        dv, ac, latent, t)
    jpred = jax.jit(lambda v, l, r: jb.apply(v, l, r, train=False))(bv, left, right)[0]
    return dict(left=left, right=right, bm=bm, dm=dm, ac=np.asarray(ac),
                att=np.asarray(jax.nn.softmax(attw[..., 0], axis=1)),
                latent=latent, t=t, jden=[np.asarray(x) for x in jden],
                jpred=np.asarray(jpred))


@torch.no_grad()
def test_build_cost_volume(setup):
    """Attention: 1e-4 absolute on probabilities; the attention-filtered
    volume: 1e-4 of its largest value (float32 through ~40 conv layers)."""
    s = setup
    cl, cr, att = s["dm"].build_cost_volume(torch.from_numpy(s["left"]), torch.from_numpy(s["right"]))
    assert cl.shape == (1, 32, H // 4, W // 4) and att.shape == (1, MD // 4, H // 4, W // 4)
    np.testing.assert_allclose(att.numpy(), s["att"], rtol=0, atol=1e-4)
    ac = nhwc(att[:, None] * concat_volume(cl, cr, MD // 4))
    assert np.abs(ac - s["ac"]).max() <= 1e-4 * np.abs(s["ac"]).max()


@torch.no_grad()
def test_denoise(setup):
    """One denoise step from the same latent and t.  Disparity and
    uncertainty: 2e-3 px absolute (the float32 rounding of two conv stacks,
    through a softmax of logits with std 3); the transformed latent is
    elementwise: 1e-6."""
    s = setup
    cl, cr, att = s["dm"].build_cost_volume(torch.from_numpy(s["left"]), torch.from_numpy(s["right"]))
    entry = ConcatEntry(concat_volume(cl, cr, MD // 4), att)
    disp, unc, tr = s["dm"].denoise(entry, torch.from_numpy(s["latent"]),
                                    torch.from_numpy(s["t"]), (H, W))
    jd_, ju, jt = s["jden"]
    np.testing.assert_allclose(disp.numpy(), jd_, rtol=0, atol=2e-3)
    np.testing.assert_allclose(unc.numpy(), ju, rtol=0, atol=2e-3)
    np.testing.assert_allclose(tr.numpy(), jt, rtol=0, atol=1e-6)


@torch.no_grad()
def test_baseline_eval_forward(setup):
    """The baseline's eval forward: 2e-3 px absolute, as denoise."""
    s = setup
    pred = s["bm"](torch.from_numpy(s["left"]), torch.from_numpy(s["right"]))
    assert len(pred) == 1 and pred[0].shape == (1, H, W)
    np.testing.assert_allclose(pred[0].numpy(), s["jpred"], rtol=0, atol=2e-3)


@pytest.mark.parametrize("diffusion", [False, True])
def test_weight_bridge_round_trip(diffusion):
    """Port state dict → the JAX package's convert_acv_state_dict (strict:
    every reference key used, none missing) → state_dict_from_jax: exact."""
    model = random_acv(MD, diffusion, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    variables = convert_acv_state_dict({k: v.numpy() for k, v in sd.items()}, diffusion)
    back = state_dict_from_jax(variables, diffusion)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    ACVNet(MD, diffusion).load_state_dict(back)  # strict


@pytest.mark.parametrize("diffusion", [False, True])
def test_weight_bridge_matches_flax_tree(diffusion):
    """The converted variables have exactly the flax model's tree and shapes
    (from an abstract init, no compute)."""
    jm = JACV(max_disp=MD, diffusion=diffusion)
    x = jnp.zeros((1, H, W, 3))
    args = (x, x)
    if diffusion:
        args += (jnp.zeros((1, H // 4, W // 4)), jnp.zeros((1,), jnp.int32),
                 jnp.zeros((1, MD // 4, H // 4, W // 4)))
    # The training forward touches every head, so init creates them all.
    shapes = jax.eval_shape(functools.partial(jm.init, train=True),
                            jax.random.PRNGKey(0), *args)
    model = random_acv(MD, diffusion, torch.Generator().manual_seed(4))
    got = convert_acv_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                 diffusion)
    want = jax.tree.map(lambda s: s.shape, {c: shapes[c] for c in ("params", "batch_stats")})
    assert jax.tree.map(np.shape, got) == want


def test_concat_entry_matches_jax_concat():
    """The prep's scan-invariant volume is the JAX builder's, transposed."""
    rng = np.random.default_rng(9)
    cl, cr = (rng.standard_normal((1, 8, 3, 10)).astype(np.float32) for _ in range(2))
    want = build_concat_volume(jnp.asarray(np.moveaxis(cl, 1, -1)),
                               jnp.asarray(np.moveaxis(cr, 1, -1)), 6)
    got = concat_volume(torch.from_numpy(cl), torch.from_numpy(cr), 6)
    np.testing.assert_array_equal(got.numpy(), nchw(want).numpy())
