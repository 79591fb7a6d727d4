"""Port parity for the folded path as a whole, float32 on the CPU, 32×64,
max_disp 64: ``FoldedACV.build_cost_volume``, ``.denoise`` and the baseline
``.forward`` against the JAX package's module path (``ACVNet``), which the
JAX package's own test holds its packed path to within 2e-3
(``tests/test_pallas_conv3d.py``).

Weights: the port's seeded random models with drawn BatchNorm statistics
and calibrated heads, turned into the JAX package's variables by its
``convert_acv_state_dict`` and carried back into fresh port models by
``tools/weights.py`` before folding.
"""

import numpy as np
import jax
import pytest
import torch

from diffuvolume_tpu.models.acv import ACVNet as JACV
from diffuvolume_tpu_torch.models.acv import ACVNet, ConcatEntry
from diffuvolume_tpu_torch.models.acv_fold import fold_acv
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume
from diffuvolume_tpu_torch.tools.weights import state_dict_from_jax
from torch_parity import calibrated_pair, stereo_pair, to_jax_variables

H, W, MD = 32, 64, 64


def _port_from_jax(variables, diffusion: bool) -> ACVNet:
    model = ACVNet(MD, diffusion)
    model.load_state_dict(state_dict_from_jax(variables, diffusion))
    return model.eval()


@pytest.fixture(scope="module")
def setup():
    left, right = stereo_pair(2, 1, H, W)
    bm, dm = calibrated_pair(MD, left, right, seed=5)
    jb, jdm = JACV(max_disp=MD, diffusion=False), JACV(max_disp=MD, diffusion=True)
    bv, dv = to_jax_variables(bm), to_jax_variables(dm)
    rng = np.random.default_rng(4)
    vol = (rng.standard_normal((1, MD // 4, H // 4, W // 4, 64)) * 0.5).astype(np.float32)
    latent = rng.uniform(-1, 1, (1, MD // 4, H // 4, W // 4)).astype(np.float32)
    t = np.asarray([300], np.int32)
    ac, attw = jax.jit(lambda v, l, r: jdm.apply(
        v, l, r, train=False, method=JACV.build_cost_volume))(dv, left, right)
    jden = jax.jit(lambda v, a, l, tt: jdm.apply(v, a, l, tt, (H, W), method=JACV.denoise))(
        dv, vol, latent, t)
    jpred = jax.jit(lambda v, l, r: jb.apply(v, l, r, train=False))(bv, left, right)[0]
    return dict(left=torch.from_numpy(left), right=torch.from_numpy(right),
                fb=fold_acv(_port_from_jax(bv, False)), fd=fold_acv(_port_from_jax(dv, True)),
                vol=vol, latent=latent, t=t, ac=np.asarray(ac),
                att=np.asarray(jax.nn.softmax(attw[..., 0], axis=1)),
                jden=[np.asarray(x) for x in jden], jpred=np.asarray(jpred))


@torch.no_grad()
def test_folded_build_cost_volume(setup):
    """Attention 2e-3 absolute on probabilities; the attention-filtered
    volume within 1e-4 of its largest value (the JAX package's own bound
    for its packed build)."""
    s = setup
    cl, cr, att = s["fd"].build_cost_volume(s["left"], s["right"])
    np.testing.assert_allclose(att.numpy(), s["att"], rtol=0, atol=2e-3)
    ac = concat_volume(cl, cr, MD // 4, att, channels_last=True).numpy()
    assert np.abs(ac - s["ac"]).max() <= 1e-4 * np.abs(s["ac"]).max()


@torch.no_grad()
def test_folded_denoise(setup):
    """One denoise step on the same volume, latent and t: disparity,
    uncertainty and the transformed latent within 2e-3 (the ones map stands
    for the attention, which the JAX volume already carries)."""
    s = setup
    vol = torch.from_numpy(s["vol"])
    entry = ConcatEntry(vol, torch.ones(vol.shape[:4]))
    got = s["fd"].denoise(entry, torch.from_numpy(s["latent"]), torch.from_numpy(s["t"]),
                          (H, W))
    for name, a, b in zip(("disp", "unc", "noise"), got, s["jden"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3, atol=2e-3, err_msg=name)


@torch.no_grad()
def test_folded_baseline_forward(setup):
    """The baseline eval forward: 2e-3 px."""
    s = setup
    pred = s["fb"].forward(s["left"], s["right"])
    assert len(pred) == 1 and pred[0].shape == (1, H, W)
    np.testing.assert_allclose(pred[0].numpy(), s["jpred"], rtol=2e-3, atol=2e-3)
