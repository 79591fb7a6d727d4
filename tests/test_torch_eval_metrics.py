"""The port's metrics, meters and input padder against the JAX package's.

The same numpy-seeded disparities, ground truths and masks go through
``diffuvolume_tpu/eval/metrics.py`` and ``diffuvolume_tpu_torch/eval/
metrics.py``: the masks and the per-image weight must be equal, the masked
means within 1e-6 relative (float32 sums in another order).  ``InputPadder``
must pad and unpad exactly as the JAX one does; ``AverageMeterDict`` must
give the JAX meter's means.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuvolume_tpu.eval import metrics as j_metrics
from diffuvolume_tpu.utils.meters import AverageMeter as JAverageMeter
from diffuvolume_tpu.utils.meters import AverageMeterDict as JAverageMeterDict
from diffuvolume_tpu.utils.padding import InputPadder as JInputPadder
from diffuvolume_tpu_torch.eval import metrics as t_metrics
from diffuvolume_tpu_torch.utils.meters import AverageMeter, AverageMeterDict
from diffuvolume_tpu_torch.utils.padding import InputPadder


def _case(seed: int, b: int = 3, h: int = 20, w: int = 28):
    """Estimates near a ground truth with errors across every threshold, a
    ground truth with invalid (0) pixels, a mask that leaves image 1 with
    under 10% coverage and image 2 empty."""
    g = np.random.default_rng(seed)
    gt = g.uniform(0.5, 80, (b, h, w)).astype(np.float32)
    gt[g.uniform(size=gt.shape) < 0.2] = 0.0
    est = (gt + g.normal(0, 3, gt.shape) * (g.uniform(size=gt.shape) < 0.6)).astype(np.float32)
    mask = (gt > 0) & (gt < 64)
    if b == 3:
        mask[1] &= g.uniform(size=(h, w)) < 0.08
        mask[2] = False
    return est, gt, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_batch_matches_jax(seed):
    est, gt, mask = _case(seed)
    got = t_metrics.metrics_batch(torch.from_numpy(est), torch.from_numpy(gt),
                                  torch.from_numpy(mask))
    want = j_metrics.metrics_batch(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["weight"].numpy(), np.asarray(want["weight"]))
    assert got["weight"].tolist() == [1.0, 0.0, 0.0]
    for k in ("EPE", "D1", "Thres1", "Thres2", "Thres3"):
        assert got[k].dtype == torch.float32 and got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
    assert float(got["EPE"][2]) == 0.0  # an empty mask averages to 0, not NaN


@pytest.mark.parametrize("thres", [0.5, 1.0, 3.0])
def test_single_metrics_match_jax(thres):
    """Each metric alone; the bad-pixel masks behind D1 and Thres are exact
    (their counts over a one-pixel mask are 0 or 1 per pixel)."""
    est, gt, mask = _case(5, b=1)
    t_args = [torch.from_numpy(a) for a in (est, gt, mask)]
    j_args = [jnp.asarray(a) for a in (est, gt, mask)]
    np.testing.assert_allclose(t_metrics.epe_metric(*t_args).numpy(),
                               np.asarray(j_metrics.epe_metric(*j_args)), rtol=1e-6)
    np.testing.assert_allclose(t_metrics.thres_metric(*t_args, thres).numpy(),
                               np.asarray(j_metrics.thres_metric(*j_args, thres)), rtol=1e-6)
    for y, x in zip(*np.nonzero(mask[0])):
        one = np.zeros_like(mask)
        one[0, y, x] = True
        t_one = [t_args[0], t_args[1], torch.from_numpy(one)]
        j_one = [j_args[0], j_args[1], jnp.asarray(one)]
        assert float(t_metrics.d1_metric(*t_one)[0]) == float(j_metrics.d1_metric(*j_one)[0])
        assert (float(t_metrics.thres_metric(*t_one, thres)[0])
                == float(j_metrics.thres_metric(*j_one, thres)[0]))


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(375, 1242), (64, 96), (33, 70)])
def test_input_padder_matches_jax(mode, hw):
    """Replicate padding to /32 and back, on (B, H, W, C) images and (B, H, W)
    disparities: equal to the JAX padder's arrays."""
    g = np.random.default_rng(hw[0])
    x = g.standard_normal((2, *hw, 3)).astype(np.float32)
    y = g.standard_normal((2, *hw, 3)).astype(np.float32)
    tp = InputPadder(x.shape, divis_by=32, mode=mode)
    jp = JInputPadder(x.shape, divis_by=32, mode=mode)
    got = tp.pad(torch.from_numpy(x), torch.from_numpy(y))
    want = jp.pad(jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.shape[1] % 32 == 0 and a.shape[2] % 32 == 0
    np.testing.assert_array_equal(tp.unpad(got[0]).numpy(), x)
    disp = got[0][..., 0]
    np.testing.assert_array_equal(tp.unpad(disp).numpy(), np.asarray(jp.unpad(want[0][..., 0])))


def test_average_meter_dict_matches_jax():
    """Means of scalars, lists and one-element tensors, with counts."""
    t, j = AverageMeterDict(), JAverageMeterDict()
    g = np.random.default_rng(9)
    for n in (1, 3, 2):
        vals = {"EPE": float(g.uniform()), "D1": [float(v) for v in g.uniform(size=3)]}
        t.update({"EPE": torch.tensor(vals["EPE"], dtype=torch.float64), "D1": vals["D1"]}, n)
        j.update(vals, n)
    got, want = t.mean(), j.mean()
    assert set(got) == set(want) and t.count == j.count == 6
    assert got["EPE"] == pytest.approx(want["EPE"], rel=1e-12)
    assert got["D1"] == pytest.approx(want["D1"], rel=1e-12)
    assert AverageMeterDict().mean() == {}
    m, jm = AverageMeter(), JAverageMeter()
    for v, n in ((2.0, 1), (torch.tensor(5.0), 3)):
        m.update(v, n)
        jm.update(float(v), n)
    assert m.mean() == jm.mean() == pytest.approx(4.25)
