"""PCWNet's training forward and KITTI12 step against the JAX package's,
on the CPU.

B=1, 64×64, max_disp 192 (the port's PCW tests' size), float64 on both sides
as in ``test_torch_train_acv.py`` (whose helpers this file uses).  Weights:
``random_pcw`` (trunk tamed) calibrated by ``calibrate_pcw``; the JAX step's
draws injected.  The six heads ``[pred0, comb_pred, pred1, pred2, pred3,
disp_finetune]`` with KITTI12's weights, the refinement included; Adam at
the milestone schedule's first rate.

The same step with the cost volume's rows split over 2 gloo ranks (a 1 × 2
grid; ``tests/test_torch_volume_split.py``), run beside the JAX compile,
holds the slice as a whole: its loss against the unsplit port step's and
the JAX step's.

Compared (measured worst in brackets): the heads, max abs 1e-3 px
[4.5e-5]; the loss, relative 1e-5 [5.4e-10]; every gradient, relative L2
per tensor 1e-4 [2.1e-6]; the BatchNorm statistics after the step, 1e-6
[3.2e-8]; every parameter after one ``make_train_step``, 1e-3 [5.5e-5].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuvolume_tpu.models.pcw import PCWNet as JPCW
from diffuvolume_tpu.ops.regression import resize_bilinear as j_resize
from diffuvolume_tpu.train import loss as jloss
from diffuvolume_tpu.train.lr import milestone_lr_schedule as j_milestones
from diffuvolume_tpu_torch.models.pcw import PCWNet
from diffuvolume_tpu_torch.tools import weights
from diffuvolume_tpu_torch.tools.random_weights import calibrate_pcw, random_pcw
from diffuvolume_tpu_torch.train.loop import (
    TrainState,
    _quarter_gt,
    make_optimizer,
    make_train_step,
)
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule
from test_torch_train_acv import (
    HEAD_ATOL,
    LOSS_RTOL,
    check_step,
    f64,
    jax_reference,
    jax_step_draws,
    one_thread,  # noqa: F401 (autouse)
    sceneflow_gt,
)
from test_torch_volume_split import check_split, join_split, start_split
from torch_parity import stereo_pair, to_jax_variables

B, H, W, MD = 1, 64, 64, 192
LR, LREPOCHS = 1e-3, "200:10"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    left, right = stereo_pair(0, B, H, W)
    src = random_pcw(MD, True, torch.Generator().manual_seed(3))
    calibrate_pcw(src, torch.from_numpy(left), torch.from_numpy(right))
    gt = sceneflow_gt(2, B, H, W, MD)
    mask = (gt < MD) & (gt > 0)
    t, noise = jax_step_draws(jax.random.PRNGKey(6), B, H, W, MD)
    disp_q = np.asarray(j_resize(jnp.clip(gt, 0.0, MD - 1), (H // 4, W // 4), 1, 2)) / 4.0
    batch = {"left": torch.from_numpy(left).double(), "right": torch.from_numpy(right).double(),
             "disp_gt": torch.from_numpy(gt).double()}
    tt, nt = torch.from_numpy(t), torch.from_numpy(np.asarray(noise, np.float64))
    procs, split_out = start_split(tmp_path_factory, "pcw", MD, None, src, batch, tt, nt)
    jmodel = JPCW(max_disp=MD, diffusion=True, dtype=jnp.float64)
    args = f64(left, right, disp_q) + [t, np.asarray(noise, np.float64)]

    def loss_fn(params, bs):
        preds, upd = jmodel.apply({"params": params, "batch_stats": bs}, *args, train=True,
                                  mutable=["batch_stats"])
        return jloss.multi_scale_loss(preds, *f64(gt), mask, jloss.KITTI12_WEIGHTS), (
            preds, upd["batch_stats"])

    j = jax_reference(loss_fn, to_jax_variables(src),
                      optax.adam(j_milestones(LR, LREPOCHS, 1)))

    def port_model():
        m = PCWNet(MD, True)
        m.load_state_dict(src.state_dict())
        return m.double().train()

    heads = port_model().train_forward(batch["left"], batch["right"],
                                       _quarter_gt(batch["disp_gt"], MD - 1), tt, nt)
    model = port_model()
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(LR, LREPOCHS, 1))
    out = make_train_step(model, jloss.KITTI12_WEIGHTS)(state, batch, t=tt, noise=nt)
    return dict(j=j, heads=[h.detach().numpy() for h in heads], out=out, model=model,
                split=join_split(procs, split_out))


def test_six_heads_match(run):
    assert len(run["heads"]) == len(run["j"]["preds"]) == 6
    for got, want in zip(run["heads"], run["j"]["preds"]):
        assert got.shape == (B, H, W)
        np.testing.assert_allclose(got, want, atol=HEAD_ATOL, rtol=0)


def test_loss_matches(run):
    assert float(run["out"]["loss"]) == pytest.approx(float(run["j"]["loss"]), rel=LOSS_RTOL)


def test_gradients_statistics_and_step_match(run):
    check_step(run["model"], weights.pcw_rules(True), run["j"], LR)


def test_split_step_matches_unsplit_and_jax(run):
    """The same step with the cost volume split over a 1 × 2 grid (8 of the
    16 rows at H/4 a rank), run beside the JAX step: its global loss
    against the unsplit port step's (relative 1e-10) and the JAX package's
    (``LOSS_RTOL``); its ranks' heads stacked against the unsplit step's."""
    check_split(run)
