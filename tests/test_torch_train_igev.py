"""IGEV-Stereo's training forward and KITTI15 step against the JAX
package's, on the CPU.

B=1, 64×96, max_disp 64 (the port's IGEV tests' size), 2 GRU iterations,
float64 on both sides as in ``test_torch_train_acv.py`` (whose helpers this
file uses).  The JAX package's GRU sums its convs' pieces in float32
(``update.py:_conv_over_pieces``, ``preferred_element_type``); here it sums
them in the inputs' dtype, the same convs.  Weights: ``random_igev``
calibrated by ``calibrate_igev``; the JAX step's draws injected.  The
forward is ``igev_forward(train=True)``: the encode's BatchNorms on batch
statistics, the rollout's upsampling BatchNorms frozen, every iterate
upsampled, the sequence loss over them and the initial disparity; the
optimiser is the recipe's ``clip_by_global_norm(1)`` + AdamW on the
one-cycle schedule.

The same step with the GEV's rows split over 2 gloo ranks (a 1 × 2 grid;
``tests/test_torch_volume_split.py``), run beside the JAX compile, holds
the slice as a whole: its loss against the unsplit port step's and the
JAX step's.

Compared (measured worst in brackets): the initial and every iterate's
upsampled disparity, max abs 1e-3 px [1.2e-10 and 4.8e-6]; the loss,
relative 1e-5 [8.2e-10]; every gradient, relative L2 per tensor 1e-4
[4.3e-6; the 38 conv biases before a training-mode BatchNorm have a
gradient that vanishes in exact arithmetic, under 1e-9 of the largest on
both sides]; the BatchNorm statistics after the step, 1e-6 [3.3e-8];
every parameter after one ``make_igev_train_step``, 1e-3 [2.1e-6].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffuvolume_tpu.models.igev.update as j_update
from diffuvolume_tpu.diffusion import make_schedule as j_schedule
from diffuvolume_tpu.diffusion import q_sample as j_q_sample
from diffuvolume_tpu.diffusion.codec import encode_disparity_volume as j_encode
from diffuvolume_tpu.models.igev.model import IGEVStereo as JIGEV
from diffuvolume_tpu.models.igev.model import igev_forward as j_igev_forward
from diffuvolume_tpu.ops.regression import resize_bilinear as j_resize
from diffuvolume_tpu.train import loss as jloss
from diffuvolume_tpu.train.lr import one_cycle_schedule as j_one_cycle
from diffuvolume_tpu_torch.diffusion import encode_disparity_volume, make_schedule, q_sample
from diffuvolume_tpu_torch.models.igev.model import IGEVStereo, igev_train_forward
from diffuvolume_tpu_torch.tools import weights
from diffuvolume_tpu_torch.tools.random_weights import calibrate_igev, random_igev
from diffuvolume_tpu_torch.train.loop import (
    TrainState,
    _quarter_gt,
    make_igev_train_step,
    make_optimizer,
)
from diffuvolume_tpu_torch.train.lr import one_cycle_schedule
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
from torch_parity import raw_pair, to_jax_variables

B, H, W, MD, ITERS = 1, 64, 96, 64, 2
LR, TOTAL, WDECAY = 2e-4, 50, 1e-5
BINS = MD // 4


def _pieces_in_dtype(kernel, pieces, dt):
    """``update._conv_over_pieces`` with the cross-piece sum in ``dt``."""
    off, acc = 0, None
    for p in pieces:
        c = p.shape[-1]
        y = jax.lax.conv_general_dilated(
            p.astype(dt), kernel[:, :, off:off + c].astype(dt), (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=dt)
        acc = y if acc is None else acc + y
        off += c
    return acc


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    left, right = raw_pair(0, B, H, W)
    src = random_igev(MD, True, torch.Generator().manual_seed(4))
    calibrate_igev(src, torch.from_numpy(left), torch.from_numpy(right))
    gt = sceneflow_gt(3, B, H, W, MD)
    valid = (gt > 0).astype(np.float64)
    t, eps = jax_step_draws(jax.random.PRNGKey(8), B, H, W, MD)
    batch = {"left": torch.from_numpy(left).double(), "right": torch.from_numpy(right).double(),
             "disp_gt": torch.from_numpy(gt).double()}
    tt, et = torch.from_numpy(t), torch.from_numpy(np.asarray(eps, np.float64))
    procs, split_out = start_split(tmp_path_factory, "igev", MD, ITERS, src, batch, tt, et)
    jmodel = JIGEV(max_disp=MD, diffusion=True, dtype=jnp.float64)
    lj, rj, gtj, epsj = f64(left, right, gt, eps)

    def loss_fn(params, bs):
        # make_igev_train_step's body (loop.py:219-247) with the draws given.
        disp_q = j_resize(jnp.clip(gtj, 0.0, 4.0 * (BINS - 1)), (H // 4, W // 4), 1, 2) / 4.0
        noisy = j_q_sample(j_schedule(1000), j_encode(disp_q, BINS, 1.0), t, epsj)
        init_up, ups, new_bs = j_igev_forward(
            jmodel, {"params": params, "batch_stats": bs}, lj, rj, iters=ITERS, noisy=noisy,
            t=t, train=True)
        return jloss.sequence_loss(ups, init_up, gtj, valid, max_disp=MD), (
            (init_up, ups), new_bs)

    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(j_one_cycle(LR, TOTAL), weight_decay=WDECAY, eps=1e-8))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_update, "_conv_over_pieces", _pieces_in_dtype)
        j = jax_reference(loss_fn, to_jax_variables(src), opt)

    def port_model():
        m = IGEVStereo(MD, True)
        m.load_state_dict(src.state_dict())
        return m.double().train()

    x_start = encode_disparity_volume(_quarter_gt(batch["disp_gt"], 4.0 * (BINS - 1)), BINS)
    noisy = q_sample(make_schedule(1000), x_start, tt, et)
    init_up, ups = igev_train_forward(port_model(), batch["left"], batch["right"], ITERS,
                                      noisy, tt)
    model = port_model()
    state = TrainState(model, make_optimizer(model, "adamw", WDECAY),
                       one_cycle_schedule(LR, TOTAL), grad_clip=1.0)
    out = make_igev_train_step(model, iters=ITERS)(state, batch, t=tt, noise=et)
    return dict(j=j, init_up=init_up.detach().numpy(), ups=ups.detach().numpy(), out=out,
                model=model, split=join_split(procs, split_out))


def test_disparities_match(run):
    (j_init, j_ups) = run["j"]["preds"]
    assert run["ups"].shape == (ITERS, B, H, W) == j_ups.shape
    np.testing.assert_allclose(run["init_up"], j_init, atol=HEAD_ATOL, rtol=0)
    np.testing.assert_allclose(run["ups"], j_ups, atol=HEAD_ATOL, rtol=0)
    np.testing.assert_allclose(run["out"]["pred"].numpy(), j_ups[-1], atol=HEAD_ATOL)


def test_loss_matches(run):
    assert float(run["out"]["loss"]) == pytest.approx(float(run["j"]["loss"]), rel=LOSS_RTOL)


def test_gradients_statistics_and_step_match(run):
    """The gradients, clipped to global norm 1 as optax clips them, the new
    statistics (the encode's; the rollout's frozen ones unchanged on both
    sides) and the parameters after the clipped AdamW step."""
    norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in jax.tree.leaves(run["j"]["grads"]))))
    scale = min(1.0, 1.0 / norm)
    worst = check_step(run["model"], weights.igev_rules(True), run["j"], LR, grad_scale=scale)
    assert worst["vanishing"] > 0


def test_split_step_matches_unsplit_and_jax(run):
    """The same step with the GEV's rows split over a 1 × 2 grid (8 of the
    16 rows at H/4 a rank), run beside the JAX step: its global loss
    against the unsplit port step's (relative 1e-10) and the JAX package's
    (``LOSS_RTOL``); its ranks' last iterates stacked against the unsplit
    step's."""
    check_split(run)
