"""The port's training pieces against the JAX package's, on the CPU.

* ``train/loss.py``: ``smooth_l1``, ``multi_scale_loss`` with each recipe's
  weights and ``sequence_loss`` on seeded numpy inputs (relative 1e-6;
  measured worst 3.5e-7, ``sequence_loss`` and ``smooth_l1`` exact).
* ``train/lr.py``: both schedules against optax's at every step of a short
  run (relative 1e-6; measured 4.8e-8, optax's milestones being float32).
* ``train/loop.py``: three Adam steps (SceneFlow, KITTI12) and three
  clip + AdamW steps (KITTI15) against ``optax.adam`` / ``optax.chain(
  clip_by_global_norm, adamw)`` on a toy parameter set, the clip both
  binding and not (relative 1e-6 on the parameters; measured 1.7e-7).
* ``models/layers.py``: the BatchNorm's training-mode update against
  ``flax.linen.BatchNorm(momentum 0.9, epsilon 1e-5)`` — the running
  variance is updated with the biased batch variance (PyTorch's own
  ``nn.BatchNorm`` takes the unbiased one, n/(n−1) larger: 40/39 on the
  2-D batch) — and its output (relative 1e-5; measured 2.5e-7).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuvolume_tpu.train import loss as jloss
from diffuvolume_tpu.train import lr as jlr
from diffuvolume_tpu_torch.models.layers import BatchNorm2d, BatchNorm3d
from diffuvolume_tpu_torch.train import loss as tloss
from diffuvolume_tpu_torch.train import lr as tlr
from diffuvolume_tpu_torch.train.loop import TrainState, apply_gradients, make_optimizer

RTOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_smooth_l1():
    g = np.random.default_rng(0)
    p, t = g.normal(0, 2, (3, 8, 9)).astype(np.float32), g.normal(0, 2, (3, 8, 9)).astype(np.float32)
    want = np.asarray(jloss.smooth_l1(jnp.asarray(p), jnp.asarray(t)))
    got = tloss.smooth_l1(torch.from_numpy(p), torch.from_numpy(t)).numpy()
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("weights", [
    jloss.SCENEFLOW_WEIGHTS, jloss.SCENEFLOW_WEIGHTS_FREEZE_ATTN,
    jloss.SCENEFLOW_WEIGHTS_ATTN_ONLY, jloss.KITTI12_WEIGHTS,
])
@pytest.mark.parametrize("empty", [False, True], ids=["masked", "empty-mask"])
def test_multi_scale_loss(weights, empty):
    g = np.random.default_rng(len(weights))
    gt = g.uniform(0, 40, (2, 16, 24)).astype(np.float32)
    ests = [gt + g.normal(0, 3, gt.shape).astype(np.float32) for _ in weights]
    mask = np.zeros_like(gt, bool) if empty else (gt > 5) & (gt < 35)
    want = float(jloss.multi_scale_loss([jnp.asarray(e) for e in ests], jnp.asarray(gt),
                                        jnp.asarray(mask), weights))
    got = float(tloss.multi_scale_loss([torch.from_numpy(e) for e in ests],
                                       torch.from_numpy(gt), torch.from_numpy(mask), weights))
    assert got == want == 0.0 if empty else abs(got - want) <= RTOL * abs(want)
    assert tuple(weights) == {
        4: tloss.SCENEFLOW_WEIGHTS, 3: tloss.SCENEFLOW_WEIGHTS_FREEZE_ATTN,
        1: tloss.SCENEFLOW_WEIGHTS_ATTN_ONLY, 6: tloss.KITTI12_WEIGHTS}[len(weights)]


@pytest.mark.parametrize("n", [1, 3, 22])
def test_sequence_loss(n):
    g = np.random.default_rng(n)
    gt = g.uniform(-10, 220, (2, 16, 24)).astype(np.float32)
    valid = g.uniform(size=gt.shape).astype(np.float32)
    preds = gt + g.normal(0, 4, (n, *gt.shape)).astype(np.float32)
    init = gt + g.normal(0, 6, gt.shape).astype(np.float32)
    want = float(jloss.sequence_loss(jnp.asarray(preds), jnp.asarray(init), jnp.asarray(gt),
                                     jnp.asarray(valid), max_disp=192))
    got = float(tloss.sequence_loss(torch.from_numpy(preds), torch.from_numpy(init),
                                    torch.from_numpy(gt), torch.from_numpy(valid), max_disp=192))
    assert abs(got - want) <= RTOL * abs(want)


@pytest.mark.parametrize("lrepochs,per_epoch", [("16,24,32,40,48:2", 3), ("200:10", 1),
                                                ("3,1:4", 5)])
def test_milestone_schedule_matches_optax(lrepochs, per_epoch):
    want = jlr.milestone_lr_schedule(1e-3, lrepochs, per_epoch)
    got = tlr.milestone_lr_schedule(1e-3, lrepochs, per_epoch)
    steps = range(0, 60 * per_epoch + 3)
    assert max(_rel(got(s), float(want(s))) for s in steps) < RTOL


@pytest.mark.parametrize("total", [50, 400, 1234])
def test_one_cycle_schedule_matches_optax(total):
    want = jlr.one_cycle_schedule(2e-4, total)
    got = tlr.one_cycle_schedule(2e-4, total)
    assert max(_rel(got(s), float(want(s))) for s in range(0, total + 150)) < RTOL
    assert got(total + 100) == pytest.approx(2e-4 * 25 / 1e4)


def _toy(seed):
    g = np.random.default_rng(seed)
    return {"a": g.normal(0, 1, (4, 3)).astype(np.float32), "b": g.normal(0, 1, (5,)).astype(np.float32)}


@pytest.mark.parametrize("recipe,clip", [("adam", None), ("adamw", 0.5), ("adamw", 100.0)],
                         ids=["adam", "adamw-clipped", "adamw-unclipped"])
def test_optimizer_steps_match_optax(recipe, clip):
    """Three steps of the port's optimiser (rate from a schedule, clip as
    the KITTI15 recipe chains it) against optax on the same gradients."""
    params, wd = _toy(1), 1e-2
    schedule = tlr.milestone_lr_schedule(1e-2, "1,2:2", 1)
    jsched = jlr.milestone_lr_schedule(1e-2, "1,2:2", 1)
    opt = (optax.adam(jsched) if recipe == "adam" else
           optax.chain(optax.clip_by_global_norm(clip), optax.adamw(jsched, weight_decay=wd,
                                                                    eps=1e-8)))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    model = torch.nn.Module()
    for k, v in params.items():
        model.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    state = TrainState(model, make_optimizer(model, recipe, wd), schedule, clip)
    for step in range(3):
        grads = _toy(10 + step)
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in grads.items():
            getattr(model, k).grad = torch.from_numpy(v.copy())
        apply_gradients(state)
    assert state.step == 3
    for k in params:
        assert _rel(getattr(model, k).detach().numpy(), jp[k]) < RTOL, k


@pytest.mark.parametrize("cls,shape", [(BatchNorm2d, (2, 4, 5, 3)), (BatchNorm3d, (2, 3, 4, 5, 3))])
def test_batchnorm_update_matches_flax(cls, shape):
    """Two training-mode calls (as a trunk shared by both views makes) and
    one eval call against flax; the running variance is the biased one."""
    g = np.random.default_rng(2)
    c = shape[-1]
    xs = [g.normal(0.3, 1.7, shape).astype(np.float32) for _ in range(2)]
    bn_j = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = bn_j.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False)
    scale, bias = g.uniform(0.5, 1.5, c).astype(np.float32), g.normal(0, 0.1, c).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    bn_t = cls(c).train()
    with torch.no_grad():
        bn_t.weight.copy_(torch.from_numpy(scale))
        bn_t.bias.copy_(torch.from_numpy(bias))
    plain = (torch.nn.BatchNorm2d if cls is BatchNorm2d else torch.nn.BatchNorm3d)(c).train()
    for x in xs:
        y_j, upd = bn_j.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              use_running_average=False, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
        y_t = bn_t(xt)
        plain(xt)
        assert _rel(np.moveaxis(y_t.detach().numpy(), 1, -1), y_j) < 1e-5
    assert _rel(bn_t.running_mean.numpy(), stats["mean"]) < 1e-5
    assert _rel(bn_t.running_var.numpy(), stats["var"]) < 1e-5
    # PyTorch's own update takes the unbiased variance: n/(n-1) more of the
    # batch's share.
    assert _rel(plain.running_var.numpy(), stats["var"]) > 1e-3
    bn_t.eval()
    xt = torch.from_numpy(np.moveaxis(xs[0], -1, 1).copy())
    y_e = bn_j.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[0]),
                     use_running_average=True)
    assert _rel(np.moveaxis(bn_t(xt).detach().numpy(), 1, -1), y_e) < 1e-5


def test_batchnorm_keeps_reference_state_dict_names():
    assert set(BatchNorm3d(4).state_dict()) == {
        "weight", "bias", "running_mean", "running_var", "num_batches_tracked"}
