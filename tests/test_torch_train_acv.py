"""ACVNet's training forward and step against the JAX package's, on the CPU.

Stages ``full``, ``attn_only`` and ``freeze_attn`` of the SceneFlow recipe
at B=2, 32×64, max_disp 64.  The weights are the port's seeded random
ACVNet, tamed as ``tests/test_torch_eval_cli.py`` tames it (each 2-D
residual branch's last BatchNorm weight × ``PCW_RESIDUAL_BN_SCALE``, the
heads calibrated to logit std 3), carried to the JAX package by its own
converter.  The timestep and the noise are the JAX step's draws
(``jax.random.split`` of one key), injected into the port.  Two JAX
compiles serve the three stages (``jax_stages``: the full model's
``value_and_grad``, from which ``freeze_attn``'s follows, and the
``attn_weights_only`` model's); the JAX package's step is each stage's
gradient through ``optax.adam`` at the schedule's first rate.  The gradients and the new
statistics cross back by ``tools/weights.py``'s rules (per-leaf transposes
and flips), so each port parameter's ``.grad`` meets its JAX leaf.

Both sides run in float64 (the JAX side under ``jax.enable_x64``): in
float32 the random network's training gradients sit on a floor of their
own, set where the BatchNorm backward of the hourglass's up-path
(``dres3.conv5``) cancels most of its input; each package's float32
gradient is then as far from the float64 one as the two float32 ones are
from each other.  Float64 shows the two agree in semantics; the constants
both keep in float32 (the diffusion schedule, the resize matrices) leave
the rest.  ``test_float32_step_is_within_its_floor`` holds the port's
float32 step to its float64 one (measured 4.7e-3).

Compared, per stage (measured worst over the three in brackets):
* the heads: max abs 1e-3 px [4.2e-5];
* the loss: relative 1e-5 [1.5e-9];
* every parameter's gradient: relative L2 per tensor 1e-4 [1.5e-6];
  ``freeze_attn``: none reaches the cost-volume branch, on either side;
  ``attn_only``: the 90 tensors the attention head does not reach are
  zero on both sides;
* the BatchNorm running statistics after the step: relative L2 1e-6
  [3.5e-8];
* every parameter after one ``make_train_step``: relative L2 1e-3
  [1.3e-4; Adam's first step is lr·g/|g| per element, so a gradient near 0
  moves the most].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuvolume_tpu.models.acv import ACVNet as JACV
from diffuvolume_tpu.ops.regression import resize_bilinear as j_resize
from diffuvolume_tpu.train import loss as jloss
from diffuvolume_tpu.train.lr import milestone_lr_schedule as j_milestones
from diffuvolume_tpu_torch.models.acv import ACVNet
from diffuvolume_tpu_torch.tools import weights
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_heads,
    random_acv,
    tame_residual_branches,
)
from diffuvolume_tpu_torch.train import loss as tloss
from diffuvolume_tpu_torch.train.loop import (
    TrainState,
    _quarter_gt,
    make_optimizer,
    make_train_step,
)
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule
from torch_parity import stereo_pair, to_jax_variables

B, H, W, MD = 2, 32, 64, 64
LR, LREPOCHS = 1e-3, "10:2"
STAGES = {
    "full": ({}, jloss.SCENEFLOW_WEIGHTS),
    "attn_only": ({"attn_weights_only": True}, jloss.SCENEFLOW_WEIGHTS_ATTN_ONLY),
    "freeze_attn": ({"freeze_attn_weights": True}, jloss.SCENEFLOW_WEIGHTS_FREEZE_ATTN),
}
# The cost-volume branch: what freeze_attn_weights stops the gradient of.
VOLUME_BRANCH = ("feature_extraction.", "concatconv.", "patch", "dres1_att_.", "dres2_att_.",
                 "classif_att_.")
HEAD_ATOL, LOSS_RTOL, GRAD_RTOL, STAT_RTOL, PARAM_RTOL = 1e-3, 1e-5, 1e-4, 1e-6, 1e-3
VANISH = 1e-9
# The float32 step against the float64 one (relative L2, worst gradient).
F32_FLOOR = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread for this file: under the suite's
    parallel workers its default pool contends with theirs, and the
    training steps here ran some 50× slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_step_draws(key, b, h, w, max_disp):
    """``make_train_step``'s draws from ``key``: one timestep for the batch,
    then the noise (``loop.py:95-97``)."""
    rng_t, rng_noise = jax.random.split(key)
    t = jnp.broadcast_to(jax.random.randint(rng_t, (1,), 0, 1000), (b,)).astype(jnp.int32)
    noise = jax.random.normal(rng_noise, (b, max_disp // 4, h // 4, w // 4))
    return np.array(t), np.array(noise)


def sceneflow_gt(seed, b, h, w, max_disp):
    """Ground truth in [0.5, max_disp + 8): a few pixels past ``max_disp``
    and a strip of zeros, which the mask leaves out."""
    gt = np.random.default_rng(seed).uniform(0.5, max_disp + 8, (b, h, w)).astype(np.float32)
    gt[:, :, :3] = 0.0
    return gt


def jax_reference(loss_fn, variables, opt) -> dict:
    """One compile, in float64 (under ``jax.enable_x64``):
    ``value_and_grad`` of ``loss_fn(params, batch_stats) → (loss, (preds,
    new_batch_stats))`` and ``opt``'s first update on the gradient, in one
    jitted function.  Returns numpy ``loss, preds, new_bs, grads,
    new_params``."""
    def step(params, bs):
        (loss, (preds, new_bs)), grads = jax.value_and_grad(
            lambda p: loss_fn(p, bs), has_aux=True)(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, preds, new_bs, grads, optax.apply_updates(params, updates)

    with jax.enable_x64(True):
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        out = jax.jit(step)(variables["params"], variables["batch_stats"])
        out = jax.tree.map(np.asarray, out)
    return dict(zip(("loss", "preds", "new_bs", "grads", "new_params"), out))


def f64(*arrays):
    return [np.asarray(a, np.float64) for a in arrays]


def check_step(model, rules, j, lr: float, grad_mask=None, grad_scale: float = 1.0) -> dict:
    """The port's model after one step against the JAX reference ``j``:
    gradients (the port's as the optimiser left them: times ``grad_scale``,
    a clip's), new running statistics and parameters (relative L2 per
    tensor).  ``grad_mask(name)`` False: both gradients must be zero.  A
    gradient that vanishes in exact arithmetic (a conv's bias before a
    training-mode BatchNorm, which takes the mean out) is rounding on both
    sides: both norms must be under ``VANISH`` of the largest, and the
    parameter may move by rounding only (under 1e-3·``lr`` apart).  Returns
    the worst of each and the count of vanishing gradients."""
    jgrads = weights.state_dict_from_rules({"params": j["grads"], "batch_stats": j["new_bs"]},
                                           rules)
    jafter = weights.state_dict_from_rules({"params": j["new_params"],
                                            "batch_stats": j["new_bs"]}, rules)
    params = dict(model.named_parameters())
    tiny = VANISH * grad_scale * max(float(np.linalg.norm(jgrads[n])) for n in params)
    worst = {"grad": 0.0, "stat": 0.0, "param": 0.0, "vanishing": 0}
    for name, p in params.items():
        g, jg = p.grad.detach().double().numpy(), jgrads[name].double().numpy() * grad_scale
        after, jafter_p = p.detach().double().numpy(), jafter[name].double().numpy()
        if grad_mask is not None and not grad_mask(name):
            assert not g.any() and not jg.any(), name
        elif np.linalg.norm(jg) <= tiny:
            assert np.linalg.norm(g) <= tiny, name
            assert np.abs(after - jafter_p).max() < 1e-3 * lr, name
            worst["vanishing"] += 1
            continue
        else:
            worst["grad"] = max(worst["grad"], rel_l2(g, jg))
        worst["param"] = max(worst["param"], rel_l2(after, jafter_p))
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            worst["stat"] = max(worst["stat"], rel_l2(v.numpy(), jafter[name]))
    assert worst["grad"] < GRAD_RTOL and worst["stat"] < STAT_RTOL, worst
    assert worst["param"] < PARAM_RTOL, worst
    return worst


@pytest.fixture(scope="module")
def inputs():
    left, right = stereo_pair(0, B, H, W)
    model = tame_residual_branches(random_acv(MD, True, torch.Generator().manual_seed(11)))
    calibrate_heads(model, torch.from_numpy(left), torch.from_numpy(right))
    gt = sceneflow_gt(1, B, H, W, MD)
    t, noise = jax_step_draws(jax.random.PRNGKey(5), B, H, W, MD)
    return dict(left=left, right=right, gt=gt, t=t, noise=noise,
                state=model.state_dict(), variables=to_jax_variables(model))


# The JAX package's top-level modules of the cost-volume branch.
J_VOLUME_BRANCH = ("feature_extraction", "concatconv0", "concatconv1", "patch", "patch_l1",
                   "patch_l2", "patch_l3", "dres1_att_0", "dres1_att_1", "dres2_att_",
                   "classif_att_0", "classif_att_1")


@pytest.fixture(scope="module")
def jax_stages(inputs):
    """The JAX package's three stages from two compiles (float64).  The full
    model's ``value_and_grad`` gives ``full`` and ``freeze_attn``:
    ``freeze_attn`` runs the same forward, its loss is the other heads'
    (weights 0.5, 0.7, 1.0) and ``stop_gradient`` zeroes the cost-volume
    branch's gradient and leaves every other one as the full loss's (the
    attention head reaches the branch only).  ``attn_only`` is the JAX
    model with ``attn_weights_only``.  Each stage's gradient then takes
    ``optax.adam``'s first step."""
    x = inputs
    gt, mask = x["gt"], (x["gt"] < MD) & (x["gt"] > 0)
    disp_q = np.asarray(j_resize(jnp.clip(gt, 0.0, MD - 1), (H // 4, W // 4), 1, 2)) / 4.0
    args = f64(x["left"], x["right"], disp_q) + [x["t"], np.asarray(x["noise"], np.float64)]
    gtj = f64(gt)[0]
    opt = optax.adam(j_milestones(LR, LREPOCHS, 1))

    def stage(kw, loss_weights):
        jmodel = JACV(max_disp=MD, diffusion=True, dtype=jnp.float64, **kw)

        def loss_fn(params, bs):
            preds, upd = jmodel.apply({"params": params, "batch_stats": bs}, *args, train=True,
                                      mutable=["batch_stats"])
            return jloss.multi_scale_loss(preds, gtj, mask, loss_weights), (
                preds, upd["batch_stats"])
        return loss_fn

    full = jax_reference(stage({}, jloss.SCENEFLOW_WEIGHTS), x["variables"], opt)
    attn = jax_reference(stage({"attn_weights_only": True}, (1.0,)), x["variables"], opt)
    frozen = {k: jax.tree.map(np.zeros_like, v) if k in J_VOLUME_BRANCH else v
              for k, v in full["grads"].items()}
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), x["variables"]["params"])
        new = jax.jit(lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]))(
            frozen, params)
        new = jax.tree.map(np.asarray, new)
    l_att = float(jloss.multi_scale_loss(full["preds"][:1], gtj, mask, (1.0,)))
    freeze = dict(loss=float(full["loss"]) - 0.5 * l_att, preds=full["preds"][1:],
                  new_bs=full["new_bs"], grads=frozen, new_params=new)
    return {"full": full, "attn_only": attn, "freeze_attn": freeze}


@pytest.fixture(scope="module", params=list(STAGES))
def run(request, inputs, jax_stages):
    stage = request.param
    kw, loss_weights = STAGES[stage]
    x = inputs
    j = jax_stages[stage]

    def port_model():
        m = ACVNet(MD, True, **kw)
        m.load_state_dict(x["state"])
        return m.double().train()

    batch = {k: torch.from_numpy(x[k]).double() for k in ("left", "right")}
    batch["disp_gt"] = torch.from_numpy(x["gt"]).double()
    t, noise = torch.from_numpy(x["t"]), torch.from_numpy(x["noise"]).double()
    heads_model = port_model()
    heads = heads_model.train_forward(batch["left"], batch["right"],
                                      _quarter_gt(batch["disp_gt"], MD - 1), t, noise)
    model = port_model()
    state = TrainState(model, make_optimizer(model, "adam"),
                       milestone_lr_schedule(LR, LREPOCHS, 1))
    out = make_train_step(model, loss_weights)(state, batch, t=t, noise=noise)
    return dict(stage=stage, j=j, heads=[h.detach().numpy() for h in heads], out=out,
                model=model, state=state)


def test_heads_match(run):
    assert len(run["heads"]) == len(run["j"]["preds"]) == len(STAGES[run["stage"]][1])
    for got, want in zip(run["heads"], run["j"]["preds"]):
        assert got.shape == (B, H, W)
        np.testing.assert_allclose(got, want, atol=HEAD_ATOL, rtol=0)
    np.testing.assert_allclose(run["out"]["pred"].numpy(), run["j"]["preds"][-1], atol=HEAD_ATOL)


def test_loss_matches(run):
    assert float(run["out"]["loss"]) == pytest.approx(float(run["j"]["loss"]), rel=LOSS_RTOL)


def test_gradients_statistics_and_step_match(run):
    """One ``make_train_step``: each gradient, the BatchNorm statistics and
    the parameters after Adam; with ``freeze_attn`` no gradient reaches the
    cost-volume branch on either side (its statistics are still updated)."""
    frozen = run["stage"] == "freeze_attn"
    mask = (lambda name: not name.startswith(VOLUME_BRANCH)) if frozen else None
    check_step(run["model"], weights.acv_rules(True), run["j"], LR, mask)
    assert run["state"].step == 1
    moved = [k for k, v in run["model"].state_dict().items()
             if k.startswith("feature_extraction.") and k.endswith("running_mean")
             and not torch.equal(v, torch.zeros_like(v))]
    assert moved  # statistics move in every stage, the frozen branch's too


def test_quarter_resolution_conditioning_matches_jax():
    """The step's ground-truth conditioning (clamp, bilinear ↓4, ÷4) is the
    JAX step's."""
    gt = sceneflow_gt(1, B, H, W, MD)
    want = np.asarray(j_resize(jnp.clip(gt, 0.0, MD - 1), (H // 4, W // 4), 1, 2)) / 4.0
    got = _quarter_gt(torch.from_numpy(gt), MD - 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_float32_step_is_within_its_floor(inputs):
    """The port's float32 step against its float64 step on the same weights
    and draws: every gradient within ``F32_FLOOR`` (relative L2; measured
    4.7e-3)."""
    x = inputs
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = ACVNet(MD, True)
        model.load_state_dict(x["state"])
        model = model.to(dtype).train()
        state = TrainState(model, make_optimizer(model), milestone_lr_schedule(LR, LREPOCHS, 1))
        batch = {k: torch.from_numpy(x[k]).to(dtype) for k in ("left", "right")}
        batch["disp_gt"] = torch.from_numpy(x["gt"]).to(dtype)
        make_train_step(model)(state, batch, t=torch.from_numpy(x["t"]),
                               noise=torch.from_numpy(x["noise"]).to(dtype))
        grads[dtype] = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    worst = max(rel_l2(grads[torch.float32][k], g) for k, g in grads[torch.float64].items())
    assert worst < F32_FLOOR
