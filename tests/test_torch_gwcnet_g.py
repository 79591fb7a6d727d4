"""``gwcnet-g``, PCWNet without the concat volume, against the JAX package's,
on the CPU: the registry, the weight bridge, the KITTI12 DDIM-3 pipeline on
both of the port's paths, the training step, the step with the cost volume
split over ranks, and one ``cli/train.py --model gwcnet-g`` step.

64×64 at max_disp 192 (the size of ``tests/test_torch_pcw*.py``).  Weights:
the seeded ``random_pcw_pair(..., use_concat_volume=False)`` (trunk tamed,
heads calibrated), turned into the JAX package's variables by its
converter, ``convert_pcw_state_dict(sd, diffusion, use_concat_volume=False)``.
The JAX model still builds 1-channel concat heads that nothing reads
(``models/pcw.py:243-245`` of the JAX package); upstream ``PWCNet_G`` has
none, so the converter leaves them out and they are filled here from
``jax.eval_shape`` of the model's init: zeros, ones for BatchNorm
variances.

* Keys: the port's state-dict keys are the torch keys of both packages'
  ``pcw_rules(diffusion, use_concat_volume=False)``; the bridge back from
  the JAX variables gives the port's state dict bit for bit.
* Pipeline: ``pcw_ddim_inference`` on the folded path and the module path
  against the JAX ``pcw_ddim_inference`` with the JAX draws injected, the
  bounds of ``tests/test_torch_pcw_pipeline.py``: 0.1 px max and 5e-3 px
  mean on the output, 1e-2 px on the baseline (the ``gwcnet-g`` eval
  forward).
* Training: the KITTI12 step in float64 against the JAX step, the
  tolerances of ``tests/test_torch_train_pcw.py`` (six heads ``HEAD_ATOL``,
  loss ``LOSS_RTOL``, gradients, statistics and parameters by
  ``check_step``); with ``diffusion`` off the step's timestep and noise go
  unread, as in the JAX step.  The same step split over a 1 × 2 grid of
  gloo ranks (``tests/test_torch_volume_split.py``), run beside the JAX
  compile: its loss against the unsplit step's (relative 1e-10) and the
  JAX step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffuvolume_tpu.diffusion.ddim import KITTI12_DDIM as J_KITTI12
from diffuvolume_tpu.eval.pipeline import pcw_ddim_inference as j_pcw_inference
from diffuvolume_tpu.models.pcw import PCWNet as JPCW
from diffuvolume_tpu.ops.regression import resize_bilinear as j_resize
from diffuvolume_tpu.tools.convert_torch_pcw import convert_pcw_state_dict
from diffuvolume_tpu.tools.convert_torch_pcw import pcw_rules as j_pcw_rules
from diffuvolume_tpu.train import loss as jloss
from diffuvolume_tpu.train.lr import milestone_lr_schedule as j_milestones
from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM
from diffuvolume_tpu_torch.eval.pipeline import pcw_ddim_inference, pcw_prep
from diffuvolume_tpu_torch.models import build_model
from diffuvolume_tpu_torch.models.pcw import PCWNet
from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
from diffuvolume_tpu_torch.tools import weights
from diffuvolume_tpu_torch.tools.random_weights import calibrate_pcw, random_pcw_pair
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
from torch_parity import jax_normal_draws, stereo_pair

B, H, W, MD = 1, 64, 64, 192
LR, LREPOCHS = 1e-3, "200:10"
# The JAX model's concat heads without a counterpart in upstream PWCNet_G.
UNREAD_HEADS = ("lastconv_0", "lastconv_1", "concat2_0", "concat2_1", "concat3_0",
                "concat3_1", "concat4_0", "concat4_1")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_variables(model: PCWNet) -> tuple[dict, list]:
    """The JAX package's variables of ``model`` (a port PCWNet without the
    concat volume): the converter's, then every leaf the JAX model has and
    the converter leaves out, zeros (ones for a BatchNorm variance).
    Returns the variables and the filled leaves' paths."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    out = convert_pcw_state_dict(sd, diffusion=model.diffusion, use_concat_volume=False)
    jm = JPCW(max_disp=model.max_disp, diffusion=model.diffusion, use_concat_volume=False)
    img = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a, b: jm.init(jax.random.PRNGKey(0), a, b), img, img)
    filled = []
    for coll in ("params", "batch_stats"):
        for path, leaf in _flat(shapes[coll]):
            node = out[coll]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            if path[-1] not in node:
                fill = np.ones if coll == "batch_stats" and path[-1] == "var" else np.zeros
                node[path[-1]] = fill(leaf.shape, np.float32)
                filled.append((coll, *path))
    return out, filled


def test_registry_builds_gwcnet_g():
    """``gwcnet-g`` builds PCWNet without diffusion or the concat volume;
    ``pcwnet_ddim`` takes the switch, as the JAX registry's lambdas do.  The
    volume is the 40 groups alone: ``dres0``'s first conv and
    ``HourglassUp``'s combine convs read 40 volume channels."""
    for name, diffusion in (("gwcnet-g", False), ("pcwnet_ddim", True)):
        kw = {} if name == "gwcnet-g" else {"use_concat_volume": False}
        m = build_model(name, max_disp=MD, **kw)
        assert m.diffusion == diffusion and not m.use_concat_volume
        assert m.dres0[0][0].weight.shape[1] == 40
        assert [getattr(m.combine1, f"combine{i}")[0][0].weight.shape[1]
                for i in (1, 2, 3)] == [104, 168, 168]
        assert not any("concat" in k or "lastconv" in k for k in m.state_dict())


@pytest.mark.parametrize("diffusion", [False, True])
def test_state_dict_keys_are_the_rules(diffusion):
    """The port's keys (less BatchNorm's counters) are the torch keys of the
    port's and the JAX package's ``pcw_rules(diffusion, False)``, which are
    upstream ``PWCNet_G``'s: no concat heads."""
    keys = {k for k in PCWNet(MD, diffusion, use_concat_volume=False).state_dict()
            if not k.endswith("num_batches_tracked")}
    assert keys == {r[0] for r in weights.pcw_rules(diffusion, False)}
    assert keys == {r[0] for r in j_pcw_rules(diffusion, False)}


@pytest.fixture(scope="module")
def setup():
    left, right = stereo_pair(8, 1, H, W)
    bm, dm = random_pcw_pair(MD, torch.Generator().manual_seed(4), use_concat_volume=False)
    calibrate_pcw(bm, torch.from_numpy(left), torch.from_numpy(right))
    dm.load_state_dict(bm.state_dict(), strict=False)
    (bv, b_filled), (dv, d_filled) = jax_variables(bm), jax_variables(dm)
    jb = JPCW(max_disp=MD, diffusion=False, use_concat_volume=False)
    jd = JPCW(max_disp=MD, diffusion=True, use_concat_volume=False)
    key = jax.random.PRNGKey(5)
    latent_shape = (1, MD // 4, H // 4, W // 4)
    jfinal, jbase = j_pcw_inference(jb, jd, bv, dv, left, right, key)
    return dict(left=torch.from_numpy(left), right=torch.from_numpy(right), bm=bm, dm=dm,
                bv=bv, dv=dv, filled=(b_filled, d_filled),
                ns=jax_normal_draws(key, J_KITTI12.sampling_steps, latent_shape),
                jfinal=np.asarray(jfinal), jbase=np.asarray(jbase))


def test_bridge_round_trips(setup):
    """The JAX variables back through ``pcw_state_dict_from_jax(..., False)``
    give the port's state dict bit for bit; the only leaves the converter
    left out are the JAX model's unread 1-channel concat heads."""
    for model, variables, filled in ((setup["bm"], setup["bv"], setup["filled"][0]),
                                     (setup["dm"], setup["dv"], setup["filled"][1])):
        back = weights.pcw_state_dict_from_jax(variables, model.diffusion, False)
        sd = model.state_dict()
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v.float() if v.is_floating_point() else v), k
        assert filled and all(p[1] == "feature_extraction" and p[2] in UNREAD_HEADS
                              for p in filled), filled


@pytest.fixture(scope="module", params=[True, False], ids=["packed", "module"])
def run(request, setup):
    r = dict(setup, packed=request.param)
    r["final"], r["base"] = pcw_ddim_inference(
        r["bm"], r["dm"], r["left"].numpy(), r["right"].numpy(), device="cpu",
        noise_source=r["ns"], packed=r["packed"])
    return r


def test_pipeline_matches_jax(run):
    """The KITTI12 DDIM-3 output and the ``gwcnet-g`` baseline against the
    JAX pipeline with the same draws, on both paths."""
    final, jfinal = run["final"].numpy(), run["jfinal"]
    assert final.shape == (1, H, W) and np.isfinite(final).all()
    err = np.abs(final - jfinal)
    assert err.max() < 0.1 and err.mean() < 5e-3, (err.max(), err.mean())
    np.testing.assert_allclose(run["base"].numpy(), run["jbase"], rtol=0, atol=1e-2)


@torch.no_grad()
def test_volumes_are_the_groups_alone(run):
    """The volumes hold the 40 groups in a 48-channel slot, the fill zero
    (the folded path's weights padded to match); the trunk makes no concat
    features; the prep's combine volume has 32 channels on both paths."""
    m = run["dm"]
    fl, fr = m.features(run["left"], run["right"])
    assert not any(k.startswith("concat") for k in fl)
    vols = m.volumes(fl, fr)
    assert [tuple(v.shape) for v in vols] == [
        (1, MD // (4 << k), H // (4 << k), W // (4 << k), 48) for k in range(4)]
    assert not any(v[..., 40:].any() for v in vols)
    f = fold_pcw(m)
    assert f.dres0_0.w.shape == (3, 3, 3, 48, 32)
    assert [getattr(f.combine1, f"combine{i}_v").w.shape[3] for i in (1, 2, 3)] == [48] * 3
    _, _, entry = pcw_prep(run["bm"], run["dm"], run["left"], run["right"], KITTI12_DDIM,
                           run["packed"])
    assert entry.volume.shape[-1 if run["packed"] else 1] == 32


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    left, right = stereo_pair(0, B, H, W)
    src, _ = random_pcw_pair(MD, torch.Generator().manual_seed(3), use_concat_volume=False)
    calibrate_pcw(src, torch.from_numpy(left), torch.from_numpy(right))
    gt = sceneflow_gt(2, B, H, W, MD)
    mask = (gt < MD) & (gt > 0)
    t, noise = jax_step_draws(jax.random.PRNGKey(6), B, H, W, MD)
    disp_q = np.asarray(j_resize(jnp.clip(gt, 0.0, MD - 1), (H // 4, W // 4), 1, 2)) / 4.0
    batch = {"left": torch.from_numpy(left).double(), "right": torch.from_numpy(right).double(),
             "disp_gt": torch.from_numpy(gt).double()}
    tt, nt = torch.from_numpy(t), torch.from_numpy(np.asarray(noise, np.float64))
    procs, split_out = start_split(tmp_path_factory, "gwcnet-g", MD, None, src, batch, tt, nt)
    jmodel = JPCW(max_disp=MD, diffusion=False, use_concat_volume=False, dtype=jnp.float64)
    args = f64(left, right, disp_q) + [t, np.asarray(noise, np.float64)]

    def loss_fn(params, bs):
        preds, upd = jmodel.apply({"params": params, "batch_stats": bs}, *args, train=True,
                                  mutable=["batch_stats"])
        return jloss.multi_scale_loss(preds, *f64(gt), mask, jloss.KITTI12_WEIGHTS), (
            preds, upd["batch_stats"])

    j = jax_reference(loss_fn, jax_variables(src)[0], optax.adam(j_milestones(LR, LREPOCHS, 1)))

    def port_model():
        m = PCWNet(MD, False, use_concat_volume=False)
        m.load_state_dict(src.state_dict())
        return m.double().train()

    heads = port_model().train_forward(batch["left"], batch["right"],
                                       _quarter_gt(batch["disp_gt"], MD - 1), tt, nt)
    model = port_model()
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(LR, LREPOCHS, 1))
    out = make_train_step(model, jloss.KITTI12_WEIGHTS)(state, batch, t=tt, noise=nt)
    return dict(j=j, heads=[h.detach().numpy() for h in heads], out=out, model=model,
                split=join_split(procs, split_out))


def test_train_heads_and_loss_match(train):
    """The six heads ``[pred0, comb_pred, pred1, pred2, pred3,
    disp_finetune]`` and the KITTI12 loss against the JAX step's."""
    assert len(train["heads"]) == len(train["j"]["preds"]) == 6
    for got, want in zip(train["heads"], train["j"]["preds"]):
        assert got.shape == (B, H, W)
        np.testing.assert_allclose(got, want, atol=HEAD_ATOL, rtol=0)
    assert float(train["out"]["loss"]) == pytest.approx(float(train["j"]["loss"]),
                                                        rel=LOSS_RTOL)


def test_train_gradients_statistics_and_step_match(train):
    check_step(train["model"], weights.pcw_rules(False, False), train["j"], LR)


def test_split_step_matches_unsplit_and_jax(train):
    """The step with the cost volume split over a 1 × 2 grid (8 of the 16
    rows at H/4 a rank): its loss against the unsplit step's and the JAX
    step's, its ranks' heads stacked against the unsplit step's."""
    check_split(train)


def test_train_cli_step(tmp_path, monkeypatch):
    """``cli/train.py --model gwcnet-g --device cpu``: the KITTI12 recipe
    (Adam, the six-head weights) takes its one step on a synthetic KITTI
    set at a 64×64 crop; the loss is finite and a checkpoint is written."""
    from chip_smoke import write_kitti

    from diffuvolume_tpu_torch.cli import train as train_cli
    from diffuvolume_tpu_torch.data.kitti import KITTIDataset
    from diffuvolume_tpu_torch.train.checkpoint import latest_step

    monkeypatch.setattr(KITTIDataset, "TRAIN_CROP", (64, 64))
    root, logdir = str(tmp_path / "kitti"), str(tmp_path / "run")
    trainlist = write_kitti(root, 1, 96, 160)
    argv = ["--datapath", root, "--trainlist", trainlist, "--dataset", "kitti12", "--model",
            "gwcnet-g", "--maxdisp", str(MD), "--batch_size", "1", "--epochs", "1",
            "--num_workers", "0", "--logdir", logdir, "--device", "cpu"]
    recipe, cfg = train_cli.build_experiment_config(train_cli.parse_args(argv))
    assert recipe == "kitti12" and cfg.model.backbone == "pcw" and not cfg.model.diffusion
    out = train_cli.main(argv)
    model = out["state"].model
    assert isinstance(model, PCWNet) and not model.use_concat_volume and not model.diffusion
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert latest_step(logdir) == 1
