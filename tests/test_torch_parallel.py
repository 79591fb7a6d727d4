"""Data parallelism (``parallel/ddp.py``) against one process, on the CPU.

One ACV SceneFlow training step (``make_train_step``, Adam) at a global
batch of 4, 32×64, ``max_disp`` 64, float64: once in this process on the
whole batch, and once in 4 gloo processes of one row each.  The ground
truth leaves each row a different number of valid pixels (a zero strip of
its own width), so a mean of per-rank means would differ from the global
mean.  Both runs draw the timestep and the noise from one seeded generator
(the ranks keep their rows of the global draw).  Compared, relative L2 a
tensor within 1e-10: the loss and EPE each rank reports, every gradient
after the all-reduce, every BatchNorm running statistic, every parameter
after Adam; the four ranks' states equal one another.  A gradient that
vanishes in exact arithmetic (under 1e-9 of the largest: a conv's bias
before a training-mode BatchNorm) is held to that bound instead, and the
parameters after Adam are compared over the elements whose gradient is
above 1e-4 of its tensor's RMS: Adam's first step is ``lr·g/(|g| + ε)``,
so an element whose gradient is rounding (the key third of an attention
block's ``qkv`` bias, which the softmax does not see) moves by an amount
that rounding sets (``chip_smoke.py`` phase 10's rule).  The same four
processes then run the training CLI as ``torchrun`` starts them, over a
synthetic SceneFlow set at a global batch of 4, against the CLI in this
process: the step's global loss within 1e-5 (float32), checkpoints from
rank 0 only; with ``--eval_freq 1`` the epoch's evaluation, split over
the ranks, gives every rank the D1 and EPE of one process's evaluation of
rank 0's checkpoint within 1e-12 relative.  The ranks run under a
timeout of their own and PyTorch on one thread each.
"""

import multiprocessing
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from diffuvolume_tpu_torch.cli import train as train_cli
from diffuvolume_tpu_torch.data import sceneflow as sf
from diffuvolume_tpu_torch.data.readers import write_pfm

from diffuvolume_tpu_torch.models.acv import ACVNet
from diffuvolume_tpu_torch.parallel import ddp
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_heads,
    random_acv,
    tame_residual_branches,
)
from diffuvolume_tpu_torch.train import loss as tloss
from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

WORLD, B, H, W, MD = 4, 4, 32, 64, 64
RTOL, VANISH, RESOLVE = 1e-10, 1e-9, 1e-4
TIMEOUT_S = 600
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch():
    g = torch.Generator().manual_seed(5)
    left = torch.randn((B, H, W, 3), generator=g, dtype=torch.float64) * 0.3
    right = torch.roll(left, -3, dims=2)
    gt = torch.rand((B, H, W), generator=g, dtype=torch.float64) * (MD + 8) + 0.5
    for i in range(B):  # a different count of valid pixels in every row
        gt[i, :, :3 + 5 * i] = 0.0
    return {"left": left, "right": right, "disp_gt": gt}


def one_step(model, batch, dp=None) -> dict:
    """One step from ``SEED``'s generator; returns the reported loss and
    EPE, the gradients, the BatchNorm statistics and the new parameters."""
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    out = make_train_step(model, dp=dp)(state, batch, torch.Generator().manual_seed(SEED))
    return {"loss": float(out["loss"]), "epe": float(out["epe"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def rank_main(rank: int, port: int, weights: str, out: str, cli_port: int, cli_argv: list,
              cli_out: str) -> None:
    """One rank: its row of the batch, the step, its results to ``out``;
    then the training CLI as ``torchrun`` starts it, its losses to
    ``cli_out``."""
    torch.set_num_threads(1)
    dp = ddp.init(rank, WORLD, "cpu", f"tcp://localhost:{port}")
    try:
        model = ACVNet(MD, True).double()
        model.load_state_dict(torch.load(weights))
        ddp.sync_batch_norm(model.train(), dp)
        dp.broadcast_parameters(model)
        torch.save(one_step(model, dp.shard(make_batch()), dp), out)
    finally:
        ddp.shutdown()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(cli_port))
    torch.save(cli_run(cli_argv), cli_out)


def spawn(target, args_of, n: int) -> None:
    """``n`` spawned processes ``target(*args_of(rank))``, joined within
    ``TIMEOUT_S``; every one must exit 0."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * n


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process step and CLI run, and each rank's."""
    tmp = tmp_path_factory.mktemp("ddp")
    batch = make_batch()
    src = tame_residual_branches(random_acv(MD, True, torch.Generator().manual_seed(11)))
    calibrate_heads(src, batch["left"].float(), batch["right"].float())
    weights = str(tmp / "weights.pt")
    torch.save(src.double().state_dict(), weights)
    root = str(tmp / "sceneflow")
    write_sceneflow(root)
    saved = (sf.SceneFlowDataset.TRAIN_CROP, sys.modules.get("torch.utils.tensorboard"),
             sf.SceneFlowDataset.TEST_CROP)
    try:
        cli_single = cli_run(["--datapath", root, "--logdir", str(tmp / "one")] + CLI_ARGS)
    finally:
        sf.SceneFlowDataset.TRAIN_CROP, sf.SceneFlowDataset.TEST_CROP = saved[0], saved[2]
        if saved[1] is None:
            sys.modules.pop("torch.utils.tensorboard", None)
        else:
            sys.modules["torch.utils.tensorboard"] = saved[1]
    port, cli_port, logdir = ddp.free_port(), ddp.free_port(), str(tmp / "ranks")
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    cli_outs = [str(tmp / f"cli{r}.pt") for r in range(WORLD)]
    cli_argv = ["--datapath", root, "--logdir", logdir] + CLI_ARGS
    spawn(rank_main, lambda r: (r, port, weights, outs[r], cli_port, cli_argv, cli_outs[r]),
          WORLD)
    model = ACVNet(MD, True).double()
    model.load_state_dict(torch.load(weights))
    return dict(single=one_step(model.train(), batch), ranks=[torch.load(o) for o in outs],
                cli_single=cli_single, cli_ranks=[torch.load(o) for o in cli_outs],
                cli_logdir=logdir, cli_root=root)


def test_valid_counts_differ_by_rank():
    counts = [int(((g > 0) & (g < MD)).sum()) for g in make_batch()["disp_gt"]]
    assert len(set(counts)) == WORLD


def test_loss_and_epe_are_the_global_batch(runs):
    single, ranks = runs["single"], runs["ranks"]
    for r in ranks:
        assert abs(r["loss"] / single["loss"] - 1) < RTOL
        assert abs(r["epe"] / single["epe"] - 1) < RTOL


@pytest.mark.parametrize("key", ["grads", "stats", "params"])
def test_step_equals_single_process(runs, key):
    """Every tensor on rank 0 against the single-process step, and every
    rank against rank 0."""
    single, ranks = runs["single"], runs["ranks"]
    want = single[key]
    tiny = VANISH * max(float(g.norm()) for g in single["grads"].values())
    for name, w in want.items():
        got = ranks[0][key][name]
        for r in ranks[1:]:
            torch.testing.assert_close(r[key][name], got, rtol=0, atol=0)
        g = single["grads"].get(name)
        if key != "stats" and float(g.norm()) <= tiny:
            if key == "grads":
                assert float(got.norm()) <= tiny, name
            continue
        if key == "params":
            resolved = g.abs() > RESOLVE * g.pow(2).mean().sqrt()
            got, w = got[resolved], w[resolved]
        assert rel_l2(got, w) < RTOL, (name, rel_l2(got, w))


def test_sharded_loss_sums_to_the_global_loss():
    """``multi_scale_loss`` with the global count: the shards' losses sum to
    the whole batch's, where the mean of the shards' own means does not."""
    batch = make_batch()
    gt = batch["disp_gt"]
    mask = (gt > 0) & (gt < MD)
    preds = [gt + torch.randn(gt.shape, generator=torch.Generator().manual_seed(k),
                              dtype=gt.dtype) for k in range(4)]
    whole = tloss.multi_scale_loss(preds, gt, mask)
    total = float(mask.sum())
    shards = [tloss.multi_scale_loss([p[i:i + 1] for p in preds], gt[i:i + 1], mask[i:i + 1],
                                     reduce=lambda n: n.new_tensor(total)) for i in range(B)]
    own = [tloss.multi_scale_loss([p[i:i + 1] for p in preds], gt[i:i + 1], mask[i:i + 1])
           for i in range(B)]
    assert abs(float(sum(shards)) / float(whole) - 1) < RTOL
    assert abs(float(sum(own)) / B / float(whole) - 1) > 1e-4


# The training CLI under a torchrun-style environment: the four ranks of
# one row each against one process at the same global batch of 4.
CLI_CROP = (32, 64)
EVAL_IMAGES = 3
CLI_ARGS = ["--model", "acvnet_ddim", "--epochs", "1", "--maxdisp", "64", "--batch_size", "4",
            "--lr", "1e-3", "--lrepochs", "10:2", "--num_workers", "0", "--device", "cpu",
            "--eval_freq", "1", "--eval_max_images", str(EVAL_IMAGES)]


def write_sceneflow(root: str) -> None:
    """Four pairs at 96×160 in the SceneFlow training tree's layout, the
    right image the left shifted 3 px, PFM ground truth in [1, 60) px."""
    g = np.random.default_rng(21)
    for scene in ("A/0000", "A/0001"):
        for eye in ("left", "right"):
            os.makedirs(os.path.join(root, "frames_finalpass/TRAIN", scene, eye))
        os.makedirs(os.path.join(root, "disparity/TRAIN", scene, "left"))
        for frame in ("0006", "0007"):
            img = g.integers(0, 255, (96, 160, 3)).astype(np.uint8)
            base = os.path.join(root, "frames_finalpass/TRAIN", scene)
            Image.fromarray(img).save(os.path.join(base, "left", f"{frame}.png"))
            Image.fromarray(np.roll(img, -3, axis=1)).save(
                os.path.join(base, "right", f"{frame}.png"))
            disp = g.uniform(1.0, 60.0, (96, 160)).astype(np.float32)
            write_pfm(os.path.join(root, "disparity/TRAIN", scene, "left", f"{frame}.pfm"), disp)


def cli_run(argv: list, crop: tuple = CLI_CROP) -> dict:
    """The CLI's step losses and evaluations at ``crop``, without
    TensorBoard (the logger's optional writer; importing it here takes some
    10 s a process)."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    sf.SceneFlowDataset.TRAIN_CROP = sf.SceneFlowDataset.TEST_CROP = crop
    out = train_cli.main(argv)
    return {"losses": out["losses"], "evals": out["evals"]}


def test_train_cli_over_ranks_equals_one_process(runs):
    """The epoch's one step: the global loss every rank reports against
    the single-process run's (float32, relative 1e-5: only the weights,
    the rows and the draws set it); only rank 0 writes checkpoints."""
    single = runs["cli_single"]["losses"]
    ranks = [r["losses"] for r in runs["cli_ranks"]]
    assert len(single) == 1 and all(len(r) == 1 for r in ranks)
    for r in ranks:
        assert abs(r[0] / single[0] - 1) < 1e-5, (r, single)
    assert sorted(f for f in os.listdir(runs["cli_logdir"]) if f.endswith(".ckpt")) == [
        "checkpoint_000001.ckpt"]


def test_train_cli_eval_splits_over_ranks(runs):
    """``--eval_freq 1`` over 4 ranks and ``EVAL_IMAGES`` test images (rank
    3 gets none): every rank reports the same D1 and EPE, equal within
    1e-12 relative to the evaluation of rank 0's checkpoint in one process
    (the same images and draws; only the order of the sums differs)."""
    from diffuvolume_tpu_torch.cli.evaluate import load_model
    from diffuvolume_tpu_torch.models import build_model
    from diffuvolume_tpu_torch.train.checkpoint import load_checkpoint

    evals = [r["evals"] for r in runs["cli_ranks"]]
    assert len(evals[0]) == 1 and all(e == evals[0] for e in evals)
    args = train_cli.parse_args(["--datapath", runs["cli_root"]] + CLI_ARGS)
    model = build_model("acvnet_ddim", max_disp=MD)
    model.load_state_dict(load_checkpoint(runs["cli_logdir"])["model"])
    wiring = train_cli._EVAL_WIRING["sceneflow"]
    baseline = load_model(None, wiring, False, MD, 0, torch.device("cpu"))
    saved = sf.SceneFlowDataset.TEST_CROP
    try:
        sf.SceneFlowDataset.TEST_CROP = CLI_CROP
        want = train_cli._epoch_eval(args, "sceneflow", model.train(), baseline,
                                     sf.SceneFlowDataset, torch.device("cpu"))
    finally:
        sf.SceneFlowDataset.TEST_CROP = saved
    for got, w in zip(evals[0][0], want):
        assert abs(got - w) <= 1e-12 * abs(w), (evals[0], want)
