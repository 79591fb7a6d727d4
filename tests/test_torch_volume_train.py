"""ACV's training step with the cost volume's rows split over ranks
(``parallel/volume_sharding.py``) against one process, on the CPU.

One ACV SceneFlow step (``make_train_step``, Adam) at a global batch of 2,
64×64, ``max_disp`` 64, float64: once in this process on the whole batch,
and once on a 2 data × 2 volume grid of 4 gloo processes (each a row of
the batch and a band of 8 of the 16 rows at H/4; the step opens
``volume_sharding`` itself).  The ground truth leaves each band of each row a
different number of valid pixels, so a mean of per-rank means would
differ from the global mean.  Compared with ``tests/test_torch_parallel.py``'s
rules, relative L2 a tensor within 1e-10: the loss and EPE each rank
reports, every gradient after the all-reduce, every BatchNorm running
statistic, every parameter after Adam (a vanishing gradient held to its
bound, Adam's parameters over the elements whose gradient resolves); the
four ranks' states equal one another.  The same for the
``freeze_attn_weights`` and ``attn_weights_only`` stages.  Then the training CLI with
``--volume_axis 2`` on the same 4 ranks as ``torchrun`` starts them, over
a synthetic SceneFlow set at a global batch of 4 (one step: after it,
Adam's first update of elements whose gradient is rounding would set the
next loss), against the CLI in one process: the step's global loss within
1e-5 (float32); then the same for the KITTI12 recipe (PCWNet) and the
KITTI15 recipe (IGEV, 2 GRU iterations; relative 5e-4, its float32 floor)
at a 64×64 crop (16 rows at H/4, 8 a band).  The CLI refuses a volume axis for a world it does not divide and
without ``torchrun``.  The ranks run under a timeout of their own and
PyTorch on one thread each.
"""

import os
import sys

import pytest
import torch

from diffuvolume_tpu_torch.data import sceneflow as sf
from diffuvolume_tpu_torch.models.acv import ACVNet
from diffuvolume_tpu_torch.parallel import ddp
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_heads,
    random_acv,
    tame_residual_branches,
)
from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
from diffuvolume_tpu_torch.train.loss import (
    SCENEFLOW_WEIGHTS,
    SCENEFLOW_WEIGHTS_ATTN_ONLY,
    SCENEFLOW_WEIGHTS_FREEZE_ATTN,
)
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule
from test_torch_parallel import CLI_CROP, cli_run, rel_l2, write_sceneflow
from test_torch_volume_sharding import free_ports, join, start

N_DATA, N_VOLUME, B, H, W, MD = 2, 2, 2, 64, 64, 64
WORLD = N_DATA * N_VOLUME
RTOL, VANISH, RESOLVE = 1e-10, 1e-9, 1e-4
SEED = 3
STAGES = {"full": SCENEFLOW_WEIGHTS, "freeze": SCENEFLOW_WEIGHTS_FREEZE_ATTN,
          "attn": SCENEFLOW_WEIGHTS_ATTN_ONLY}
CLI_ARGS = ["--model", "acvnet_ddim", "--epochs", "1", "--maxdisp", "64", "--batch_size",
            "4", "--lr", "1e-3", "--lrepochs", "10:2", "--num_workers", "0", "--device",
            "cpu"]
# The PCW and IGEV recipes' CLI runs: a crop whose 16 rows at H/4 split in
# bands of 8 (their hourglasses' three stride-2 levels).
SPLIT_CLI_CROP = (64, 64)
SPLIT_CLI_ARGS = {
    "pcwnet_ddim": ["--model", "pcwnet_ddim", "--lr", "1e-3", "--lrepochs", "10:2"],
    "igev_ddim": ["--model", "igev_ddim", "--lr", "2e-4", "--iters", "2"],
}
SPLIT_CLI_COMMON = ["--epochs", "1", "--maxdisp", "64", "--batch_size", "4", "--num_workers",
                    "0", "--device", "cpu"]
# The CLI's float32 loss, split against one process, relative.  IGEV's
# random network (the CLI's own initialisation, no calibration) moves its
# float32 loss by 1.08e-4 relative in one process between 1 and 4 intra-op
# threads (129.94261 against 129.95660), so its split is held to 5e-4; its
# float64 step is held to 1e-10 in tests/test_torch_volume_split.py.
CLI_RTOL = {"acvnet_ddim": 1e-5, "pcwnet_ddim": 1e-5, "igev_ddim": 5e-4}


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
    for i in range(B):  # a different count of valid pixels in every band of every row
        gt[i, :H // 2, :3 + 5 * i] = 0.0
        gt[i, H // 2:, :13 + 7 * i] = 0.0
    return {"left": left, "right": right, "disp_gt": gt}


def stage_model(stage: str, weights: dict) -> ACVNet:
    model = ACVNet(MD, True, attn_weights_only=stage == "attn",
                   freeze_attn_weights=stage == "freeze").double()
    model.load_state_dict(weights)
    return model.train()


def one_step(model, batch, weights, dp=None) -> dict:
    """One step from ``SEED``'s generator; returns the reported loss and
    EPE, the gradients, the BatchNorm statistics and the new parameters."""
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    out = make_train_step(model, weights, dp=dp)(state, batch,
                                                 torch.Generator().manual_seed(SEED))
    return {"loss": float(out["loss"]), "epe": float(out["epe"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def rank_main(rank: int, port: int, weights: str, out: str, cli_ports: list, cli_argvs: list,
              cli_outs: list) -> None:
    """One rank of the 2 × 2 grid: its row and band, each stage's step, its
    results to ``out``; then the training CLI as ``torchrun`` starts it with
    ``--volume_axis 2``, once a model (ACV, PCW, IGEV), its losses to
    ``cli_outs``."""
    torch.set_num_threads(1)
    mesh = ddp.init(rank, WORLD, "cpu", f"tcp://localhost:{port}", n_volume=N_VOLUME)
    try:
        res = {}
        for stage, loss_weights in STAGES.items():
            model = stage_model(stage, torch.load(weights))
            ddp.sync_batch_norm(model, mesh)
            mesh.broadcast_parameters(model)
            res[stage] = one_step(model, mesh.shard(make_batch()), loss_weights, mesh)
        torch.save(res, out)
    finally:
        ddp.shutdown()
    for cli_port, argv, cli_out in zip(cli_ports, cli_argvs, cli_outs):
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                          MASTER_ADDR="localhost", MASTER_PORT=str(cli_port))
        torch.save(cli_run(argv, cli_crop(argv)), cli_out)


def cli_crop(argv: list) -> tuple:
    return SPLIT_CLI_CROP if any(m in argv for m in SPLIT_CLI_ARGS) else CLI_CROP


def cli_one_process(argv: list) -> dict:
    """The training CLI in this process (``cli_run``), the dataset's crops
    and the TensorBoard module restored after it."""
    saved = (sf.SceneFlowDataset.TRAIN_CROP, sys.modules.get("torch.utils.tensorboard"),
             sf.SceneFlowDataset.TEST_CROP)
    try:
        return cli_run(argv, cli_crop(argv))
    finally:
        sf.SceneFlowDataset.TRAIN_CROP, sf.SceneFlowDataset.TEST_CROP = saved[0], saved[2]
        if saved[1] is None:
            sys.modules.pop("torch.utils.tensorboard", None)
        else:
            sys.modules["torch.utils.tensorboard"] = saved[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-process steps and CLI runs, and each rank's; the ranks
    start first and run beside this process's runs."""
    tmp = tmp_path_factory.mktemp("volume_train")
    batch = make_batch()
    src = tame_residual_branches(random_acv(MD, True, torch.Generator().manual_seed(11)))
    calibrate_heads(src, batch["left"].float(), batch["right"].float())
    weights = str(tmp / "weights.pt")
    torch.save(src.double().state_dict(), weights)
    root = str(tmp / "sceneflow")
    write_sceneflow(root)
    port, *cli_ports = free_ports(1 + 1 + len(SPLIT_CLI_ARGS))
    models = ["acvnet_ddim", *SPLIT_CLI_ARGS]
    logdirs = {m: str(tmp / f"ranks_{m}") for m in models}
    argvs = {m: ["--datapath", root, "--logdir", logdirs[m]] + (
        CLI_ARGS if m == "acvnet_ddim" else SPLIT_CLI_ARGS[m] + SPLIT_CLI_COMMON)
        for m in models}
    outs = [str(tmp / f"rank{r}.pt") for r in range(WORLD)]
    cli_outs = [[str(tmp / f"cli_{m}_{r}.pt") for m in models] for r in range(WORLD)]
    procs = start(rank_main, lambda r: (
        r, port, weights, outs[r], cli_ports,
        [argvs[m] + ["--volume_axis", str(N_VOLUME)] for m in models], cli_outs[r]), WORLD)
    try:  # the single-process runs while the ranks run
        cli_single = {m: cli_one_process(argvs[m][:3] + [str(tmp / f"one_{m}")] + argvs[m][4:])
                      for m in models}
        state = torch.load(weights)
        single = {stage: one_step(stage_model(stage, state), batch, w)
                  for stage, w in STAGES.items()}
    finally:
        join(procs)
    cli_ranks = {m: [torch.load(cli_outs[r][i]) for r in range(WORLD)]
                 for i, m in enumerate(models)}
    return dict(single=single, ranks=[torch.load(o) for o in outs], cli_single=cli_single,
                cli_ranks=cli_ranks, cli_logdirs=logdirs)


def test_valid_counts_differ_by_band():
    gt = make_batch()["disp_gt"]
    valid = (gt > 0) & (gt < MD)
    counts = [int(valid[i, k * H // 2:(k + 1) * H // 2].sum())
              for i in range(B) for k in range(N_VOLUME)]
    assert len(set(counts)) == WORLD


@pytest.mark.parametrize("stage", list(STAGES))
def test_loss_and_epe_are_the_global_batch(runs, stage):
    single = runs["single"][stage]
    for r in runs["ranks"]:
        assert abs(r[stage]["loss"] / single["loss"] - 1) < RTOL
        assert abs(r[stage]["epe"] / single["epe"] - 1) < RTOL


@pytest.mark.parametrize("key", ["grads", "stats", "params"])
@pytest.mark.parametrize("stage", list(STAGES))
def test_split_step_equals_single_process(runs, stage, key):
    """Every tensor on rank 0 against the single-process step, and every
    rank against rank 0."""
    single = runs["single"][stage]
    ranks = [r[stage] for r in runs["ranks"]]
    want = single[key]
    assert set(ranks[0][key]) == set(want)
    tiny = VANISH * max(float(g.norm()) for g in single["grads"].values())
    for name, w in want.items():
        got = ranks[0][key][name]
        for r in ranks[1:]:
            torch.testing.assert_close(r[key][name], got, rtol=0, atol=0)
        g = single["grads"].get(name)
        if key != "stats" and (g is None or float(g.norm()) <= tiny):
            if key == "grads":
                assert float(got.norm()) <= tiny, name
            elif g is None:  # a parameter the loss does not reach stays put
                assert rel_l2(got, w) < RTOL, name
            continue
        if key == "params":
            resolved = g.abs() > RESOLVE * g.pow(2).mean().sqrt()
            got, w = got[resolved], w[resolved]
        assert rel_l2(got, w) < RTOL, (name, rel_l2(got, w))


def test_train_cli_volume_axis_equals_one_process(runs):
    """``--volume_axis 2`` on 4 ranks: the epoch's one step's global loss,
    on every rank, against the single-process run's (float32, relative
    1e-5: only the weights, the rows and the draws set it); only rank 0
    writes checkpoints."""
    check_cli(runs, "acvnet_ddim")


@pytest.mark.parametrize("model", list(SPLIT_CLI_ARGS))
def test_train_cli_volume_axis_splits_pcw_and_igev(runs, model):
    """The KITTI12 (PCWNet) and KITTI15 (IGEV) recipes under ``--volume_axis
    2`` on the same 4 ranks as ACV's: as ACV's, the global loss on every
    rank against one process's (float32, relative ``CLI_RTOL``)."""
    check_cli(runs, model)


def check_cli(runs, model: str) -> None:
    single = runs["cli_single"][model]["losses"]
    assert len(single) == 1
    for r in runs["cli_ranks"][model]:
        assert len(r["losses"]) == 1
        assert abs(r["losses"][0] / single[0] - 1) < CLI_RTOL[model], (r["losses"], single)
    assert sorted(f for f in os.listdir(runs["cli_logdirs"][model]) if f.endswith(".ckpt")) == [
        "checkpoint_000001.ckpt"]


@pytest.mark.parametrize("model, world, error, match", [
    ("acvnet_ddim", "3", ValueError, "world size is 3"),
    ("acvnet_ddim", None, ValueError, "world size is 1"),
])
def test_train_cli_refuses_a_volume_axis_it_cannot_split(monkeypatch, model, world, error,
                                                         match):
    """``--volume_axis 2``: a world it does not divide and a run without
    ``torchrun`` refuse it; nothing falls back to an unsplit run."""
    from diffuvolume_tpu_torch.cli import train as train_cli

    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    with pytest.raises(error, match=match):
        train_cli.main(["--datapath", "/nonexistent", "--model", model, "--volume_axis", "2",
                        "--device", "cpu"])
