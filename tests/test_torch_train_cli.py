"""The port's training entry point on the CPU, over a synthetic SceneFlow
set (the layout ``tests/test_integration_cli.py`` builds for the JAX
package's CLI; that test is ``slow``-marked for the JAX CLI's cost and is
not run here).

* one epoch writes a checkpoint that the port's ``cli/evaluate`` loads as a
  reference checkpoint;
* ``--resume`` continues from the saved step;
* ``--init_from`` chains the SceneFlow stages ``attn_only`` →
  ``freeze_attn`` → ``full``, each starting from the last one's weights;
* the KITTI12 recipe (PCWNet) with ``--eval_freq 1`` prints its D1, and the
  KITTI15 recipe (IGEV-Stereo) takes its steps;
* without a card, and without ``--device cpu``, the CLI refuses to run;
  ``--volume_axis`` above 1 is refused;
* the flags fold into ``config.py``'s dataclasses as the JAX CLI's do.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffuvolume_tpu_torch.cli import evaluate
from diffuvolume_tpu_torch.cli import train as train_cli
from diffuvolume_tpu_torch.data import sceneflow as sf
from diffuvolume_tpu_torch.data.readers import write_pfm
from diffuvolume_tpu_torch.train.checkpoint import latest_step, load_checkpoint

CROP = (32, 64)
BASE = ["--maxdisp", "64", "--batch_size", "2", "--lr", "1e-3", "--lrepochs", "10:2",
        "--num_workers", "0", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread for this file: under the suite's
    parallel workers its default pool contends with theirs, and the
    training steps here ran some 50× slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sceneflow(tmp_path_factory):
    """Four pairs at 96×160 in the SceneFlow training tree's layout, the right
    image the left shifted 3 px, PFM ground truth near 3 px."""
    root = tmp_path_factory.mktemp("sceneflow_train")
    g = np.random.default_rng(21)
    for scene in ("A/0000", "A/0001"):
        for eye in ("left", "right"):
            os.makedirs(root / "frames_finalpass/TRAIN" / scene / eye)
        os.makedirs(root / "disparity/TRAIN" / scene / "left")
        for frame in ("0006", "0007"):
            img = g.integers(0, 255, (96, 160, 3)).astype(np.uint8)
            Image.fromarray(img).save(root / "frames_finalpass/TRAIN" / scene / "left" /
                                      f"{frame}.png")
            Image.fromarray(np.roll(img, -3, axis=1)).save(
                root / "frames_finalpass/TRAIN" / scene / "right" / f"{frame}.png")
            disp = (3.0 + g.uniform(0, 0.5, (96, 160))).astype(np.float32)
            write_pfm(str(root / "disparity/TRAIN" / scene / "left" / f"{frame}.pfm"), disp)
    return str(root)


@pytest.fixture
def crops(monkeypatch):
    monkeypatch.setattr(sf.SceneFlowDataset, "TRAIN_CROP", CROP)
    monkeypatch.setattr(sf.SceneFlowDataset, "TEST_CROP", CROP)


def test_one_epoch_writes_a_checkpoint_evaluate_loads(sceneflow, tmp_path, crops, capsys):
    logdir = str(tmp_path / "run")
    out = train_cli.main(["--datapath", sceneflow, "--model", "acvnet_ddim", "--epochs", "1",
                          "--logdir", logdir] + BASE)
    assert latest_step(logdir) == 2  # 4 samples / batch 2
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    text = capsys.readouterr().out
    assert "dataset: 4 samples, 2 steps/epoch" in text and "epoch 0 done" in text
    assert os.path.exists(os.path.join(logdir, "metrics.jsonl"))
    saved = load_checkpoint(logdir)
    assert set(saved) == {"step", "model", "optimizer"} and saved["step"] == 2
    path = os.path.join(logdir, "checkpoint_000002.ckpt")
    model = evaluate.load_model(path, "acv", True, 64, 0, torch.device("cpu"))
    for k, v in out["state"].model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v.cpu()), k


def test_resume_continues_from_its_step(sceneflow, tmp_path, crops, capsys):
    logdir = str(tmp_path / "run")
    argv = ["--datapath", sceneflow, "--model", "acvnet", "--logdir", logdir] + BASE
    train_cli.main(argv + ["--epochs", "1"])
    first = load_checkpoint(logdir)
    out = train_cli.main(argv + ["--epochs", "2", "--resume"])
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert latest_step(logdir) == 4 and out["state"].step == 4 and len(out["losses"]) == 2
    assert first["optimizer"]["state"][0]["step"] == 2
    assert load_checkpoint(logdir)["optimizer"]["state"][0]["step"] == 4


def test_init_from_chains_the_sceneflow_stages(sceneflow, tmp_path, crops):
    """Each stage starts from the last one's checkpoint: every entry both
    hold at one shape is the donor's at the first step."""
    donor, starts = None, []
    for stage in ("attn_only", "freeze_attn", "full"):
        logdir = str(tmp_path / stage)
        argv = ["--datapath", sceneflow, "--model", "acvnet_ddim", "--epochs", "1",
                "--stage", stage, "--logdir", logdir] + BASE
        if donor is not None:
            argv += ["--init_from", donor]
        train_cli.run(train_cli.parse_args(argv), on_start=lambda s: starts.append(
            {k: v.clone() for k, v in s.model.state_dict().items()}))
        if donor is not None:
            saved = load_checkpoint(donor)["model"]
            assert all(torch.equal(starts[-1][k], v) for k, v in saved.items())
        assert latest_step(logdir) == 2
        donor = logdir
    with pytest.raises(ValueError, match="SceneFlow"):
        train_cli.main(["--datapath", sceneflow, "--model", "pcwnet_ddim", "--stage",
                        "attn_only", "--logdir", str(tmp_path / "x")] + BASE)


def test_kitti12_recipe_prints_its_d1(sceneflow, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sf.SceneFlowDataset, "TRAIN_CROP", (64, 64))
    monkeypatch.setattr(sf.SceneFlowDataset, "TEST_CROP", (64, 64))
    logdir = str(tmp_path / "pcw")
    out = train_cli.main(["--datapath", sceneflow, "--model", "pcwnet_ddim", "--epochs", "1",
                          "--eval_freq", "1", "--eval_max_images", "1", "--logdir", logdir]
                         + BASE)
    text = capsys.readouterr().out
    assert "eval: D1" in text and "(best)" in text
    assert 0.0 <= out["best_d1"] <= 1.0
    assert latest_step(logdir) == 2 and out["state"].model.training


def test_kitti15_recipe_takes_its_steps(sceneflow, tmp_path, monkeypatch):
    """IGEV-Stereo: AdamW + one-cycle + clip + the sequence loss."""
    monkeypatch.setattr(sf.SceneFlowDataset, "TRAIN_CROP", (64, 96))
    logdir = str(tmp_path / "igev")
    out = train_cli.main(["--datapath", sceneflow, "--model", "igev_ddim", "--epochs", "1",
                          "--iters", "1", "--logdir", logdir] + BASE)
    state = out["state"]
    assert latest_step(logdir) == 2 and state.grad_clip == 1.0
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert all(np.isfinite(out["losses"]))


def test_refuses_without_a_card(sceneflow, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--datapath", sceneflow])
    with pytest.raises(ValueError, match="world size"):
        train_cli.main(["--datapath", sceneflow, "--volume_axis", "2"])


def test_build_experiment_config_roundtrip():
    """config.py is the configuration surface, as the JAX CLI's
    ``test_build_experiment_config_roundtrip`` has it."""
    args = train_cli.parse_args(["--datapath", "/tmp/x", "--model", "igev_ddim", "--bf16",
                                 "--volume_axis", "2", "--lr", "2e-4"])
    recipe, cfg = train_cli.build_experiment_config(args)
    assert recipe == "kitti15"
    assert cfg.model.backbone == "igev" and cfg.model.diffusion
    assert cfg.optim.optimizer == "adamw" and cfg.optim.grad_clip == 1.0
    assert cfg.optim.bf16 and cfg.parallel.volume_axis == 2
    recipe, cfg = train_cli.build_experiment_config(
        train_cli.parse_args(["--datapath", "/tmp/x", "--model", "pcwnet_ddim"]))
    assert recipe == "kitti12" and cfg.optim.optimizer == "adam" and cfg.optim.grad_clip is None


def test_config_matches_the_jax_package():
    """The port's own copy of config.py: the same fields, defaults and
    recipes."""
    import dataclasses

    import diffuvolume_tpu.config as j_config
    from diffuvolume_tpu_torch import config as t_config

    for name in ("SCENEFLOW_TRAIN", "KITTI12_FINETUNE", "KITTI15_FINETUNE"):
        assert dataclasses.asdict(getattr(t_config, name)) == dataclasses.asdict(
            getattr(j_config, name)), name
