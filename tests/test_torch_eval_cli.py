"""The port's evaluation entry point against the JAX package's, on the CPU.

* A reference-style checkpoint (the port model's ``state_dict`` with the
  ``module.`` prefix, saved under ``model``) read by the JAX package's
  ``convert_*_state_dict`` gives variables from which ``tools/weights.py``
  rebuilds the same state dict, for ACVNet, PCWNet and IGEV-Stereo; the
  port's CLI loads the same file into the same weights.
* ``cli/evaluate.main`` with ``--baseline_only --device cpu`` over a
  synthetic SceneFlow set gives the JAX evaluate CLI's ``FINAL:`` metrics
  over the same checkpoint file and images (EPE within 1e-4 absolute).
* ``cli/save_disp`` writes one file a pair; the registry builds the JAX
  registry's names; the CLIs and the bench refuse to run without a card
  unless asked for the CPU.
"""

import ast
import os

import numpy as np
import pytest
import torch
from PIL import Image

import diffuvolume_tpu.data.sceneflow as j_sf
import diffuvolume_tpu_torch.data.sceneflow as t_sf
from diffuvolume_tpu.data.readers import write_pfm
from diffuvolume_tpu.models import MODELS as J_MODELS
from diffuvolume_tpu.tools.convert_torch import convert_acv_state_dict
from diffuvolume_tpu.tools.convert_torch_igev import convert_igev_state_dict
from diffuvolume_tpu.tools.convert_torch_pcw import convert_pcw_state_dict
from diffuvolume_tpu_torch.cli import evaluate, save_disp
from diffuvolume_tpu_torch.data.readers import read_pfm
from diffuvolume_tpu_torch.models import MODELS, build_model
from diffuvolume_tpu_torch.models.layers import BasicBlock
from diffuvolume_tpu_torch.tools import bench, weights
from diffuvolume_tpu_torch.tools.random_weights import (
    PCW_RESIDUAL_BN_SCALE,
    calibrate_heads,
    random_acv,
)

MAXDISP = 64
CROP = (64, 96)


@pytest.fixture(scope="module")
def sceneflow(tmp_path_factory):
    """Two pairs at 72×112 in the SceneFlow test tree's layout, the right
    image the left shifted 3 px, PFM ground truth near 3 px with a strip
    of invalid (0) pixels."""
    root = tmp_path_factory.mktemp("sceneflow")
    g = np.random.default_rng(31)
    scene = root / "frames_finalpass" / "TEST" / "A" / "0000"
    for eye in ("left", "right"):
        os.makedirs(scene / eye)
    os.makedirs(root / "disparity" / "TEST" / "A" / "0000" / "left")
    for frame in ("0006", "0007"):
        img = g.integers(0, 255, (72, 112, 3)).astype(np.uint8)
        Image.fromarray(img).save(scene / "left" / f"{frame}.png")
        Image.fromarray(np.roll(img, -3, axis=1)).save(scene / "right" / f"{frame}.png")
        disp = (3.0 + g.uniform(0, 0.5, (72, 112))).astype(np.float32)
        disp[:, :10] = 0.0
        write_pfm(str(root / "disparity" / "TEST" / "A" / "0000" / "left" / f"{frame}.pfm"),
                  disp)
    return str(root)


def _reference_ckpt(model, path) -> str:
    sd = {f"module.{k}": v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "epoch": 3}, path)
    return str(path)


@pytest.mark.parametrize("backbone,diffusion", [
    ("acv", False), ("acv", True), ("pcw", False), ("pcw", True), ("igev", False),
    ("igev", True),
])
def test_reference_checkpoint_round_trip(tmp_path, backbone, diffusion):
    """port state dict → reference checkpoint file → the JAX converter →
    ``tools/weights.py`` → the same tensors; and the port CLI's loader reads
    the file into the same state dict."""
    base_name, ddim_name = evaluate.BACKBONES[backbone][:2]
    model = build_model(ddim_name if diffusion else base_name, max_disp=MAXDISP)
    with torch.no_grad():  # distinct values everywhere, BatchNorm statistics included
        g = torch.Generator().manual_seed(5)
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g))
    path = _reference_ckpt(model, tmp_path / "ref.ckpt")
    convert, rebuild = {
        "acv": (convert_acv_state_dict, weights.state_dict_from_jax),
        "pcw": (convert_pcw_state_dict, weights.pcw_state_dict_from_jax),
        "igev": (convert_igev_state_dict, weights.igev_state_dict_from_jax),
    }[backbone]
    variables = convert(torch.load(path, map_location="cpu")["model"], diffusion=diffusion)
    back = rebuild(variables, diffusion=diffusion)
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(back[k], v), k
    loaded = evaluate.load_model(path, backbone, diffusion, MAXDISP, 0, torch.device("cpu"))
    assert not loaded.training
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k


def _final_line(text: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith("FINAL:"))
    return ast.literal_eval(line.removeprefix("FINAL:").strip())


def test_evaluate_baseline_only_matches_jax_cli(sceneflow, tmp_path, monkeypatch, capsys):
    """Both CLIs over the same checkpoint file and images: the ACV baseline
    alone at maxdisp 64, two 64×96 crops.  The checkpoint is a tamed random
    ACVNet, as a trained one is tame: each 2-D residual block's ``conv2``
    BatchNorm weight × ``PCW_RESIDUAL_BN_SCALE`` (``random_pcw``'s rule),
    the heads calibrated on the first crop (logit std 3).  At the JAX
    package's initialisation untamed, the trunk's activations reach 1e12
    and float32 summation order alone moves the second crop's disparity by
    up to 0.97 px between the two packages (mean 0.057; the floor recorded
    for ACV's card-vs-CPU gap); tamed, both crops agree within 3e-4 px."""
    from diffuvolume_tpu.cli import evaluate as j_evaluate

    for mod in (j_sf, t_sf):
        monkeypatch.setattr(mod.SceneFlowDataset, "TEST_CROP", CROP)
    s = t_sf.SceneFlowDataset(sceneflow)[0]
    model = random_acv(MAXDISP, False, torch.Generator().manual_seed(11))
    with torch.no_grad():
        for block in model.modules():
            if isinstance(block, BasicBlock):
                block.conv2[1].weight.mul_(PCW_RESIDUAL_BN_SCALE)
    calibrate_heads(model, torch.from_numpy(s["left"])[None], torch.from_numpy(s["right"])[None],
                    target_std=3.0)
    ckpt = _reference_ckpt(model, tmp_path / "baseline.ckpt")
    argv = ["--backbone", "acv", "--datapath", sceneflow, "--baseline_ckpt", ckpt,
            "--baseline_only", "--maxdisp", str(MAXDISP), "--max_images", "2"]

    got = evaluate.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    j_evaluate.main(argv)
    jax_out = capsys.readouterr().out
    want = _final_line(jax_out)
    assert _final_line(port_out) == got["final"]
    assert set(got["final"]) == set(want) == {"EPE", "D1", "Thres1", "Thres2", "Thres3"}
    assert got["device"] == "cpu"
    assert got["final"]["EPE"] == pytest.approx(want["EPE"], abs=1e-4)
    for k in ("D1", "Thres1", "Thres2", "Thres3"):  # shares of 4,992 pixels an image
        assert got["final"][k] == pytest.approx(want[k], abs=1e-3), k
    assert "throughput:" in port_out and "[0/2]" in port_out


def test_save_disp_writes_each_pair(sceneflow, tmp_path, monkeypatch):
    """Random weights, the two-pass ACV DDIM pipeline on the CPU: one PFM a
    pair, of the crop's size, finite, in [0, maxdisp); the KITTI 16-bit PNG
    writer stores disparity × 256."""
    monkeypatch.setattr(t_sf.SceneFlowDataset, "TEST_CROP", CROP)
    out = save_disp.main(["--datapath", sceneflow, "--device", "cpu", "--maxdisp",
                          str(MAXDISP), "--format", "pfm", "--max_images", "1",
                          "--outdir", str(tmp_path / "pred")])
    assert [os.path.basename(p) for p in out] == ["0006.pfm"]
    disp, _ = read_pfm(out[0])
    assert disp.shape == CROP and np.isfinite(disp).all()
    assert disp.min() >= 0 and disp.max() < MAXDISP
    save_disp.save_png16(str(tmp_path / "d.png"), disp)
    arr = np.asarray(Image.open(tmp_path / "d.png"))
    assert arr.shape == CROP and arr.dtype == np.uint16
    np.testing.assert_array_equal(arr, np.clip(disp * 256.0, 0, 65535).astype(np.uint16))


def test_registry_names_match_jax():
    """Every name of the JAX registry; each builds the port's model with
    the JAX registry's ``diffusion`` setting; ``gwcnet-g`` without the
    concat volume."""
    assert set(MODELS) == set(J_MODELS)
    for name in MODELS:
        m = build_model(name, max_disp=MAXDISP)
        assert m.diffusion == name.endswith("_ddim") and m.max_disp == MAXDISP
        if name.startswith(("gwcnet", "pcwnet")):
            assert m.use_concat_volume == (name != "gwcnet-g")


def test_entry_points_refuse_to_run_without_a_card(sceneflow, monkeypatch):
    """Without a CUDA device the CLIs raise unless asked for the CPU, and the
    bench exits non-zero: no silent fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--datapath", sceneflow])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        save_disp.main(["--datapath", sceneflow])
    with pytest.raises(SystemExit):
        bench.main(["--model", "igev", "--reps", "1"])
    args = bench.parse_args([])
    assert (args.model, args.reps, args.iters, args.f32, args.refine_module) == (
        "acv", 5, 32, False, False)
