"""The training path reaches none of the port's kernels, and a kernel
refuses what it could not differentiate.

The kernels have no backward (nor do the JAX package's Pallas kernels: every
packed dispatch there is gated on ``not train``).  On a CUDA tensor a
wrapper's output carries no autograd history, so a training forward that
called one would train without the gradient through it, silently.  Here:

* every wrapper of ``ops/kernels/`` that a model module imports is replaced
  by one that raises, in the importing module and in its own, and one CPU
  training step of ACVNet (each SceneFlow stage), PCWNet and IGEV-Stereo
  runs to its end with a gradient on every parameter it reaches;
* ``_build.check_cuda``, which every wrapper calls before it launches,
  refuses a CUDA tensor that requires grad in grad mode and takes it under
  ``torch.no_grad`` (a stand-in tensor: there is no card here; the card
  test is ``tests/test_torch_gpu.py``).
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from diffuvolume_tpu_torch.models.acv import ACVNet
from diffuvolume_tpu_torch.models.igev.model import IGEVStereo
from diffuvolume_tpu_torch.models.pcw import PCWNet
from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.train.loop import (
    TrainState,
    make_igev_train_step,
    make_optimizer,
    make_train_step,
)
from diffuvolume_tpu_torch.train.loss import (
    KITTI12_WEIGHTS,
    SCENEFLOW_WEIGHTS,
    SCENEFLOW_WEIGHTS_ATTN_ONLY,
    SCENEFLOW_WEIGHTS_FREEZE_ATTN,
)
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

MODEL_MODULES = ["models.layers", "models.acv", "models.pcw", "models.igev.model",
                 "models.igev.extractor", "models.igev.geometry", "models.igev.update"]
KERNEL_MODULES = ["concat_volume", "conv2d", "conv3d_fold", "conv3d_up", "depthwise",
                  "fused_head", "gwc_volume", "layout"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread for this file: under the suite's
    parallel workers its default pool contends with theirs, and the
    training steps here ran some 50× slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wrappers():
    """(kernel module, name) of every function there that counts launches."""
    out = []
    for km in KERNEL_MODULES:
        mod = importlib.import_module(f"diffuvolume_tpu_torch.ops.kernels.{km}")
        for name, fn in vars(mod).items():
            if inspect.isfunction(fn) and hasattr(fn, "launches"):
                out.append((mod, name))
    return out


@pytest.fixture
def no_kernels(monkeypatch):
    """Every wrapper raises, wherever a model module reaches it."""
    called = []

    def refuse(name):
        def wrapper(*args, **kwargs):
            called.append(name)
            raise AssertionError(f"the training path called the kernel wrapper {name}")
        return wrapper

    wrappers = _wrappers()
    assert len(wrappers) >= 19
    for mod, name in wrappers:
        monkeypatch.setattr(mod, name, refuse(name))
    for mm in MODEL_MODULES:
        mod = importlib.import_module(f"diffuvolume_tpu_torch.{mm}")
        for _, name in wrappers:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse(name))
    return called


def _batch(seed, b, h, w, max_disp, raw=False):
    g = np.random.default_rng(seed)
    left = g.uniform(0, 255, (b, h, w, 3)) if raw else g.normal(0, 0.3, (b, h, w, 3))
    gt = g.uniform(1.0, max_disp - 1.0, (b, h, w))
    return {"left": torch.tensor(left, dtype=torch.float32),
            "right": torch.tensor(np.roll(left, -3, axis=2), dtype=torch.float32),
            "disp_gt": torch.tensor(gt, dtype=torch.float32)}


def _step(model, step_fn, batch):
    gen = torch.Generator().manual_seed(0)
    model.init_weights(gen).train()
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    out = step_fn(state, batch, gen)
    assert state.step == 1 and torch.isfinite(out["loss"])
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("stage,weights", [
    ("full", SCENEFLOW_WEIGHTS), ("attn_only", SCENEFLOW_WEIGHTS_ATTN_ONLY),
    ("freeze_attn", SCENEFLOW_WEIGHTS_FREEZE_ATTN)])
def test_acv_step_reaches_no_kernel(no_kernels, stage, weights):
    model = ACVNet(64, True, attn_weights_only=stage == "attn_only",
                   freeze_attn_weights=stage == "freeze_attn")
    grads = _step(model, make_train_step(model, weights), _batch(0, 1, 32, 64, 64))
    assert not no_kernels
    if stage == "full":
        assert all(g is not None and g.abs().sum() > 0 for g in grads.values())
    if stage == "freeze_attn":
        assert not grads["feature_extraction.firstconv.0.0.weight"].any()


def test_pcw_step_reaches_no_kernel(no_kernels):
    model = PCWNet(64, True)
    grads = _step(model, make_train_step(model, KITTI12_WEIGHTS), _batch(1, 1, 64, 64, 64))
    assert not no_kernels
    assert all(g is not None and g.abs().sum() > 0 for g in grads.values())


def test_igev_step_reaches_no_kernel(no_kernels):
    model = IGEVStereo(64, True)
    grads = _step(model, make_igev_train_step(model, iters=1),
                  _batch(2, 1, 64, 96, 64, raw=True))
    assert not no_kernels
    assert all(g is not None for g in grads.values())


def test_the_patch_would_catch_an_eval_forward(no_kernels):
    """The same patch stops the eval forward, which runs on the kernels."""
    model = ACVNet(64, False).eval()
    b = _batch(0, 1, 32, 64, 64)
    with torch.no_grad(), pytest.raises(AssertionError, match="kernel wrapper"):
        model(b["left"], b["right"])
    assert no_kernels


class _CudaStandIn:
    """What ``check_cuda`` reads of a tensor, on a CUDA device."""

    def __init__(self, requires_grad: bool):
        self.device = torch.device("cuda:0")
        self.requires_grad = requires_grad

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("requires_grad", [False, True])
def test_check_cuda_refuses_tracked_tensors_in_grad_mode(requires_grad):
    x = _CudaStandIn(requires_grad)
    if requires_grad:
        with pytest.raises(RuntimeError, match="no backward"):
            _build.check_cuda(_CudaStandIn(False), x)
    else:
        _build.check_cuda(x)
    with torch.no_grad():
        _build.check_cuda(x)
