"""The port's spans (``utils/spans.py``) on the CPU.

* With no profiler recording, ``span`` enters no ``record_function``
  (replaced here by one that raises) and is one shared no-op.
* Under a CPU-only torch.profiler, a folded ACV call (DDIM-5) and a folded
  PCW call (KITTI12 DDIM-3) at 32×64 emit the tree of the spans' table:
  one ``dv.infer``, one ``dv.prep`` in it, a ``dv.ddim.step`` a sampling
  step, ``dv.features`` in both passes, ``dv.refine`` in pass 1 and in
  every step (PCW), and a ``dv.h2d`` for every host-built array copied,
  counted below by where it is made.
* A float64 ACV training step emits ``dv.train.forward``,
  ``dv.train.backward`` and ``dv.train.optimizer`` once each, side by side.
* The names emitted are the module's constants, with its prefix.
"""

import collections
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffuvolume_tpu_torch.diffusion.ddim import KITTI12_DDIM, DDIMConfig
from diffuvolume_tpu_torch.eval.pipeline import acv_ddim_inference, pcw_ddim_inference
from diffuvolume_tpu_torch.models.acv_fold import fold_acv
from diffuvolume_tpu_torch.models.pcw_fold import fold_pcw
from diffuvolume_tpu_torch.ops.regression import resize_linear
from diffuvolume_tpu_torch.tools.random_weights import random_acv, random_pcw_pair
from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule
from diffuvolume_tpu_torch.utils import spans

H, W, MD = 32, 64, 64

# Host-built arrays copied in a call: the schedule's buffers and the
# ensemble weights (in dv.infer); the conditioning latent's ↓4, two
# matrices (pass 1); a step's re-encode and renewal mask, two each; PCW's
# refinement input, both views' features resized over H and W.  On the CPU
# the heads take their plain versions, which resize over D, H and W by
# three matrices a head (the card's kernels build none).
SCHEDULE, ENSEMBLE, LATENT, STEP, REFINE, HEAD = 11, 1, 2, 4, 4, 3


def _tree(fn) -> collections.Counter:
    """``{(span, innermost enclosing span or None): count}`` of ``fn()``'s
    spans under a CPU-only profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    tree = collections.Counter()
    for e in prof.events():
        if not e.name.startswith(spans.PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(spans.PREFIX):
            p = p.cpu_parent
        tree[(e.name, None if p is None else p.name)] += 1
    return tree


def _pair(seed: int):
    g = torch.Generator().manual_seed(seed)
    left = torch.randn((1, H, W, 3), generator=g) * 0.3
    return left, torch.roll(left, -3, 2)


@pytest.fixture(scope="module")
def acv_tree():
    g = torch.Generator().manual_seed(0)
    base, ddim = fold_acv(random_acv(MD, False, g)), fold_acv(random_acv(MD, True, g))
    cfg = dataclasses.replace(DDIMConfig(), max_disp=MD, num_bins=MD // 4)
    return cfg, _tree(lambda: acv_ddim_inference(base, ddim, *_pair(1), cfg, device="cpu"))


@pytest.fixture(scope="module")
def pcw_tree():
    base, ddim = random_pcw_pair(MD, torch.Generator().manual_seed(2))
    base, ddim = fold_pcw(base), fold_pcw(ddim)
    cfg = dataclasses.replace(KITTI12_DDIM, max_disp=MD, num_bins=MD // 4)
    return cfg, _tree(lambda: pcw_ddim_inference(base, ddim, *_pair(3), cfg, device="cpu"))


@pytest.fixture(scope="module")
def train_tree():
    g = torch.Generator().manual_seed(4)
    model = random_acv(MD, True, g).double().train()
    state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
    left, right = (x.double() for x in _pair(5))
    gt = torch.rand((1, H, W), generator=g, dtype=torch.float64) * 40 + 1
    step = make_train_step(model)
    return _tree(lambda: step(state, {"left": left, "right": right, "disp_gt": gt},
                              generator=g))


def _name(n: str) -> str:
    return spans.PREFIX + n


def test_span_off_enters_no_record_function(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span(spans.INFER) is spans.span(spans.H2D)
    with spans.span(spans.DDIM_STEP), spans.span(spans.H2D):
        out = resize_linear(torch.ones(2, 8), 4, 1)
    assert out.shape == (2, 4)


def test_acv_call_emits_the_tree(acv_tree):
    cfg, tree = acv_tree
    n = cfg.sampling_steps
    want = {
        (_name(spans.INFER), None): 1,
        (_name(spans.PREP), _name(spans.INFER)): 1,
        (_name(spans.FEATURES), _name(spans.PREP)): 2,
        (_name(spans.DDIM_STEP), _name(spans.INFER)): n,
        (_name(spans.H2D), _name(spans.INFER)): SCHEDULE + ENSEMBLE,
        (_name(spans.H2D), _name(spans.PREP)): LATENT + HEAD,
        (_name(spans.H2D), _name(spans.DDIM_STEP)): n * (STEP + HEAD),
    }
    assert dict(tree) == want


def test_pcw_call_emits_the_tree(pcw_tree):
    cfg, tree = pcw_tree
    n = cfg.sampling_steps
    want = {
        (_name(spans.INFER), None): 1,
        (_name(spans.PREP), _name(spans.INFER)): 1,
        (_name(spans.FEATURES), _name(spans.PREP)): 2,
        (_name(spans.REFINE), _name(spans.PREP)): 1,
        (_name(spans.DDIM_STEP), _name(spans.INFER)): n,
        (_name(spans.REFINE), _name(spans.DDIM_STEP)): n,
        (_name(spans.H2D), _name(spans.INFER)): SCHEDULE + ENSEMBLE,
        (_name(spans.H2D), _name(spans.PREP)): LATENT + HEAD,
        (_name(spans.H2D), _name(spans.REFINE)): (1 + n) * REFINE,
        # Each step's heads: the disparity and the uncertainty at it.
        (_name(spans.H2D), _name(spans.DDIM_STEP)): n * (STEP + 2 * HEAD),
    }
    assert dict(tree) == want


def test_train_step_emits_its_three_spans(train_tree):
    top = {k: v for k, v in train_tree.items() if k[1] is None}
    assert top == {(_name(spans.TRAIN_FORWARD), None): 1,
                   (_name(spans.TRAIN_BACKWARD), None): 1,
                   (_name(spans.TRAIN_OPTIMIZER), None): 1}
    # The ground truth's ↓4 and the schedule's buffers: in the forward.
    assert set(train_tree) - set(top) == {(_name(spans.H2D), _name(spans.TRAIN_FORWARD))}


def test_span_names_are_the_constants(acv_tree, pcw_tree, train_tree):
    emitted = {name for tree in (acv_tree[1], pcw_tree[1], train_tree) for name, _ in tree}
    assert emitted == {_name(n) for n in spans.NAMES}
    assert emitted == {"dv.infer", "dv.prep", "dv.features", "dv.refine", "dv.ddim.step",
                       "dv.h2d", "dv.train.forward", "dv.train.backward", "dv.train.optimizer"}
