"""The training step of the three recipes, on one card.

Counterpart of ``diffuvolume_tpu/train/loop.py``.  Reference semantics:
SceneFlow/main.py:126-156 (clamp the ground truth, bilinear ↓4, ÷4, the
diffusion-conditioned forward, weighted smooth-L1, Adam) and
KITTI15/train_stereo.py:150-174 (the GRU rollout, the sequence loss, the
gradient-norm clip, AdamW).  A ``TrainState`` holds the model, its
optimiser, the learning-rate schedule and the step count; a step updates
the model and the optimiser in place.  The step draws one timestep for the
whole batch and the noise from an explicit ``torch.Generator``; both can be
passed in instead (the tests feed the JAX step's draws).  Gradients run
through the differentiable plain ops, never the kernels (which have no
backward), as the JAX package's training runs XLA's.  Given a
``parallel.Mesh``, a step takes this rank's rows of the global batch: it
draws the global batch's timestep and noise and keeps its data rows,
divides its loss by the global count of valid pixels, sums the gradients
over the ranks before the clip and the optimiser, and reports the global
loss and EPE (``parallel/ddp.py``).  A grid with a volume axis
(``parallel/volume_sharding.py``) makes every step run inside
``volume_sharding(mesh)``: the model keeps its band of the volume's rows
(ACV and PCW also of the noise; IGEV's noise multiplies the gathered GEV
whole), its heads return the band's full-resolution rows, the loss and the
EPE take the same rows of the ground truth (and of ``valid``), and the sums
over the world add the bands' shares (the gradient of whatever runs whole
on every rank, the trunk, PCW's refinement, IGEV's rollout, is linear in
each band's share).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from diffuvolume_tpu_torch.diffusion import encode_disparity_volume, make_schedule, q_sample
from diffuvolume_tpu_torch.ops.regression import resize_bilinear
from diffuvolume_tpu_torch.parallel.volume_sharding import constrain_volume, volume_sharding
from diffuvolume_tpu_torch.train.loss import SCENEFLOW_WEIGHTS, multi_scale_loss, sequence_loss
from diffuvolume_tpu_torch.train.lr import Schedule
from diffuvolume_tpu_torch.utils.spans import TRAIN_BACKWARD, TRAIN_FORWARD, TRAIN_OPTIMIZER, span

TIMESTEPS = 1000


@dataclasses.dataclass
class TrainState:
    """The model, its optimiser, the schedule of its learning rate, the
    global-norm clip (None: none) and the updates made so far."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    grad_clip: float | None = None
    step: int = 0


def make_optimizer(model: torch.nn.Module, optimizer: str = "adam",
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """``optax.adam`` (betas 0.9/0.999, eps 1e-8, no decay; SceneFlow and
    KITTI12) or ``optax.adamw`` with ``weight_decay`` (KITTI15), over the
    trainable parameters; the rate is set by ``apply_gradients``."""
    params = [p for p in model.parameters() if p.requires_grad]
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if optimizer == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    raise ValueError(f"optimizer must be 'adam' or 'adamw', got {optimizer!r}")


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``: the gradients scaled by ``max_norm /
    ‖g‖`` when the global norm ``‖g‖ ≥ max_norm`` (``clip_grad_norm_``
    divides by ``‖g‖ + 1e-6``).  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def apply_gradients(state: TrainState) -> None:
    """Clip (if the state says so), set the rate to ``schedule(step)``, step
    the optimiser, count the step.  A parameter the loss did not reach gets
    a zero gradient first: optax updates every leaf (its moments decay, the
    weight decay applies), where PyTorch's optimisers skip a ``None``."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if state.grad_clip is not None:
        clip_by_global_norm_(params, state.grad_clip)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def _autocast(device: torch.device, bf16: bool):
    return (torch.autocast(device.type, dtype=torch.bfloat16) if bf16
            else contextlib.nullcontext())


def _quarter_gt(disp_gt: torch.Tensor, hi: float) -> torch.Tensor:
    """The ground truth clamped to ``[0, hi]``, bilinear ↓4, ÷4 (bin units)."""
    b, h, w = disp_gt.shape
    return resize_bilinear(disp_gt.clamp(0.0, hi), (h // 4, w // 4), 1, 2) / 4.0


def draw_t(b: int, device, generator: torch.Generator | None) -> torch.Tensor:
    """One timestep in [0, 1000) for the whole batch (acv_ddim.py:441)."""
    return torch.randint(0, TIMESTEPS, (1,), generator=generator, device=device).expand(b)


def _epe(pred: torch.Tensor, disp_gt: torch.Tensor, mask: torch.Tensor, dp=None) -> torch.Tensor:
    m = mask.float()
    num, den = ((pred.detach().float() - disp_gt).abs() * m).sum(), m.sum()
    if dp is not None:
        num, den = dp.sum(num), dp.sum(den)
    return num / den.clamp_min(1.0)


def _draws(b: int, shape, dev, generator, t, noise, dp):
    """The step's timestep ``(b,)`` and noise ``(b, *shape)``: drawn for the
    global batch (``b × n_data`` rows) when not given, in the order
    timestep then noise, and this rank's data rows kept."""
    n = b if dp is None else b * dp.n_data
    if t is None:
        t = draw_t(n, dev, generator)
        t = t if dp is None else dp.rows(t)
    if noise is None:
        noise = torch.randn((n, *shape), generator=generator, device=dev)
        noise = noise if dp is None else dp.rows(noise)
    return t, noise


def _update(state: TrainState, loss: torch.Tensor, dp) -> None:
    with span(TRAIN_BACKWARD):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if dp is not None:
        dp.all_reduce_gradients(p for g in state.optimizer.param_groups for p in g["params"])
    with span(TRAIN_OPTIMIZER):
        apply_gradients(state)


def make_train_step(model, weights=SCENEFLOW_WEIGHTS, bf16: bool = False,
                    dp=None) -> Callable:
    """The ACV / PCW step: ``step(state, batch, generator=None, t=None,
    noise=None) → {"loss", "epe", "pred"}`` (detached; ``pred`` the last
    head).  Batch: ``left``/``right`` ``(B, H, W, 3)``, ``disp_gt`` ``(B, H,
    W)`` on the model's device (with ``dp``, this rank's rows).  ``bf16``:
    autocast to bfloat16 over float32 master weights (the JAX package's
    ``dtype`` with float32 params).  With a volume axis in ``dp``, the step
    runs inside ``volume_sharding(dp)`` and ``pred`` and ``gt`` are this
    rank's rows."""
    reduce = None if dp is None else dp.sum

    def step(state: TrainState, batch, generator=None, t=None, noise=None) -> dict:
        with volume_sharding(dp):
            return split_step(state, batch, generator, t, noise)

    def split_step(state, batch, generator, t, noise) -> dict:
        left, right, disp_gt = batch["left"], batch["right"], batch["disp_gt"]
        b, h, w = disp_gt.shape
        max_disp = model.max_disp
        dev = disp_gt.device
        with span(TRAIN_FORWARD):
            mask = (disp_gt < max_disp) & (disp_gt > 0)
            disp_q = _quarter_gt(disp_gt, max_disp - 1)
            t, noise = _draws(b, (max_disp // 4, h // 4, w // 4), dev, generator, t, noise, dp)
            model.train()
            with _autocast(dev, bf16):
                preds = model.train_forward(left, right, disp_q, t, noise)
            # The heads' rows (this rank's band under the volume split).
            disp_gt, mask = constrain_volume(disp_gt), constrain_volume(mask)
            loss = multi_scale_loss(preds, disp_gt, mask, weights, reduce)
        _update(state, loss, dp)
        loss = loss.detach()
        return {"loss": loss if dp is None else dp.sum(loss),
                "epe": _epe(preds[-1], disp_gt, mask, dp), "pred": preds[-1].detach(),
                "gt": disp_gt}

    return step


def make_igev_train_step(model, iters: int = 22, bf16: bool = False, dp=None) -> Callable:
    """The KITTI15 step (train_stereo.py:150-174): the diffusion-conditioned
    GRU rollout, the sequence loss over its iterates; the state's optimiser
    carries the clip.  Batch: ``left``/``right`` ``(B, H, W, 3)`` (RAW
    [0, 255] in the reference), ``disp_gt`` ``(B, H, W)``, optional
    ``valid``.  Returns as ``make_train_step``'s step."""
    from diffuvolume_tpu_torch.models.igev.model import igev_train_forward

    num_bins = model.max_disp // 4
    reduce = None if dp is None else dp.sum

    def step(state: TrainState, batch, generator=None, t=None, noise=None) -> dict:
        with volume_sharding(dp):
            return split_step(state, batch, generator, t, noise)

    def split_step(state, batch, generator, t, noise) -> dict:
        left, right, disp_gt = batch["left"], batch["right"], batch["disp_gt"]
        valid = batch.get("valid")
        b, h, w = disp_gt.shape
        dev = disp_gt.device
        with span(TRAIN_FORWARD):
            if valid is None:
                valid = (disp_gt > 0).float()
            disp_q = _quarter_gt(disp_gt, 4.0 * (num_bins - 1))
            t, noise = _draws(b, (num_bins, h // 4, w // 4), dev, generator, t, noise, dp)
            x_start = encode_disparity_volume(disp_q, num_bins, model.scale)
            noisy = q_sample(make_schedule(TIMESTEPS, device=dev), x_start, t, noise)
            model.train()
            with _autocast(dev, bf16):
                init_up, disp_ups = igev_train_forward(model, left, right, iters, noisy, t)
            # The iterates' rows (this rank's band under the volume split).
            disp_gt, valid = constrain_volume(disp_gt), constrain_volume(valid)
            loss = sequence_loss(disp_ups, init_up, disp_gt, valid, max_disp=model.max_disp,
                                 reduce=reduce)
        _update(state, loss, dp)
        mask = (valid >= 0.5) & (disp_gt < model.max_disp)
        loss = loss.detach()
        return {"loss": loss if dp is None else dp.sum(loss),
                "epe": _epe(disp_ups[-1], disp_gt, mask, dp), "pred": disp_ups[-1].detach(),
                "gt": disp_gt}

    return step
