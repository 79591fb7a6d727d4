"""What the benchmark takes from the program under test
(``diffuvolume_tpu_torch``): its models built from a state dict, its
two-pass evaluation entry and its training step.  Imported only inside
these functions, so that the harness's other modules and the reference
load without it.
"""

from __future__ import annotations

import importlib

import torch


def ddim_config(cfg: dict):
    from diffuvolume_tpu_torch.diffusion.ddim import DDIMConfig

    s = dict(cfg["sampler"])
    s["ensemble_weights"] = tuple(s["ensemble_weights"])
    return DDIMConfig(**s)


def _model(family, name: str, cfg: dict, state: dict, dev):
    from diffuvolume_tpu_torch.models import build_model

    with torch.device(dev):
        model = build_model(family.PORT[name], **family.port_kwargs(cfg))
    model.load_state_dict(state, strict=True)
    return model


def eval_models(family, cfg: dict, base_state: dict, ddim_state: dict, dev):
    """The baseline and DDIM models in the evaluation dtype, eval mode,
    folded once (the folded path the evaluate CLI takes)."""
    module, name = family.PORT["fold"]
    fold = getattr(importlib.import_module(module), name)
    dtype = getattr(torch, cfg["eval"]["dtype"])
    return tuple(fold(_model(family, k, cfg, s, dev).to(dtype).eval())
                 for k, s in (("baseline", base_state), ("ddim", ddim_state)))


def eval_entry(family):
    """``call(models, ddim_cfg, left, right, noise, dev) → (final, baseline)``,
    the program's two-pass entry (looked up at each call)."""
    def call(models, ddim_cfg, left, right, noise, dev):
        from diffuvolume_tpu_torch.eval import pipeline

        return getattr(pipeline, family.PORT["entry"])(
            *models, left, right, ddim_cfg, device=dev, noise_source=noise)
    return call


class Trainer:
    """The program's training state and step (``train/loop.py``): the DDIM
    model in float32 from ``state``, Adam, the recipe's learning rate, the
    step with the loss weights; ``bf16`` its autocast path."""

    def __init__(self, family, cfg: dict, state: dict, dev, bf16: bool = False):
        from diffuvolume_tpu_torch.train.loop import TrainState, make_optimizer, make_train_step
        from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule

        t = cfg["train"]
        self.model = _model(family, "ddim", cfg, state, dev).train()
        self.state = TrainState(self.model, make_optimizer(self.model),
                                milestone_lr_schedule(t["lr"], t["lrepochs"], t["steps_per_epoch"]))
        self.step_fn = make_train_step(self.model, tuple(t["loss_weights"]), bf16=bf16)

    def step(self, batch, t, noise) -> dict:
        """One step: ``{"loss", "pred" (the last head's disparity)}``."""
        left, right, gt = batch
        return self.step_fn(self.state, {"left": left, "right": right, "disp_gt": gt},
                            t=t, noise=noise)

    def params(self) -> dict:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def first_moments(self) -> dict:
        """Each parameter's Adam first moment, by name (zero before its
        first update)."""
        opt = self.state.optimizer
        return {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                for k, p in self.model.named_parameters()}
