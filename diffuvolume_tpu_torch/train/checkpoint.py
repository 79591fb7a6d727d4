"""Checkpoints in the reference's layout, and its partial warm start.

Counterpart of ``diffuvolume_tpu/train/checkpoint.py``.  A checkpoint is a
``torch.save`` file ``{"step", "model", "optimizer"}`` (the reference saves
``{"epoch", "model", "optimizer"}``, SceneFlow/main.py:118-121), named
``checkpoint_{step:06d}.ckpt`` in the run's directory; its ``model`` entry
loads in ``cli/evaluate.py`` as a reference checkpoint.  ``--resume`` takes
the latest (main.py:73-83); ``partial_warm_start`` copies the entries that
both state dicts hold with one shape (main.py:84-91), so that a diffusion
model absorbs a plain backbone's checkpoint.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.ckpt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"checkpoint_{step:06d}.ckpt")


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> str:
    """Write ``{step, model, optimizer}`` (tensors on the CPU) for ``step``;
    returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    state = {"step": step,
             "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "optimizer": None if optimizer is None else optimizer.state_dict()}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    """The highest step saved in ``ckpt_dir``, None if there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None = None) -> dict | None:
    """The saved dict of ``step`` (the latest by default) on the CPU, None if
    the directory holds none."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu")


def restore_checkpoint(ckpt_dir: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer | None = None,
                       step: int | None = None) -> int | None:
    """Load the given (or latest) step into ``model`` and ``optimizer`` in
    place; returns the step, None if there is nothing to restore."""
    state = load_checkpoint(ckpt_dir, step)
    if state is None:
        return None
    model.load_state_dict(state["model"])
    if optimizer is not None and state.get("optimizer") is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def partial_warm_start(target: dict, source: dict) -> dict:
    """``target`` with every entry that ``source`` also holds, at the same
    shape, taken from ``source`` (the others stay)."""
    out = dict(target)
    for k, v in source.items():
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = v.to(out[k].dtype)
    return out
