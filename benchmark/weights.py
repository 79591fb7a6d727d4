"""Weights and inputs made on the card from ``--seed``.

The initialisation is a frozen copy of the arithmetic of
``diffuvolume_tpu_torch/models/layers.py:init_weights`` and
``diffuvolume_tpu_torch/tools/random_weights.py`` (``_draw_batchnorm``,
``tame_residual_branches``, ``calibrate_heads`` / ``calibrate_pcw``) at
commit 0c541214e7bc0f7b596b9f45a2d9eed18cdd0d1b, drawn in a few large
calls on the card instead of leaf by leaf on the host:

* convolutions and transposed convolutions, 2-D and 3-D: normal(0,
  sqrt(2 / n)), n the kernel's volume times its output channels; linear
  layers: Xavier uniform; biases 0;
* BatchNorm ``"identity"``: weight 1, bias 0, running mean 0, variance 1;
  ``"drawn"``: weight and running variance uniform in [0.5, 1.5), bias
  and running mean normal with std 0.1;
* ``residual_bn_scale``: each 2-D residual block's last BatchNorm weight
  times this (the repo applies it to PCWNet; the benchmark to both
  networks, see PERF.md);
* ``calibration``: ``[module, target]`` pairs, in order: the module's
  weight is scaled so that its output on the first pair of the pool has
  standard deviation ``target`` (the heads' logits, PCW's refinement
  residual), measured on the reference in float32.

A module registered under two names (IGEV-Stereo's ``norm3``, which is
also ``downsample.1``) is drawn once, under the name ``named_modules``
gives it, and the same tensors stand under its other names in the state.

Then every tensor is rounded to the dtype it is served in.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def draw_state(net: nn.Module, rules: dict, g: torch.Generator, dev) -> dict:
    """A state dict for ``net``'s structure (which may sit on the meta
    device), float32 on ``dev``."""
    normal, uniform = [], []  # (name, shape, scale, offset)
    fixed = {}
    first: dict[int, str] = {}  # a module's first name, by identity
    aliases = []  # (another name, the first name)
    for mname, m in net.named_modules(remove_duplicate=False):
        if id(m) in first:
            aliases.append((mname, first[id(m)]))
            continue
        first[id(m)] = mname
        p = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            n = math.prod(m.kernel_size) * m.weight.shape[1 if m.transposed else 0]
            normal.append((p + "weight", m.weight.shape, math.sqrt(2.0 / n), 0.0))
            if m.bias is not None:
                fixed[p + "bias"] = torch.zeros(m.bias.shape, device=dev)
        elif isinstance(m, nn.Linear):
            bound = math.sqrt(6.0 / sum(m.weight.shape))
            uniform.append((p + "weight", m.weight.shape, 2 * bound, -bound))
            fixed[p + "bias"] = torch.zeros(m.bias.shape, device=dev)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            c = m.num_features
            tame = (rules.get("residual_bn_scale") or 1.0) if mname.endswith("conv2.1") else 1.0
            fixed[p + "num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=dev)
            if rules["batchnorm"] == "identity":
                fixed[p + "weight"] = torch.full((c,), tame, device=dev)
                fixed[p + "bias"] = torch.zeros(c, device=dev)
                fixed[p + "running_mean"] = torch.zeros(c, device=dev)
                fixed[p + "running_var"] = torch.ones(c, device=dev)
            else:
                uniform.append((p + "weight", (c,), tame, 0.5 * tame))
                normal.append((p + "bias", (c,), 0.1, 0.0))
                normal.append((p + "running_mean", (c,), 0.1, 0.0))
                uniform.append((p + "running_var", (c,), 1.0, 0.5))
    state = dict(fixed)
    for leaves, draw in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [math.prod(s) for _, s, _, _ in leaves]
        flat = draw(sum(sizes), generator=g, device=dev)
        counts = torch.tensor(sizes, device=dev)
        scale = torch.repeat_interleave(torch.tensor([l[2] for l in leaves], device=dev), counts)
        offset = torch.repeat_interleave(torch.tensor([l[3] for l in leaves], device=dev), counts)
        flat = flat * scale + offset
        for (name, shape, _, _), part in zip(leaves, flat.split(sizes)):
            state[name] = part.view(shape)
    for alias, name in aliases:
        for key in [k for k in state if k.startswith(name + ".")]:
            state[alias + key[len(name):]] = state[key]
    missing = set(net.state_dict()) ^ set(state)
    if missing:
        raise KeyError(f"the drawn state and the network differ in {sorted(missing)}")
    return state


def served(state: dict, dtype: torch.dtype) -> dict:
    """Floating tensors rounded to ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


@torch.no_grad()
def calibrate(net: nn.Module, state: dict, targets, left, right) -> dict:
    """Scale each ``[module, target]``'s weight in ``state`` so that its
    output on ``left``/``right`` has std ``target`` (the modules in order,
    each measured after the earlier ones are scaled); ``net`` is a
    float32 reference on the images' device."""
    for name, target in targets:
        net.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in state.items()})
        seen = []
        hook = net.get_submodule(name).register_forward_hook(
            lambda _m, _i, out: seen.append(out.float().std()))
        try:
            net(left, right)
        finally:
            hook.remove()
        key = f"{name}.weight"
        state[key] = (state[key].float() * (target / seen[0])).to(state[key].dtype)
    return state


def eval_states(family, cfg: dict, g: torch.Generator, dev, left, right):
    """``(baseline state, DDIM state)``: the DDIM model shares the
    baseline's weights and adds its time embedding; calibrated on the
    reference (float32, TF32 off) and served in the evaluation dtype."""
    rules = cfg["eval"]["weights"]
    dtype = getattr(torch, cfg["eval"]["dtype"])
    with torch.device("meta"):
        shape_net = family.reference(cfg, diffusion=True)
    ddim = served(draw_state(shape_net, rules, g, dev), dtype)
    with torch.device(dev):
        base_net = family.reference(cfg, diffusion=False).eval()
    base = {k: v for k, v in ddim.items() if not k.startswith("time_embedding.")}
    with exact_float32():
        calibrate(base_net, base, rules.get("calibration", []), left, right)
    ddim.update(base)
    return base, ddim


def train_state(family, cfg: dict, g: torch.Generator, dev) -> dict:
    """The DDIM model's initial state for training, float32."""
    with torch.device("meta"):
        shape_net = family.reference(cfg, diffusion=True)
    return draw_state(shape_net, cfg["train"]["weights"], g, dev)


class exact_float32:
    """Within: cuDNN's convolutions and matmuls without TF32 (the
    reference's float32); the two settings are restored on exit."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved
        return False


def image_pairs(n: int, h: int, w: int, std: float, shift: int, g, dev, mean: float = 0.0):
    """``(left, right)`` ``(n, h, w, 3)`` float32: normal images of ``std``
    about ``mean`` (a traffic's ``image_mean``: 0 for normalised images,
    mid-range for RAW ones in [0, 255]), the right one the left shifted
    ``shift`` px."""
    left = torch.randn((n, h, w, 3), generator=g, device=dev) * std + mean
    return left, torch.roll(left, -shift, dims=2)


def sampler_draws(sampler: dict, shape, g, dev) -> dict:
    """The DDIM draws of one batch: ``init`` (noise-initialised samplers),
    ``z`` and ``replace`` for every step; ``replace`` uniform for the
    uniform replacement, normal for a q-sample."""
    n = sampler["sampling_steps"]
    out = {}
    if sampler["init_mode"] == "noise":
        out["init"] = torch.randn(shape, generator=g, device=dev)
    out["z"] = torch.randn((n, *shape), generator=g, device=dev)
    draw = torch.rand if sampler["replace_mode"] == "uniform" else torch.randn
    out["replace"] = draw((n, *shape), generator=g, device=dev)
    return out
