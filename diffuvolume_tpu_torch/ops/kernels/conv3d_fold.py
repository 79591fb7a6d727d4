"""3-D convolution with eval BatchNorm folded into its weights, channels-last.

Kernels: ``csrc/conv3d_fold.cu`` — the bf16 3×3×3 convs on
``csrc/conv_hopper.cuh`` (stride 1: ``conv_s1``; stride 2: ``conv_bf16``),
the bf16 1×1×1 conv on ``csrc/conv_k1.cuh``, a plain FMA kernel in
float32 (``csrc/conv_igemm.cuh``).  They serve six TPU kernels of
``diffuvolume_tpu/ops/pallas/conv3d.py`` (the first, second, fifth and
sixth below share the stride-1 kernel); each has its own wrapper here and
its own launch count:

* ``conv3d_fold_p``  ← ``conv3d_fold_p`` (3×3×3, stride 1, + residual,
  × post_mul)
* ``conv3d_fold_x2`` ← ``conv3d_fold_x2`` (the same conv at the wide entries:
  C_in 64, or the 40-channel patch volume in a 48-channel slot)
* ``conv3d_fold_s2`` ← ``conv3d_fold_s2`` (3×3×3, stride 2)
* ``conv1x1_fold_p`` ← ``conv1x1_fold_p`` (1×1×1, + residual)
* ``conv3d_fold_small`` ← ``conv3d_fold`` (3×3×3 stride 1 at C_in 8 or 16,
  IGEV's module path; C_in 8 runs on a zero-filled half chunk, no slot)
* ``conv3d_packed`` ← ``conv3d_packed`` (3×3×3 stride 1 + bias, ReLU or
  none, at C_in 8 … 128: the module paths' eligible convs after
  ``models/layers.py:route_conv3d``; the TPU kernel's lane packing is not
  carried over, the conv runs on plain NDHWC)

Plain version: ``conv3d_fold_plain``.  Layouts: activations ``(B, D, H, W,
C)``, weights ``(k, k, k, C_in, C_out)`` in the model's dtype, bias
``(C_out,)`` float32, ``post_mul`` ``(B, H_out, W_out, C_out)`` in the
model's dtype, broadcast over D.  The epilogue is conv → + bias → +
residual → ``act`` → × post_mul in float32, then one rounding; ``act`` is
``None``, ``"relu"`` (ACVNet), ``"mish"`` (PCWNet) or ``"leaky"``
(LeakyReLU 0.01, IGEV).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.ops.kernels import _build


# The kernels' activation codes (csrc/conv_igemm.cuh Act).
ACT_CODES = {None: 0, "relu": 1, "mish": 2, "leaky": 3}
LEAKY_SLOPE = 0.01
# The bf16 3×3×3 and 2-D convs' tensor-core forms (csrc/conv_hopper.cuh
# TensorCores): the plan's own choice (wgmma at 64 output channels a tile,
# and 128 at stride 1), or one forced.
TC_AUTO, TC_MMA, TC_WGMMA = -1, 0, 1


def apply_act(y: torch.Tensor, act: str | None) -> torch.Tensor:
    """The epilogue's activation on a float32 tensor.  Mish is taken as the
    kernels take it: ``x·((1+eˣ)² − 1)/((1+eˣ)² + 1)``, ``x`` itself above
    20; ``"leaky"`` is LeakyReLU with slope 0.01."""
    if act is None:
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "leaky":
        return torch.where(y > 0.0, y, LEAKY_SLOPE * y)
    if act == "mish":
        t = (1.0 + torch.exp(y.clamp(max=20.0))) ** 2
        return torch.where(y > 20.0, y, y * (t - 1.0) / (t + 1.0))
    raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")


def finish_plain(y: torch.Tensor, residual, act, post_mul, dtype) -> torch.Tensor:
    """The epilogue on a float32 ``(B, D, H, W, C)`` conv result: + residual,
    ``act``, × post_mul broadcast over D, one rounding to ``dtype``."""
    if residual is not None:
        y = y + residual.float()
    y = apply_act(y, act)
    if post_mul is not None:
        y = y * post_mul.float()[:, None]
    return y.to(dtype).contiguous()


def conv3d_fold_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                      stride: int = 1, residual: torch.Tensor | None = None,
                      act: str | None = None,
                      post_mul: torch.Tensor | None = None) -> torch.Tensor:
    """``act(conv(x, w) + bias + residual) · post_mul`` in float32 through
    ``F.conv3d``, rounded once to ``x``'s dtype; zero padding ``(k - 1) / 2``."""
    k = w.shape[0]
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 None if bias is None else bias.float(), stride=stride, padding=(k - 1) // 2)
    return finish_plain(y.permute(0, 2, 3, 4, 1), residual, act, post_mul, x.dtype)


def check_operands(x, w, bias, residual, out_shape, what: str, post_mul=None,
                   cin_step: int = 16) -> None:
    """Shapes, dtypes, devices, contiguity and alignment of a folded conv's
    operands; raise on anything the kernels do not take.  bf16 input channels
    must be a multiple of ``cin_step``."""
    if x.dim() != 5 or w.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"{what}: x (B, D, H, W, C) and w (k, k, k, C, Co) must agree, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: w is {w.dtype}, x is {x.dtype}")
    if x.dtype == torch.bfloat16 and x.shape[4] % cin_step:
        raise ValueError(f"{what}: bf16 input channels must be a multiple of {cin_step} "
                         f"(zero-fill the slot), got {x.shape[4]}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (w.shape[4],)):
        raise ValueError(f"{what}: bias must be ({w.shape[4]},) float32")
    if residual is not None and (tuple(residual.shape) != tuple(out_shape)
                                 or residual.dtype != x.dtype):
        raise ValueError(f"{what}: residual must be {tuple(out_shape)} {x.dtype}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    pm_shape = (out_shape[0], *out_shape[2:])
    if post_mul is not None and (tuple(post_mul.shape) != pm_shape or post_mul.dtype != x.dtype):
        raise ValueError(f"{what}: post_mul must be {pm_shape} {x.dtype}, got "
                         f"{tuple(post_mul.shape)} {post_mul.dtype}")
    tensors = [t for t in (x, w, bias, residual, post_mul) if t is not None]
    _build.check_cuda(*tensors)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def act_code(act: str | None) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")
    return ACT_CODES[act]


def _fold(x, w, bias, stride, residual, act, ks, wrapper, post_mul=None, cin_step=16,
          tc=TC_AUTO, plan_shape=None):
    if w.shape[:3] != (ks, ks, ks):
        raise ValueError(f"{wrapper.__name__} takes a {ks}×{ks}×{ks} kernel, got "
                         f"{tuple(w.shape[:3])}")
    code = act_code(act)
    if x.device.type == "cpu":
        return conv3d_fold_plain(x, w, bias, stride, residual, act, post_mul)
    b, d, h, wd, cin = x.shape
    pad = (ks - 1) // 2
    osz = [(n + 2 * pad - ks) // stride + 1 for n in (d, h, wd)]
    out_shape = (b, *osz, w.shape[4])
    check_operands(x, w, bias, residual, out_shape, wrapper.__name__, post_mul, cin_step)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if stride == 1:
        plan, ws = None, None
        if ks == 3 and x.dtype == torch.bfloat16:
            splits = 0 if plan_shape is None else s1_plan(
                tuple(plan_shape), w.shape[4], x.device, tc)["splits"]
            plan = s1_plan(tuple(x.shape), w.shape[4], x.device, tc, splits)
            if plan["splits"] > 1:
                ws = torch.empty((plan["splits"], *out_shape), dtype=torch.float32,
                                 device=x.device)
        elif ks == 1 and x.dtype == torch.bfloat16 and w.shape[4] % 8:
            raise ValueError(f"conv1x1_fold_p: bf16 C_out must be a multiple of 8, got "
                             f"{w.shape[4]}")
        _build.launch("dv_conv3d_fold", x, x.data_ptr(), w.data_ptr(), _ptr(bias),
                      _ptr(residual), _ptr(post_mul), out.data_ptr(), _ptr(ws),
                      None if plan is None else plan.ptr, b, d, h, wd, cin, w.shape[4], ks, code)
    else:
        plan, ws = None, None
        if x.dtype == torch.bfloat16:
            if w.shape[4] % 8:
                raise ValueError(f"conv3d_fold_s2: bf16 C_out must be a multiple of 8, got "
                                 f"{w.shape[4]}")
            plan = s2_plan(x.shape, w.shape[4], x.device, tc)
            if plan["splits"] > 1:
                ws = torch.empty((plan["splits"], *out_shape), dtype=torch.float32,
                                 device=x.device)
        _build.launch("dv_conv3d_s2", x, x.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(),
                      _ptr(ws), None if plan is None else plan.ptr, b, d, h, wd, cin, w.shape[4],
                      code)
    wrapper.launches += 1
    return out


@functools.lru_cache(maxsize=256)
def s1_plan(x_shape: tuple, cout: int, device: torch.device, tc: int = TC_AUTO,
            splits: int = 0) -> _build.Plan:
    """The tile plan the bf16 stride-1 3×3×3 kernel (rows 5, 6, 14, 15)
    takes for ``x (B, D, H, W, C) → C_out`` on ``device``
    (``_build.PLAN_KEYS``: the tile, the grid's blocks, the K splits, shared
    memory, blocks per SM, the tensor-core form), made once a shape and
    handed to every launch.  ``splits`` > 0 keeps the tile and sets the K
    splits (the planner weighs 1 … 8 for every tile; an output element's
    sum depends on the splits alone, not on the tile)."""
    b, d, h, w, cin = x_shape
    pl = _build.plan("dv_conv3d_s1_plan", device, b, d, h, w, cin, cout, tc)
    if splits and splits != pl["splits"]:
        pl["splits"] = pl.ints[_build.PLAN_KEYS.index("splits")] = splits
    return pl


@functools.lru_cache(maxsize=256)
def s2_plan(x_shape: tuple, cout: int, device: torch.device, tc: int = TC_AUTO) -> _build.Plan:
    """The tile plan the bf16 stride-2 kernel takes for ``x (B, D, H, W, C)
    → C_out`` on ``device`` (``_build.PLAN_KEYS``: the tile, the grid's
    blocks, the K splits, shared memory, blocks per SM, the tensor-core
    form), made once a shape and handed to every launch."""
    b, d, h, w, cin = x_shape
    return _build.plan("dv_conv3d_s2_plan", device, b, d, h, w, cin, cout, tc)


@functools.lru_cache(maxsize=256)
def k1_plan(x_shape: tuple, cout: int, residual: bool, device: torch.device) -> _build.Plan:
    """The plan the bf16 1×1×1 kernel (row 9, ``csrc/conv_k1.cuh``) takes for
    ``x (B, D, H, W, C) → C_out`` on ``device`` (``_build.K1_PLAN_KEYS``:
    positions a tile, ring stages, grid, blocks an SM, shared memory, tiles,
    channels a tile); the kernel makes the same plan at each launch, this
    reports it."""
    b, d, h, w, cin = x_shape
    return _build.plan("dv_conv1x1_plan", device, b, d, h, w, cin, cout, int(residual),
                       keys=_build.K1_PLAN_KEYS)


def conv3d_fold_p(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                  residual: torch.Tensor | None = None, act: str | None = None,
                  post_mul: torch.Tensor | None = None) -> torch.Tensor:
    """3×3×3 stride-1 conv, ``(B, D, H, W, C) → (B, D, H, W, Co)``."""
    return _fold(x, w, bias, 1, residual, act, 3, conv3d_fold_p, post_mul)


def conv3d_fold_p_on(tc: int, x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None, residual: torch.Tensor | None = None,
                     act: str | None = None,
                     post_mul: torch.Tensor | None = None) -> torch.Tensor:
    """``conv3d_fold_p`` on tensor-core form ``tc`` (``TC_MMA``,
    ``TC_WGMMA``; a bf16 plan without a wgmma form takes mma.sync), for
    timing the forms of the stride-1 kernel that rows 5, 6, 14 and 15 share
    against each other; counted as ``conv3d_fold_p``."""
    return _fold(x, w, bias, 1, residual, act, 3, conv3d_fold_p, post_mul, tc=tc)


def conv3d_fold_x2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   act: str | None = None) -> torch.Tensor:
    """The wide entry conv (C_in 64, or 48 with zero-filled slots → 32);
    the same kernel as ``conv3d_fold_p``, counted apart."""
    return _fold(x, w, bias, 1, None, act, 3, conv3d_fold_x2)


def conv3d_fold_s2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   act: str | None = None) -> torch.Tensor:
    """3×3×3 stride-2 conv, ``(B, D, H, W, C) → (B, ⌈D/2⌉, ⌈H/2⌉, ⌈W/2⌉, Co)``."""
    return _fold(x, w, bias, 2, None, act, 3, conv3d_fold_s2)


def conv3d_fold_s2_on(tc: int, x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, act: str | None = None) -> torch.Tensor:
    """``conv3d_fold_s2`` on tensor-core form ``tc`` (``TC_MMA``,
    ``TC_WGMMA``; a bf16 plan without a wgmma form takes mma.sync), for
    timing the forms against each other; counted as ``conv3d_fold_s2``."""
    return _fold(x, w, bias, 2, None, act, 3, conv3d_fold_s2, tc=tc)


def conv1x1_fold_p(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                   act: str | None = None, residual: torch.Tensor | None = None) -> torch.Tensor:
    """1×1×1 conv, ``(B, D, H, W, C) → (B, D, H, W, Co)``; IGEV's agg convs
    over a concatenation run as two, the second with the first as its
    residual."""
    return _fold(x, w, bias, 1, residual, act, 1, conv1x1_fold_p)


def conv3d_fold_small(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                      act: str | None = None) -> torch.Tensor:
    """3×3×3 stride-1 conv at C_in 8 or 16 on plain NDHWC, ``(B, D, H, W, C)
    → (B, D, H, W, Co)`` (IGEV's module path: corr_stem, the hourglass's
    16-channel convs, the 8→1 classifier); the same kernel as
    ``conv3d_fold_p``, counted apart."""
    if x.shape[-1] not in (8, 16):
        raise ValueError(f"conv3d_fold_small takes 8 or 16 input channels, got {x.shape[-1]}")
    return _fold(x, w, bias, 1, None, act, 3, conv3d_fold_small, cin_step=8)


# The input channels ``conv3d_packed`` takes, as the TPU kernel's contract
# (``conv3d.py:139-145`` of the JAX package).
PACKED_CIN = (8, 16, 32, 64, 128)


def conv3d_packed(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
                  act: str | None = None, plan_shape: tuple | None = None) -> torch.Tensor:
    """3×3×3 stride-1 pad-1 conv + bias, then ReLU (``act="relu"``) or
    nothing, ``(B, D, H, W, C) → (B, D, H, W, Co)`` at C ∈ ``PACKED_CIN``;
    the same kernel as ``conv3d_fold_p``, counted apart.  ``plan_shape``:
    take the K splits of that input shape's plan (a band of a volume split
    over ranks passes the whole volume's shape, so that its bfloat16 sums
    round as the whole's)."""
    if x.shape[-1] not in PACKED_CIN:
        raise ValueError(f"conv3d_packed takes {PACKED_CIN} input channels, got {x.shape[-1]}")
    if act not in (None, "relu"):
        raise ValueError(f"conv3d_packed: act must be None or 'relu', got {act!r}")
    return _fold(x, w, bias, 1, None, act, 3, conv3d_packed, cin_step=8, plan_shape=plan_shape)


conv3d_fold_p.launches = 0
conv3d_fold_x2.launches = 0
conv3d_fold_s2.launches = 0
conv1x1_fold_p.launches = 0
conv3d_fold_small.launches = 0
conv3d_packed.launches = 0
