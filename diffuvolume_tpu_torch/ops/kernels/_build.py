"""Build ``diffuvolume_tpu_torch/csrc/*.cu`` into one shared library and load it.

The sources have a plain C interface (no PyTorch headers), so each file
compiles in seconds.  On first use every ``.cu`` is compiled by its own
``nvcc`` process, all started together, then linked with ``-shared`` into
``build/kernels/libdvkernels_<hash>.so`` at the repository root; the hash
covers the sources and flags, so an unchanged tree reuses its library.  The
library is loaded with ``ctypes``.  A missing ``nvcc``, a failed build, or a
non-zero CUDA error code returned by a launch raises.

Nothing here runs at import time: the CPU tests import every kernel module
but never build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C entry points: name → argument types.  Every one ends with (dtype code,
# device index, stream) and returns the CUDA error code of the launch
# (cudaGetLastError()), 0 on success.
SIGNATURES = {
    # cost, disp, unc, b, d4, h4, w4, d, h, w, align_corners
    "dv_fused_head": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I],
    # cost, query, unc, b, d4, h4, w4, d, h, w, align_corners
    "dv_fused_uncertainty_at": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I],
    # left, right, out, plan (GWC_PLAN_KEYS), b, c, h, w, groups, d
    "dv_gwc_volume": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I],
    # left, right, cat_l|0, cat_r|0, out, plan (SLOT_PLAN_KEYS), b, c, cc, h, w, groups,
    # d, slot, mask_ref
    "dv_gwc_volume_slot": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    # x, wt, dil, out, plan (DW_PLAN_KEYS), b, d, h, w, c, max dil
    "dv_depthwise_hw": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I],
    # x, wt1, dil1, wt2, dil2, out, plan, b, d, h, w, c, max dil1, max dil2
    "dv_depthwise_hw2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
    # cl, cr, att|0, out, b, c, d, h, w
    "dv_concat_volume": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    # vol, m1, m2|0, out, b, c, dhw
    "dv_dhw_mul": [_P, _P, _P, _P, _I, _I, _L],
    # the same two, channels-last output / volume; the concat takes its plan
    # (CONCAT_PLAN_KEYS): cl, cr, att|0, out, plan, b, c, d, h, w
    "dv_concat_volume_cl": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I],
    "dv_dhw_mul_cl": [_P, _P, _P, _P, _I, _I, _L],
    # x, w, bias|0, res|0, post_mul|0, out, ws|0, plan|0, b, d, h, w, cin, cout, ks, act
    # (stride 1)
    "dv_conv3d_fold": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I],
    # x, w, bias|0, out, ws|0, plan|0, b, d, h, w, cin, cout, act (3×3×3 stride 2)
    "dv_conv3d_s2": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
    # x, w, bias|0, res|0, post_mul|0, out, plan|0, b, d, h, w, cin, cout, ks, act
    "dv_conv3d_up": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I],
    # x, out, plan (TRANSPOSE_PLAN_KEYS), b, c, s, c_slot
    "dv_pack": [_P, _P, _P, _I, _I, _L, _I],
    # x, out, plan, b, c, s
    "dv_unpack": [_P, _P, _P, _I, _I, _L],
    # x, out, plan|0 (TRANSPOSE_PLAN_KEYS, a one-channel slot), b, d, s, c_slot, co
    "dv_unpack_hwdc": [_P, _P, _P, _I, _I, _L, _I, _I],
    # x, w, bias|0, res|0, out, plan|0, b, h, w, cin, cout, dilation, act
    "dv_conv2d_flat": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I],
}
_TAIL = [_I, _I, _P]

# The bf16 3×3×3 and dilated 2-D convs' tile plans: shape, tensor-core
# form (csrc/conv_hopper.cuh TensorCores), device index, an int[PLAN_KEYS]
# out (hopper::Plan's fields in order); return the CUDA error code.  The
# launch entry points take the same ints back.
PLAN_SIGNATURES = {
    # b, d, h, w, cin, cout, tc, device, plan
    "dv_conv3d_s1_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dv_conv3d_s2_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, d, h, w, cin, cout, ks, tc, device, plan
    "dv_conv3d_up_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, h, w, cin, cout, dilation, tc, device, plan
    "dv_conv2d_flat_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, d, h, w, cin, cout, residual, device, plan (K1_PLAN_KEYS)
    "dv_conv1x1_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, c, h, w, groups, d, dtype, 16-byte aligned, forced disparities an item,
    # threads a block (0: the rule's), device, plan (GWC_PLAN_KEYS)
    "dv_gwc_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, c, cc, h, w, d, slot, dtype, forced tw, ds (0: the rule's), device, plan
    # (SLOT_PLAN_KEYS)
    "dv_gwc_slot_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # planes, h, w, c, max dil1, max dil2 (0: one stencil), dtype, forced tw, warps a
    # channel vector, blocks (0: the rule's), device, plan (DW_PLAN_KEYS)
    "dv_depthwise_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, c, h, w, d, att, dtype, forced tw, ds, blocks (0: the rule's), device, plan
    # (CONCAT_PLAN_KEYS)
    "dv_concat_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # b, m, n, ldo, dtype, 16-byte aligned, forced lanes a tile column (1: the
    # element form), blocks (0: the rule's), device, plan (TRANSPOSE_PLAN_KEYS)
    "dv_transpose_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
PLAN_KEYS = ("bh", "bmw", "nth", "ntw", "ntn", "splits", "bn", "ck", "mt", "blocks",
             "smem_bytes", "blocks_per_sm", "positions", "wgmma", "kh_a_stage")
# The bf16 1×1×1 conv's plan (csrc/conv_k1.cuh k1::Plan): positions a tile,
# ring stages, grid, blocks an SM, shared memory a block, tiles, output
# channels a tile.
K1_PLAN_KEYS = ("positions", "stages", "blocks", "blocks_per_sm", "smem_bytes", "tiles", "bn")
# The NCDHW GWC volume's plan (csrc/gwc_volume.cu GwcPlan): W positions and
# disparities an item, the 16-byte form or the element form, items, threads a
# block, grid, blocks an SM, shared memory a block.
GWC_PLAN_KEYS = ("tw", "ds", "vec", "items", "threads", "blocks", "blocks_per_sm",
                 "smem_bytes")
# The GWC volume in the slot's plan (csrc/gwc_volume.cu SlotPlan): W positions
# and disparities a block, D ranges, threads, shared memory a block, grid,
# staged row stride in elements.
SLOT_PLAN_KEYS = ("tw", "ds", "nds", "threads", "smem_bytes", "blocks", "ld")
# The patch stencils' plan (csrc/depthwise_hw.cu DwPlan): W tile, grid, warps
# a (stage, channel vector), the staged rows' skew, threads and shared memory
# a block, blocks an SM.
DW_PLAN_KEYS = ("tw", "blocks", "wpc", "skew", "threads", "smem_bytes", "blocks_per_sm")
# The channels-last concat's plan (csrc/concat_volume.cu ConcatPlan): W
# positions and disparities a work item, items, threads, grid, blocks an SM,
# shared memory a block.
CONCAT_PLAN_KEYS = ("tw", "ds", "items", "threads", "blocks", "blocks_per_sm", "smem_bytes")
# pack / unpack's transpose plan (csrc/layout.cu TransposePlan): the 16-byte
# form or the element form, lanes a tile column, tiles, threads, grid, blocks
# an SM.
TRANSPOSE_PLAN_KEYS = ("vec", "lr", "tiles", "threads", "blocks", "blocks_per_sm")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile and link the library if it is not built yet.

    Returns ``(path, seconds spent building)`` (0 when it was cached).
    """
    out = BUILD_DIR / f"libdvkernels_{source_hash()}.so"
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    stem = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    log_path = BUILD_DIR / f"{out.stem}.log"
    log_path.write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}; see {log_path}\n"
                           + "\n".join(logs))
    tmp = BUILD_DIR / f"{stem}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the current sources' build, or '' if it was not built here."""
    path = BUILD_DIR / f"libdvkernels_{source_hash()}.log"
    return path.read_text() if path.exists() else ""


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes + _TAIL
        fn.restype = ctypes.c_int
    for name, argtypes in PLAN_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dv_error_string.argtypes = [ctypes.c_int]
    lib.dv_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _launch_helpers():
    """``like.dtype`` → dtype code, and device index → the current stream's
    handle: PyTorch's raw-stream binding, which spares each launch building
    a ``torch.cuda.Stream`` (about a microsecond of host time a call)."""
    import torch

    codes = {getattr(torch, k.split(".")[1]): v for k, v in DTYPE_CODES.items()}
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return codes, raw or (lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(name: str, like, *args) -> None:
    """Call C entry point ``name`` on ``like``'s device and current stream,
    with ``like``'s dtype code; raise on a non-zero CUDA error code."""
    codes, current_stream = _launch_helpers()
    code = codes.get(like.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {like.dtype}")
    index = like.device.index
    lib = library()
    err = getattr(lib, name)(*args, code, index, current_stream(index))
    if err != 0:
        msg = lib.dv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


class Plan(dict):
    """A tile plan: ``PLAN_KEYS`` → int, and ``ptr``, the address of the
    same ints as the launch entry points take them (kept alive with the
    plan)."""


def plan(name: str, device, *args, keys: tuple = PLAN_KEYS) -> Plan:
    """The tile plan C entry point ``name`` picks for ``args`` (the shape
    and the tensor-core form) on ``device`` (a CUDA ``torch.device``), as
    ``keys`` → int."""
    ints = (ctypes.c_int * len(keys))()
    lib = library()
    err = getattr(lib, name)(*args, device.index or 0, ints)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.dv_error_string(err).decode()})")
    pl = Plan(zip(keys, ints))
    pl.ints, pl.ptr = ints, ctypes.addressof(ints)
    return pl


def check_cuda(*tensors) -> None:
    """Every tensor on one CUDA device and contiguous, and none that autograd
    tracks; raise otherwise.  The kernels have no backward: a tensor that
    requires grad in grad mode would leave the kernel's output without a
    gradient path, silently."""
    import torch

    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got one on {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the port's kernels have no backward: call them under torch.no_grad() (the "
            "evaluation entry points do), or train through the models' train_forward, "
            "which runs the differentiable plain ops")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
