"""Row 3's and rows 11-12's plans and timing entry points on the CPU.

The plans are made in the kernels' sources (``csrc/concat_volume.cu``
``concat_plan_t``, ``csrc/layout.cu`` ``transpose_plan_t``) from the shape
and the device, so the plans themselves are card tests
(``tests/test_torch_gpu.py``).  Here: the plans cross to Python in their
structs' field order, the forced-plan entry points take the plain version
on a CPU tensor, pack and unpack ask for the transpose of the right matrix
and tell an unaligned pointer, and the plain versions at the transposer's
edge shapes agree with the JAX package's layout functions.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuvolume_tpu.ops.pallas import conv3d as pc
from diffuvolume_tpu_torch.ops import cost_volume as plain
from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
from diffuvolume_tpu_torch.ops.kernels import layout as kl


@pytest.mark.parametrize("source,struct,keys,entry", [
    ("concat_volume.cu", "ConcatPlan", _build.CONCAT_PLAN_KEYS, "dv_concat_plan"),
    ("layout.cu", "TransposePlan", _build.TRANSPOSE_PLAN_KEYS, "dv_transpose_plan"),
])
def test_plan_keys_follow_the_kernels_plans(source, struct, keys, entry):
    """Each plan crosses between C and Python as ints in its struct's field
    order; the plan entry point ends in the int array and the launch entry
    takes the plan's address after its tensors."""
    src = (Path(_build.CSRC) / source).read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = [name for line in body.splitlines()
              for name in re.findall(r"(\w+)\s*[,;]", line.split("//")[0])]
    assert tuple(fields) == keys
    assert _build.PLAN_SIGNATURES[entry][-1] is _build.ctypes.c_void_p
    assert f"DV_EXPORT int {entry}(" in src
    launches = {"concat_volume.cu": ("dv_concat_volume_cl", 4),
                "layout.cu": ("dv_pack", 2)}
    name, at = launches[source]
    assert _build.SIGNATURES[name][at] is _build.ctypes.c_void_p
    assert re.search(rf"DV_EXPORT int {name}\([^)]*const int\* plan", src)


def test_forced_entry_points_take_the_plain_version_on_the_cpu():
    g = torch.Generator().manual_seed(20)
    cl, cr = (torch.randn((2, 8, 3, 11), generator=g) for _ in "lr")
    att = torch.softmax(torch.randn((2, 5, 3, 11), generator=g), 1)
    for a in (att, None):
        assert torch.equal(kc.concat_volume_cl_on((8, 2, 3), cl, cr, 5, a),
                           plain.concat_volume_mul(cl, cr, 5, a, channels_last=True))
    x = torch.randn((2, 5, 3, 4, 7), generator=g)
    assert torch.equal(kl.pack_on((2, 7), x, 8), kl.pack_plain(x, 8))
    y = kl.pack_plain(x)
    assert torch.equal(kl.unpack_on((1, 0), y), kl.unpack_plain(y))


@pytest.mark.parametrize("offset", [0, 1])
def test_pack_and_unpack_ask_for_their_transpose(monkeypatch, offset):
    """pack is the transpose of (B, C, S) into (B, S, c_slot), unpack of
    (B, S, C) into (B, C, S); the plan is asked for 16-byte alignment of
    both pointers (a view one element in is not)."""
    asked = []
    monkeypatch.setattr(kl, "transpose_plan", lambda *args: asked.append(args))
    n = 2 * 5 * 3 * 4 * 8
    x = torch.zeros(n + 1)[offset:offset + n].view(2, 5, 3, 4, 8)
    out = torch.zeros(2 * 3 * 4 * 8 * 8)
    kl._plan(x, out, 2, 5, 96, 8, (0, 0))
    kl._plan(x, out, 2, 96, 5, 96, (4, 9))
    assert asked == [(2, 5, 96, 8, torch.float32, torch.device("cpu"), offset == 0, (0, 0)),
                     (2, 96, 5, 96, torch.float32, torch.device("cpu"), offset == 0, (4, 9))]


@pytest.mark.parametrize("c,c_slot,dhw", [(13, 16, (2, 4, 8)), (40, 64, (4, 5, 7)),
                                          (12, 12, (6, 3, 3))])
def test_pack_unpack_plain_at_the_edges_match_jax(c, c_slot, dhw):
    """The transposer's edge shapes (C and S not whole vectors, a slot
    fill): the plain pack against the JAX package's ``pack_padded`` read
    back with ``unpack_padded`` (its channels up to the slot), and unpack
    inverting it; exact."""
    rng = np.random.default_rng(21)
    d, h, w = dhw
    x = rng.standard_normal((1, d, h, w, c)).astype(np.float32)
    lanes = 64  # the JAX layout packs two D planes into 128 lanes
    x_lanes = np.pad(x, ((0, 0),) * 4 + ((0, lanes - c),))
    want = np.asarray(pc.unpack_padded(pc.pack_padded(jnp.asarray(x_lanes), 2), d, h, w,
                                       lanes, 2))[..., :c_slot]
    got = kl.pack(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), c_slot)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kl.unpack(got)[:, :c].numpy(), np.moveaxis(x, -1, 1))


def test_gwc_plan_keys_follow_the_kernels_plan():
    """Row 2's plan crosses between C and Python as ints in ``GwcPlan``'s
    field order, and ``dv_gwc_volume`` takes the plan's address after its
    tensors; ``gwc_volume_on`` takes the plain version on a CPU tensor."""
    src = (Path(_build.CSRC) / "gwc_volume.cu").read_text()
    body = re.search(r"struct GwcPlan \{(.*?)\n\};", src, re.S).group(1)
    fields = [name for line in body.splitlines()
              for name in re.findall(r"(\w+)\s*[,;]", line.split("//")[0])]
    assert tuple(fields) == _build.GWC_PLAN_KEYS
    assert _build.PLAN_SIGNATURES["dv_gwc_plan"][-1] is _build.ctypes.c_void_p
    assert _build.SIGNATURES["dv_gwc_volume"][3] is _build.ctypes.c_void_p
    assert re.search(r"DV_EXPORT int dv_gwc_volume\([^)]*const int\* plan", src)
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(21)
    left, right = (torch.randn((1, 24, 3, 11), generator=g) for _ in "lr")
    assert torch.equal(kg.gwc_volume_on((16, 128), left, right, 5, 2),
                       plain.build_gwc_volume(left, right, 5, 2))
