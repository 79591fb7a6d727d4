"""Rows 16 and 10's launch plans and the fused patch-stencil pair.

The plans are made in the kernels' sources (``csrc/gwc_volume.cu``
``slot_plan``, ``csrc/depthwise_hw.cu`` ``plan``) from the shape and the
device's SM count, shared memory and occupancy, so the tests of the plans
themselves need the card (marked ``gpu``; they skip without one): at every
path's shape they must fit one block's shared memory (227 KB on an H100),
keep their threads within the kernels' bounds, and give a grid that fills
the card's SMs or else split the work further (row 16: D across blocks).
On the CPU: the plans cross to Python in their structs' field order, the
stencil rows' skew is the one the bank-group search picks, the timing entry
points take the plain version on a CPU tensor, and the fused pair's plain
version agrees with the JAX package's Pallas ``depthwise_hw_p`` applied
twice (interpret mode), float32.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from diffuvolume_tpu_torch.ops import cost_volume as plain
from diffuvolume_tpu_torch.ops.kernels import _build
from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

PATCH_L123 = (1,) * 8 + (2,) * 16 + (3,) * 16 + (1,) * 8
RUN = 4  # outputs a lane makes along W (csrc/depthwise_hw.cu kRun)
SMEM_LIMIT = 232448  # bytes a block may take on an H100 (227 KB)
DTYPES = {2: torch.bfloat16, 4: torch.float32}

# Row 16 at every path's shape: (label, b, C, cc, G, D, H, W, slot).
VOLUMES = [
    ("ACV", 1, 320, 0, 40, 48, 128, 240, 48),
    ("PCW 1/4", 1, 320, 12, 40, 48, 96, 312, 64),
    ("PCW 1/8", 1, 320, 12, 40, 24, 48, 156, 64),
    ("PCW 1/16", 1, 320, 12, 40, 12, 24, 78, 64),
    ("PCW 1/32", 1, 320, 12, 40, 6, 12, 39, 64),
    ("IGEV", 1, 96, 0, 8, 48, 96, 312, 16),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the plans are made on the card: needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("elsize", [2, 4])
@pytest.mark.parametrize("case", VOLUMES, ids=[v[0] for v in VOLUMES])
def test_slot_plan_fits_and_fills(dev, case, elsize):
    _, b, c, cc, g, d, h, w, slot = case
    p = kg.slot_plan(b, c, cc, h, w, d, slot, DTYPES[elsize], dev)
    assert p["smem_bytes"] <= SMEM_LIMIT
    assert p["smem_bytes"] == (2 * p["tw"] + p["ds"] - 1) * p["ld"] * elsize
    assert p["ld"] * elsize % 16 == 0 and (p["ld"] * elsize // 16) % 2 == 1
    assert p["tw"] % 4 == 0 and p["threads"] % 32 == 0 and 32 <= p["threads"] <= 512
    assert p["nds"] * p["ds"] >= d > (p["nds"] - 1) * p["ds"]
    assert p["blocks"] == -(-w // p["tw"]) * h * b * p["nds"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert p["blocks"] >= sms or p["nds"] > 1
    assert c // g in kg.SLOT_CPG


@pytest.mark.gpu
@pytest.mark.parametrize("elsize", [2, 4])
@pytest.mark.parametrize("dm1,dm2", [(1, 0), (3, 0), (1, 3)], ids=["patch", "patch_l123", "pair"])
def test_depthwise_plan_fits_and_fills(dev, dm1, dm2, elsize):
    """The ACV slot volume (1, 48, 128, 240, 48): one stencil at dilation 1
    or 3 and the fused pair."""
    planes, h, w, c = 48, 128, 240, 48
    p = kd.depthwise_plan(planes, h, w, c, DTYPES[elsize], dm1, dm2, dev)
    assert p["smem_bytes"] <= SMEM_LIMIT
    nvec = c * elsize // 16
    assert p["threads"] == 32 * nvec * (2 if dm2 else 1) * p["wpc"]
    assert p["threads"] <= (1024 if elsize == 4 else 512)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-w // p["tw"])
    assert p["blocks"] == min(sms * p["blocks_per_sm"], planes * tiles * h) >= sms
    assert p["skew"] == ((nvec | 1) + 4) % 8


@pytest.mark.gpu
def test_depthwise_plan_small_and_refused(dev):
    """A plane smaller than a run, and more channels than a block's threads
    can own (one warp a channel vector and stage)."""
    p = kd.depthwise_plan(2, 4, 3, 16, torch.float32, 3, 1, dev)
    assert p["tw"] == 3 and p["blocks"] == 2 * 4
    with pytest.raises(RuntimeError, match="dv_depthwise_plan"):
        kd.depthwise_plan(1, 8, 8, 136, torch.bfloat16, 1, 1, dev)


@pytest.mark.parametrize("source,struct,keys,entry", [
    ("gwc_volume.cu", "SlotPlan", _build.SLOT_PLAN_KEYS, "dv_gwc_slot_plan"),
    ("depthwise_hw.cu", "DwPlan", _build.DW_PLAN_KEYS, "dv_depthwise_plan"),
])
def test_plan_keys_follow_the_kernels_plans(source, struct, keys, entry):
    """Each plan crosses between C and Python as ints in its struct's field
    order: the keys name each field, in that order; the plan entry point
    has a ctypes signature ending in the int array."""
    src = (Path(_build.CSRC) / source).read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", src, re.S).group(1)
    fields = [name for line in body.splitlines()
              for name in re.findall(r"(\w+)\s*[,;]", line.split("//")[0])]
    assert tuple(fields) == keys
    assert _build.PLAN_SIGNATURES[entry][-1] is _build.ctypes.c_void_p
    assert f"DV_EXPORT int {entry}(" in src


def _conflicts(ldu: int, skew: int, dl: int) -> int:
    """Bank-group conflicts of a staged row (a position's 16-byte units at
    q·ldu + skew·⌊q/4⌋, eight 16-byte bank groups) when each quarter-warp's
    8 lanes load the RUN + 2 input vectors of their runs at dilation dl,
    each of the 6 unit offsets of a position: the worst lanes a group,
    summed over the loads."""
    starts = [(s // dl) * RUN * dl + s % dl for s in range(32)]
    total = 0
    for m in range(RUN + 2):
        for c in range(6):
            for quarter in range(4):
                banks = [((q := starts[lane] + (m - 1) * dl + c) * ldu + skew * (q // 4)) % 8
                         for lane in range(8 * quarter, 8 * quarter + 8)]
                total += max(banks.count(b) for b in set(banks))
    return total


def test_run_skew_spreads_bank_groups():
    """The kernel's skew, (ldu + 4) mod 8, is for every odd row stride ldu
    (mod 8) the one of the 8 that meets the fewest bank-group conflicts over
    dilations 1, 2 and 3, no more at each than no skew does, and none at
    dilation 1 (each lane's run start in a group of its own)."""
    src = (Path(_build.CSRC) / "depthwise_hw.cu").read_text()
    assert "inline int skew_for(int ldu) { return (ldu + 4) & 7; }" in src
    for ldu in (1, 3, 5, 7):
        skew = (ldu + 4) % 8
        total = lambda k: sum(_conflicts(ldu, k, dl) for dl in (1, 2, 3))  # noqa: E731
        assert min(range(8), key=total) == skew
        assert all(_conflicts(ldu, skew, dl) <= _conflicts(ldu, 0, dl) for dl in (1, 2, 3))
        starts = [s * RUN for s in range(8)]
        assert len({(q * ldu + skew * (q // 4)) % 8 for q in starts}) == 8


def test_timing_entry_points_take_the_plain_version_on_the_cpu():
    """``gwc_volume_packed_on`` and the stencils' ``*_on`` forms ignore the
    forced tile on a CPU tensor and give the plain version."""
    g = torch.Generator().manual_seed(3)
    left, right = (torch.randn((1, 16, 3, 9), generator=g) for _ in "lr")
    cat_l, cat_r = (torch.randn((1, 4, 3, 9), generator=g) for _ in "lr")
    got = kg.gwc_volume_packed_on((8, 2), left, right, 5, 8, 32, cat_l, cat_r, True)
    assert torch.equal(got, plain.gwc_volume_slot(left, right, 5, 8, 32, cat_l, cat_r, True))
    x = torch.randn((1, 2, 5, 7, 16), generator=g)
    w1, w2 = (torch.randn((3, 3, 16), generator=g) for _ in "12")
    dil = (1,) * 8 + (2,) * 8
    assert torch.equal(kd.depthwise_hw_p_on((4, 1, 3), x, w1, dil),
                       kd.depthwise_hw_plain(x, w1, dil))
    assert torch.equal(kd.depthwise_hw_p2_on((4, 1, 3), x, w1, dil, w2, dil),
                       kd.depthwise_hw_plain2(x, w1, dil, w2, dil))


def test_depthwise_hw_p2_matches_pallas():
    """The fused pair's plain version (two stencils, the intermediate in the
    volume's dtype) against the Pallas ``depthwise_hw_p`` twice: ``patch``
    (dilation 1) then ``patch_l1/l2/l3`` (1, 2, 3), the 48-channel slot
    against the JAX kernel's 64-lane slots; 1e-4 absolute and relative
    (float32 summation order)."""
    import jax.numpy as jnp

    from diffuvolume_tpu.ops.pallas import conv3d as pc

    b, d, h, w = 1, 4, 16, 12
    rng = np.random.default_rng(11)
    x, kp, k1, k2, k3 = (rng.standard_normal(s).astype(np.float32) for s in
                         ((b, d, h, w, 40), (3, 3, 40), (3, 3, 8), (3, 3, 16), (3, 3, 16)))
    pk = pc.pack_padded_k(jnp.asarray(x), tile_h=8, interpret=True, c_slot=64)
    wp = np.zeros((1, 3, 3, 128), np.float32)
    wl = np.zeros((3, 3, 3, 128), np.float32)
    for phi in range(2):
        wp[0, :, :, phi * 64:phi * 64 + 40] = kp
        for gi, (k, lo, hi) in enumerate(((k1, 0, 8), (k2, 8, 24), (k3, 24, 40))):
            wl[gi, :, :, phi * 64 + lo:phi * 64 + hi] = k
    pk = pc.depthwise_hw_p(pk, jnp.asarray(wp), (1,), w_real=w, h_real=h, tile_h=8,
                           interpret=True)
    pk = pc.depthwise_hw_p(pk, jnp.asarray(wl), (1, 2, 3), w_real=w, h_real=h, tile_h=8,
                           interpret=True)
    want = np.asarray(pc.unpack_padded_k(pk, d, h, w, 40, tile_h=8, interpret=True))

    x48 = torch.from_numpy(np.pad(x, ((0, 0),) * 4 + ((0, 8),)))
    w1 = torch.from_numpy(np.pad(kp, ((0, 0), (0, 0), (0, 8))))
    w2 = torch.from_numpy(np.pad(np.concatenate([k1, k2, k3], -1), ((0, 0), (0, 0), (0, 8))))
    got = kd.depthwise_hw_p2(x48, w1, (1,) * 48, w2, PATCH_L123)
    np.testing.assert_allclose(got[..., :40].numpy(), want, rtol=1e-4, atol=1e-4)
    assert not got[..., 40:].any()
    assert torch.equal(got, kd.depthwise_hw_p(kd.depthwise_hw_p(x48, w1, (1,) * 48), w2,
                                              PATCH_L123))


def test_depthwise_hw_p2_refuses_bad_operands():
    x = torch.zeros((1, 2, 4, 5, 8))
    w = torch.zeros((3, 3, 8))
    with pytest.raises(ValueError, match="must agree"):
        kd.depthwise_hw_p2(x, w, (1,) * 8, torch.zeros((3, 3, 4)), (1,) * 8)
    with pytest.raises(ValueError, match="positive"):
        kd.depthwise_hw_p2(x, w, (1,) * 8, w, (0,) * 8)
