"""What the port's float32 means, and IGEV at its production iteration count.

* ``eval/pipeline.py:float32_exact``: a float32 pipeline call runs cuDNN's
  convs (and matmuls) without TF32 and gives the caller's settings back; a
  bfloat16 call leaves them alone.  The flag is a process setting, so the
  check runs here on the CPU: a forward hook reads it during the call.
* ``geometry.band_exact_domain``: band mode equals volume mode for every
  disparity inside it.
* ``random_weights.calibrate_igev_drift``: a 32-iteration rollout at 32×192
  (``chip_smoke.py``'s phase-4 width, half its height) stays in that domain
  on both passes of the two-pass pipeline.

The port alone, no JAX: a 32-iteration JAX rollout costs far more than the
Tier-1 budget allows (PERF.md).
"""

import dataclasses

import numpy as np
import pytest
import torch

from diffuvolume_tpu_torch.diffusion.ddim import KITTI15_DDIM
from diffuvolume_tpu_torch.eval.pipeline import (
    float32_exact,
    igev_baseline_inference,
    igev_ddim_inference,
)
from diffuvolume_tpu_torch.models.igev.geometry import (
    band_exact_domain,
    build_geo_pyramid,
    geo_lookup,
)
from diffuvolume_tpu_torch.models.igev.model import track_disparity
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_igev_drift,
    random_igev,
    random_igev_pair,
)


@pytest.fixture
def tf32_flags():
    """Save and restore the two TF32 switches around a test."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(scope="module")
def igev_model():
    return random_igev(64, False, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("caller", [True, False])
def test_float32_call_runs_without_tf32(tf32_flags, igev_model, caller):
    """During a float32 ``igev_baseline_inference`` a conv of the trunk sees
    both switches off; after it the caller's setting is back."""
    model = igev_model
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = caller
    seen = []
    conv = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    hook = conv.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    left = torch.rand((1, 32, 64, 3), generator=torch.Generator().manual_seed(1)) * 255
    try:
        out = igev_baseline_inference(model, left, left.roll(-3, 2), iters=1, device="cpu",
                                      packed=False)
    finally:
        hook.remove()
    assert torch.isfinite(out).all()
    assert seen and all(s == (False, False) for s in seen)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
        caller, caller)


def test_bfloat16_models_keep_the_callers_tf32(tf32_flags):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    with float32_exact(torch.nn.Linear(2, 2).bfloat16()):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with float32_exact(torch.nn.Linear(2, 2).bfloat16(), torch.nn.Linear(2, 2)):
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("w4", [24, 48, 312])
def test_band_exact_domain(w4):
    """Band mode equals volume mode at disparities spanning the domain (1e-3
    abs + 1e-4 rel: the two modes place a sample by anchor-relative and by
    absolute columns, which round apart by ~1e-5 px at column 311; a read
    outside the band is off by the correlation itself, O(1)); at W/4 = 24
    the domain is [−1, 2] and a disparity of 6 already reads outside it."""
    lo, hi = band_exact_domain(w4)
    g = torch.Generator().manual_seed(w4)
    ml, mr = (torch.randn((1, 8, 3, w4), generator=g) for _ in range(2))
    geo = torch.randn((1, 3, w4, 16, 8), generator=g)
    coords = torch.arange(w4, dtype=torch.float32).expand(1, 3, w4)
    band, vol = (build_geo_pyramid(ml, mr, geo, 2, mode) for mode in ("band", "volume"))
    disps = [torch.full((1, 3, w4), v) for v in (lo, hi, (lo + hi) / 2)]
    disps.append(lo + (hi - lo) * torch.rand((1, 3, w4), generator=g))
    for disp in disps:
        torch.testing.assert_close(geo_lookup(band, disp, coords), geo_lookup(vol, disp, coords),
                                   atol=1e-3, rtol=1e-4)
    if w4 == 24:
        assert hi == 2.0
        out = torch.full((1, 3, w4), 6.0)
        assert not torch.allclose(geo_lookup(band, out, coords), geo_lookup(vol, out, coords))


@pytest.fixture
def two_threads():
    """Two intra-op threads for a test of many small ops: under the test
    workers' load, more threads only contend."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@torch.no_grad()
def test_igev_32_iterations_stay_in_the_band_domain(two_threads):
    """``calibrate_igev_drift`` models through the folded two-pass pipeline
    with 32 GRU iterations at 32×192: every disparity that enters or leaves
    one of the 96 updates lies in [−1, 26], and the output is finite."""
    h, w, md = 32, 192, 64
    rng = np.random.default_rng(3)
    left = torch.from_numpy(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32))
    right = left.roll(-3, 2)
    gen = torch.Generator().manual_seed(0)
    bm, _ = random_igev_pair(md, gen)
    _, dm = random_igev_pair(md, gen)
    for m in (bm, dm):
        calibrate_igev_drift(m, left, right, iters=32)
    cfg = dataclasses.replace(KITTI15_DDIM, max_disp=md, num_bins=md // 4)
    with track_disparity(bm, dm) as track:
        final, base = igev_ddim_inference(bm, dm, left, right, cfg, device="cpu", iters=32,
                                          generator=torch.Generator().manual_seed(0))
    lo, hi = band_exact_domain(w // 4)
    assert (lo, hi) == (-1.0, 26.0)
    assert track.updates == (1 + cfg.sampling_steps) * 32
    assert lo <= track.lo and track.hi <= hi, (track.lo, track.hi)
    assert torch.isfinite(final).all() and torch.isfinite(base).all()
