"""Port parity: diffusion schedule, DDIM coefficients, codec and sampler.

Inputs come from numpy seeds and go to both packages; tolerances are
stated per test with their reason.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import diffuvolume_tpu.diffusion as jd
from diffuvolume_tpu.diffusion.codec import encode_disparity_volume as j_encode
from diffuvolume_tpu.ops.regression import resize_bilinear as j_resize
import diffuvolume_tpu_torch.diffusion as td
from diffuvolume_tpu_torch.ops.regression import resize_bilinear as t_resize

RNG = np.random.default_rng(5)


def test_schedule_buffers_match():
    """Both compute the buffers in float64 numpy and cast once to float32:
    the float32 buffers must be identical."""
    js, ts = jd.make_schedule(1000), td.make_schedule(1000)
    for f in dataclasses.fields(ts):
        np.testing.assert_array_equal(
            getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(td.cosine_beta_schedule(1000), jd.cosine_beta_schedule(1000))


@pytest.mark.parametrize("steps,eta", [(5, 1.0), (3, 1.0), (2, 0.5)])
def test_ddim_step_coefficients_match(steps, eta):
    """Same float64 host arithmetic: exact, and finite at t = T-1."""
    jc, tc = jd.ddim_step_coefficients(1000, steps, eta), td.ddim_step_coefficients(1000, steps, eta)
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k])
        assert np.isfinite(tc[k]).all()
    np.testing.assert_array_equal(td.ddim_time_pairs(1000, steps), jd.ddim_time_pairs(1000, steps))


def test_q_sample_and_noise_inversion_match():
    """Elementwise float32 algebra on gathered buffers: 1e-6 relative."""
    js, ts = jd.make_schedule(1000), td.make_schedule(1000)
    x0 = RNG.standard_normal((2, 6, 3, 4)).astype(np.float32)
    eps = RNG.standard_normal((2, 6, 3, 4)).astype(np.float32)
    t = np.asarray([999, 17], np.int32)
    jx = jd.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
    tx = td.q_sample(ts, torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(eps))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    je = jd.predict_noise_from_start(js, jx, jnp.asarray(t), jnp.asarray(x0))
    te = td.predict_noise_from_start(ts, tx, torch.from_numpy(t), torch.from_numpy(x0))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)
    assert td.extract(ts.betas, torch.from_numpy(t), 4).shape == (2, 1, 1, 1)


@pytest.mark.parametrize("with_mask", [False, True])
def test_codec_matches(with_mask):
    """Hat weights, last-bin one-hot and the valid mask: exact up to one
    float32 rounding (1e-6)."""
    disp = RNG.uniform(0, 47.999, (2, 5, 7)).astype(np.float32)
    disp[0, 0, :4] = [47.0, 47.5, 0.0, 12.0]
    valid = (RNG.uniform(size=disp.shape) > 0.4).astype(np.float32) if with_mask else None
    j = j_encode(jnp.asarray(disp), 48, 1.0, None if valid is None else jnp.asarray(valid))
    t = td.encode_disparity_volume(torch.from_numpy(disp), 48, 1.0,
                                   None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


# ---- ddim_sample: shared mock denoiser, injected noise ----

B, H, W, D = 1, 16, 24, 12
H4, W4 = H // 4, W // 4


def _mock(xp, resize, softmax, clip, t_scale):
    """The same branch-forcing denoiser in either framework: a softmax
    read-out of the latent, upsampled ×4, with its own spread as the
    uncertainty; ``transformed`` depends on t."""

    def fn(latent, t, *aux):
        p = softmax(3.0 * latent)
        d = xp.arange(D, dtype=latent.dtype)[None, :, None, None]
        dq = (p * d).sum(1)
        sq = (p * xp.abs(d - dq[:, None])).sum(1)
        disp = 4.0 * resize(dq, (H, W), 1, 2)
        unc = 4.0 * resize(sq, (H, W), 1, 2)
        transformed = clip((latent + 1.0) / 2.0 + t[:, None, None, None] * t_scale, 0.0, 1.0)
        out = (disp, unc, transformed)
        if aux:
            return out + (aux[0] + 1.0,)
        return out

    return fn


j_mock = _mock(jnp, j_resize, lambda x: jax.nn.softmax(x, axis=1),
               jnp.clip, 1e-5)
t_mock = _mock(torch, t_resize, lambda x: torch.softmax(x, dim=1),
               torch.clamp, 1e-5)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    base_q = rng.uniform(2.0, D - 3.0, (B, H4, W4)).astype(np.float32)
    latent0 = np.array(j_encode(jnp.asarray(base_q), D, 1.0))
    baseline = np.array(j_resize(jnp.asarray(base_q), (H, W), 1, 2)) * 4.0
    # Nudge pixels so that renewal (and KITTI15's hard clamp) keeps some and
    # not others.
    baseline = baseline + rng.choice([0.0, 3.0, 8.0], size=baseline.shape).astype(np.float32)
    shape = (cfg.sampling_steps, B, D, H4, W4)
    z = rng.standard_normal(shape).astype(np.float32)
    rep = (rng.uniform(size=shape) if cfg.replace_mode == "uniform"
           else rng.standard_normal(shape)).astype(np.float32)
    ns = {"z": z, "replace": rep,
          "init": rng.standard_normal((B, D, H4, W4)).astype(np.float32)}
    return baseline, latent0, ns


@pytest.mark.parametrize("preset", ["sceneflow", "kitti12", "kitti15"])
def test_ddim_sample_matches_jax(preset):
    """Whole-loop parity with a shared mock and injected draws.  The loop is
    float32 elementwise algebra plus small matmul resizes; 1e-4 absolute on
    disparities of ~40 px, as the JAX package's loop parity holds."""
    cfgs = {"sceneflow": (jd.SCENEFLOW_DDIM, td.SCENEFLOW_DDIM),
            "kitti12": (jd.KITTI12_DDIM, td.KITTI12_DDIM),
            "kitti15": (jd.KITTI15_DDIM, td.KITTI15_DDIM)}
    jcfg, tcfg = cfgs[preset]
    jcfg = dataclasses.replace(jcfg, max_disp=4 * D, num_bins=D)
    tcfg = dataclasses.replace(tcfg, max_disp=4 * D, num_bins=D)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    baseline, latent0, ns = _inputs(tcfg, seed=11)

    jf, js = jd.ddim_sample(jd.make_schedule(1000), jcfg, j_mock, jnp.asarray(baseline),
                            jnp.asarray(latent0), jax.random.PRNGKey(0), noise_source=ns)
    tf, ts = td.ddim_sample(td.make_schedule(1000), tcfg, t_mock, torch.from_numpy(baseline),
                            torch.from_numpy(latent0), noise_source=ns)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    # The mock and baseline make each branch taken at some pixels only.
    if tcfg.hard_clamp_tau is None:
        taken = np.abs(ts.numpy()[0] - baseline) < tcfg.consistency_tau
    else:
        taken = ts.numpy()[0] == baseline
    assert taken.any() and not taken.all()


def test_ddim_sample_aux_and_reencode_match():
    """``denoise_aux_init`` threads state through the steps and a custom
    ``reencode_fn`` replaces the clamp → ↓4 → /4 re-encode (KITTI15's
    hooks); same mock, same draws, same 1e-4 tolerance."""
    jcfg = dataclasses.replace(jd.KITTI15_DDIM, max_disp=4 * D, num_bins=D)
    tcfg = dataclasses.replace(td.KITTI15_DDIM, max_disp=4 * D, num_bins=D)
    baseline, latent0, ns = _inputs(tcfg, seed=12)
    jf, _ = jd.ddim_sample(
        jd.make_schedule(1000), jcfg, j_mock, jnp.asarray(baseline), jnp.asarray(latent0),
        jax.random.PRNGKey(0), noise_source=ns, denoise_aux_init=jnp.zeros(()),
        reencode_fn=lambda d: j_resize(jnp.clip(d, 0.0, 30.0), (H4, W4), 1, 2) / 4.0)
    tf, _ = td.ddim_sample(
        td.make_schedule(1000), tcfg, t_mock, torch.from_numpy(baseline),
        torch.from_numpy(latent0), noise_source=ns, denoise_aux_init=torch.zeros(()),
        reencode_fn=lambda d: t_resize(d.clamp(0.0, 30.0), (H4, W4), 1, 2) / 4.0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)


def test_ddim_sample_generator_is_deterministic():
    """Without injected draws the port draws from its generator: the same
    seed gives the same trajectory, another seed another one."""
    cfg = dataclasses.replace(td.SCENEFLOW_DDIM, max_disp=4 * D, num_bins=D)
    baseline, latent0, _ = _inputs(cfg, seed=13)
    sched = td.make_schedule(1000)
    run = lambda seed: td.ddim_sample(  # noqa: E731
        sched, cfg, t_mock, torch.from_numpy(baseline), torch.from_numpy(latent0),
        generator=torch.Generator().manual_seed(seed))[0]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
