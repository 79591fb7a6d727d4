"""The frozen reference against the program at small sizes on the CPU.

The reference (``benchmark/reference``) must compute what the program's
networks, sampler and training step compute; these tests hold it to the
program's module path in float32 (float64 for the training step, where a
float32 ReLU input within rounding of zero takes either branch).
"""

import copy

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import ddim as ref_ddim
from benchmark.reference import train as ref_train

H, W, MD = 64, 128, 64


def small_cfg(cell_name: str) -> dict:
    cfg = copy.deepcopy(harness.cell(harness.load_spec(), cell_name)["cfg"])
    cfg["model"]["max_disp"] = MD
    cfg["sampler"].update(max_disp=MD, num_bins=MD // 4)
    return cfg


def images(seed=0, b=1):
    g = torch.Generator().manual_seed(seed)
    return weights.image_pairs(b, H, W, 0.3, 3, g, "cpu")


def eval_pair(cell_name: str):
    """A calibrated float32 baseline/DDIM state pair, and the images."""
    cfg = small_cfg(cell_name)
    fam = harness.family(cfg)
    cfg["eval"]["dtype"] = "float32"
    left, right = images()
    base, ddim = weights.eval_states(fam, cfg, torch.Generator().manual_seed(1), "cpu",
                                     left, right)
    return cfg, fam, base, ddim, left, right


def port_model(fam, name, cfg, state):
    from diffuvolume_tpu_torch.models import build_model

    m = build_model(fam.PORT[name], **fam.port_kwargs(cfg))
    m.load_state_dict(state)
    return m.eval()


@pytest.mark.parametrize("cell_name", ["acv_sf_b4", "pcw_k12_b1"])
def test_bench_network_matches_port(cell_name):
    cfg, fam, base, _, left, right = eval_pair(cell_name)
    net = fam.reference(cfg, False).eval()
    net.load_state_dict(base)
    with torch.no_grad():
        ref = net(left, right)[0]
        prog = port_model(fam, "baseline", cfg, base)(left, right)[0]
    assert (ref - prog).abs().max() < 0.05
    assert (ref - prog).abs().mean() < 2e-3


def _denoise(baseline):
    """A stand-in denoiser: the disparity and uncertainty follow the latent,
    so the sampler's decisions depend on the draws."""
    def fn(latent, t):
        m = latent.mean(1)
        up = torch.nn.functional.interpolate(m[:, None], baseline.shape[1:], mode="bilinear")[:, 0]
        disp = baseline + 2.0 * up + t[:, None, None].float() * 1e-3
        return disp, 3.0 * up.abs() + 0.5, (latent.clamp(-1, 1) + 1) / 2
    return fn


@pytest.mark.parametrize("cell_name", ["acv_sf_b4", "pcw_k12_b1"])
def test_bench_sampler_matches_port(cell_name):
    from diffuvolume_tpu_torch.diffusion import ddim as port_ddim
    from diffuvolume_tpu_torch.diffusion import make_schedule

    cfg = small_cfg(cell_name)
    s = cfg["sampler"]
    g = torch.Generator().manual_seed(3)
    baseline = torch.rand(2, H, W, generator=g) * (MD - 1)
    latent = ref_ddim.latent_of(baseline, s, (H // 4, W // 4))
    draws = weights.sampler_draws(s, (2, s["num_bins"], H // 4, W // 4), g, "cpu")
    ref, ref_steps = ref_ddim.sample(s, _denoise(baseline), baseline, latent, draws, (H, W))
    pcfg = port_ddim.DDIMConfig(**dict(s, ensemble_weights=tuple(s["ensemble_weights"])))
    prog, prog_steps = port_ddim.ddim_sample(make_schedule(1000), pcfg, _denoise(baseline),
                                             baseline, latent, noise_source=draws)
    assert torch.allclose(torch.stack(ref_steps), prog_steps, atol=1e-4)
    assert torch.allclose(ref, prog, atol=1e-4)


@pytest.mark.parametrize("cell_name", ["acv_sf_b4", "pcw_k12_b1"])
def test_bench_two_pass_matches_port(cell_name):
    """The whole two-pass pipeline on the module path, float32: the
    baseline within rounding, the final within rounding wherever the
    sampler's decisions agree (nearly everywhere)."""
    from diffuvolume_tpu_torch.eval import pipeline

    from benchmark import program

    cfg, fam, base, ddim, left, right = eval_pair(cell_name)
    refs = []
    for diffusion, state in ((False, base), (True, ddim)):
        net = fam.reference(cfg, diffusion).eval()
        net.load_state_dict(state)
        refs.append(net)
    s = cfg["sampler"]
    draws = weights.sampler_draws(s, (1, s["num_bins"], H // 4, W // 4),
                                  torch.Generator().manual_seed(5), "cpu")
    final, baseline, _ = ref_ddim.two_pass(*refs, s, left, right, draws)
    entry = getattr(pipeline, fam.PORT["entry"])
    models = (port_model(fam, "baseline", cfg, base), port_model(fam, "ddim", cfg, ddim))
    p_final, p_base = entry(*models, left, right, program.ddim_config(cfg), device="cpu",
                            noise_source=draws, packed=False)
    assert (baseline - p_base).abs().max() < 0.05
    assert ((final - p_final).abs() < 0.01).float().mean() > 0.9


def test_bench_train_step_matches_port():
    """The ACV step's loss and first gradient, float64."""
    from benchmark import program
    from benchmark.drivers import train_steps

    cell = copy.deepcopy(harness.cell(harness.load_spec(), "acv_sf_train_b4"))
    cell["cfg"]["model"]["max_disp"] = MD
    cell["traffic"].update(height=H, width=W, batch=2, pool_batches=1)
    cfg, fam = cell["cfg"], harness.family(cell["cfg"])
    g = torch.Generator().manual_seed(7)
    state0 = {k: v.double() if v.is_floating_point() else v
              for k, v in weights.train_state(fam, cfg, g, "cpu").items()}
    (batch, t, noise), = train_steps.inputs(cell, g, "cpu")
    batch, noise = tuple(x.double() for x in batch), noise.double()
    trainer = program.Trainer(fam, cfg, state0, "cpu")
    trainer.model.double()
    p_out = trainer.step(batch, t, noise)
    p_grad = {k: m / (1 - train_steps.ADAM_BETA1) for k, m in trainer.first_moments().items()}
    net = fam.reference(cfg, True).double()
    net.load_state_dict(state0)
    r_loss, r_pred = ref_train.step(net, ref_train.make_adam(net, 1e-3), batch, t, noise,
                                    tuple(cfg["train"]["loss_weights"]))
    assert abs(float(p_out["loss"]) - float(r_loss)) < 1e-8 * abs(float(r_loss))
    assert (p_out["pred"] - r_pred).abs().max() < 1e-4  # the port resizes by float32 matrices
    for k, p in net.named_parameters():
        scale = max(float(p.grad.norm()), 1e-3)
        assert float((p_grad[k] - p.grad).norm()) < 1e-5 * scale, k
