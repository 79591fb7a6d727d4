"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(the cell's driver and the result line) on the CPU at a small size, with
one fault planted in the program: an answer altered where it is produced,
half of a batch left out, a training step that leaves its state
unchanged, a training step over half its batch.  The sound run at the same
size is held to the same limits.
"""

import copy

import pytest
import torch

from benchmark import harness, run

SMALL = {"acv_sf_b4": (64, 128, 64, 2), "pcw_k12_b1": (64, 128, 64, 1),
         "acv_sf_train_b4": (64, 128, 64, 2)}


def small_cell(name):
    cell = copy.deepcopy(harness.cell(harness.load_spec(), name))
    h, w, md, b = SMALL[name]
    cell["cfg"]["model"]["max_disp"] = md
    cell["cfg"]["sampler"].update(max_disp=md, num_bins=md // 4)
    cell["traffic"].update(height=h, width=w, batch=b)
    if cell["traffic"]["phase"] == "eval":
        cell["traffic"].update(pool_batches=2, check_batches=2, warmup_calls=1)
    else:
        cell["traffic"].update(pool_batches=cell["traffic"]["check_steps"] + 1)
    return cell


def correct(name, seed=11) -> bool:
    cell = small_cell(name)
    res = harness.driver(cell["traffic"]).run(cell, seed, 0.1, None, torch.device("cpu"))
    line, _ = run.result(cell, res, res["setup_end"], "cpu", None)
    return line["correct"]


def _patch_entry(monkeypatch, name, fault):
    from diffuvolume_tpu_torch.eval import pipeline

    fam = harness.family(harness.cell(harness.load_spec(), name)["cfg"])
    real = getattr(pipeline, fam.PORT["entry"])

    def broken(base, ddim, left, right, cfg, **kw):
        return fault(real, base, ddim, left, right, cfg, **kw)

    monkeypatch.setattr(pipeline, fam.PORT["entry"], broken)


def altered(real, *args, **kw):
    final, base = real(*args, **kw)
    final = final.clone()
    final[0] += 5.0
    return final, base


def half_batch(real, base, ddim, left, right, cfg, noise_source, **kw):
    h = max(1, left.shape[0] // 2)
    draws = {k: v[:h] if k == "init" else v[:, :h] for k, v in noise_source.items()}
    final, baseline = real(base, ddim, left[:h], right[:h], cfg, noise_source=draws, **kw)
    fill = -(-left.shape[0] // h)
    return final.repeat(fill, 1, 1)[:left.shape[0]], baseline.repeat(fill, 1, 1)[:left.shape[0]]


@pytest.mark.parametrize("name", ["acv_sf_b4", "pcw_k12_b1"])
def test_bench_eval_answer_altered(name, monkeypatch):
    _patch_entry(monkeypatch, name, altered)
    assert not correct(name)


def test_bench_eval_half_batch_left_out(monkeypatch):
    _patch_entry(monkeypatch, "acv_sf_b4", half_batch)
    assert not correct("acv_sf_b4")


def test_bench_train_state_unchanged(monkeypatch):
    from diffuvolume_tpu_torch.train import loop

    monkeypatch.setattr(loop, "apply_gradients", lambda state: None)
    assert not correct("acv_sf_train_b4")


def test_bench_train_half_batch(monkeypatch):
    from diffuvolume_tpu_torch.train import loop

    real = loop.make_train_step

    def make(model, *a, **kw):
        step = real(model, *a, **kw)

        def half(state, batch, generator=None, t=None, noise=None):
            h = batch["disp_gt"].shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()}, generator, t[:h], noise[:h])
        return half

    monkeypatch.setattr(loop, "make_train_step", make)
    assert not correct("acv_sf_train_b4")


@pytest.mark.parametrize("name", list(SMALL))
def test_bench_sound_run_correct(name):
    assert correct(name)


def float8_reference(real, base, ddim, left, right, cfg, noise_source, **kw):
    """The control in the program's place: the reference in float8."""
    from benchmark.reference import ddim as ref_ddim
    from benchmark.reference.precision import lower_precision

    name = "acv_sf_b4" if type(base).__name__ == "FoldedACV" else "pcw_k12_b1"
    fam = harness.family(harness.cell(harness.load_spec(), name)["cfg"])
    sampler = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    nets = []
    for diffusion, folded in ((False, base), (True, ddim)):
        net = fam.reference(small_cell(name)["cfg"], diffusion).eval()
        net.load_state_dict({k: v.float() if v.is_floating_point() else v
                             for k, v in folded.model.state_dict().items()})
        nets.append(lower_precision(net, "float8"))
    final, baseline, _ = ref_ddim.two_pass(*nets, sampler, left, right, noise_source)
    return final, baseline


@pytest.mark.parametrize("name", ["acv_sf_b4", "pcw_k12_b1"])
def test_bench_eval_control_not_correct(name, monkeypatch):
    _patch_entry(monkeypatch, name, float8_reference)
    assert not correct(name)


def test_bench_train_control_not_correct(monkeypatch):
    """The program's own bfloat16 step in place of its float32 one."""
    from diffuvolume_tpu_torch.train import loop

    real = loop.make_train_step
    monkeypatch.setattr(loop, "make_train_step", lambda m, w, bf16=False: real(m, w, bf16=True))
    assert not correct("acv_sf_train_b4")
