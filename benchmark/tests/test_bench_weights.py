"""The weights and inputs drawn from the seed, on the CPU.

``weights.draw_state`` draws any network the program builds: IGEV-Stereo's
2-D transposed convolutions and the BatchNorms it registers under two
names included, into a state that the program's model loads strictly.  The
networks of the benchmark's configurations draw the same bits as before
IGEV-Stereo could be drawn (hashes pinned from that commit), and so do the
images of a traffic without ``image_mean``.  The control's lower precision
rounds a 2-D transposed convolution's operands.
"""

import hashlib
import math

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import harness, weights
from benchmark.reference.precision import lower_precision, round_to

IGEV = ["igev", "igev_ddim"]
MD = 64
RULES = {"batchnorm": "drawn", "residual_bn_scale": 0.1}


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        v = state[k].detach().cpu().contiguous()
        h.update(f"{k}|{v.dtype}|{tuple(v.shape)}|".encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def igev_state(name: str, seed: int = 5):
    from diffuvolume_tpu_torch.models import build_model

    with torch.device("meta"):
        shape_net = build_model(name, max_disp=MD)
    return shape_net, weights.draw_state(shape_net, RULES, torch.Generator().manual_seed(seed),
                                         "cpu")


def aliases(net: nn.Module) -> list[list[str]]:
    """The names of each module registered under more than one."""
    names: dict[int, list[str]] = {}
    for n, m in net.named_modules(remove_duplicate=False):
        names.setdefault(id(m), []).append(n)
    return [v for v in names.values() if len(v) > 1]


@pytest.mark.parametrize("name", IGEV)
def test_bench_igev_state_covers_every_key(name):
    net, state = igev_state(name)
    assert set(state) == set(net.state_dict())
    assert sum(isinstance(m, nn.ConvTranspose2d) for m in net.modules()) == 7


@pytest.mark.parametrize("name", IGEV)
def test_bench_igev_state_loads_strictly(name):
    from diffuvolume_tpu_torch.models import build_model

    _, state = igev_state(name)
    model = build_model(name, max_disp=MD)
    model.load_state_dict(state, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("name", IGEV)
def test_bench_igev_norm3_under_both_names(name):
    net, state = igev_state(name)
    pairs = aliases(net)
    assert sorted(p[0] for p in pairs) == [f"cnet.layer{i}.0.norm3" for i in (2, 3, 4, 5)]
    for first, other in pairs:
        assert other == first.replace("norm3", "downsample.1")
        for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            assert torch.equal(state[f"{first}.{leaf}"], state[f"{other}.{leaf}"])
        # Drawn, not left at a constant.
        assert state[f"{first}.bias"].std() > 0


def test_bench_igev_transposed_conv_std():
    net, state = igev_state("igev_ddim", seed=2**31 + 9)
    for mname, m in net.named_modules():
        if not isinstance(m, nn.ConvTranspose2d):
            continue
        w = state[f"{mname}.weight"]
        want = math.sqrt(2.0 / (math.prod(m.kernel_size) * w.shape[1]))
        # The sample std's relative standard error is 1 / sqrt(2 N); five of them.
        tol = 5.0 / math.sqrt(2 * w.numel())
        assert abs(w.std().item() / want - 1) < tol, (mname, w.std().item(), want)
        assert abs(w.mean().item()) < 5 * want / math.sqrt(w.numel()), mname
        if m.bias is not None:
            assert not state[f"{mname}.bias"].any(), mname


# Drawn by the parent of the commit that taught the harness IGEV-Stereo's
# modules: the states of the benchmark's networks must not move a bit.
PINNED = {("acv_sf_b4", 7): "b3cf2203dd591915", ("acv_sf_b4", 2**31 + 5): "3910e2ee50798b10",
          ("pcw_k12_b1", 7): "2dc0419dd2d1698d", ("pcw_k12_b1", 2**31 + 5): "1d8629ecde36c878"}
PINNED_TRAIN = {7: "41a0de67bacb5962", 2**31 + 5: "2e14331560f8ffe4"}
PINNED_IMAGES = {(3, (2, 16, 24, 0.3, 3)): "5b2e257a6e8cc793",
                 (2**31 + 5, (1, 8, 40, 1.0, 5)): "273f3842212345ee"}


@pytest.mark.parametrize("cell,seed", sorted(PINNED))
def test_bench_eval_draw_unchanged(cell, seed):
    cfg = harness.cell(harness.load_spec(), cell)["cfg"]
    fam = harness.family(cfg)
    with torch.device("meta"):
        net = fam.reference(cfg, diffusion=True)
    assert not aliases(net)
    state = weights.draw_state(net, cfg["eval"]["weights"], torch.Generator().manual_seed(seed),
                               "cpu")
    assert digest(state) == PINNED[(cell, seed)]


@pytest.mark.parametrize("seed", sorted(PINNED_TRAIN))
def test_bench_train_draw_unchanged(seed):
    cfg = harness.cell(harness.load_spec(), "acv_sf_train_b4")["cfg"]
    state = weights.train_state(harness.family(cfg), cfg, torch.Generator().manual_seed(seed),
                                "cpu")
    assert digest(state) == PINNED_TRAIN[seed]


@pytest.mark.parametrize("seed,args", sorted(PINNED_IMAGES))
def test_bench_images_without_mean_unchanged(seed, args):
    pair = weights.image_pairs(*args, torch.Generator().manual_seed(seed), "cpu")
    assert digest(dict(zip("lr", pair))) == PINNED_IMAGES[(seed, args)]
    raw = weights.image_pairs(*args, torch.Generator().manual_seed(seed), "cpu", 127.5)
    for a, b in zip(pair, raw):
        assert torch.equal(a + 127.5, b)


@pytest.mark.parametrize("kind", ["bfloat16", "float8"])
def test_bench_lower_precision_rounds_transposed_conv2d(kind):
    g = torch.Generator().manual_seed(4)
    m = nn.ConvTranspose2d(6, 5, 4, stride=2, padding=1)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape, generator=g))
        m.bias.copy_(torch.randn(m.bias.shape, generator=g))
    x = torch.randn((2, 6, 7, 9), generator=g) * 3
    w = m.weight.detach().clone()
    assert not torch.equal(round_to(w, kind), w) and not torch.equal(round_to(x, kind), x)
    want = F.conv_transpose2d(round_to(x, kind), round_to(w, kind), m.bias.detach(), stride=2,
                              padding=1)
    net = lower_precision(nn.Sequential(m), kind)
    assert torch.equal(net[0].weight, round_to(w, kind))
    with torch.no_grad():
        assert torch.equal(net(x), want)
