"""The cost volume's rows split over ranks (``parallel/volume_sharding.py``)
against one process, on the CPU.

Gloo processes run as ``tests/test_torch_parallel.py``'s spawned ones do
(one intra-op thread each, joined within a timeout, every one exiting 0),
each on its band of the rows of the same seeded tensors; what they return
is compared here with the unsplit op in this process.  They fork from a
``forkserver`` that imports PyTorch once, the three grids' ranks start
together, and this process makes the unsplit and JAX references while
they run.

* ``halo`` and ``gather_rows`` at 2 and 3 ranks: the forward against
  slices of the zero- or edge-padded whole, the backward against autograd
  of the unsplit op (each rank's loss weights its output by its own draw;
  the bands' gradients, stacked, against the whole's);
* each op of the split's halo table on 2 ranks against the unsplit op,
  forward and input gradient, float64, relative L2 within 1e-10: the
  3×3×3 stride-1 ``ConvBN``, ``HeadConv3D`` and ``PackedConv3d``, the
  stride-2 ``ConvBN``, the transposed conv, the 1×1×1 ``ConvBN``, the
  patch convs at dilations 1, 2 and 3, ``AttentionBlock3D``, the
  trilinear ×4 upsample and regression (``regress_head``) and ACV's eval
  head (``fused_head_rows``, the fused kernel's plain version here);
* a band that breaks the rule (a multiple of 4 rows at H/4) raises;
* ``ACVNet.forward`` (the module path, eval, tamed seeded weights) at
  64×128, ``max_disp`` 64, on 1 × 2 and 1 × 4 grids against the unsplit
  forward in float64 (relative L2 within 1e-10), and the 1 × 2 split
  forward in float32 against the JAX package's ``ACVNet`` on the same
  weights within ``tests/test_torch_acv.py``'s 2e-3 px.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffuvolume_tpu_torch.models.acv import ACVNet, fused_head_rows
from diffuvolume_tpu_torch.models.layers import (
    AttentionBlock3D,
    ConvTransposeBN,
    HeadConv3D,
    PackedConv3d,
    conv3d_rows,
    convbn_3d,
)
from diffuvolume_tpu_torch.ops.regression import regress_head
from diffuvolume_tpu_torch.parallel import ddp
from diffuvolume_tpu_torch.parallel.mesh import Mesh
from diffuvolume_tpu_torch.parallel.volume_sharding import (
    constrain_volume,
    gather_rows,
    halo,
    volume_sharding,
)
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_heads,
    random_acv,
    tame_residual_branches,
)

RTOL = 1e-10
TIMEOUT_S = 600
H, W, MD = 64, 128, 64
JAX_ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def start(target, args_of, n: int) -> list:
    """``n`` processes ``target(*args_of(rank))``, started.  They fork from
    a fresh server process (``forkserver``) that imports ``target``'s
    module, and with it PyTorch, once for every rank, rather than once a
    rank as under ``spawn``."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([target.__module__])
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join(procs: list) -> None:
    """``procs`` joined within ``TIMEOUT_S`` of this call (killed past it);
    every one must exit 0."""
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)


def free_ports(n: int) -> list:
    """``n`` distinct free ports, one a process group started together."""
    ports = set()
    while len(ports) < n:
        ports.add(ddp.free_port())
    return sorted(ports)


# What each 1 × world grid runs, all three worlds spawned together (each
# process pays its own imports): the halo and gather at 2 and 3 ranks, the
# halo table at 2, ACVNet's forward at 2 (float64 and float32) and 4
# (float64).
PARTS = {2: ("halo", "ops", "acv"), 3: ("halo",), 4: ("acv",)}


def rank_main(rank, world, port, out, weights) -> None:
    """One rank: each of its world's parts, the results to ``out``."""
    torch.set_num_threads(1)
    mesh = ddp.init(rank, world, "cpu", f"tcp://localhost:{port}", n_volume=world)
    try:
        targets = {"halo": halo_ranks, "ops": ops_ranks,
                   "acv": lambda m: acv_ranks(m, torch.load(weights))}
        torch.save({part: targets[part](mesh) for part in PARTS[world]}, out)
    finally:
        ddp.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, acv_weights):
    """Each rank's results on the 1 × 2, 1 × 3 and 1 × 4 grids, by world,
    and, made in this process while the ranks run, the unsplit forwards
    (float64 and float32) and the JAX package's forward on the same
    weights."""
    tmp, procs, outs = tmp_path_factory.mktemp("grids"), [], {}
    try:
        for world, port in zip(PARTS, free_ports(len(PARTS))):
            outs[world] = [str(tmp / f"w{world}r{r}.pt") for r in range(world)]
            procs += start(rank_main,
                           lambda r, w=world, p=port: (r, w, p, outs[w][r], acv_weights), world)
        whole, jpred = acv_whole(acv_weights), acv_jax(acv_weights)
    finally:
        join(procs)
    grids = {world: [torch.load(o) for o in files] for world, files in outs.items()}
    return dict(grids=grids, whole=whole, jax=jpred)


# ---- halo and gather_rows ------------------------------------------------

HALO_ROWS = 6  # 2 or 3 rows a band
HALO_CASES = [(1, 1, "zero"), (2, 0, "zero"), (0, 2, "replicate"), (2, 1, "replicate")]


def halo_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 4, HALO_ROWS, 5), generator=g, dtype=torch.float64)
    weights = [torch.randn((2, 3, 4, HALO_ROWS + 4, 5), generator=g, dtype=torch.float64)
               for _ in range(3)]
    return x, weights


def halo_ranks(mesh):
    """Each case's halo of this rank's band and its gradient from the loss
    ``Σ halo · weight`` (the weight this rank's draw), then ``gather_rows``
    and its gradient."""
    x, weights = halo_inputs()
    r, n = mesh.volume_index, HALO_ROWS // mesh.n_volume
    out = {}
    with volume_sharding(mesh):
        return halo_cases(x, weights, r, n, out)


def halo_cases(x, weights, r, n, out):
    for top, bottom, edge in HALO_CASES:
        band = constrain_volume(x).requires_grad_()
        y = halo(band, top, bottom, edge)
        (y * weights[r][:, :, :, :y.shape[3]]).sum().backward()
        out[top, bottom, edge] = (y.detach(), band.grad)
    band = constrain_volume(x).requires_grad_()
    full = gather_rows(band)
    (full * weights[r][:, :, :, :HALO_ROWS]).sum().backward()
    out["gather"] = (full.detach(), band.grad)
    assert band.grad.shape[3] == n
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_halo_and_gather_rows(world, runs):
    ranks = [r["halo"] for r in runs["grids"][world]]
    x, weights = halo_inputs()
    n = HALO_ROWS // world
    for top, bottom, edge in HALO_CASES:
        xg = x.clone().requires_grad_()
        mode = "constant" if edge == "zero" else "replicate"
        padded = F.pad(xg, (0, 0, top, bottom, 0, 0), mode=mode)
        loss = 0
        for r in range(world):
            want = padded[:, :, :, r * n:r * n + n + top + bottom]
            got, _ = ranks[r][top, bottom, edge]
            torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
            loss = loss + (want * weights[r][:, :, :, :want.shape[3]]).sum()
        loss.backward()
        grads = torch.cat([ranks[r][top, bottom, edge][1] for r in range(world)], dim=3)
        assert rel_l2(grads, xg.grad) < RTOL, (top, bottom, edge)
    for r in range(world):
        torch.testing.assert_close(ranks[r]["gather"][0], x, rtol=0, atol=0)
    want = sum(w[:, :, :, :HALO_ROWS] for w in weights[:world])
    grads = torch.cat([ranks[r]["gather"][1] for r in range(world)], dim=3)
    assert rel_l2(grads, want) < RTOL


# ---- the halo table, one op at a time, on 2 ranks -------------------------

OP_SHAPE = (1, 8, 8, 8, 12)  # (B, C, D, H4, W4): 4 rows a band


def op_cases() -> dict:
    """Each op of the split's table, seeded, float64, eval mode (the
    BatchNorms' running statistics drawn), as ``f(x)`` on an NCDHW input
    or, for the heads, on ``x[:, 0]`` as ``(B, D, H4, W4)`` logits."""
    g = torch.Generator().manual_seed(1)

    def seeded(m):
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
            for name, b in m.named_buffers():
                if name.endswith("running_mean"):
                    b.copy_(torch.randn(b.shape, generator=g) * 0.1)
                elif name.endswith("running_var"):
                    b.copy_(torch.rand(b.shape, generator=g) + 0.5)
        return m.double().eval()

    c = OP_SHAPE[1]
    packed = seeded(torch.nn.Conv3d(32, 8, 3, 1, 1, bias=False))
    packed.__class__ = PackedConv3d
    packed_train = seeded(torch.nn.Conv3d(32, 8, 3, 1, 1, bias=False)).train()
    packed_train.__class__ = PackedConv3d
    lift = seeded(torch.nn.Conv3d(c, 32, 1, bias=False))

    def patch(d):
        m = seeded(torch.nn.Conv3d(c, c, (1, 3, 3), padding=(0, d, d), dilation=(1, d, d),
                                   groups=c, bias=False))
        return lambda x: conv3d_rows(m, x)

    return {
        "convbn_s1": seeded(convbn_3d(c, 8, 3, 1, 1)),
        "head": seeded(HeadConv3D(c)),
        "packed": lambda x, m=packed: conv3d_rows(m, lift(x)),
        "packed_train": lambda x, m=packed_train: conv3d_rows(m, lift(x)),
        "convbn_s2": seeded(convbn_3d(c, 8, 3, 2, 1)),
        "deconv": seeded(ConvTransposeBN(c, 4)),
        "convbn_1x1": seeded(convbn_3d(c, 8, 1, 1, 0)),
        "patch_d1": patch(1), "patch_d2": patch(2), "patch_d3": patch(3),
        "attention": seeded(AttentionBlock3D(16, num_heads=4)),
        "regress_head": lambda x: regress_head(x[:, 0], 4 * OP_SHAPE[2], (32, 48)),
        "fused_head": lambda x: torch.stack(
            fused_head_rows(x[:, 0], 4 * OP_SHAPE[2], (32, 48)), 1),
    }


# Two kernels' plain versions compute in float32, and the kernels have no
# backward (they refuse a tracked input on the card): their forwards are
# held here.  The eval ``PackedConv3d`` (``conv3d_packed``) has its crop's
# gradient held in training mode, where it is an ``nn.Conv3d``
# (``packed_train``); the fused head takes ``regress_head``'s halo and
# crop (``upsample_halo``), whose gradient is held in float64.
FORWARD_ONLY = {"packed", "fused_head"}


def op_input(name: str) -> torch.Tensor:
    shape = list(OP_SHAPE)
    if name == "attention":
        shape[1] = 16
    return torch.randn(shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)


def op_grad_weight(y: torch.Tensor) -> torch.Tensor:
    return torch.randn(y.shape, generator=torch.Generator().manual_seed(3), dtype=y.dtype)


def ops_ranks(mesh):
    """Each op on this rank's band: its output and its input's gradient
    under ``Σ out · weight`` (the weight this rank's band of one global
    draw)."""
    out = {}
    for name, f in op_cases().items():
        with volume_sharding(mesh):
            x = constrain_volume(op_input(name)).requires_grad_()
            y = f(x)
        shape = list(y.shape)
        shape[-2] *= mesh.n_volume
        whole = op_grad_weight(torch.empty(shape, dtype=y.dtype))
        first, n = y.shape[-2] * mesh.volume_index, y.shape[-2]
        (y * whole.narrow(-2, first, n)).sum().backward()
        out[name] = (y.detach(), x.grad)
    return out


def test_halo_table_ops_on_two_ranks(runs):
    """Forward and input gradient of every op of the table, split against
    whole (float64, relative L2 within 1e-10)."""
    ranks = [r["ops"] for r in runs["grids"][2]]
    for name, f in op_cases().items():
        x = op_input(name).requires_grad_()
        y = f(x)
        (y * op_grad_weight(y)).sum().backward()
        got = torch.cat([r[name][0] for r in ranks], dim=-2)
        grad = torch.cat([r[name][1] for r in ranks], dim=-2)
        assert got.shape == y.shape, name
        assert rel_l2(got, y.detach()) < RTOL, (name, rel_l2(got, y.detach()))
        if name not in FORWARD_ONLY:
            assert rel_l2(grad, x.grad) < RTOL, (name, rel_l2(grad, x.grad))


def test_band_rule_raises():
    """At H/4 a band must hold a multiple of 4 rows: 32×64 has 8 rows at
    H/4, 2 a band over 4 ranks.  No collective runs before the check."""
    model = ACVNet(MD, False).double().eval()
    mesh = Mesh(0, 4, torch.device("cpu"), n_volume=4)
    x = torch.zeros((1, 32, 64, 3), dtype=torch.float64)
    with volume_sharding(mesh), pytest.raises(ValueError, match="band rule"):
        model(x, x)


# ---- ACVNet's module-path forward ------------------------------------------

def acv_inputs():
    g = torch.Generator().manual_seed(4)
    left = torch.randn((1, H, W, 3), generator=g) * 0.3
    return left, torch.roll(left, -3, dims=2)


@pytest.fixture(scope="module")
def acv_weights(tmp_path_factory) -> str:
    """Tamed seeded weights with heads calibrated on the inputs (float32),
    made once and saved for every process."""
    left, right = acv_inputs()
    model = tame_residual_branches(random_acv(MD, False, torch.Generator().manual_seed(5)))
    with torch.no_grad():
        calibrate_heads(model, left, right)
    path = str(tmp_path_factory.mktemp("acv_weights") / "acv.pt")
    torch.save(model.state_dict(), path)
    return path


def acv_model(state: dict, dtype) -> ACVNet:
    model = ACVNet(MD, False)
    model.load_state_dict(state)
    return model.to(dtype).eval()


def acv_ranks(mesh, state):
    """The split forward in float64, and on 2 ranks in float32 too."""
    left, right = acv_inputs()
    dtypes = (torch.float64, torch.float32) if mesh.n_volume == 2 else (torch.float64,)
    out = {}
    for dt in dtypes:
        model = acv_model(state, dt)
        with torch.no_grad(), volume_sharding(mesh):
            out[str(dt)] = model(left.to(dt), right.to(dt))[0]
    return out


def acv_whole(weights: str) -> dict:
    """The unsplit forward in float64 and float32, by dtype."""
    left, right = acv_inputs()
    state = torch.load(weights)
    with torch.no_grad():
        return {str(dt): acv_model(state, dt)(left.to(dt), right.to(dt))[0]
                for dt in (torch.float64, torch.float32)}


def acv_jax(weights: str) -> np.ndarray:
    """The JAX package's ``ACVNet`` eval forward (float32) on the same
    weights and images."""
    import jax

    from diffuvolume_tpu.models.acv import ACVNet as JACV
    from torch_parity import to_jax_variables

    left, right = acv_inputs()
    jmodel = JACV(max_disp=MD, diffusion=False)
    return np.asarray(jax.jit(lambda v, lt, rt: jmodel.apply(v, lt, rt, train=False))(
        to_jax_variables(acv_model(torch.load(weights), torch.float32)), left.numpy(),
        right.numpy())[0])


def acv_split(runs, world: int, dtype) -> torch.Tensor:
    """The bands of the 1 × ``world`` split forward in ``dtype``, in order."""
    return torch.cat([r["acv"][str(dtype)] for r in runs["grids"][world]], dim=1)


@pytest.mark.parametrize("world", [2, 4])
def test_acv_forward_split_equals_whole(runs, world):
    got, want = acv_split(runs, world, torch.float64), runs["whole"][str(torch.float64)]
    assert got.shape == want.shape == (1, H, W)
    assert rel_l2(got, want) < RTOL, rel_l2(got, want)


def test_acv_forward_split_matches_jax(runs):
    """The 1 × 2 split forward in float32 against the JAX package's
    ``ACVNet`` eval forward on the same weights: 2e-3 px, as
    ``tests/test_torch_acv.py``'s unsplit forward."""
    got = acv_split(runs, 2, torch.float32).numpy()
    np.testing.assert_allclose(got, runs["jax"], rtol=0, atol=JAX_ATOL)
