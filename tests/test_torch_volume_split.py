"""PCWNet's and IGEV-Stereo's cost volumes split over ranks
(``parallel/volume_sharding.py``), and the uneven bands, against one
process on the CPU.

Gloo ranks fork from a ``forkserver`` as ``tests/test_torch_volume_sharding.py``'s
do (one intra-op thread each, joined within a timeout, every one exiting
0); a world of 2 and a world of 4 start together, and this process makes
the unsplit forwards while they run.

* ``edges`` / ``band`` / ``level_band``: the cuts and the refusals, a table;
* the KITTI12 step (PCWNet, ``make_train_step``, six heads, Adam) and the
  KITTI15 step (IGEV, ``make_igev_train_step``, 3 GRU iterations, clip +
  AdamW) in float64 on a 1 × 2 grid, a 1 × 4 grid with uneven bands (40
  rows at H/4 cut 16 / 8 / 8 / 8) and a 2 × 2 grid (the world of 4 holds
  both grids), each against the single-process step, which one rank of
  the world makes before the split steps (one case a rank) and compares
  with its own copy of the split step's state: the loss and EPE every
  rank reports, every gradient after the all-reduce, every BatchNorm
  statistic, every parameter after the optimiser, relative L2 within
  1e-10 (a vanishing gradient held to its bound, the optimiser's
  parameters over the elements whose gradient resolves); every rank's
  state equal to rank 0's (a checksum of the bits).  Only the gaps leave
  the ranks (PCW's 36M float64 parameters and gradients stay in memory).
  The single-process step takes its BatchNorm
  sums in ``_GlobalBatchNorm``'s formula, as the ranks do (each norm's
  ``reduce_stats`` the identity): PyTorch's own BatchNorm rounds another
  way, and IGEV's smallest trunk gradients move by up to 1.9e-10 between
  the two formulas in one process with no split (measured, calibrated
  weights, float64);
* the module-path eval forwards split over 1 × 2 against unsplit, float64,
  relative L2 within 1e-10: PCWNet routed (``route_conv3d``: the packed
  convs' halo and crop), IGEV's ``igev_forward`` (``conv3x3x3_small``'s
  halo and crop), and ACVNet at a shape the equal-band rule refused (20
  rows at H/4 cut 12 / 8).
"""

import pytest
import torch

from diffuvolume_tpu_torch.models.acv import ACVNet
from diffuvolume_tpu_torch.models.igev.model import IGEVStereo, igev_forward
from diffuvolume_tpu_torch.models.layers import _FlaxRunningStats, route_conv3d
from diffuvolume_tpu_torch.models.pcw import PCWNet
from diffuvolume_tpu_torch.parallel import ddp
from diffuvolume_tpu_torch.parallel.mesh import Mesh, make_mesh
from diffuvolume_tpu_torch.parallel.volume_sharding import (
    band,
    cut_rows,
    edges,
    level_band,
    volume_sharding,
)
from diffuvolume_tpu_torch.tools.random_weights import (
    calibrate_heads,
    calibrate_igev,
    calibrate_pcw,
    random_acv,
    random_igev,
    random_pcw,
)
from diffuvolume_tpu_torch.train.loop import (
    TrainState,
    make_igev_train_step,
    make_optimizer,
    make_train_step,
)
from diffuvolume_tpu_torch.train.loss import KITTI12_WEIGHTS
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule, one_cycle_schedule
from test_torch_volume_sharding import free_ports, join, rel_l2, start

RTOL, VANISH, RESOLVE = 1e-10, 1e-9, 1e-4
MD, ITERS = 64, 3

# case → (model, n_data, n_volume, global batch, H, W)
CASES = {
    "pcw_1x2": ("pcw", 1, 2, 1, 64, 32),
    "igev_1x2": ("igev", 1, 2, 1, 64, 64),
    "pcw_1x4": ("pcw", 1, 4, 1, 160, 32),
    "igev_1x4": ("igev", 1, 4, 1, 160, 64),
    "pcw_2x2": ("pcw", 2, 2, 2, 64, 32),
    "igev_2x2": ("igev", 2, 2, 2, 64, 64),
}
WORLDS = {2: ("pcw_1x2", "igev_1x2"), 4: ("pcw_1x4", "igev_1x4", "pcw_2x2", "igev_2x2")}
FORWARD_HW = {"pcw": (64, 64), "igev": (64, 96), "acv": (80, 64)}  # ACV: 20 rows at H/4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the band rule -------------------------------------------------------

BAND_TABLE = [  # (rows, multiple, volume axis, band sizes; None: refused)
    (16, 4, 2, [8, 8]),
    (20, 4, 2, [12, 8]),
    (80, 8, 4, [24, 24, 16, 16]),
    (40, 8, 2, [24, 16]),
    (40, 8, 4, [16, 8, 8, 8]),
    (96, 8, 8, [16, 16, 16, 16, 8, 8, 8, 8]),
    (7, 1, 3, [3, 2, 2]),
    (18, 4, 4, [4, 4, 4, 6]),
    (16, 8, 2, [8, 8]),
    (8, 4, 4, None),
    (16, 8, 4, None),
    (12, 4, 4, None),
]


@pytest.mark.parametrize("rows, multiple, v, sizes", BAND_TABLE)
def test_band_cuts_and_refusals(rows, multiple, v, sizes):
    """Edges at multiples of ``multiple``, sizes at most one multiple
    apart, the larger bands first, the last taking ``rows % multiple``;
    a refusal exactly when ``v`` exceeds ``rows / multiple``, naming the
    rule.  ``band`` on each rank of the axis gives its own."""
    if sizes is None:
        assert v > rows / multiple
        with pytest.raises(ValueError, match="band rule"):
            edges(rows, multiple, v)
        return
    assert v <= rows / multiple
    e = edges(rows, multiple, v)
    assert [b - a for a, b in zip(e, e[1:])] == sizes
    assert all(x % multiple == 0 for x in e[:-1])
    for r in range(v):
        with volume_sharding(Mesh(r, v, torch.device("cpu"), n_volume=v)):
            assert band(rows, multiple) == (e[r], sizes[r])


def test_level_bands_scale_the_quarter_cut():
    """IGEV's crop (320×736: 80 rows at H/4) over 4 ranks: 24 / 24 / 16 /
    16 at H/4, each level's band the H/4 band divided by 2^k; a cut that
    the deepest level cannot hold raises."""
    for r, want in enumerate([(0, 24), (24, 24), (48, 16), (64, 16)]):
        with volume_sharding(Mesh(r, 4, torch.device("cpu"), n_volume=4)):
            assert cut_rows(80, 8) == want
            for k in range(4):
                assert level_band(k) == (want[0] >> k, want[1] >> k)
    with volume_sharding(Mesh(1, 2, torch.device("cpu"), n_volume=2)):
        cut_rows(20, 4)  # 12 / 8: the edge at 12 is no whole row at H/32
        assert level_band(2) == (3, 2)
        with pytest.raises(ValueError, match="band rule"):
            level_band(3)


# ---- inputs --------------------------------------------------------------

def make_batch(case: str) -> dict:
    """Seeded images (normalised for PCW, RAW for IGEV), the right the left
    shifted 3 px, ground truth whose valid counts differ by band and by
    row, the step's timestep and noise for the global batch."""
    kind, _, _, b, h, w = CASES[case]
    g = torch.Generator().manual_seed(list(CASES).index(case))
    if kind == "pcw":
        left = torch.randn((b, h, w, 3), generator=g, dtype=torch.float64) * 0.3
    else:
        left = torch.rand((b, h, w, 3), generator=g, dtype=torch.float64) * 255.0
    gt = torch.rand((b, h, w), generator=g, dtype=torch.float64) * (MD + 8) + 0.5
    for i in range(b):
        gt[i, :h // 3, :3 + 5 * i] = 0.0
        gt[i, h // 3:, :11 + 7 * i] = 0.0
    t = torch.randint(0, 1000, (1,), generator=g).expand(b)
    noise = torch.randn((b, MD // 4, h // 4, w // 4), generator=g, dtype=torch.float64)
    return {"left": left, "right": torch.roll(left, -3, dims=2), "disp_gt": gt, "t": t,
            "noise": noise}


def calibrated(kind: str) -> dict:
    """Seeded weights (the ACV baseline, the PCW and IGEV DDIM models,
    drawn from seed 7), heads calibrated on a forward input (float32)."""
    gen = torch.Generator().manual_seed(7)
    model = (random_acv(MD, False, gen) if kind == "acv"
             else (random_pcw if kind == "pcw" else random_igev)(MD, True, gen))
    h, w = FORWARD_HW[kind]
    g = torch.Generator().manual_seed(9)
    left = (torch.randn((1, h, w, 3), generator=g) * 0.3 if kind != "igev"
            else torch.rand((1, h, w, 3), generator=g) * 255.0)
    right = torch.roll(left, -3, dims=2)
    with torch.no_grad():
        {"acv": calibrate_heads, "pcw": calibrate_pcw, "igev": calibrate_igev}[kind](
            model, left, right)
    return model.state_dict()


def model_of(kind: str, state: dict, train: bool):
    """``calibrated``'s weights in a bare model, float64."""
    model = {"acv": lambda: ACVNet(MD, False), "pcw": lambda: PCWNet(MD, True),
             "igev": lambda: IGEVStereo(MD, True)}[kind]()
    model.load_state_dict(state)
    model = model.double()
    return model.train() if train else model.eval()


def one_formula(model):
    """``_GlobalBatchNorm``'s sums in one process: every norm's
    ``reduce_stats`` the identity."""
    for m in model.modules():
        if isinstance(m, _FlaxRunningStats):
            m.reduce_stats = torch.clone
    return model


def recipe_step(kind: str, model, batch: dict, t, noise, dp=None, iters: int = ITERS) -> dict:
    """One step of the KITTI12 recipe (``kind`` "pcw" or "gwcnet-g": six
    heads, Adam) or the KITTI15 one ("igev": ``iters`` GRU iterations, clip
    + AdamW) with the draws given; its metrics."""
    if kind in ("pcw", "gwcnet-g"):
        state = TrainState(model, make_optimizer(model), milestone_lr_schedule(1e-3, "10:2", 1))
        step = make_train_step(model, KITTI12_WEIGHTS, dp=dp)
    else:
        state = TrainState(model, make_optimizer(model, "adamw", 1e-5),
                           one_cycle_schedule(2e-4, 50), grad_clip=1.0)
        step = make_igev_train_step(model, iters=iters, dp=dp)
    return step(state, batch, t=t, noise=noise)


def run_step(case: str, model, dp=None) -> dict:
    """One step of ``case``'s recipe on its batch (this rank's data rows
    under ``dp``): the reported loss and EPE, the gradients, the BatchNorm
    statistics and the parameters after it."""
    batch = make_batch(case)
    t, noise = batch.pop("t"), batch.pop("noise")
    if dp is not None:
        batch, t, noise = dp.shard(batch), dp.rows(t), dp.rows(noise)
    out = recipe_step(CASES[case][0], model, batch, t, noise, dp)
    return {"loss": float(out["loss"]), "epe": float(out["epe"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def split_recipe_rank(rank: int, port: int, inputs: str, out: str) -> None:
    """One rank of a 1 × 2 grid running ``recipe_step`` on ``inputs``
    (``kind``, ``max_disp``, ``iters``, the model's ``state``, ``batch``,
    ``t``, ``noise``; float64): its loss and last head's rows to ``out``.
    The JAX parity files run it beside their JAX step.  ``kind`` "pcw" and
    "igev" are the DDIM models, "gwcnet-g" PCWNet without diffusion or the
    concat volume."""
    from diffuvolume_tpu_torch.models.igev.model import IGEVStereo
    from diffuvolume_tpu_torch.models.pcw import PCWNet

    torch.set_num_threads(1)
    x = torch.load(inputs)
    mesh = ddp.init(rank, 2, "cpu", f"tcp://localhost:{port}", n_volume=2)
    try:
        model = {"pcw": lambda md: PCWNet(md, True),
                 "gwcnet-g": lambda md: PCWNet(md, False, use_concat_volume=False),
                 "igev": lambda md: IGEVStereo(md, True)}[x["kind"]](x["max_disp"])
        model.load_state_dict(x["state"])
        model = ddp.sync_batch_norm(model.double().train(), mesh)
        res = recipe_step(x["kind"], model, x["batch"], x["t"], x["noise"], mesh, x["iters"])
        torch.save({"loss": float(res["loss"]), "pred": res["pred"]}, out)
    finally:
        ddp.shutdown()


def start_split(tmp_path_factory, kind: str, max_disp: int, iters, model, batch: dict, t,
                noise) -> tuple:
    """``split_recipe_rank`` on 2 ranks over ``model``'s weights and the
    step's inputs, started; ``(processes, their outputs)``."""
    tmp = tmp_path_factory.mktemp(f"split_{kind}")
    inputs = str(tmp / "inputs.pt")
    torch.save({"kind": kind, "max_disp": max_disp, "iters": iters,
                "state": model.state_dict(), "batch": batch, "t": t, "noise": noise}, inputs)
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    port = ddp.free_port()
    return start(split_recipe_rank, lambda r: (r, port, inputs, outs[r]), 2), outs


def join_split(procs: list, outs: list) -> dict:
    """``start_split``'s ranks joined: the loss each reports and the last
    head's rows stacked."""
    join(procs)
    ranks = [torch.load(o) for o in outs]
    return {"losses": [r["loss"] for r in ranks],
            "pred": torch.cat([r["pred"] for r in ranks], dim=1)}


def check_split(run: dict) -> None:
    """A JAX parity file's split step against its unsplit port step and
    JAX step: the loss (relative 1e-10 and ``LOSS_RTOL``) and the last
    head (relative L2 1e-10)."""
    from test_torch_train_acv import LOSS_RTOL

    unsplit, jloss = float(run["out"]["loss"]), float(run["j"]["loss"])
    for loss in run["split"]["losses"]:
        assert abs(loss / unsplit - 1) < RTOL, (loss, unsplit)
        assert abs(loss / jloss - 1) < LOSS_RTOL, (loss, jloss)
    assert rel_l2(run["split"]["pred"], run["out"]["pred"]) < RTOL


def forward(kind: str, state: dict) -> torch.Tensor:
    """The module-path eval forward in float64 on ``FORWARD_HW``: PCWNet
    routed, IGEV with 2 GRU iterations, the ACV baseline."""
    model = model_of(kind, state, train=False)
    h, w = FORWARD_HW[kind]
    g = torch.Generator().manual_seed(12)
    left = (torch.rand((1, h, w, 3), generator=g, dtype=torch.float64) * 255.0 if kind == "igev"
            else torch.randn((1, h, w, 3), generator=g, dtype=torch.float64) * 0.3)
    right = torch.roll(left, -3, dims=2)
    with torch.no_grad():
        if kind == "igev":
            return igev_forward(model, left, right, iters=2)
        if kind == "pcw":
            model = route_conv3d(model)
        return model(left, right)[0]


# ---- the ranks -----------------------------------------------------------

def checksum(res: dict) -> torch.Tensor:
    """A checksum of the bits of a step's gradients, statistics and
    parameters: each float64 as an int64 times an odd int64 that its index
    sets, summed with wrap-around."""
    bits = torch.cat([t.reshape(-1) for key in ("grads", "stats", "params")
                      for t in res[key].values()]).view(torch.int64)
    odd = torch.arange(bits.numel(), dtype=torch.int64) * 6364136223846793005 | 1
    return (bits * odd).sum().reshape(1)


def step_gaps(got: dict, want: dict) -> dict:
    """``got``'s tensors against the single-process step ``want``, by key:
    the names past ``RTOL`` (relative L2) with their gap; a gradient that
    vanishes in ``want`` held to the bound instead, the parameters compared
    over the elements whose gradient resolves."""
    tiny = VANISH * max(float(g.norm()) for g in want["grads"].values())
    gaps = {}
    for key in ("grads", "stats", "params"):
        bad = [] if set(got[key]) == set(want[key]) else [("names", sorted(got[key]))]
        for name, w in want[key].items():
            x = got[key].get(name)
            g = want["grads"].get(name)  # None for a statistic
            if x is None:
                continue
            if g is not None and float(g.norm()) <= tiny:
                if key == "grads" and float(x.norm()) > tiny:
                    bad.append((name, float(x.norm())))
                continue
            if key == "params":
                resolved = g.abs() > RESOLVE * g.pow(2).mean().sqrt()
                x, w = x[resolved], w[resolved]
            if rel_l2(x, w) >= RTOL:
                bad.append((name, rel_l2(x, w)))
        gaps[key] = bad
    return gaps


def rank_main(rank: int, world: int, port: int, states: str, out: str) -> None:
    """One rank: the single-process step of its world's ``rank``-th case
    (one case a rank), then its world's split steps (the world of 4 as a
    1 × 4 grid, then as a 2 × 2 one on the same group): each step's loss,
    EPE and state checksum, rank 0's checksum, and for its own case the
    gaps to the single-process step; in the world of 2, the split
    forwards.  The results to ``out``."""
    torch.set_num_threads(1)
    mesh = ddp.init(rank, world, "cpu", f"tcp://localhost:{port}", n_volume=world)
    grids = {world: mesh, (2, 2): make_mesh(2, 2, torch.device("cpu")) if world == 4 else None}
    try:
        weights, res = torch.load(states), {}
        mine = WORLDS[world][rank]
        kind = CASES[mine][0]
        want = run_step(mine, one_formula(model_of(kind, weights[kind], train=True)))
        for case in WORLDS[world]:
            kind, n_data, n_volume = CASES[case][:3]
            dp = grids[world] if n_data == 1 else grids[n_data, n_volume]
            model = ddp.sync_batch_norm(model_of(kind, weights[kind], train=True), dp)
            dp.broadcast_parameters(model)
            got = run_step(case, model, dp)
            ours = checksum(got)
            rank0 = ours.clone()
            torch.distributed.broadcast(rank0, 0)
            res[case] = {"loss": got["loss"], "epe": got["epe"],
                         "same_as_rank0": bool(ours == rank0)}
            if case == mine:
                res[case].update(single={"loss": want["loss"], "epe": want["epe"]},
                                 gaps=step_gaps(got, want))
        if world == 2:
            for kind in FORWARD_HW:
                with volume_sharding(mesh):
                    res["forward", kind] = forward(kind, weights[kind])
        torch.save(res, out)
    finally:
        ddp.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results by case (the single-process steps made by the
    ranks, one a rank), and the unsplit forwards, made in this process
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("volume_split")
    weights = {kind: calibrated(kind) for kind in FORWARD_HW}
    states = str(tmp / "weights.pt")
    torch.save(weights, states)
    procs, outs = [], {}
    try:
        for world, port in zip(WORLDS, free_ports(len(WORLDS))):
            outs[world] = [str(tmp / f"w{world}r{r}.pt") for r in range(world)]
            procs += start(rank_main,
                           lambda r, w=world, p=port: (r, w, p, states, outs[w][r]), world)
        whole = {kind: forward(kind, weights[kind]) for kind in FORWARD_HW}
    finally:
        join(procs)
    results = {world: [torch.load(o) for o in files] for world, files in outs.items()}
    ranks = {case: [r[case] for r in results[world]]
             for world, cases in WORLDS.items() for case in cases}
    split = {kind: [r["forward", kind] for r in results[2]] for kind in FORWARD_HW}
    return dict(ranks=ranks, whole=whole, split=split)


def owner(runs, case: str) -> dict:
    """The result of the rank that made ``case``'s single-process step."""
    return next(r for r in runs["ranks"][case] if "single" in r)


# ---- the steps -------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_split_loss_and_epe_are_the_global_batch(runs, case):
    single = owner(runs, case)["single"]
    for r in runs["ranks"][case]:
        assert abs(r["loss"] / single["loss"] - 1) < RTOL, (r["loss"], single["loss"])
        assert abs(r["epe"] / single["epe"] - 1) < RTOL, (r["epe"], single["epe"])


@pytest.mark.parametrize("key", ["grads", "stats", "params"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_step_equals_single_process(runs, case, key):
    """Every tensor of the split step against the single-process step (the
    gaps ``step_gaps`` found, none); every rank's state equals rank 0's."""
    assert all(r["same_as_rank0"] for r in runs["ranks"][case])
    assert owner(runs, case)["gaps"][key] == []


# ---- the forwards ------------------------------------------------------------

@pytest.mark.parametrize("kind", list(FORWARD_HW))
def test_module_path_forward_split_equals_whole(runs, kind):
    """Each rank's rows, stacked, against the unsplit forward; ACV's 20
    rows at H/4 split 12 / 8, so its bands hold 48 and 32 image rows."""
    got = torch.cat(runs["split"][kind], dim=1)
    want = runs["whole"][kind]
    assert got.shape == want.shape == (1, *FORWARD_HW[kind])
    if kind == "acv":
        assert [r.shape[1] for r in runs["split"][kind]] == [48, 32]
    assert rel_l2(got, want) < RTOL, rel_l2(got, want)
