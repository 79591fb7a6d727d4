"""Training CLI: the reference's SceneFlow/main.py, KITTI12/main.py and
KITTI15/train_stereo.py recipes, on one card.

Counterpart of ``diffuvolume_tpu/cli/train.py``, with its flags and its
printed lines, plus ``--device``:

    python -m diffuvolume_tpu_torch.cli.train --dataset sceneflow --datapath DIR \\
        --model acvnet_ddim --batch_size 4 --epochs 48 --lrepochs "16,24,32,40,48:2"

It runs on ``cuda:0`` unless ``--device`` says otherwise (``--device cpu``
for the tests), and never falls back to the CPU.  The model starts from the
JAX package's initialisation scheme drawn with ``--seed``; ``--init_from``
warm-starts it from another run's latest checkpoint (the entries both state
dicts hold at one shape), ``--resume`` continues this run's.  ``--bf16``
autocasts the forward to bfloat16 over float32 weights.  An epoch ends with
a checkpoint (``train/checkpoint.py``) that ``cli/evaluate.py`` loads as it
loads a reference checkpoint, and, with ``--eval_freq``, the two-model DDIM
evaluation on the port's kernels.

Under ``torchrun --nproc_per_node N`` it trains on the JAX CLI's ``data``
axis (``parallel/ddp.py``): ``--batch_size`` is the global batch, each rank
takes its contiguous rows of every batch the single-process loader yields,
BatchNorm and the loss's means are taken over the global batch, the
gradients are summed over the ranks before the clip and the optimiser, and
only rank 0 prints, logs and writes checkpoints; the step equals the
single-process step at the same global batch.  ``--eval_freq``'s
evaluation splits the test images over the ranks and sums their D1 and
EPE.  Each rank runs on
``cuda:LOCAL_RANK`` (NCCL), or with ``--device cpu`` on the CPU (gloo).

``--volume_axis V`` (every recipe) also splits the cost volume's rows
over ``V`` ranks: a world of ``n_data × V`` ranks under
``torchrun`` forms the ``(data, volume)`` grid (``parallel/mesh.py``),
``--batch_size`` splits over ``n_data``, and each step runs inside
``volume_sharding`` (``parallel/volume_sharding.py``, opened by the step of
``train/loop.py``), its band of the
quarter-resolution rows a rank; the step equals the single-process step.
The JAX CLI builds the same mesh but never enters its ``volume_sharding``;
the port follows the flag's help.  A world that ``V`` does not divide and
a run without ``torchrun`` raise; no recipe falls back to an unsplit run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from diffuvolume_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
)
from diffuvolume_tpu_torch.data.loader import DataLoader, prefetch_to_device
from diffuvolume_tpu_torch.data.zoo import fetch_dataset
from diffuvolume_tpu_torch.models import build_model
from diffuvolume_tpu_torch.parallel import ddp
from diffuvolume_tpu_torch.train.checkpoint import (
    load_checkpoint,
    partial_warm_start,
    restore_checkpoint,
    save_checkpoint,
)
from diffuvolume_tpu_torch.train.loop import (
    TrainState,
    make_igev_train_step,
    make_optimizer,
    make_train_step,
)
from diffuvolume_tpu_torch.train.loss import (
    KITTI12_WEIGHTS,
    SCENEFLOW_WEIGHTS,
    SCENEFLOW_WEIGHTS_ATTN_ONLY,
    SCENEFLOW_WEIGHTS_FREEZE_ATTN,
)
from diffuvolume_tpu_torch.train.lr import milestone_lr_schedule, one_cycle_schedule
from diffuvolume_tpu_torch.utils.device import resolve_device
from diffuvolume_tpu_torch.utils.logger import Logger
from diffuvolume_tpu_torch.utils.meters import AverageMeter
from diffuvolume_tpu_torch.utils.visualization import disp_error_image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DiffuVolume training (PyTorch/CUDA)")
    p.add_argument("--model", default="acvnet_ddim", help="model registry name")
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument(
        "--stage", choices=["attn_only", "freeze_attn", "full"], default="full",
        help="staged ACV training (SceneFlow recipe): 'attn_only' trains just "
        "the attention branch (SceneFlow/models/loss.py:5-8, acv.py:94 "
        "attn_weights_only), 'freeze_attn' trains the rest with the attention "
        "weights frozen (loss.py:10-13); chain the stages with --init_from",
    )
    p.add_argument(
        "--init_from", default=None,
        help="run directory whose latest checkpoint warm-starts the model (the "
        "state-dict entries both hold at one shape; chains --stage runs, starts "
        "KITTI finetunes from a SceneFlow run)",
    )
    p.add_argument("--bf16", action="store_true",
                   help="autocast the forward to bfloat16 over float32 weights")
    p.add_argument("--volume_axis", type=int, default=1,
                   help="mesh size of the cost-volume sharding axis "
                   "(ParallelConfig.volume_axis): ranks a band of the volume's rows, "
                   "under torchrun")
    p.add_argument(
        "--recipe", choices=["sceneflow", "kitti12", "kitti15"], default=None,
        help="training recipe (loss weights / optimizer / schedule); "
        "default inferred from --model.  sceneflow: Adam + milestone decay + "
        "[.5,.5,.7,1] (SceneFlow/main.py); kitti12: same optimizer family, "
        "6-head weights [...,1.3] (KITTI12/main.py:70,100); kitti15: AdamW + "
        "OneCycle + grad-clip 1.0 + sequence loss (KITTI15/train_stereo.py:64-70)",
    )
    p.add_argument("--iters", type=int, default=22, help="IGEV train GRU iterations")
    p.add_argument("--wdecay", type=float, default=1e-5, help="AdamW weight decay (kitti15)")
    p.add_argument("--dataset", default="sceneflow")
    p.add_argument("--datapath", required=True)
    p.add_argument("--trainlist", default=None)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--num_workers", type=int, default=8,
                   help="host decode/augment workers (reference: 16)")
    p.add_argument("--shuffle", action="store_true", default=True)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=48)
    p.add_argument("--lrepochs", default="16,24,32,40,48:2")
    p.add_argument("--logdir", default="./checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--summary_freq", type=int, default=100)
    # Per-epoch DDIM evaluation with best-D1 tracking (KITTI12/main.py:117-137).
    p.add_argument("--testlist", default=None)
    p.add_argument("--eval_freq", type=int, default=0, help="epochs between evals (0=off)")
    p.add_argument("--eval_baseline_ckpt", default=None,
                   help="frozen baseline checkpoint for the two-model eval")
    p.add_argument("--eval_max_images", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda:N (default cuda:0) or cpu")
    return p.parse_args(argv)


# Per-recipe eval wiring: the backbone whose baseline model, DDIM preset and
# pipeline cli/evaluate.py's BACKBONES name (the JAX CLI's _EVAL_WIRING:
# acvnet + SCENEFLOW_DDIM, gwcnet-gc + KITTI12_DDIM, igev + KITTI15_DDIM).
_EVAL_WIRING = {"sceneflow": "acv", "kitti12": "pcw", "kitti15": "igev"}


def build_experiment_config(args):
    """Fold the CLI surface into the one dataclass config (config.py): the
    dataclasses are the configuration, argparse their CLI skin."""
    backbone = ("igev" if "igev" in args.model
                else "pcw" if "pcw" in args.model or "gwc" in args.model
                else "acv")
    recipe = args.recipe or {"igev": "kitti15", "pcw": "kitti12", "acv": "sceneflow"}[backbone]
    return recipe, ExperimentConfig(
        model=ModelConfig(backbone=backbone, max_disp=args.maxdisp,
                          diffusion="ddim" in args.model),
        data=DataConfig(dataset=args.dataset, datapath=args.datapath,
                        trainlist=args.trainlist, testlist=args.testlist,
                        batch_size=args.batch_size),
        optim=OptimConfig(lr=args.lr, lrepochs=args.lrepochs, epochs=args.epochs,
                          optimizer="adamw" if recipe == "kitti15" else "adam",
                          weight_decay=args.wdecay,
                          grad_clip=1.0 if recipe == "kitti15" else None,
                          bf16=args.bf16),
        parallel=ParallelConfig(volume_axis=args.volume_axis),
        logdir=args.logdir, seed=args.seed, resume=args.resume, loadckpt=args.init_from,
    )


def _epoch_eval(args, recipe, model, baseline, dataset_cls, dev, dp=None):
    """The two-model DDIM evaluation with the in-training weights (eval
    mode, the port's kernels); returns mean ``(D1, EPE)`` over the test
    images.  Image ``i`` draws from a generator seeded with ``i``.  With
    ``dp`` each rank evaluates images ``rank, rank + world_size, …`` and the
    sums are taken over the ranks: every rank returns the single-process
    means."""
    from diffuvolume_tpu_torch.cli.evaluate import BACKBONES
    from diffuvolume_tpu_torch.eval.metrics import metrics_batch

    _, _, preset, infer, _, _ = BACKBONES[_EVAL_WIRING[recipe]]
    cfg = dataclasses.replace(preset, max_disp=model.max_disp, num_bins=model.max_disp // 4)
    test_ds = dataset_cls(args.datapath, list_filename=args.testlist, training=False)
    n = len(test_ds) if args.eval_max_images == 0 else min(args.eval_max_images, len(test_ds))
    kw = {"iters": args.iters} if recipe == "kitti15" else {}
    first, stride = (0, 1) if dp is None else (dp.rank, dp.world_size)
    sums = torch.zeros(3, dtype=torch.float64, device=dev)  # D1, EPE, images
    model.eval()
    try:
        for i in range(first, n, stride):
            s = test_ds[i]
            left = torch.from_numpy(s["left"])[None].to(dev)
            right = torch.from_numpy(s["right"])[None].to(dev)
            final, _ = infer(baseline, model, left, right, cfg, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(i), **kw)
            gt = torch.from_numpy(s["disp_gt"])[None].to(dev)
            m = metrics_batch(final, gt, (gt > 0) & (gt < model.max_disp))
            sums += torch.stack([m["D1"][0].double(), m["EPE"][0].double(), sums.new_ones(())])
    finally:
        model.train()
    if dp is not None:
        sums = dp.sum(sums)
    d1, epe, count = sums.tolist()
    return d1 / count, epe / count


def build_state(args, recipe: str, cfg: ExperimentConfig, steps_per_epoch: int, dev,
                dp: ddp.Mesh | None = None):
    """The model (the JAX package's initialisation drawn with ``--seed``,
    then ``--init_from``), its optimiser and schedule, and the train step;
    with ``dp``, BatchNorm over the global batch and rank 0's parameters on
    every rank."""
    model_kw = {"max_disp": cfg.model.max_disp}
    if args.stage != "full":
        if recipe != "sceneflow":
            raise ValueError("--stage is the SceneFlow/ACV recipe's")
        model_kw["attn_weights_only"] = args.stage == "attn_only"
        model_kw["freeze_attn_weights"] = args.stage == "freeze_attn"
    model = build_model(args.model, **model_kw)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    if cfg.loadckpt:
        donor = load_checkpoint(cfg.loadckpt)
        if donor is None:
            raise FileNotFoundError(f"no checkpoint in {cfg.loadckpt}")
        model.load_state_dict(partial_warm_start(model.state_dict(), donor["model"]))
        if dp is None or dp.is_main:
            print(f"warm-started from {cfg.loadckpt}")
    model = model.to(dev).train()
    if dp is not None:
        ddp.sync_batch_norm(model, dp)
        dp.broadcast_parameters(model)

    total = cfg.optim.epochs * steps_per_epoch
    if recipe == "kitti15":
        schedule = one_cycle_schedule(cfg.optim.lr, total)
        step = make_igev_train_step(model, iters=args.iters, bf16=cfg.optim.bf16, dp=dp)
    else:
        schedule = milestone_lr_schedule(cfg.optim.lr, cfg.optim.lrepochs, steps_per_epoch)
        weights = (
            KITTI12_WEIGHTS if recipe == "kitti12"
            else SCENEFLOW_WEIGHTS_ATTN_ONLY if args.stage == "attn_only"
            else SCENEFLOW_WEIGHTS_FREEZE_ATTN if args.stage == "freeze_attn"
            else SCENEFLOW_WEIGHTS
        )
        step = make_train_step(model, weights, bf16=cfg.optim.bf16, dp=dp)
    optimizer = make_optimizer(model, cfg.optim.optimizer, cfg.optim.weight_decay)
    return TrainState(model, optimizer, schedule, cfg.optim.grad_clip), step


def run(args, on_start=None, on_step=None) -> dict:
    """Train as ``main`` does.  ``on_start(state)`` is called before the
    first step, ``on_step(state, metrics)`` after each.  Returns ``{"state",
    "best_d1", "losses", "evals"}`` (``evals``: each evaluation's ``(D1,
    EPE)``).  Started by ``torchrun``, the process joins its
    data-parallel group here and leaves it on return."""
    recipe, cfg = build_experiment_config(args)
    _check_volume_axis(cfg.parallel.volume_axis)
    dp = ddp.from_env(args.device, n_volume=cfg.parallel.volume_axis)
    try:
        return _train(args, recipe, cfg, dp, on_start, on_step)
    finally:
        if dp is not None:
            ddp.shutdown()


def _check_volume_axis(v: int) -> None:
    """``--volume_axis V``: at least 1; above 1 under a ``torchrun`` world
    that ``V`` divides."""
    if v < 1:
        raise ValueError(f"--volume_axis must be at least 1, got {v}")
    if v == 1:
        return
    world = int(os.environ.get("WORLD_SIZE", 1))
    if "WORLD_SIZE" not in os.environ or world % v:
        raise ValueError(f"--volume_axis {v} needs a torchrun world size that it divides; "
                         f"the world size is {world}")


def _train(args, recipe, cfg, dp, on_start, on_step) -> dict:
    main_rank = dp is None or dp.is_main
    say = print if main_rank else (lambda *a, **k: None)
    dev = resolve_device(args.device) if dp is None else dp.device
    if dp is not None and cfg.data.batch_size % dp.n_data:
        raise ValueError(f"--batch_size {cfg.data.batch_size} does not split over "
                         f"{dp.n_data} data ranks")
    dataset = fetch_dataset(cfg.data.dataset, cfg.data.datapath, training=True,
                            list_filename=cfg.data.trainlist, seed=cfg.seed)
    steps_per_epoch = max(len(dataset) // cfg.data.batch_size, 1)
    say(f"dataset: {len(dataset)} samples, {steps_per_epoch} steps/epoch"
        + ("" if dp is None else f", {dp.world_size} ranks ({dp.n_data} data × "
           f"{dp.n_volume} volume) of {cfg.data.batch_size // dp.n_data}"))
    state, train_step = build_state(args, recipe, cfg, steps_per_epoch, dev, dp)

    start_epoch = 0
    if cfg.resume:
        restored = restore_checkpoint(cfg.logdir, state.model, state.optimizer)
        if restored is not None:
            state.step = restored
            start_epoch = restored // steps_per_epoch
            say(f"resumed at epoch {start_epoch}")

    baseline = None
    if args.eval_freq > 0:
        from diffuvolume_tpu_torch.cli.evaluate import load_model

        baseline = load_model(args.eval_baseline_ckpt, _EVAL_WIRING[recipe], False,
                              args.maxdisp, 0, dev)
    best_d1, evals = float("inf"), []

    loader = DataLoader(dataset, args.batch_size, shuffle=args.shuffle,
                        num_workers=args.num_workers, drop_last=True, seed=args.seed)
    logger = Logger(cfg.logdir, print_freq=args.summary_freq) if main_rank else None
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    if on_start is not None:
        on_start(state)
    for epoch in range(start_epoch, args.epochs):
        meter = AverageMeter()
        t0 = time.time()
        batches = ({k: v for k, v in b.items() if k not in ("filename", "filenames")}
                   for b in loader)
        if dp is not None:
            batches = (dp.shard(b) for b in batches)
        # Batches land on the card 2 ahead of compute.
        for i, batch in enumerate(prefetch_to_device(batches, dev, size=2)):
            metrics = train_step(state, batch, generator)
            loss = float(metrics["loss"])
            meter.update(loss)
            losses.append(loss)
            if on_step is not None:
                on_step(state, metrics)
            if i % args.summary_freq == 0 and main_rank:
                _summary(logger, state, metrics, epoch, i, steps_per_epoch, loss, t0)
        say(f"epoch {epoch} done: mean loss {meter.mean():.4f}")
        if main_rank:
            save_checkpoint(cfg.logdir, state.step, state.model, state.optimizer)
        if baseline is not None and (epoch + 1) % args.eval_freq == 0:
            d1, epe = _epoch_eval(args, recipe, state.model, baseline, type(dataset), dev, dp)
            evals.append((d1, epe))
            tag = ""
            if d1 < best_d1:
                best_d1 = d1
                tag = "  (best)"
            say(f"epoch {epoch} eval: D1 {d1:.4f} EPE {epe:.4f}{tag}")
        if dp is not None:
            dp.barrier()
    if logger is not None:
        logger.close()
    return {"state": state, "best_d1": best_d1, "losses": losses, "evals": evals}


def _summary(logger, state, metrics, epoch, i, steps_per_epoch, loss, t0) -> None:
    print(f"epoch {epoch} step {i}/{steps_per_epoch} loss {loss:.3f} "
          f"EPE {float(metrics['epe']):.3f} ({(time.time() - t0) / (i + 1):.2f}s/it)")
    logger.write_dict({"train/loss": loss, "train/epe": metrics["epe"]}, step=state.step)
    # Image summaries (SceneFlow/main.py via experiment.py:72-88
    # save_images): est / GT / KITTI error map, sample 0 (its band of rows
    # under the volume split).
    est = metrics["pred"][0].float().cpu().numpy()
    gt = metrics["gt"][0].float().cpu().numpy()
    logger.write_images({"train/disp_est": est, "train/disp_gt": gt,
                         "train/errormap": disp_error_image(est, gt)}, step=state.step)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
