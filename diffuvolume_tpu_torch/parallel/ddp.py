"""Data parallelism over processes: the JAX package's ``data`` mesh axis.

Joins the process group and places the process in the ``(data, volume)``
grid of ``parallel/mesh.py``; with ``n_volume = 1`` that grid is the one
semantics the JAX training CLI uses its mesh for: the global batch split
over devices, parameters replicated, one update from the whole batch's
gradient (with ``n_volume`` above 1, ``parallel/volume_sharding.py`` also
splits the cost volume's rows).  Under the JAX mesh
every reduction in the step is global, and so it is here:

* **BatchNorm** normalises with the global batch's mean and biased
  variance (``mesh.py:15-17``), and updates its running statistics from
  them as flax does, ``n`` the global count: ``sync_batch_norm`` hands
  each of the port's ``BatchNorm2d/3d`` the sum across the ranks, which
  its forward and backward take their batch sums through
  (``models/layers.py``, ``_GlobalBatchNorm``).  ``nn.SyncBatchNorm``
  would keep the unbiased variance.
* **The masked loss means** divide the local masked sum by the global
  count of valid pixels (``train/loss.py``, the JAX package's
  ``loss.py:28-30``); each rank's loss is its share of the global loss, so
  the sum of the ranks' gradients is the global gradient.  Averaging
  per-rank means, as ``DistributedDataParallel`` does, differs whenever
  the ranks hold different numbers of valid pixels (KITTI's sparse ground
  truth).
* **The draws**: every rank draws the global batch's timestep and noise
  from one generator and keeps its own rows (``train/loop.py``).
* **The samples**: every rank runs the single-process loader and keeps its
  contiguous rows of each global batch (``rows``), augmentation included.

After the backward the gradients are summed across the ranks in one
flattened all-reduce, then clipped by their global norm and applied by the
optimiser, identically on every rank.  Parameters are broadcast from rank
0 first, as ``DistributedDataParallel`` does.  The train forwards are
methods other than ``forward``, which torch's ``DistributedDataParallel``
wrapper needs every step to go through, so its two collectives are written
out here.  At world size 1 every collective still runs.

Processes come from ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``; ``from_env``) or from the caller
(``init``): NCCL on the card and gloo on the CPU by default; gloo on the
card when the caller asks for it (several ranks on one device).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from diffuvolume_tpu_torch.parallel.mesh import Mesh, make_mesh
from diffuvolume_tpu_torch.utils.device import resolve_device


def init(rank: int, world_size: int, device: str | torch.device | None = None,
         init_method: str = "env://", backend: str | None = None,
         n_volume: int = 1) -> Mesh:
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://localhost:PORT``, or ``env://`` for
    ``MASTER_ADDR`` / ``MASTER_PORT``) and return this rank's place in the
    ``(world_size / n_volume, n_volume)`` grid (``parallel/mesh.py``).
    ``backend`` defaults to NCCL for a CUDA ``device`` (default ``cuda:0``)
    and gloo for the CPU; gloo on a card runs several ranks on one device,
    which NCCL refuses."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size % n_volume:
        raise ValueError(f"a volume axis of {n_volume} does not divide a world of "
                         f"{world_size} ranks")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            device_id=dev if backend == "nccl" else None)
    return make_mesh(world_size // n_volume, n_volume, dev)


def free_port() -> int:
    """A TCP port on localhost that is free now (a group's address for
    ``init``)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def from_env(device: str | torch.device | None = None, n_volume: int = 1) -> Mesh | None:
    """The group ``torchrun`` describes in the environment as a grid of
    ``n_volume`` ranks a band, or None when the process was not started by
    it (no ``WORLD_SIZE``).  The device defaults to ``cuda:LOCAL_RANK``;
    pass ``"cpu"`` for gloo on the CPU."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return init(rank, world, device, n_volume=n_volume)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def sync_batch_norm(model: torch.nn.Module, dp: Mesh) -> torch.nn.Module:
    """Every ``models/layers.py`` BatchNorm of ``model`` normalises with the
    statistics of the global batch in training (``reduce_stats``).  A norm
    whose input is a band of rows under the volume split sums over the
    world; one whose input is whole on every rank of a volume group sums
    over the data group (the world when ``n_volume`` is 1; see
    ``parallel/mesh.py``).  On the three models' split paths the bands are
    the 3-D ones, every ``BatchNorm3d`` (the hourglasses, PCW's heads,
    IGEV's ``corr_stem`` and GEV tower), and every ``BatchNorm2d`` is whole
    (the trunks, ACV's ``concatconv``, PCW's refinement and
    ``dispupsample``, IGEV's feature attention convs, which run on the whole
    trunk feature, its context net and its frozen upsampling).  The
    state-dict names stay.  Returns ``model``."""
    from diffuvolume_tpu_torch.models.layers import BatchNorm3d, _FlaxRunningStats

    for m in model.modules():
        if isinstance(m, _FlaxRunningStats):
            m.reduce_stats = dp.sum if isinstance(m, BatchNorm3d) else dp.data_sum
    return model
