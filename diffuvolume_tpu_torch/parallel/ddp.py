"""Data parallelism over processes: the JAX package's ``data`` mesh axis.

Counterpart of ``diffuvolume_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``shard_batch``) for the one semantics the JAX training
CLI uses it for: the global batch split over devices, parameters
replicated, one update from the whole batch's gradient.  Under the JAX mesh
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
(``init``): NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from diffuvolume_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DataParallel:
    """One rank of a data-parallel group: ``rank`` of ``world_size``, its
    device."""

    rank: int
    world_size: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, x):
        """This rank's contiguous rows of a global-batch tensor or array
        (the leading axis split in ``world_size`` equal parts)."""
        b = x.shape[0]
        if b % self.world_size:
            raise ValueError(f"a batch of {b} does not split over {self.world_size} ranks")
        n = b // self.world_size
        return x[self.rank * n:(self.rank + 1) * n]

    def shard(self, batch: dict) -> dict:
        """``rows`` of every array of a collated batch."""
        return {k: self.rows(v) for k, v in batch.items()}

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, outside autograd (BatchNorm's
        batch sums, counts, metrics)."""
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    def broadcast_parameters(self, model: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, 0)

    def all_reduce_gradients(self, params) -> None:
        """Every parameter's gradient summed over the ranks, in one
        flattened all-reduce; a parameter no rank's loss reached gets zeros
        (optax updates every leaf)."""
        params = list(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

    def barrier(self) -> None:
        dist.barrier()


def init(rank: int, world_size: int, device: str | torch.device | None = None,
         init_method: str = "env://") -> DataParallel:
    """Join the process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://localhost:PORT``, or ``env://`` for
    ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL for a CUDA ``device`` (default
    ``cuda:0``), gloo for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world_size,
                            device_id=dev if dev.type == "cuda" else None)
    return DataParallel(rank, world_size, dev)


def free_port() -> int:
    """A TCP port on localhost that is free now (a group's address for
    ``init``)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def from_env(device: str | torch.device | None = None) -> DataParallel | None:
    """The group ``torchrun`` describes in the environment, or None when the
    process was not started by it (no ``WORLD_SIZE``).  The device defaults
    to ``cuda:LOCAL_RANK``; pass ``"cpu"`` for gloo on the CPU."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return init(rank, world, device)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def sync_batch_norm(model: torch.nn.Module, dp: DataParallel) -> torch.nn.Module:
    """Every ``models/layers.py`` BatchNorm of ``model`` normalises with the
    statistics of the global batch in training (``reduce_stats``); the
    state-dict names stay.  Returns ``model``."""
    from diffuvolume_tpu_torch.models.layers import _FlaxRunningStats

    for m in model.modules():
        if isinstance(m, _FlaxRunningStats):
            m.reduce_stats = dp.sum
    return model
