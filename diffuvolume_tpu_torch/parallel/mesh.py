"""The ``(data, volume)`` grid of processes.

Counterpart of ``diffuvolume_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``shard_batch``).  The JAX package lays its devices out
as a ``(data, volume)`` mesh: the global batch is split over ``data``, and
under ``parallel/volume_sharding.py`` the cost volume's rows over
``volume``.  Here the processes of a ``torch.distributed`` group take the
places of the devices: rank ``r`` sits at data index ``r // n_volume`` and
volume index ``r % n_volume``.  Its *data group* is the ranks at its volume
index (one a data index), its *volume group* the ranks at its data index
(one a band of rows), both made by ``dist.new_group``, in ascending rank
order.

Under the JAX mesh every reduction in the step is global, and so it is
here: ``sum`` takes a tensor's sum over the world, ``data_sum`` over the
data group.  What runs whole on every rank of a volume group (the 2-D
trunk, PCW's refinement, IGEV's context net) takes the data group's
BatchNorm sums (a world sum would count each image ``n_volume`` times in
the backward's share); the 3-D layers hold one band of rows a rank and
take the world's (``parallel/ddp.py:sync_batch_norm``).
A grid of ``n_volume = 1`` is data parallelism (``parallel/ddp.py``): its
data group is the world, and it makes no group of its own.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """One rank of a ``(data, volume)`` grid: ``rank`` of ``world_size``, its
    device, the grid's ``n_volume``, the group's backend, and its data and
    volume groups (None for ``n_volume = 1``: the world, and this rank
    alone)."""

    rank: int
    world_size: int
    device: torch.device
    n_volume: int = 1
    backend: str = "gloo"
    data_group: dist.ProcessGroup | None = None
    volume_group: dist.ProcessGroup | None = None

    @property
    def n_data(self) -> int:
        return self.world_size // self.n_volume

    @property
    def data_index(self) -> int:
        return self.rank // self.n_volume

    @property
    def volume_index(self) -> int:
        return self.rank % self.n_volume

    @property
    def volume_ranks(self) -> list[int]:
        """The global ranks of this rank's volume group, by volume index."""
        first = self.data_index * self.n_volume
        return list(range(first, first + self.n_volume))

    @property
    def host_staging(self) -> bool:
        """Whether rows exchanged between ranks go through host memory: gloo
        sends and receives CPU tensors only."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, x):
        """This rank's contiguous rows of a global-batch tensor or array (the
        leading axis split in ``n_data`` equal parts, by data index)."""
        b = x.shape[0]
        if b % self.n_data:
            raise ValueError(f"a batch of {b} does not split over {self.n_data} data ranks")
        n = b // self.n_data
        return x[self.data_index * n:(self.data_index + 1) * n]

    def shard(self, batch: dict) -> dict:
        """``rows`` of every array of a collated batch."""
        return {k: self.rows(v) for k, v in batch.items()}

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the world, outside autograd (the 3-D
        BatchNorms' batch sums, counts, losses, metrics)."""
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group, outside autograd (the 2-D
        BatchNorms' batch sums)."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.data_group)
        return out

    def broadcast_parameters(self, model: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, 0)

    def all_reduce_gradients(self, params) -> None:
        """Every parameter's gradient summed over the world, in one flattened
        all-reduce; a parameter no rank's loss reached gets zeros (optax
        updates every leaf)."""
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


def make_mesh(n_data: int, n_volume: int, device: torch.device) -> Mesh:
    """This process's place in a ``(n_data, n_volume)`` grid over the
    initialised process group, whose size must be ``n_data · n_volume``.
    Every rank makes every data and volume group, in one order, as
    ``dist.new_group`` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data < 1 or n_volume < 1 or n_data * n_volume != world:
        raise ValueError(f"a {n_data} × {n_volume} grid does not cover a world of {world} "
                         f"ranks")
    mesh = Mesh(rank, world, torch.device(device), n_volume, dist.get_backend())
    if n_volume == 1:
        return mesh
    for v in range(n_volume):
        group = dist.new_group([d * n_volume + v for d in range(n_data)])
        if v == mesh.volume_index:
            mesh.data_group = group
    for d in range(n_data):
        group = dist.new_group([d * n_volume + v for v in range(n_volume)])
        if d == mesh.data_index:
            mesh.volume_group = group
    return mesh
