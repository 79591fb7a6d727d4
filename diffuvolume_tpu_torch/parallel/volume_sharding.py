"""The cost volume's rows split over the ``volume`` axis of the grid.

Counterpart of ``diffuvolume_tpu/parallel/volume_sharding.py``.  There a
context-local ``PartitionSpec`` (``P("data", None, "volume")`` on the
``(B, D, H4, W4, C)`` volume: its quarter-resolution rows) makes the volume
builders constrain their outputs, and GSPMD propagates the split through
the 3-D aggregation, inserting the halo exchanges for the convs and making
every reduction global.  PyTorch has no GSPMD, so the port writes the split
out by hand, with the same semantics: under ``volume_sharding(mesh)`` each
rank of a volume group (``parallel/mesh.py``) holds one band of rows,
``[i·n, (i+1)·n)`` for volume index ``i``, of every tensor on the split
path, and an op that reads across rows first takes a halo of its
neighbours' rows:

* ``constrain_volume(x)``: this rank's band of a whole tensor (the volume
  builders slice their features with it: a volume row depends only on
  the same feature row);
* ``halo(x, top, bottom, edge)``: the band with ``top`` rows of the rank
  above and ``bottom`` of the rank below, zeros or copies of the edge row
  at the global edges; its backward sends the halo's gradient back to
  its owner, which adds it into its edge rows;
* ``gather_rows(x)``: every band of the volume group on every rank; its
  backward keeps this rank's rows of the gradient summed over the group.

The rows are the second axis from the end in every layout the split path
holds (NCDHW volumes, ``(B, D, H, W)`` costs, ``(B, C, H, W)`` features,
``(B, H, W)`` maps).  Over gloo the exchanged rows go through host memory
(its sends and receives take CPU tensors); over NCCL they stay on the
card.  Which layer takes which halo is ``models/layers.py``'s and
``ops/regression.py``'s business.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from diffuvolume_tpu_torch.parallel.mesh import Mesh

ROWS = -2  # the rows' axis in every layout of the split path

_STATE = threading.local()


def current_volume_spec() -> Mesh | None:
    """The grid whose volume axis splits the cost volume, inside
    ``volume_sharding``; None outside it."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def volume_sharding(mesh: Mesh | None):
    """Split the cost volume's rows over ``mesh``'s volume groups while the
    context is open; a grid without a volume axis (``n_volume`` 1), or
    None, splits nothing."""
    prev = current_volume_spec()
    _STATE.mesh = mesh if mesh is not None and mesh.n_volume > 1 else None
    try:
        yield
    finally:
        _STATE.mesh = prev


def band(rows: int, multiple: int = 1) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's band of ``rows`` global rows.
    The band must be a whole multiple of ``multiple`` rows (ACV's: 4 at
    H/4, for its two stride-2 levels); a shape that breaks the rule
    raises."""
    mesh = current_volume_spec()
    v = mesh.n_volume
    if rows % v or (rows // v) % multiple:
        raise ValueError(f"{rows} rows do not split over a volume axis of {v} in bands of a "
                         f"multiple of {multiple} rows (the band rule)")
    n = rows // v
    return mesh.volume_index * n, n


def constrain_volume(x: torch.Tensor) -> torch.Tensor:
    """This rank's band of the rows of ``x`` (contiguous) under
    ``volume_sharding``; ``x`` itself outside it."""
    if current_volume_spec() is None:
        return x
    first, n = band(x.shape[ROWS])
    return x.narrow(ROWS, first, n).contiguous()


def _exchange(mesh: Mesh, sends: list, recvs: list) -> list:
    """One batch of point-to-point transfers in the volume group: ``sends``
    ``(tensor, peer)``, ``recvs`` ``(shape, like, peer)``; returns the
    received tensors on ``like``'s device and dtype.  Peers are global
    ranks."""
    stage = mesh.host_staging
    ops, bufs = [], []
    for t, peer in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, peer, mesh.volume_group))
    for shape, like, peer in recvs:
        buf = torch.empty(shape, dtype=like.dtype, device="cpu" if stage else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.volume_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b, (_, like, _) in zip(bufs, recvs)]


def _neighbours(mesh: Mesh) -> tuple[int | None, int | None]:
    """The global ranks of the bands above and below (None at an edge)."""
    i, ranks = mesh.volume_index, mesh.volume_ranks
    return (ranks[i - 1] if i > 0 else None,
            ranks[i + 1] if i < mesh.n_volume - 1 else None)


def _rows_shape(x: torch.Tensor, k: int) -> list:
    shape = list(x.shape)
    shape[ROWS] = k
    return shape


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, edge, mesh):
        n = x.shape[ROWS]
        if max(top, bottom) > n:
            raise ValueError(f"a halo of {top} / {bottom} rows is deeper than a band of {n}")
        up, down = _neighbours(mesh)
        sends, recvs = [], []
        if up is not None and bottom:  # the band above reads my first rows
            sends.append((x.narrow(ROWS, 0, bottom), up))
        if down is not None and top:  # the band below reads my last rows
            sends.append((x.narrow(ROWS, n - top, top), down))
        if up is not None and top:
            recvs.append((_rows_shape(x, top), x, up))
        if down is not None and bottom:
            recvs.append((_rows_shape(x, bottom), x, down))
        got = iter(_exchange(mesh, sends, recvs))

        def fill(k, row):
            if edge == "zero":
                return x.new_zeros(_rows_shape(x, k))
            return x.narrow(ROWS, row, 1).expand(_rows_shape(x, k))

        parts = []
        if top:
            parts.append(next(got) if up is not None else fill(top, 0))
        parts.append(x)
        if bottom:
            parts.append(next(got) if down is not None else fill(bottom, n - 1))
        ctx.meta = (n, top, bottom, edge, mesh)
        return torch.cat(parts, ROWS)

    @staticmethod
    def backward(ctx, g):
        n, top, bottom, edge, mesh = ctx.meta
        up, down = _neighbours(mesh)
        g_top, g_bottom = g.narrow(ROWS, 0, top), g.narrow(ROWS, top + n, bottom)
        core = g.narrow(ROWS, top, n).clone()
        sends, recvs = [], []
        if up is not None and top:  # my top halo's gradient belongs to the band above
            sends.append((g_top, up))
        if down is not None and bottom:
            sends.append((g_bottom, down))
        if down is not None and top:  # the band below's top halo is my last rows
            recvs.append((_rows_shape(g, top), g, down))
        if up is not None and bottom:
            recvs.append((_rows_shape(g, bottom), g, up))
        got = iter(_exchange(mesh, sends, recvs))
        if down is not None and top:
            core.narrow(ROWS, n - top, top).add_(next(got))
        if up is not None and bottom:
            core.narrow(ROWS, 0, bottom).add_(next(got))
        if edge == "replicate":
            if up is None and top:
                core.narrow(ROWS, 0, 1).add_(g_top.sum(ROWS, keepdim=True))
            if down is None and bottom:
                core.narrow(ROWS, n - 1, 1).add_(g_bottom.sum(ROWS, keepdim=True))
        return core, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, edge: str = "zero") -> torch.Tensor:
    """This rank's band ``x`` with ``top`` rows of the band above before it
    and ``bottom`` rows of the band below after it, under
    ``volume_sharding``: ``top + n + bottom`` rows, the global rows ``[h0 −
    top, h1 + bottom)``.  Past the global edges the rows are zeros
    (``edge="zero"``, a conv's zero padding) or copies of the edge row
    (``"replicate"``, a resize's clamped coordinates).  Differentiable: the
    halo's gradient is added into its owner's rows."""
    if edge not in ("zero", "replicate"):
        raise ValueError(f"edge must be 'zero' or 'replicate', got {edge!r}")
    return _Halo.apply(x, top, bottom, edge, current_volume_spec())


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        n = x.shape[ROWS]
        full = x.new_zeros(_rows_shape(x, n * mesh.n_volume))
        full.narrow(ROWS, mesh.volume_index * n, n).copy_(x)
        # A sum of one band and zeros: each row exactly its owner's.
        dist.all_reduce(full, group=mesh.volume_group)
        ctx.meta = (n, mesh)
        return full

    @staticmethod
    def backward(ctx, g):
        n, mesh = ctx.meta
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.volume_group)
        return g.narrow(ROWS, mesh.volume_index * n, n).contiguous(), None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every band of the volume group, in order, on every rank of it.
    Differentiable: the gradient of this rank's band is its rows of the
    gradient summed over the group."""
    return _GatherRows.apply(x, current_volume_spec())
