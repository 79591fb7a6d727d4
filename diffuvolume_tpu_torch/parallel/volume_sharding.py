"""The cost volume's rows split over the ``volume`` axis of the grid.

Counterpart of ``diffuvolume_tpu/parallel/volume_sharding.py``.  There a
context-local ``PartitionSpec`` (``P("data", None, "volume")`` on the
``(B, D, H4, W4, C)`` volume: its quarter-resolution rows) makes the volume
builders constrain their outputs, and GSPMD propagates the split through
the 3-D aggregation, inserting the halo exchanges for the convs and making
every reduction global.  PyTorch has no GSPMD, so the port writes the split
out by hand, with the same semantics: under ``volume_sharding(mesh)`` each
rank of a volume group (``parallel/mesh.py``) holds one band of rows of
every tensor on the split path, and an op that reads across rows first
takes a halo of its neighbours' rows.

The bands are cut once a forward, at the quarter-resolution (H/4) rows,
by ``cut_rows(rows, multiple)`` (the model calls it with its
``BAND_MULTIPLE``: the stride-2 levels below H/4 need every band edge on a
multiple of ``2^levels`` rows): edges at multiples of ``multiple``, the
bands' sizes at most one ``multiple`` apart, the first ranks taking the
larger ones (``band``; 80 rows in multiples of 8 over 4 ranks: 24, 24, 16,
16), so every shape the unsplit model takes splits while ``V`` is at most
``rows / multiple``.  Every other level's band is that cut scaled: the
H/4 band ``[h0, h1)`` is ``[h0/2^k, h1/2^k)`` at H/4/2^k (``level_band``)
and ``[4·h0, 4·h1)`` at full resolution, never a cut of the level's own
row count.  A tensor's level is read from its rows: a whole tensor's
against the H/4 rows, a band's against this rank's H/4 band.

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
from fractions import Fraction

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
    prev = current_volume_spec(), getattr(_STATE, "cut", None)
    _STATE.mesh = mesh if mesh is not None and mesh.n_volume > 1 else None
    _STATE.cut = None
    try:
        yield
    finally:
        _STATE.mesh, _STATE.cut = prev


def edges(rows: int, multiple: int, n_volume: int) -> list[int]:
    """The ``n_volume + 1`` edges of the bands of ``rows`` rows: at multiples
    of ``multiple``, the bands' sizes at most one ``multiple`` apart, the
    first ones the larger (the last also takes ``rows % multiple``).  Raises
    when ``n_volume`` exceeds ``rows / multiple`` (the band rule)."""
    units = rows // multiple
    if n_volume > units:
        raise ValueError(f"{rows} rows do not split over a volume axis of {n_volume} in bands "
                         f"of a multiple of {multiple} rows (the band rule: at most "
                         f"{units} bands)")
    q, r = divmod(units, n_volume)
    out = [0]
    for i in range(n_volume):
        out.append(out[-1] + (q + (i < r)) * multiple)
    out[-1] = rows
    return out


def _own(e: list[int]) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's band between the edges ``e``."""
    i = current_volume_spec().volume_index
    return e[i], e[i + 1] - e[i]


def band(rows: int, multiple: int = 1) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's band of ``rows`` global rows
    under ``volume_sharding``, cut by ``edges``."""
    return _own(edges(rows, multiple, current_volume_spec().n_volume))


def cut_rows(rows: int, multiple: int) -> tuple[int, int]:
    """Cut the ``rows`` quarter-resolution rows into bands of multiples of
    ``multiple`` (``edges``) for the rest of this ``volume_sharding``
    block: every level's band is this cut scaled.  Returns this rank's
    ``band``."""
    _STATE.cut = edges(rows, multiple, current_volume_spec().n_volume)
    return _own(_STATE.cut)


def _scaled(scale: Fraction) -> list[int]:
    """The cut's edges at ``scale`` times the H/4 rows; raises where an edge
    falls between rows."""
    out = [e * scale for e in _STATE.cut]
    if any(x.denominator != 1 for x in out):
        raise ValueError(f"the bands' edges {_STATE.cut} at H/4 fall between rows at "
                         f"{scale} of that resolution (the band rule)")
    return [int(x) for x in out]


def _edges_of_whole(rows: int) -> list[int]:
    """The edges of a whole tensor of ``rows`` rows: the cut scaled from the
    H/4 rows (a cut of ``rows`` into single rows first, when none was
    made)."""
    if _STATE.cut is None:
        _STATE.cut = edges(rows, 1, current_volume_spec().n_volume)
    return _scaled(Fraction(rows, _STATE.cut[-1]))


def _edges_of_band(n: int) -> list[int]:
    """The edges of the level whose band on this rank holds ``n`` rows."""
    if _STATE.cut is None:
        raise ValueError("no band was cut in this volume_sharding block (cut_rows)")
    return _scaled(Fraction(n, _own(_STATE.cut)[1]))


def band_of(x: torch.Tensor) -> tuple[int, int, int]:
    """``(first row, rows, global rows)`` of this rank's band ``x`` at its
    level."""
    e = _edges_of_band(x.shape[ROWS])
    return *_own(e), e[-1]


def level_band(k: int) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's band at H/4/2^k: the H/4 band's
    ``[h0, h1)`` divided by ``2^k``."""
    return _own(_scaled(Fraction(1, 2 ** k)))


def constrain_volume(x: torch.Tensor) -> torch.Tensor:
    """This rank's band of the rows of ``x`` (contiguous) under
    ``volume_sharding``; ``x`` itself outside it."""
    if current_volume_spec() is None:
        return x
    return x.narrow(ROWS, *_own(_edges_of_whole(x.shape[ROWS]))).contiguous()


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
        e = _edges_of_band(n)
        least = min(b - a for a, b in zip(e, e[1:]))
        if max(top, bottom) > least:
            raise ValueError(f"a halo of {top} / {bottom} rows is deeper than the smallest "
                             f"band, {least} rows")
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
    def forward(ctx, x, first, rows, mesh):
        n = x.shape[ROWS]
        full = x.new_zeros(_rows_shape(x, rows))
        full.narrow(ROWS, first, n).copy_(x)
        # A sum of one band and zeros: each row exactly its owner's.
        dist.all_reduce(full, group=mesh.volume_group)
        ctx.meta = (first, n, mesh)
        return full

    @staticmethod
    def backward(ctx, g):
        first, n, mesh = ctx.meta
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.volume_group)
        return g.narrow(ROWS, first, n).contiguous(), None, None, None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every band of the volume group, in order, on every rank of it.
    Differentiable: the gradient of this rank's band is its rows of the
    gradient summed over the group."""
    first, _, rows = band_of(x)
    return _GatherRows.apply(x, first, rows, current_volume_spec())
