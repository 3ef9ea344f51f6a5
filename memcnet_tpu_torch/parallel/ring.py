"""The ring exchange of the tiled ops, and the differentiable collectives
of the parallel layer.

The JAX per-tile code (memcnet_tpu/parallel/tiling.py) uses three things
inside ``shard_map``: ``axis_index``, ``axis_size`` and ``ppermute`` ring
shifts.  ``TileRing`` offers the same three for the tile axes of one op
call, with two implementations per axis, as the mesh places it:

  * *in this process*: the tiles of the axis are stacked into the batch
    dimension, tile index outermost, so a (B, C, H, W) frame over t tiles
    of W becomes (t * B, C, H, W / t); ``index`` is a per-sample tensor of
    tile indices and a shift is a ``torch.roll`` over the tile index.  One
    kernel launch serves every tile.
  * *across ranks*: one tile per rank of the axis's line of ranks; a shift
    is ``dist.batch_isend_irecv`` to the ring neighbours inside an
    ``autograd.Function`` whose backward shifts the cotangent the other way
    (``ppermute``'s transpose), since the sharded train step
    differentiates through the exchange.

``split`` and ``merge`` turn whole frames into tiles and back.  Across
ranks every rank of a tile line holds the whole frame (the convolutions of
a tiled model run on the whole frame on each rank): ``split`` keeps this
rank's tile and its backward all-gathers the tiles' cotangents, ``merge``
all-gathers the tiles and its backward keeps this rank's part, so the ranks
of a line end the backward with the same whole-frame gradients.
"""

import math

import torch
import torch.distributed as dist


def _p2p_shift(x, k, ranks, pos, group):
    """The value of the rank k places before this one along ``ranks``."""
    t = len(ranks)
    if k % t == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(pos + k) % t], group),
           dist.P2POp(dist.irecv, out, ranks[(pos - k) % t], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, line):
        ctx.k, ctx.line = k, line
        return _p2p_shift(x, k, *line)

    @staticmethod
    def backward(ctx, g):
        return _p2p_shift(g, -ctx.k, *ctx.line), None, None


def _gather(x, dim, group, t):
    parts = [torch.empty_like(x) for _ in range(t)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pos, t, group):
        ctx.dim, ctx.t, ctx.group = dim, t, group
        n = x.shape[dim] // t
        return x.narrow(dim, pos * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group, ctx.t), None, None, None, None


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, pos, t, group):
        ctx.dim, ctx.pos, ctx.n = dim, pos, x.shape[dim]
        return _gather(x, dim, group, t)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.pos * ctx.n, ctx.n).contiguous(), None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks of ``group``, differentiable: each
    rank's result feeds its own loss, so the backward sums the cotangents
    over the ranks too."""
    return _AllReduceSum.apply(x, group)


class TileRing:
    """``axis_size``, ``axis_index`` and ring shifts over the tile axes of
    one op call, and the split of whole frames into tiles and back.

    Args:
      mesh: a ``parallel.mesh.Mesh``.
      axes: (axis name, tensor dim) pairs in the order the frame is split,
        e.g. (("tile", -1), ("tile_h", -2)).
      batch: the batch of the whole frames (samples per rank).
    """

    def __init__(self, mesh, axes, batch):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.batch = batch
        # axes in this process, outermost batch factor first (each split
        # stacks its tiles outside the ones before it)
        self._stacked = [a for a, _ in reversed(self.axes) if not mesh.is_across(a)]
        self.n = batch * math.prod(mesh.shape[a] for a in self._stacked)

    def size(self, axis):
        return self.mesh.shape[axis]

    def _factors(self, axis):
        """(tiles outside ``axis``, its tiles, samples inside it) of the
        stacked batch."""
        i = self._stacked.index(axis)
        outer = math.prod(self.mesh.shape[a] for a in self._stacked[:i])
        t = self.mesh.shape[axis]
        return outer, t, self.n // (outer * t)

    def index(self, axis, device):
        """Each sample's tile index along ``axis``, (n,) int64."""
        if self.mesh.is_across(axis):
            return torch.full((self.n,), self.mesh.coords[axis], dtype=torch.int64,
                              device=device)
        _, t, inner = self._factors(axis)
        return torch.arange(self.n, device=device) // inner % t

    def shift(self, x, axis, k):
        """Ring-shift per-tile values by k tiles along ``axis``: each tile
        gets the value of the tile k places before it (``ppermute`` with
        pairs (i, i + k))."""
        if self.mesh.is_across(axis):
            line = (self.mesh.axis_ranks(axis), self.mesh.coords[axis], self.mesh.axis_group(axis))
            return _Shift.apply(x, k, line)
        outer, t, inner = self._factors(axis)
        return x.reshape(outer, t, inner, *x.shape[1:]).roll(k, 1).reshape(x.shape)

    def split(self, x):
        """Whole frames (batch, C, H, W) -> this process's tiles (n, C,
        H / t_h, W / t)."""
        for axis, dim in self.axes:
            t = self.mesh.shape[axis]
            if self.mesh.is_across(axis):
                x = _Split.apply(x, dim, self.mesh.coords[axis], t,
                                 self.mesh.axis_group(axis))
            else:
                x = torch.cat(x.chunk(t, dim=dim), dim=0)
        return x

    def merge(self, x):
        """The inverse of ``split``: every rank of a tile line gets the
        whole frames."""
        for axis, dim in reversed(self.axes):
            t = self.mesh.shape[axis]
            if self.mesh.is_across(axis):
                x = _Merge.apply(x, dim, self.mesh.coords[axis], t,
                                 self.mesh.axis_group(axis))
            else:
                x = torch.cat(x.chunk(t, dim=0), dim=dim)
        return x
