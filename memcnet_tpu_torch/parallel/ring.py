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

    def stacked(self, axis):
        """(t, inner) of an axis stacked in this process's batch -- the tile
        k places before tile b is b - k inner, up to the frame's edge
        (``project_kernel.stacked_neighbour``) -- or None across ranks."""
        if self.mesh.is_across(axis):
            return None
        _, t, inner = self._factors(axis)
        return t, inner

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


# -- halo gathers of partitioned frames (parallel/partition.py) ----------------------


def stacked_take(x, dim, outer, t, index, width):
    """Tiles stacked into the batch (``outer`` groups of t tiles, tile index
    outside the samples) -> each tile's ``width`` positions along ``dim``
    named by ``index`` (t * width,) over the flattened (t * P + 1)
    positions of the tiles' axis, the last a zero.  One index gather;
    autograd's backward scatters the cotangents back to their tiles."""
    dim = dim % x.dim()
    n, P = x.shape[0], x.shape[dim]
    lead, trail = x.shape[1:dim], x.shape[dim + 1:]
    S = math.prod(trail)
    y = x.reshape(outer, t, -1, P, S).transpose(1, 2)
    R = y.shape[1]
    y = y.reshape(outer, R, t * P, S)
    y = torch.cat([y, y.new_zeros(outer, R, 1, S)], dim=2)
    y = y.index_select(2, index).reshape(outer, R, t, width, S).transpose(1, 2)
    return y.reshape((n,) + tuple(lead) + (width,) + tuple(trail))


def ranks_plan(cols, bounds, c, device):
    """What rank c of a tile line sends and receives for the halo gather of
    ``cols`` (each tile's global positions, -1 for a zero) over tiles that
    own ``bounds``: (to_prev, to_next) local indices of its own positions
    that its neighbours read, the counts it receives from them, and the
    index of its positions in cat(from_prev, own, from_next, zero)."""
    t = len(bounds)
    a, b = bounds[c]

    def owned_by(j, gs):
        if not 0 <= j < t:
            return []
        lo, hi = bounds[j]
        return sorted({g for g in gs if lo <= g < hi})

    from_prev, from_next = owned_by(c - 1, cols[c]), owned_by(c + 1, cols[c])
    to_prev = [g - a for g in owned_by(c, cols[c - 1])] if c > 0 else []
    to_next = [g - a for g in owned_by(c, cols[c + 1])] if c < t - 1 else []
    n_p, n_n, own = len(from_prev), len(from_next), b - a
    pos = {g: i for i, g in enumerate(from_prev)}
    pos.update({g: n_p + g - a for g in range(a, b)})
    pos.update({g: n_p + own + i for i, g in enumerate(from_next)})
    index = [pos[g] if g >= 0 else n_p + own + n_n for g in cols[c]]

    def as_tensor(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return as_tensor(to_prev), as_tensor(to_next), n_p, n_n, as_tensor(index)


def _swap(sends, recvs, group):
    """Post every (peer, tensor) send and (peer, buffer) receive of one
    exchange, skipping empty ones (both sides agree on the sizes)."""
    ops = [dist.P2POp(dist.isend, x.contiguous(), peer, group)
           for peer, x in sends if x.numel()]
    ops += [dist.P2POp(dist.irecv, buf, peer, group) for peer, buf in recvs if buf.numel()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _like(x, dim, n):
    shape = list(x.shape)
    shape[dim] = n
    return x.new_empty(shape)


class _Bands(torch.autograd.Function):
    """Send bands to the previous and next rank of a line, receive theirs;
    the backward sends the cotangents back (no wraparound)."""

    @staticmethod
    def forward(ctx, to_prev, to_next, link):
        prev, nxt, group, n_p, n_n, dim = link
        ctx.link = link
        ctx.sizes = (to_prev.shape[dim], to_next.shape[dim])
        from_prev, from_next = _like(to_prev, dim, n_p), _like(to_next, dim, n_n)
        sends = [(prev, to_prev)] if prev is not None else []
        sends += [(nxt, to_next)] if nxt is not None else []
        recvs = [(prev, from_prev)] if prev is not None else []
        recvs += [(nxt, from_next)] if nxt is not None else []
        _swap(sends, recvs, group)
        return from_prev, from_next

    @staticmethod
    def backward(ctx, g_prev, g_next):
        prev, nxt, group, _, _, dim = ctx.link
        to_prev, to_next = _like(g_prev, dim, ctx.sizes[0]), _like(g_next, dim, ctx.sizes[1])
        sends = [(prev, g_prev)] if prev is not None else []
        sends += [(nxt, g_next)] if nxt is not None else []
        recvs = [(prev, to_prev)] if prev is not None else []
        recvs += [(nxt, to_next)] if nxt is not None else []
        _swap(sends, recvs, group)
        return to_prev, to_next, None


def ranks_take(x, dim, plan, ranks, coord, group):
    """This rank's halo gather along ``dim`` (``ranks_plan``): its bands
    to and from the neighbouring ranks of the line ``ranks``, then one index
    gather over cat(from_prev, own, from_next, zero)."""
    to_prev, to_next, n_p, n_n, index = plan
    dim = dim % x.dim()
    t = len(ranks)
    link = (ranks[coord - 1] if coord > 0 else None, ranks[coord + 1] if coord < t - 1 else None,
            group, n_p, n_n, dim)
    from_prev, from_next = _Bands.apply(x.index_select(dim, to_prev),
                                        x.index_select(dim, to_next), link)
    ext = torch.cat([from_prev, x, from_next, _like(x, dim, 1).zero_()], dim=dim)
    return ext.index_select(dim, index)


class _GatherUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes, coord, group):
        ctx.dim, ctx.start, ctx.n, ctx.group = dim, sum(sizes[:coord]), sizes[coord], group
        pad = max(sizes) - x.shape[dim]
        if pad:
            x = torch.cat([x, _like(x, dim, pad).zero_()], dim=dim)
        parts = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None, None, None


def gather_uneven(x, dim, sizes, coord, group):
    """The parts of a line of ranks, ``sizes[i]`` along ``dim`` on rank i,
    concatenated on every rank; the backward keeps this rank's part."""
    return _GatherUneven.apply(x, dim % x.dim(), list(sizes), coord, group)


class _GatherSummed(_GatherUneven):
    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None, None, None


def gather_summed(x, dim, sizes, coord, group):
    """``gather_uneven`` for a whole that each rank uses in its own way (a
    whole level that a tile's data-dependent gather reads): the backward
    sums the cotangents over the line's ranks and keeps this rank's part."""
    return _GatherSummed.apply(x, dim % x.dim(), list(sizes), coord, group)


def reduce_scatter_uneven(x, dim, sizes, coord, group):
    """The sum of ``x`` over the ranks of a line, of which rank i keeps the
    ``sizes[i]`` positions along ``dim`` after those of the ranks before
    it; not differentiable (``Partition.reduce`` gives the backward)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.narrow(dim % x.dim(), sum(sizes[:coord]), sizes[coord]).contiguous()
