"""Spatially partitioned frames: every spatial layer on its tile, exchanging
only halos (the port's counterpart of frames placed with ``frame_sharding``
in the JAX package, whose convolutions GSPMD partitions).

``mesh.shard_frames(mesh, *frames)``, called under ``spatial_tiling(mesh)``,
splits whole frames into tiles over the context's W axis (and H axis, with
``axis_h``) and records a ``Partition`` of the frame's global H and W in the
context.  While it is recorded, ``nn.layers`` reads every 4-D input as a tile
of a partitioned frame, and the warp and the projection run their tile-local
steps (``parallel.tiling``) with no split and no merge.
``mesh.gather_frames`` is the inverse.

Geometry.  A level is the frame at 1/2^l of its size; its global size along
an axis is ``size >> l`` (while ``size`` halves evenly and there are at least
as many positions as tiles).  At a level of global size g over t tiles, tile
i owns the positions [ceil(i g / t), ceil((i + 1) g / t)): 720p padded to
1344 over 4 tiles gives 336 columns each at full resolution, 11, 10, 11, 10
at 1/32 (g = 42) and 6, 5, 5, 5 at 1/64 (g = 21).  Frames are not padded
further, so the partitioned forward is the untiled one.  A layer infers the
level of its input from the tile's width and height, and that mapping must
be one to one (``Axis``).

Where the tiles live (``parallel.mesh``):
  * in this process, the tiles are stacked into the batch, tile index
    outermost (H tiles outside W tiles, as ``TileRing`` stacks them), each
    padded to the widest tile of its level.  The padding is junk: no halo
    reads it, BatchNorm and the losses mask it, and ``gather_frames`` drops
    it.  One index gather over the stacked tiles brings every tile its
    halo (``ring.stacked_take``);
  * across ranks, each rank holds its tile at its true size, and a halo is
    a ``batch_isend_irecv`` of bands with the two neighbours whose backward
    sends the cotangents back (``ring.ranks_take``).

Each layer's halo follows from the output positions the tile owns: a
stride-2 k3 conv needs p or p + 1 columns, a k4 s2 p1 deconv 1-2, a 2x2
max- or average pool 0-1 (at an uneven level a pooled output can straddle
two tiles: at 720p the 84 columns of 1/16 start tiles at 21, 42 and 63), a
global align_corners upsample 0-1; beyond the global edge it is zeros.
Across ranks a halo must stay within one neighbour (checked when its plan
is made); stacked tiles read any tile.  Every gather runs in the profiler
range ``HALO_RANGE``.  Index maps are cached per (axis, level, layer
geometry, device).

Among the models' layers one op reads beyond any halo: SPyNet's warp samples
the second frame's level wherever its flow points.  ``gather`` brings that level whole to
every tile, as GSPMD gathers the operand of a data-dependent gather in the
JAX package: one index gather over stacked tiles, an all-gather whose
backward sums the cotangents across ranks.  It runs in its own profiler
range, ``GATHER_RANGE``, and counts itself in ``gathers``; no layer with a
halo form calls it.  ``level_input_window`` gives the same op the 0-1
column halo of the coarse flow that the global upsample reads, and each
tile's global origin (ops/cuda/gather_kernel.py::level_input_tile).

The op library (``ops``, through ``ops/frame.py``) reads and writes at
data-dependent cells anywhere in the frame, as GSPMD lets the JAX ops do on
``frame_sharding``-placed arrays.  Where it reads, ``gather`` brings the
level whole; where it writes, each tile scatters into a whole-frame buffer
of its sample on global coordinates and ``reduce`` -- the transpose of
``gather`` -- sums those buffers over every tile of the sample and gives
each tile its owned part: one index gather over stacked tiles (every
stacked tile of a sample scatters into the same buffer, so the sum is the
scatter's own), a reduce-scatter over the tile axes' groups across ranks.
It runs in ``REDUCE_RANGE`` and counts itself in ``reductions``; its
backward is ``gather``.  ``clamped_take`` is a halo whose positions beyond
the global edge repeat the edge (the patch window of ``occlusion_weight``,
``replication_pad2d``) or reach fs - 1 positions right and down
(``separable_conv``).  Some outputs of the op library are sized by the frame
but are no level of it -- ``separable_conv``'s valid extent, a padded
extent, a grid sample's grid: derived extents, tiled by the same ownership
rule, registered per axis (``add_extent``; a tile width that names both a
level and an extent raises) and looked up by ``extent``; the layers' level
lookup (``level``) ignores them.
"""

import math

import numpy as np
import torch
from torch.profiler import record_function

from memcnet_tpu_torch.ops.cuda._lib import LaunchCounter
from memcnet_tpu_torch.parallel import ring as R

HALO_RANGE = "partition.halo"  # the profiler range of every halo gather and crop
GATHER_RANGE = "partition.gather"  # the profiler range of the whole-level gathers
REDUCE_RANGE = "partition.reduce"  # the profiler range of the whole-level reductions
gathers = LaunchCounter("partition.gather")  # whole-level gathers (Partition.gather)
reductions = LaunchCounter("partition.reduce")  # whole-level reductions (Partition.reduce)


def owned(g, t):
    """[start, stop) of each of t tiles over g positions."""
    return [(-(-i * g // t), -(-(i + 1) * g // t)) for i in range(t)]


class Axis:
    """One tiled axis of a partitioned frame: its mesh axis, tensor dim and
    global size at full resolution, and the levels its tiles can hold."""

    def __init__(self, mesh, name, dim, size):
        self.name, self.dim, self.size = name, dim, size
        self.t = mesh.shape[name]
        self.across = mesh.is_across(name)
        self.coord = mesh.coords[name] if self.across else None
        if size % self.t:
            raise ValueError(f"a frame of {size} positions does not split into {self.t} tiles "
                             f"over {name!r} at full resolution")
        self.levels = {}   # local size -> the level's global size
        self.extents = {}  # local size -> a derived extent's global size
        g = size
        while g >= self.t:
            w = self.width(g)
            if w in self.levels:
                raise ValueError(f"tiles of {w} positions over {name!r} hold both the level of "
                                 f"{self.levels[w]} and of {g}: the level of a tile is ambiguous")
            self.levels[w] = g
            if g % 2:
                break
            g //= 2

    def bounds(self, g):
        return owned(g, self.t)

    def own(self, g, i):
        a, b = self.bounds(g)[i]
        return b - a

    def width(self, g):
        """The local size at the level of global size g: this rank's tile's,
        or the widest stacked tile's."""
        if self.across:
            return self.own(g, self.coord)
        return max(b - a for a, b in self.bounds(g))

    def level(self, width):
        """The global size of the level whose tiles are ``width`` wide."""
        if width not in self.levels:
            raise ValueError(f"a tile of {width} positions over {self.name!r} is no level of "
                             f"the partitioned frame (levels {self.levels})")
        return self.levels[width]

    def out_width(self, g, i):
        """The width tile i's output takes at the level of global size g."""
        return self.own(g, i) if self.across else self.width(g)

    def _key(self, g, i):
        """The local size tile i of an extent of g is looked up by."""
        return self.own(g, i) if self.across else self.width(g)

    def add_extent(self, g):
        """Register g positions, no level, as a derived extent of the frame
        (tiled by the ownership rule); raise where a tile of it would be as
        wide as a tile of a level or of another extent, on any rank."""
        known = list(self.levels.values()) + list(self.extents.values())
        if g in known:
            return
        if g < self.t:
            raise ValueError(f"an extent of {g} positions over {self.name!r} does not split "
                             f"into {self.t} tiles")
        for other in known:
            if any(self._key(g, i) == self._key(other, i) for i in range(self.t)):
                kind = "level" if other in self.levels.values() else "extent"
                raise ValueError(f"tiles over {self.name!r} hold both the {kind} of {other} and "
                                 f"the extent of {g} positions: the extent of a tile is "
                                 "ambiguous")
        self.extents[self.width(g)] = g

    def extent(self, width):
        """The global size of the level or derived extent whose tiles are
        ``width`` wide."""
        if width in self.levels:
            return self.levels[width]
        if width in self.extents:
            return self.extents[width]
        raise ValueError(f"a tile of {width} positions over {self.name!r} is no level of the "
                         f"partitioned frame, nor an extent (levels {self.levels}, extents "
                         f"{self.extents})")


class Partition:
    """The partition of one frame size over a mesh: its axes, the batch
    layout of its tiles and the halo plans of its layers.

    Args:
      mesh: a ``parallel.mesh.Mesh``.
      axis: the mesh axis tiling W; ``axis_h`` the one tiling H, or None.
      H, W: the frame's global size at full resolution.
    """

    def __init__(self, mesh, axis, axis_h, H, W):
        self.mesh = mesh
        self.frame = (H, W)
        self.w = Axis(mesh, axis, -1, W)
        self.h = Axis(mesh, axis_h, -2, H) if axis_h else None
        self.axes = [a for a in (self.w, self.h) if a is not None]
        # stacked axes, outermost first (TileRing's order)
        self._stacked = [a for a in (self.h, self.w) if a is not None and not a.across]
        self.stacked = math.prod(a.t for a in self._stacked)
        self.across = mesh.group is not None
        self._plans = {}

    # -- the batch layout ---------------------------------------------------------

    def samples(self, n):
        """Samples (of this rank) in a batch of n stacked tiles."""
        return n // self.stacked

    def _outer(self, ax):
        i = self._stacked.index(ax)
        return math.prod(a.t for a in self._stacked[:i])

    def tile_index(self, ax, n, device):
        """Each of n stacked samples' tile index along ``ax``, (n,) int64."""
        if ax.across:
            return torch.full((n,), ax.coord, dtype=torch.int64, device=device)
        outer = self._outer(ax)
        return torch.arange(n, device=device) // (n // (outer * ax.t)) % ax.t

    def ring(self, n):
        """The ``TileRing`` of a batch of n tiles (the tiled warp and
        projection's ring shifts)."""
        axes = ((self.w.name, -1),) + (((self.h.name, -2),) if self.h else ())
        return R.TileRing(self.mesh, axes, self.samples(n))

    def level(self, x):
        """(global H, global W) of the level of the tiles x; an untiled H is
        its own size."""
        gh = self.h.level(x.shape[-2]) if self.h else x.shape[-2]
        return gh, self.w.level(x.shape[-1])

    def tile_size(self, gh, gw):
        """The (h, w) of this process's tiles (or this rank's) at the level
        of global size (gh, gw)."""
        return (self.h.width(gh) if self.h else gh), self.w.width(gw)

    def extent(self, x, dims=(-2, -1)):
        """(global H, global W) of the level or derived extent of the tiles
        x, whose H and W are the dims ``dims``; an untiled H is its own size."""
        gh = self.h.extent(x.shape[dims[0]]) if self.h else x.shape[dims[0]]
        return gh, self.w.extent(x.shape[dims[1]])

    def add_extent(self, gh, gw):
        """Register the derived extent (gh, gw) of the frame on each tiled
        axis (``Axis.add_extent``); returns it."""
        if self.h:
            self.h.add_extent(gh)
        self.w.add_extent(gw)
        return gh, gw

    def origins(self, size, n, device):
        """(n, 4) int32: each of n stacked tiles' (or this rank's) global
        origin (y0, x0) and the positions it owns (h, w) in the level or
        extent ``size`` (gh, gw)."""
        gh, gw = size
        ck = ("origins", gh, gw, n, device)
        o = self._plans.get(ck)
        if o is None:
            cols = []
            for ax, g in ((self.h, gh), (self.w, gw)):
                if ax is None:
                    cols.append(torch.tensor([[0, g]], dtype=torch.int32).expand(n, 2))
                    continue
                rows = torch.tensor([[a, b - a] for a, b in ax.bounds(g)], dtype=torch.int32)
                cols.append(rows[self.tile_index(ax, n, torch.device("cpu"))])
            (y0, own_h), (x0, own_w) = (c.unbind(1) for c in cols)
            o = torch.stack([y0, x0, own_h, own_w], 1).contiguous().to(device)
            self._plans[ck] = o
        return o

    # -- halo gathers ------------------------------------------------------------

    def take(self, x, ax, g_in, g_out, key, cols_of):
        """The positions ``cols_of(i, E)`` (global, at the level g_in; -1 for
        a zero) along ``ax`` for each tile i, whose output at the level g_out
        is E wide.  Cached per (ax, g_in, g_out, key, device)."""
        ck = (ax.name, g_in, g_out, key, x.device)
        plan = self._plans.get(ck)
        if plan is None:
            cols = [cols_of(i, ax.out_width(g_out, i)) for i in range(ax.t)]
            plan = self._plan(ax, g_in, cols, x.device)
            self._plans[ck] = plan
        with record_function(HALO_RANGE):
            if ax.across:
                return R.ranks_take(x, ax.dim, plan, self.mesh.axis_ranks(ax.name), ax.coord,
                                    self.mesh.axis_group(ax.name))
            return R.stacked_take(x, ax.dim, self._outer(ax), ax.t, *plan)

    def _plan(self, ax, g_in, cols, device):
        bounds = ax.bounds(g_in)
        owner = np.repeat(np.arange(ax.t), [b - a for a, b in bounds])
        if ax.across:
            for i, c in enumerate(cols):
                if any(abs(owner[g] - i) > 1 for g in c if g >= 0):
                    raise ValueError(f"a halo over {ax.name!r} at the level of {g_in} reaches "
                                     "beyond the neighbouring ranks")
            return R.ranks_plan(cols, bounds, ax.coord, device)
        width = max(len(c) for c in cols)
        P = ax.width(g_in)
        flat = []
        for c in cols:
            c = list(c) + [-1] * (width - len(c))
            flat += [owner[g] * P + g - bounds[owner[g]][0] if g >= 0 else ax.t * P for g in c]
        return torch.tensor(flat, dtype=torch.int64, device=device), width

    def clamped_take(self, x, size_in, size_out, shift=(0, 0), lo=(0, 0), hi=(0, 0)):
        """The tiles x of the extent ``size_in`` (gh, gw) -> along each tiled
        axis, tile i's input positions clamp(j - shift) for j from c0 - lo to
        c1 + hi, [c0, c1) its owned outputs in the extent ``size_out``: the
        global edge repeats beyond the frame (an edge-replicating halo);
        positions past c1 + hi, the padding of a stacked tile, read zeros.
        An untiled axis is left as it is."""
        for ax, g_in, g_out, sh, a, b in zip((self.h, self.w), size_in, size_out, shift, lo, hi):
            if ax is None:
                continue

            def cols(i, E, ax=ax, g_in=g_in, g_out=g_out, sh=sh, a=a, b=b):
                c0, c1 = ax.bounds(g_out)[i]
                return [min(max(j - sh, 0), g_in - 1) if j < c1 + b else -1
                        for j in range(c0 - a, c0 + E + b)]

            x = self.take(x, ax, g_in, g_out, ("clamped", sh, a, b), cols)
        return x

    def window(self, x, ax, g_in, k, s, p):
        """x extended along ``ax`` for a (k, stride s, zero padding p) window
        op run with no padding on that axis: tile i gets the input positions
        its owned outputs read, zeros beyond the global edge."""
        g_out = (g_in + 2 * p - k) // s + 1

        def cols(i, E):
            c0, c1 = ax.bounds(g_out)[i]
            lo, hi = c0 * s - p, (c1 - 1) * s - p + k
            return [g if lo <= g < hi and 0 <= g < g_in else -1
                    for g in range(lo, lo + (E - 1) * s + k)]

        return self.take(x, ax, g_in, g_out, ("window", k, s, p), cols)

    def crop(self, x, ax, g_out, key, offsets):
        """Tile i's ``ax.out_width`` positions from ``offsets[i]`` of its own
        (a per-tile narrow; one index gather where the stacked tiles' offsets
        differ)."""
        if ax.across:
            return x.narrow(ax.dim, offsets[ax.coord], ax.out_width(g_out, ax.coord))
        E = ax.width(g_out)
        if len(set(offsets)) == 1:
            return x.narrow(ax.dim, offsets[0], E)
        ck = (ax.name, g_out, ("crop",) + key, x.device)
        plan = self._plans.get(ck)
        if plan is None:
            P = x.shape[ax.dim]
            flat = [i * P + o + e for i, o in enumerate(offsets) for e in range(E)]
            plan = (torch.tensor(flat, dtype=torch.int64, device=x.device), E)
            self._plans[ck] = plan
        with record_function(HALO_RANGE):
            return R.stacked_take(x, ax.dim, self._outer(ax), ax.t, *plan)

    # -- the layers' partitioned forms -----------------------------------------------

    def _tiled(self, dim):
        return self.w if dim == -1 else self.h

    def conv_input(self, x, kernel, stride, padding):
        """(x extended on the tiled axes, the padding left for the untiled
        axis) for a conv or pool of ``kernel`` (kh, kw), ``stride`` and
        zero ``padding`` (ph, pw)."""
        gh, gw = self.level(x)
        pads = []
        for dim, g, k, s, p in ((-2, gh, kernel[0], stride[0], padding[0]),
                                (-1, gw, kernel[1], stride[1], padding[1])):
            ax = self._tiled(dim)
            if ax is None:
                pads.append(p)
                continue
            x = self.window(x, ax, g, k, s, p)
            pads.append(0)
        return x, tuple(pads)

    def deconv_input(self, x, k, s, p):
        """(x extended on the tiled axes, the padding left for the untiled
        axis, a function that crops the transposed conv's output): tile i
        reads the inputs m from floor((c0 + p - k + 1) / s) on, so its
        owned outputs start at a per-tile offset of k - 1 .. k + s - 2."""
        gh, gw = self.level(x)
        pads, crops = [], []
        for dim, g in ((-2, gh), (-1, gw)):
            ax = self._tiled(dim)
            if ax is None:
                pads.append(p)
                continue
            g_out = (g - 1) * s - 2 * p + k
            starts = [c0 for c0, _ in ax.bounds(g_out)]
            m_lo = [(c0 + p - k + 1) // s for c0 in starts]
            offsets = [c0 + p - s * m for c0, m in zip(starts, m_lo)]

            def cols(i, E, ax=ax, g=g, g_out=g_out, m_lo=m_lo, offsets=offsets):
                c0, c1 = ax.bounds(g_out)[i]
                # the inputs the owned outputs read, in a window of the inputs up
                # to the last output's
                first = max(-(-(c0 + p - k + 1) // s), 0)
                last = min((c1 - 1 + p) // s, g - 1)
                M = (offsets[i] + E - 1) // s + 1
                return [m if first <= m <= last else -1 for m in range(m_lo[i], m_lo[i] + M)]

            x = self.take(x, ax, g, g_out, ("deconv", k, s, p), cols)
            crops.append((ax, g_out, offsets))
            pads.append(0)

        def crop(y):
            for ax, g_out, offsets in crops:
                y = self.crop(y, ax, g_out, ("deconv", k, s, p), offsets)
            return y

        return x, tuple(pads), crop

    def upsample(self, x, scale):
        """Bilinear x ``scale``, align_corners=True on the frame's global
        coordinates: output position j reads j (g_in - 1) / (g_out - 1) of
        the global input, as F.interpolate computes it in float32 or wider (the
        W lerp first, then H), whatever the tile; the result in x's type."""
        gh, gw = self.level(x)
        y = x.to(torch.promote_types(x.dtype, torch.float32))
        for dim, g in ((-1, gw), (-2, gh)):
            y = self._lerp(y, dim, g, g * scale)
        return y.to(x.dtype)

    def _lerp(self, y, dim, g_in, g_out):
        ax = self._tiled(dim)
        n = y.shape[0]
        scale = np.float32(g_in - 1) / np.float32(g_out - 1)

        def taps(j):
            src = np.float32(j) * scale
            i0 = int(src)
            return i0, min(i0 + 1, g_in - 1), float(np.float32(src - np.float32(i0)))

        if ax is None:  # an untiled axis: the local gathers
            ck = ("lerp", dim, g_in, g_out, y.device)
            if ck not in self._plans:
                i0, i1, lam = zip(*(taps(j) for j in range(g_out)))
                shape = [1] * y.dim()
                shape[dim] = g_out
                self._plans[ck] = (torch.tensor(i0 + i1, dtype=torch.int64, device=y.device),
                                   torch.tensor(lam, device=y.device).view(shape))
            idx, lam = self._plans[ck]
            both = y.index_select(dim % y.dim(), idx)
            lam = lam.to(y.dtype)
        else:
            def cols(i, E):
                c0, c1 = ax.bounds(g_out)[i]
                t = [taps(j) if j < c1 else (-1, -1, 0.0) for j in range(c0, c0 + E)]
                return [a for a, _, _ in t] + [b for _, b, _ in t]

            both = self.take(y, ax, g_in, g_out, ("lerp",), cols)
            lam = self._lerp_weights(ax, g_in, g_out, taps, n, y.device).to(y.dtype)
        a, b = both.chunk(2, dim=dim)
        return a * (1.0 - lam) + b * lam

    def _lerp_weights(self, ax, g_in, g_out, taps, n, device):
        ck = (ax.name, g_in, g_out, ("lerp weights", n), device)
        lam = self._plans.get(ck)
        if lam is None:
            rows = []
            for i in range(ax.t):
                c0, c1 = ax.bounds(g_out)[i]
                E = ax.out_width(g_out, i)
                rows.append([taps(j)[2] if j < c1 else 0.0 for j in range(c0, c0 + E)])
            if ax.across:
                lam = torch.tensor(rows[ax.coord], device=device).expand(n, -1)
            else:
                lam = torch.tensor(rows, device=device)[self.tile_index(ax, n, device)]
            shape = [n, 1, 1, 1]
            shape[ax.dim] = lam.shape[1]
            lam = lam.reshape(shape)
            self._plans[ck] = lam
        return lam

    # -- a whole level, for a gather that reads anywhere ----------------------------

    def gather(self, x, size=None):
        """The whole level (or derived extent, ``size`` by default x's) of
        the tiles x, (samples, C, gh, gw): sample s is the frame of the
        stacked tiles j with j % samples == s (the tile index is outermost),
        or of this rank's data slice.  Counted in ``gathers``, in the
        profiler range ``GATHER_RANGE``."""
        gh, gw = size or self.extent(x)
        gathers.count += 1
        with record_function(GATHER_RANGE):
            if self.across:
                for ax, g in ((self.w, gw), (self.h, gh)):
                    if ax is not None:
                        x = R.gather_summed(x, ax.dim, [ax.own(g, i) for i in range(ax.t)],
                                            ax.coord, self.mesh.axis_group(ax.name))
                return x
            n, C, h, w = x.shape
            T = self.stacked
            ck = ("gather", gh, gw, h, w, x.device)
            index = self._plans.get(ck)
            if index is None:
                tile, local = [], []
                for ax, g in ((self.h, gh), (self.w, gw)):
                    if ax is None:
                        tile.append(np.zeros(g, np.int64))
                        local.append(np.arange(g))
                        continue
                    b = ax.bounds(g)
                    owner = np.repeat(np.arange(ax.t), [hi - lo for lo, hi in b])
                    tile.append(owner)
                    local.append(np.arange(g) - np.array([lo for lo, _ in b])[owner])
                t_w = self.w.t
                flat = ((tile[0][:, None] * t_w + tile[1][None, :]) * (h * w)
                        + local[0][:, None] * w + local[1][None, :])
                index = torch.from_numpy(flat.reshape(-1)).to(x.device)
                self._plans[ck] = index
            y = x.reshape(T, n // T, C, h * w).permute(1, 2, 0, 3).reshape(n // T, C, T * h * w)
            return y.index_select(2, index).reshape(n // T, C, gh, gw)

    def reduce(self, s):
        """The transpose of ``gather``: s (samples, C, gh, gw), this
        process's whole-frame sums per sample (every stacked tile of a sample
        scattered into one buffer) or this rank's -> each tile's owned part of
        the sum over every tile of its sample, (n, C, h, w), a stacked tile's
        padding zero: one index gather over stacked tiles, a reduce-scatter
        over each tile axis's group of ranks.  Its backward is ``gather``.
        Counted in ``reductions``, in the profiler range ``REDUCE_RANGE``."""
        reductions.count += 1
        with record_function(REDUCE_RANGE):
            return _Reduce.apply(s, self)

    def _reduce(self, s):
        gh, gw = s.shape[-2:]
        if self.across:
            for ax, g in ((self.w, gw), (self.h, gh)):
                if ax is not None:
                    s = R.reduce_scatter_uneven(s, ax.dim, [ax.own(g, i) for i in range(ax.t)],
                                                ax.coord, self.mesh.axis_group(ax.name))
            return s
        S, C = s.shape[:2]
        T = self.stacked
        h, w = self.tile_size(gh, gw)
        ck = ("reduce", gh, gw, s.device)
        index = self._plans.get(ck)
        if index is None:
            glob = []
            for ax, g, size in ((self.h, gh, h), (self.w, gw, w)):
                if ax is None:
                    glob.append(np.arange(size)[None, :])
                    continue
                glob.append(np.array([[a + k if a + k < b else -1 for k in range(size)]
                                      for a, b in ax.bounds(g)]))
            gy, gx = glob[0][:, None, :, None], glob[1][None, :, None, :]
            flat = np.where((gy >= 0) & (gx >= 0), gy * gw + gx, gh * gw)  # (th, tw, h, w)
            index = torch.from_numpy(flat.reshape(-1)).to(s.device)
            self._plans[ck] = index
        y = torch.cat([s.reshape(S, C, gh * gw), s.new_zeros(S, C, 1)], dim=2)
        y = y.index_select(2, index).view(S, C, T, h, w)
        return y.permute(2, 0, 1, 3, 4).reshape(T * S, C, h, w)

    def level_input_window(self, flow, fst):
        """What SPyNet's level input on the tiles fst reads of the coarse
        flow tiles ``flow`` at half fst's level, on the frame's global
        coordinates: (each tile's window of the coarse flow -- the columns
        and rows from the first to the last that its owned positions' x2
        align_corners lerp reads, a 0-1 halo --, (n, 6) int32 per sample: the
        tile's global origin (y0, x0), its window's global origin (cy0,
        cx0) and the positions it owns (h, w), and the level's global
        (GH, GW))."""
        GH, GW = self.level(fst)
        if self.level(flow) != (GH // 2, GW // 2):
            raise ValueError(f"a coarse flow of the level {self.level(flow)} for a level input "
                             f"of {(GH, GW)}")
        n = fst.shape[0]
        per_axis = []
        for dim, G in ((-2, GH), (-1, GW)):
            ax, g = self._tiled(dim), G // 2
            scale = np.float32(g - 1) / np.float32(2 * g - 1)

            def tap(j, g=g, scale=scale):  # (i0, i1) of output j, as the kernel's up_lerp
                i = int(scale * np.float32(min(j, 2 * g - 1)))
                return i, i + (i < g - 1)

            if ax is None:
                per_axis.append(([0], [0], [G]))
                continue
            spans = [(tap(c0)[0], tap(c1 - 1)[1]) for c0, c1 in ax.bounds(G)]
            flow = self.take(flow, ax, g, G, ("level input",),
                             lambda i, E, spans=spans: list(range(spans[i][0], spans[i][1] + 1)))
            per_axis.append(([c0 for c0, _ in ax.bounds(G)], [a for a, _ in spans],
                             [ax.own(G, i) for i in range(ax.t)]))
        ck = ("level input origins", GH, GW, n, fst.device)
        origins = self._plans.get(ck)
        if origins is None:
            cols = []
            for ax, (o, c, own) in zip((self.h, self.w), per_axis):
                rows = torch.tensor([o, c, own], dtype=torch.int32).t()  # (tiles, 3)
                if ax is None:
                    cols.append(rows.expand(n, 3))
                elif ax.across:
                    cols.append(rows[ax.coord].expand(n, 3))
                else:
                    cols.append(rows[self.tile_index(ax, n, torch.device("cpu"))])
            (y0, cy0, own_h), (x0, cx0, own_w) = (c.unbind(1) for c in cols)
            origins = torch.stack([y0, x0, cy0, cx0, own_h, own_w], 1).contiguous().to(
                fst.device)
            self._plans[ck] = origins
        return flow, origins, (GH, GW)

    # -- reductions over owned pixels -----------------------------------------------

    def mask(self, x, size=None):
        """(n, 1, h, w) float32 of the pixels the stacked tiles own, or None
        where every pixel is owned (across ranks, or an even level); x at
        the level or extent ``size``, by default its level."""
        if self.across:
            return None
        gh, gw = size or self.level(x)
        n, _, h, w = x.shape
        ck = ("mask", gh, gw, n, x.device)
        m = self._plans.get(ck, False)
        if m is False:
            m = None
            parts = []
            for ax, g, size in ((self.h, gh, h), (self.w, gw, w)):
                if ax is None:
                    parts.append(torch.ones(n, size, device=x.device))
                    continue
                own = torch.tensor([ax.own(g, i) for i in range(ax.t)], device=x.device)
                lim = own[self.tile_index(ax, n, x.device)]
                parts.append((torch.arange(size, device=x.device) < lim[:, None]).float())
            if not all(bool(p.all()) for p in parts):
                m = (parts[0][:, :, None] * parts[1][:, None, :])[:, None]
            self._plans[ck] = m
        return m

    def count(self, x):
        """Pixels per channel of the samples x's tiles belong to (on this
        rank; across ranks the owned pixels of this rank's tile)."""
        gh, gw = self.level(x)
        if self.across:
            return x.shape[0] * x.shape[2] * x.shape[3]
        return self.samples(x.shape[0]) * gh * gw

    def tile_groups(self):
        """The groups of this rank's tile lines (across ranks), W first."""
        return [self.mesh.axis_group(a.name) for a in self.axes] if self.across else []

    # -- whole frames in and out ---------------------------------------------------

    def split(self, x):
        """Whole (B, C, h, w) tensors at any level of the frame -> this
        process's stacked tiles, or this rank's tile (and data slice)."""
        if self.across and self.mesh.shape.get("data", 1) > 1:
            d, r = self.mesh.shape["data"], self.mesh.coords["data"]
            b = x.shape[0] // d
            x = x[r * b:(r + 1) * b]
        for ax in self.axes:
            g = x.shape[ax.dim]
            ax.add_extent(g)  # a derived extent where g is no level
            bounds = ax.bounds(g)
            if ax.across:
                a, b = bounds[ax.coord]
                x = x.narrow(ax.dim, a, b - a)
                continue
            E = ax.width(g)
            tiles = []
            for a, b in bounds:
                tile = x.narrow(ax.dim, a, b - a)
                if b - a < E:
                    pad = [0, 0, 0, 0]
                    pad[1 if ax.dim == -1 else 3] = E - (b - a)
                    tile = torch.nn.functional.pad(tile, pad)
                tiles.append(tile)
            x = torch.cat(tiles, dim=0)
        return x.contiguous()

    def merge(self, x):
        """The inverse of ``split``: whole tensors, on every rank."""
        gh, gw = self.extent(x)
        for ax, g in reversed([(a, gw if a is self.w else gh) for a in self.axes]):
            bounds = ax.bounds(g)
            if ax.across:
                x = R.gather_uneven(x, ax.dim, [b - a for a, b in bounds], ax.coord,
                                    self.mesh.axis_group(ax.name))
                continue
            x = torch.cat([t.narrow(ax.dim, 0, b - a)
                           for t, (a, b) in zip(x.chunk(ax.t, dim=0), bounds)], dim=ax.dim)
        if self.across and self.mesh.shape.get("data", 1) > 1:
            x = R.gather_uneven(x, 0, [x.shape[0]] * self.mesh.shape["data"],
                                self.mesh.coords["data"], self.mesh.axis_group("data"))
        return x


class _Reduce(torch.autograd.Function):
    """``Partition.reduce``; its backward gathers the cotangent whole."""

    @staticmethod
    def forward(ctx, s, part):
        ctx.part, ctx.size = part, tuple(s.shape[-2:])
        return part._reduce(s)

    @staticmethod
    def backward(ctx, g):
        return ctx.part.gather(g.contiguous(), ctx.size), None
