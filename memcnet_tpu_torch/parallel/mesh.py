"""Device mesh and the ZeRO-1 partition rule (port of memcnet_tpu/parallel/
mesh.py).

Axes, as in the JAX package:

  * ``data`` -- data parallelism: frame pairs (or windows) split across
    ranks; gradients averaged over it (``parallel.step``);
  * ``tile`` -- the W pixel axis split into tiles for the warp and the
    projection (``parallel.tiling``), and ``tile_h`` the H axis in a 2-D
    grid (``make_mesh_2d``).

``make_mesh(n)`` factorises n into (data, tile) with tile = gcd(n,
max_tile); ``make_mesh_2d`` gives (data, tile_h, tile).

Where an axis lives.  JAX places a mesh's positions on devices and lets
GSPMD move data between them.  The port's ``Mesh`` says for each axis where
its positions are:
  * *in this process*: the tiles of the axis are stacked into the batch
    dimension of one device's tensors, so one kernel launch serves every
    tile (``devices`` lists the positions, and may repeat one card);
  * *across ranks*: one position per rank of a torch.distributed group,
    ranks laid out data-major (the first axis outermost) as jax.make_mesh
    lays out devices.  Each such axis gets one subgroup per line of ranks
    along it (``axis_group``).
With a ``group`` every axis lives across its ranks; without one every axis
lives in this process.

Placing frames.  ``frame_sharding``, ``frame_sharding_2d`` and
``replicated`` name, as the JAX package's PartitionSpecs do, the mesh axis
each dim of a (B, C, H, W) frame is split over.  ``shard_frames(mesh,
*frames)``, under ``spatial_tiling(mesh)``, splits whole frames into this
process's stacked tiles or this rank's tile (and data slice) over the
context's axes and records the frame's partition in the context
(``parallel.partition``), so that every layer runs on its tile;
``gather_frames`` is the inverse.  Frames passed whole to a model under
``spatial_tiling`` are replicated: the tiled ops split and merge them
themselves (``parallel.ring.TileRing.split`` and ``merge``).
``zero1_sharding`` becomes ``zero1_partition``, which ``parallel.zero``
applies to each parameter.
"""

import math

import torch
import torch.distributed as dist

from memcnet_tpu_torch.parallel.context import active_partition, active_tiling, record_partition
from memcnet_tpu_torch.parallel.partition import Partition


class Mesh:
    """Named axes, their sizes, and where each lives.

    Args:
      shape: {axis name: size}, outermost first.
      devices: without ``group``, one ``torch.device`` per position (the
        tiled ops run on the device of the tensors they are given).
      group: a torch.distributed group spanning every rank of the default
        group, one rank per position.
    """

    def __init__(self, shape, *, devices=None, group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.across = self.axis_names if group is not None else ()
        self.devices = list(devices or [])
        if group is None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for the {self.size} positions of "
                             f"{self.shape}")
        self.group = group
        self.coords = {}
        self._groups, self._ranks = {}, {}
        if group is not None:
            self._lay_out_ranks(group)

    def _lay_out_ranks(self, group):
        world = dist.get_world_size(group)
        if world != dist.get_world_size():
            raise ValueError("a mesh's group must span every rank of the default group")
        sizes = [self.shape[a] for a in self.across]
        if self.size != world:
            raise ValueError(f"{self.shape} holds {self.size} positions, the group {world} "
                             "ranks")
        me = dist.get_rank(group)
        grid = torch.arange(world).reshape(sizes)
        self.coords = dict(zip(self.across, (int(c) for c in
                                             torch.nonzero(grid == me)[0])))
        # one subgroup per line of ranks along each axis; every rank creates
        # every subgroup, in the same order, as new_group requires
        for d, a in enumerate(self.across):
            lines = grid.movedim(d, -1).reshape(-1, sizes[d])
            for line in lines.tolist():
                g = dist.new_group(line)
                if me in line:
                    self._groups[a], self._ranks[a] = g, line

    def is_across(self, axis):
        """True if ``axis`` lives across ranks, False if in this process."""
        if axis not in self.shape:
            raise KeyError(f"the mesh has no axis {axis!r} ({self.axis_names})")
        return axis in self.across

    def axis_group(self, axis):
        """The subgroup of the ranks along ``axis`` through this rank (None
        for an axis in this process)."""
        return self._groups.get(axis) if self.is_across(axis) else None

    def axis_ranks(self, axis):
        """The global ranks along ``axis`` through this rank, in axis order."""
        return self._ranks[axis]

    def __repr__(self):
        where = {a: ("ranks" if a in self.across else "process") for a in self.axis_names}
        return f"Mesh({self.shape}, {where})"


def _local_devices(n_devices, devices):
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] * n for the "
                               "CPU")
        n = n_devices or count
        devices = [torch.device("cuda", i % count) for i in range(n)]
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return list(devices)


def _size(n_devices, devices, group):
    if group is not None:
        n = dist.get_world_size(group)
        if n_devices is not None and n_devices != n:
            raise ValueError(f"n_devices {n_devices} differs from the group's {n} ranks")
        return n, None
    devices = _local_devices(n_devices, devices)
    return len(devices), devices


def make_mesh(n_devices=None, *, max_tile=4, devices=None, group=None):
    """(data, tile) over n positions, tile = gcd(n, max_tile): in this
    process on ``devices`` (default: the CUDA devices, repeated up to
    ``n_devices``), or across the ranks of ``group``."""
    n, devices = _size(n_devices, devices, group)
    tile = math.gcd(n, max_tile)
    return Mesh({"data": n // tile, "tile": tile}, devices=devices, group=group)


def make_mesh_2d(n_devices=None, *, tile_h=2, tile_w=2, devices=None, group=None):
    """(data, tile_h, tile) mesh for a 2-D spatial grid: 720p frames are
    wider than tall, so W tiles alone cap the spatial split at about 4."""
    n, devices = _size(n_devices, devices, group)
    if n % (tile_h * tile_w):
        raise ValueError(f"{n} positions do not split into {tile_h} x {tile_w} tiles")
    return Mesh({"data": n // (tile_h * tile_w), "tile_h": tile_h, "tile": tile_w},
                devices=devices, group=group)


def zero1_partition(shape, n):
    """The dim of a parameter of ``shape`` that ZeRO-1 shards over n ranks:
    the largest dim that n divides evenly (the first of equal ones), or None
    to replicate (``_zero1_leaf_sharding`` of the JAX package)."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


def mesh_barrier(mesh):
    """Wait until every rank of the mesh arrives (``dist.barrier`` over its
    group); nothing when every axis lives in this process."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def frame_sharding(mesh):
    """(B, C, H, W): batch over data, width over tile (a PartitionSpec's
    axis names, one per dim)."""
    return ("data", None, None, "tile")


def frame_sharding_2d(mesh):
    """(B, C, H, W): batch over data, height over tile_h, width over tile."""
    return ("data", None, "tile_h", "tile")


def replicated(mesh):
    return ()


def _context_sharding(mesh):
    ctx = active_tiling()
    if ctx is None or ctx.mesh is not mesh:
        raise RuntimeError("shard and gather frames under spatial_tiling(mesh) of this mesh")
    return ctx, ("data", None, ctx.axis_h, ctx.axis)


def shard_frames(mesh, *frames, sharding=None):
    """Whole frames (B, C, H, W) -> this process's tiles stacked into the
    batch, or this rank's tile of its data slice, over the active
    ``spatial_tiling`` context's axes (``sharding`` defaults to them;
    ``replicated(mesh)`` returns the frames as they are).  The first call
    under a context records the partition of its first frame's H and W
    there; a tensor of another size is a level or a derived extent of that
    frame (``Partition.split``).  Returns one tensor for one frame, else a
    tuple."""
    ctx, spec = _context_sharding(mesh)
    if sharding is not None and tuple(sharding) == replicated(mesh):
        return frames[0] if len(frames) == 1 else frames
    if sharding is not None and tuple(sharding) != spec:
        raise ValueError(f"the spatial_tiling context shards frames as {spec}, not {sharding}")
    part = active_partition()
    if part is None:
        H, W = frames[0].shape[-2:]
        part = record_partition(Partition(mesh, ctx.axis, ctx.axis_h, H, W))
    out = tuple(part.split(f) for f in frames)
    return out[0] if len(out) == 1 else out


def gather_frames(mesh, *tiles):
    """The inverse of ``shard_frames``: whole tensors (at any level or
    derived extent of the frame) on every rank, the stacked tiles' padding
    dropped."""
    from memcnet_tpu_torch.parallel.context import active_partition

    _context_sharding(mesh)
    part = active_partition()
    if part is None:
        raise RuntimeError("no frames were sharded under this spatial_tiling context")
    out = tuple(part.merge(t) for t in tiles)
    return out[0] if len(out) == 1 else out
