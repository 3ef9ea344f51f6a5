"""Dispatch contexts of the parallel layer (port of memcnet_tpu/parallel/
context.py, and the data-parallel context the port's BatchNorm reads).

``spatial_tiling(mesh)`` makes ``filter_interp_warp``,
``filter_interp_warp_split`` and ``flow_project`` dispatch to the halo-
exchange implementations in ``parallel.tiling``: the warp and the
projection are the ops whose data-dependent gathers and scatters the tiles
must exchange by hand.  The JAX package consults the context while it traces
a jitted step; the port's ops read it each time they are called, so the same
model code serves the whole frame and the tiled one.

Frames that come in sharded (``parallel.mesh.shard_frames`` under the
context) record a ``parallel.partition.Partition`` of their global size in
it (``active_partition``): then every spatial layer runs on its tile with
halos (``nn.layers``), the warp and the projection go straight to their
tile-local steps, and the rest of the op library (N3-N11), the grid sample
and the replication pad run on the frame's global coordinates, with a whole
level gathered or reduced where an index is data-dependent
(``ops/frame.py``), as GSPMD runs every op of the JAX package on
``frame_sharding``-placed arrays.  Frames passed whole keep the behaviour
above: the convs on the whole frame, the warp and the projection split and
merged, the other ops whole.

``data_parallel(group)`` makes the train-mode BatchNorm
(``nn.layers.batch_norm_train``) reduce its batch statistics over the ranks
of ``group``, as GSPMD does for a batch-sharded BatchNorm in the JAX
package's sharded step.

Both contexts are thread-local.

    mesh = make_mesh(4, devices=[torch.device("cuda")] * 4)   # (data 1, tile 4)
    with spatial_tiling(mesh, halo=64):
        out = model(x0, x2)                          # whole frames
        t0, t2 = shard_frames(mesh, x0, x2)          # or sharded ones
        out = gather_frames(mesh, model(t0, t2)[0][1])
"""

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class TilingContext:
    mesh: Any                   # parallel.mesh.Mesh
    axis: str = "tile"          # mesh axis tiling the W pixel dimension
    batch_axis: str = "data"    # mesh axis of the batch (accepted; the ops are per sample)
    halo: int = 64              # columns exchanged with ring neighbours
    axis_h: Optional[str] = None  # optional mesh axis tiling the H dimension
    halo_h: Optional[int] = None  # rows exchanged (defaults to ``halo``)


_state = threading.local()


def active_tiling():
    """The innermost active TilingContext, or None."""
    return getattr(_state, "ctx", None)


@contextmanager
def spatial_tiling(mesh, *, axis="tile", batch_axis="data", halo=64, axis_h=None,
                   halo_h=None):
    """Dispatch the warp and the projection to the tiled implementations
    while this context is active.  Pass ``axis_h`` for a 2-D (tile_h, tile)
    grid."""
    prev, prev_part = active_tiling(), getattr(_state, "partition", None)
    _state.ctx = TilingContext(mesh, axis, batch_axis, halo, axis_h, halo_h)
    _state.partition = None
    try:
        yield _state.ctx
    finally:
        _state.ctx, _state.partition = prev, prev_part


def active_partition():
    """The ``Partition`` of the frames sharded under the innermost
    ``spatial_tiling``, or None (no context, or whole frames)."""
    return getattr(_state, "partition", None) if active_tiling() is not None else None


def record_partition(partition):
    """Record the partition of sharded frames in the active context
    (``parallel.mesh.shard_frames``); one frame size per context (other
    sizes are its levels and derived extents)."""
    if active_tiling() is None:
        raise RuntimeError("shard frames under spatial_tiling(mesh): the layers read the "
                           "partition from it")
    prev = getattr(_state, "partition", None)
    if prev is not None and prev.frame != partition.frame:
        raise ValueError(f"frames of {partition.frame} sharded where {prev.frame} are")
    if prev is None:
        _state.partition = partition
    return _state.partition


def active_data_group():
    """The process group of the innermost ``data_parallel`` context, or None."""
    return getattr(_state, "data_group", None)


@contextmanager
def data_parallel(group):
    """Train-mode BatchNorm reduces its batch statistics over ``group`` (a
    torch.distributed process group) while this context is active; None
    turns the reduction off."""
    prev = active_data_group()
    _state.data_group = group
    try:
        yield group
    finally:
        _state.data_group = prev
