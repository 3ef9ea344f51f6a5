"""The parallel layer (port of memcnet_tpu/parallel): the device mesh and
the placement of frames (``mesh``), the tiling and data-parallel contexts
(``context``), the ring exchange, halo gathers and differentiable
collectives (``ring``), halo-exchange tiling of the warp and the projection
(``tiling``), every layer on the tiles of sharded frames (``partition``),
ZeRO-1 Adamax (``zero``), the data-parallel and sharded train steps
(``step``) and the GOP scheduler of the multihost demo (``gop``).
"""

from memcnet_tpu_torch.parallel.context import (
    TilingContext,
    active_data_group,
    active_partition,
    active_tiling,
    data_parallel,
    spatial_tiling,
)
from memcnet_tpu_torch.parallel.mesh import (
    Mesh,
    frame_sharding,
    frame_sharding_2d,
    gather_frames,
    make_mesh,
    make_mesh_2d,
    mesh_barrier,
    replicated,
    shard_frames,
    zero1_partition,
)
from memcnet_tpu_torch.parallel.step import (
    DataParallelStep,
    sharded_frames,
    sharded_mesh,
    sharded_train_step,
)
from memcnet_tpu_torch.parallel.tiling import (
    tiled_filter_interp_warp,
    tiled_filter_interp_warp_split,
    tiled_flow_project,
)
from memcnet_tpu_torch.parallel.zero import ZeroAdamax

__all__ = ["TilingContext", "active_data_group", "active_partition", "active_tiling",
           "data_parallel", "spatial_tiling", "Mesh", "frame_sharding", "frame_sharding_2d",
           "gather_frames", "make_mesh", "make_mesh_2d", "mesh_barrier", "replicated",
           "shard_frames", "zero1_partition", "tiled_filter_interp_warp",
           "tiled_filter_interp_warp_split", "tiled_flow_project", "ZeroAdamax", "DataParallelStep", "sharded_mesh",
           "sharded_frames", "sharded_train_step"]
