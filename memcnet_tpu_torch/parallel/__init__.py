"""The parallel layer (port of memcnet_tpu/parallel): the device mesh
(``mesh``), the tiling and data-parallel contexts (``context``), the ring
exchange and differentiable collectives (``ring``), halo-exchange tiling of
the warp and the projection (``tiling``), ZeRO-1 Adamax (``zero``), the
data-parallel and sharded train steps (``step``) and the GOP scheduler of
the multihost demo (``gop``).
"""

from memcnet_tpu_torch.parallel.context import (
    TilingContext,
    active_data_group,
    active_tiling,
    data_parallel,
    spatial_tiling,
)
from memcnet_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_2d,
    mesh_barrier,
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

__all__ = ["TilingContext", "active_data_group", "active_tiling", "data_parallel",
           "spatial_tiling", "Mesh", "make_mesh", "make_mesh_2d", "mesh_barrier",
           "zero1_partition", "tiled_filter_interp_warp", "tiled_filter_interp_warp_split",
           "tiled_flow_project", "ZeroAdamax", "DataParallelStep", "sharded_mesh",
           "sharded_frames", "sharded_train_step"]
