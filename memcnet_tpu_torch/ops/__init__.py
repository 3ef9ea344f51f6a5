"""The op library (port of memcnet_tpu/ops): the reference's native ops.

Inventory of the reference's op library (SURVEY.md section 2.1), as the JAX
package maps it:
  N1 FilterInterpolationLayer    -> warp.filter_interp_warp (K1 on the card;
                                    filter_interp_warp_split warps a frame and
                                    its context in one pass)
  N2 FlowProjectionLayer         -> projection.flow_project (K2 + K3)
  N3 InterpolationLayer          -> warp.bilinear_warp
  N4 InterpolationChLayer        -> warp.bilinear_warp_ch (the same function)
  N5 SeparableConvLayer          -> sepconv.separable_conv
  N6 SeparableConvFlowLayer      -> sepconv.separable_conv_flow
  N7 DepthFlowProjectionLayer    -> projection.depth_flow_project (K2's payload
                                    entry + K3)
  N8 WeightedFlowProjectionLayer -> projection.weighted_flow_project (K2's
                                    payload entry + K3)
  N9 WeightLayer                 -> mc.occlusion_weight
  N10 PixelValue/PixelWeight     -> mc.pixel_splat, mc.pixel_value, mc.pixel_weight
  N11 ReliableWeightLayer        -> mc.reliable_weight
  N12/N13 (THC glue, CPU mirror) -> the wrappers' checks and the plain
                                    versions beside each kernel
N1, N2, N7 and N8 run hand-written CUDA kernels on CUDA tensors (ops/cuda);
the others are stock PyTorch on any device, as they are XLA in the JAX
package.  Every op also runs on the tiles of sharded frames
(parallel/partition.py): N1 and N2 on their tile-local steps, the others on
the frame's global coordinates (ops/frame.py), N7 and N8 on K2's payload
entry on tile origins.
"""

from memcnet_tpu_torch.ops.mc import (
    occlusion_weight,
    pixel_splat,
    pixel_value,
    pixel_weight,
    reliable_weight,
)
from memcnet_tpu_torch.ops.projection import (
    depth_flow_project,
    flow_project,
    weighted_flow_project,
)
from memcnet_tpu_torch.ops.sepconv import separable_conv, separable_conv_flow
from memcnet_tpu_torch.ops.warp import (
    bilinear_warp,
    bilinear_warp_ch,
    filter_interp_warp,
    filter_interp_warp_split,
)

__all__ = (
    "filter_interp_warp",
    "filter_interp_warp_split",
    "bilinear_warp",
    "bilinear_warp_ch",
    "flow_project",
    "depth_flow_project",
    "weighted_flow_project",
    "separable_conv",
    "separable_conv_flow",
    "occlusion_weight",
    "pixel_splat",
    "pixel_value",
    "pixel_weight",
    "reliable_weight",
)
