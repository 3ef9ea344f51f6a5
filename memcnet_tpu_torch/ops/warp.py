"""Adaptive filter-interpolation warp (port of memcnet_tpu/ops/warp.py).

Semantics of the reference's FilterInterpolation (my_lib_kernel.cu:1087-1218),
as the JAX package pins them: per output pixel p, follow the flow to
x2 = p + f, take the fs x fs edge-clamped patch whose top-left tap is
(int(y2) + 1 - fs/2, int(x2) + 1 - fs/2), weight it by the per-pixel filter
times the bilinear quadrant factors, and sum.  Pixels with x2 outside
[0, W-1] (or y2 outside [0, H-1]) or |f| >= frame/2 copy the source through,
with the gradient of that copy dropped.

On CUDA tensors the forward is the hand-written kernel K1
(ops/cuda/warp_kernel.py); on CPU tensors it is the plain PyTorch version
beside it.  Gradients are autograd of the plain version in both cases.
Landing coordinates are computed in float32 even for bf16 activations.
Under an active ``parallel.spatial_tiling`` context both filter warps
dispatch to the tiled warp (``parallel/tiling.py``: halo exchange, flow clamped to the
halo budget), whose tile-local step is K1's tile entry on CUDA tensors; the
split warp keeps its sources apart there too.  On frames sharded under the
context (``parallel.partition``) the inputs are tiles, and the warps run
the tile-local step alone.

``bilinear_warp`` (N3, InterpolationLayer; N4, InterpolationChLayer, any
channel count; my_lib_kernel.cu:507-686) is the classic backward warp, valid
iff 0 <= x2 < W and 0 <= y2 < H (strict, unlike the filter warp's <= W-1),
the right and bottom taps clamped to the border, zero outside.  It is XLA in
the JAX package and stock PyTorch here (four gathers; autograd backward), on
any device.  On sharded frames it runs as the JAX op does on
``frame_sharding``-placed arrays: the image's level comes whole through
``Partition.gather`` (``ops/frame.py``), the flow and the result stay on
the tiles, and validity and the border clamps are the frame's, so a flow
that lands anywhere in the frame gives the untiled answer.
"""

import torch

from memcnet_tpu_torch.ops.cuda import warp_kernel
from memcnet_tpu_torch.ops.frame import frame_of


def filter_interp_warp_split(images, flow, filt, *, filter_size=4):
    """Warp channel-split sources (e.g. a frame and its 64-channel context)
    that share one flow and filter in one pass.

    Args:
      images: sequence of (B, C_k, H, W) sources of one type.
      flow: (B, 2, H, W), channel 0 = x, channel 1 = y.
      filt: (B, filter_size**2, H, W) per-pixel weights.
    Returns:
      tuple of (B, C_k, H, W) warped tensors, one per source.
    """
    from memcnet_tpu_torch.parallel.context import active_partition, active_tiling

    t = active_tiling()
    if t is not None:
        from memcnet_tpu_torch.parallel.tiling import tiled_filter_interp_warp_split, warp_tiles

        part = active_partition()
        if part is not None:
            return warp_tiles(part.ring(flow.shape[0]), tuple(images), flow, filt,
                              frame=part.frame, filter_size=filter_size, halo=t.halo,
                              axis=t.axis, axis_h=t.axis_h, halo_h=t.halo_h)
        return tiled_filter_interp_warp_split(
            t.mesh, images, flow, filt, filter_size=filter_size, halo=t.halo, axis=t.axis,
            batch_axis=t.batch_axis, axis_h=t.axis_h, halo_h=t.halo_h)
    return warp_kernel.warp(tuple(images), flow, filt, filter_size)


def filter_interp_warp(image, flow, filt, *, filter_size=4):
    """Warp one (B, C, H, W) source; see filter_interp_warp_split."""
    return filter_interp_warp_split((image,), flow, filt, filter_size=filter_size)[0]


def bilinear_warp(image, flow):
    """Bilinear backward warp of image (B, C, H, W) along flow (B, 2, H, W);
    out of range -> 0.  Coordinates and blend weights in float32; the result
    in the image's type."""
    fr = frame_of(flow)
    src = fr.whole(image)
    H, W = fr.size
    n, _, h, w = flow.shape
    f = flow.float()
    ys, xs = fr.coords(n, h, w, f.device)
    x2 = xs + f[:, 0]
    y2 = ys + f[:, 1]
    valid = (x2 >= 0.0) & (y2 >= 0.0) & (x2 < float(W)) & (y2 < float(H))
    ixL = x2.to(torch.int32).clamp(0, W - 1)
    iyT = y2.to(torch.int32).clamp(0, H - 1)
    ixR = (ixL + 1).clamp(max=W - 1)  # my_lib_kernel.cu:552-553
    iyB = (iyT + 1).clamp(max=H - 1)
    a = (x2 - ixL.float())[:, None]
    b = (y2 - iyT.float())[:, None]
    out = ((1 - a) * (1 - b) * fr.take(src, iyT, ixL) + a * (1 - b) * fr.take(src, iyT, ixR)
           + (1 - a) * b * fr.take(src, iyB, ixL) + a * b * fr.take(src, iyB, ixR))
    return torch.where(valid[:, None], out, 0.0).to(image.dtype)


# the reference's two layers share one function, as in the JAX package
bilinear_warp_ch = bilinear_warp
