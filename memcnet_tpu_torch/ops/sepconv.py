"""SepConv-family ops (port of memcnet_tpu/ops/sepconv.py):
SeparableConvLayer (N5) and SeparableConvFlowLayer (N6), exported capability
in the reference with no model call site.  XLA in the JAX package, stock
PyTorch here (shifted multiply-adds; autograd backward, which equals the
reference's hand backward, my_lib_kernel.cu:339-390), on any device.

  * separable_conv (my_lib_kernel.cu:285-337): out[c, y, x] = sum over
    j, i < fs of image[c, y + j, x + i] * vert[j, y, x] * horiz[i, y, x], a
    valid-convolution output (H - fs + 1, W - fs + 1).
  * separable_conv_flow (:19-84): the centroid of each 1-D kernel minus
    (fs - 1) / 2, channel 0 from horiz (x), channel 1 from vert (y);
    FLOW_SENTINEL where the weights sum to exactly 0.

On sharded frames (``parallel/partition.py``) the valid output (H - fs + 1,
W - fs + 1) is a derived extent of the frame, tiled by the ownership rule:
vert, horiz and the output are its tiles, and the image tile takes the fs -
1 positions right and below that its owned outputs read (taps x .. x + fs -
1; ``Partition.clamped_take``).  separable_conv_flow is per pixel and runs
on any tiles as it is.
"""

import torch


FLOW_SENTINEL = -2000.0  # my_lib_kernel.cu:67, "no kernel mass"


def separable_conv(image, vert, horiz):
    """image (B, C, H, W), vert and horiz (B, fs, H-fs+1, W-fs+1) ->
    (B, C, H-fs+1, W-fs+1), in the JAX package's order of sums."""
    from memcnet_tpu_torch.parallel.context import active_partition

    fs = vert.shape[1]
    part = active_partition()
    if part is not None:  # the image tiles extended right and down by fs - 1
        gh, gw = part.extent(image)
        valid = part.add_extent(gh - fs + 1, gw - fs + 1)
        image = part.clamped_take(image, (gh, gw), valid, hi=(fs - 1, fs - 1))
    B, C, H, W = image.shape
    oH, oW = H - fs + 1, W - fs + 1
    if horiz.shape[1] != fs or tuple(vert.shape[2:]) != (oH, oW) \
            or tuple(horiz.shape[2:]) != (oH, oW):
        raise ValueError(f"separable_conv: kernels {tuple(vert.shape)} and "
                         f"{tuple(horiz.shape)} do not fit image {tuple(image.shape)}")
    out = torch.zeros((B, C, oH, oW), dtype=image.dtype, device=image.device)
    for j in range(fs):
        # the horizontal pass at row offset j: sum_i I[y + j, x + i] h_i
        inner = torch.zeros_like(out)
        for i in range(fs):
            inner = inner + image[:, :, j:j + oH, i:i + oW] * horiz[:, None, i]
        out = out + inner * vert[:, None, j]
    return out


def _centroid(k):
    fs = k.shape[1]
    idx = torch.arange(fs, dtype=k.dtype, device=k.device).view(1, fs, 1, 1)
    s = torch.sum(k, dim=1)
    c = torch.sum(idx * k, dim=1) / torch.where(s == 0.0, 1.0, s)
    c = c - (fs - 1.0) / 2.0
    return torch.where(torch.abs(s) > 0.0, c, FLOW_SENTINEL)


def separable_conv_flow(vert, horiz):
    """vert, horiz (B, fs, oH, oW) -> flow (B, 2, oH, oW): channel 0 the x
    centroid of horiz, channel 1 the y centroid of vert; FLOW_SENTINEL where
    a kernel's weights sum to 0."""
    if horiz.shape[1] != vert.shape[1]:
        raise ValueError(f"separable_conv_flow: {tuple(vert.shape)} vs {tuple(horiz.shape)}")
    return torch.stack([_centroid(horiz), _centroid(vert)], dim=1)
