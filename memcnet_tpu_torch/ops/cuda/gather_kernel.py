"""K5: the bilinear grid-sample kernel, its plain version and its launch count.

Replaces the TPU kernel ``memcnet_tpu/ops/pallas/gather_kernel.py::
gather_bands`` (kernel ``_gather_kernel``), whose one model use is
``grid_sample_bilinear`` in SPyNet's backward warp.  CUDA source:
``memcnet_tpu_torch/csrc/gather.cu``.

Function: ``F.grid_sample(x, grid, mode='bilinear', padding_mode='zeros',
align_corners=True)`` written as ``_grid_sample_xla`` (memcnet_tpu/nn/
layers.py:334-360) writes it: unnormalise ``(g + 1) * (W - 1) / 2``, floor,
four bilinear taps, each out-of-range tap zeroed.  Coordinates, weights and
sums are float32 whatever x's type, and the result is rounded once to x's
type, as the Pallas kernel does.  Any grid size (B, Ho, Wo, 2) is served.

What bounds it on the H100: memory -- x, the float32 grid and the output each
cross HBM once.  Its design: one thread per output pixel computes the four
tap weights and addresses once and loops over the channels.  The TPU band
plan, zero-ring pre-pad, lane padding and ``gather_ok`` budget were DMA
geometry; a CUDA thread reads any address, and the zero ring becomes a bounds
test per tap.
"""

import torch

from memcnet_tpu_torch.ops.cuda import _lib

counter = _lib.LaunchCounter("grid_sample")


def reference(x, grid):
    """Plain PyTorch version: the 4-tap formulation, float32, rounded once."""
    B, C, H, W = x.shape
    _, Ho, Wo, _ = grid.shape
    g = grid.float()
    gx = (g[..., 0] + 1.0) * (W - 1) / 2.0
    gy = (g[..., 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    x0 = x0.long()
    y0 = y0.long()
    src = x.float().reshape(B, C, H * W)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, Ho * Wo)
        v = torch.gather(src, 2, lin.expand(B, C, Ho * Wo)).reshape(B, C, Ho, Wo)
        return v * inb[:, None]

    out = (tap(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
           + tap(y0, x0 + 1) * (wx * (1 - wy))[:, None]
           + tap(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
           + tap(y0 + 1, x0 + 1) * (wx * wy)[:, None])
    return out.to(x.dtype)


def launch(x, grid):
    what = "grid_sample"
    B, C, H, W = x.shape
    if grid.dim() != 4 or grid.shape[0] != B or grid.shape[3] != 2:
        raise ValueError(f"{what}: grid {tuple(grid.shape)} is not (B, Ho, Wo, 2) for x "
                         f"{tuple(x.shape)}")
    code = _lib.dtype_code(x.dtype)
    x = x.contiguous()
    grid = grid.float().contiguous()
    _lib.check_cuda_args(what, x, grid)
    lib = _lib.lib()
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, C, Ho, Wo), dtype=x.dtype, device=x.device)
    err = lib.memc_grid_sample(x.data_ptr(), grid.data_ptr(), out.data_ptr(),
                               B, C, H, W, Ho, Wo, code, _lib.stream_ptr(x))
    _lib.check(err, what)
    counter.count += 1
    return out


class _GridSampleFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain version for x and
    grid (as ``_gs_fast_op``'s VJP is that of ``_grid_sample_xla``)."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x, grid)
        return launch(x, grid)

    @staticmethod
    def backward(ctx, g):
        x, grid = ctx.saved_tensors
        gx, gg = _lib.reference_grads(reference, [x, grid], list(ctx.needs_input_grad[:2]), [g])
        return gx, gg


def grid_sample(x, grid):
    """Bilinear, zeros, align_corners=True grid sample: the kernel on CUDA
    tensors, the plain version on CPU tensors.  x (B, C, H, W), grid
    (B, Ho, Wo, 2) -> (B, C, Ho, Wo) in x's type."""
    if _lib.on_cuda(x, grid):
        return _GridSampleFunction.apply(x, grid)
    return reference(x, grid)
