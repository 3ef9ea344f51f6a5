"""K4: the small-input-channel direct convolution kernel, its plain version
and its launch count.

Replaces the TPU kernel ``memcnet_tpu/ops/pallas/conv_kernel.py::
conv2d_small``.  CUDA source: ``memcnet_tpu_torch/csrc/conv.cu``.

Function: PyTorch Conv2d with stride 1 and 'same' zero padding (K // 2) for
odd K in {3, 5, 7}, optional bias and fused ReLU, float32 accumulation of the
inputs' exact products, NCHW in and out, output rounded once to the input
type.  It serves any spatial size; the TPU path's 96x96 gate was a TPU
heuristic.

Its callers: the ctx conv (3 -> 64) and every conv of SPyNet's 7x7 stacks
(8 -> 32 -> 64 -> 32 -> 16 -> 2, bias, ReLU on the first four).

What bounds it on the H100: in bf16 the ideal kernel is bound by writing the
output for the ctx conv and by its operations (tensor-core rate) for SPyNet's
convs; this direct form runs its C*K*K multiply-adds per output on the float32
CUDA cores and is bound by them.  Its design: a block owns a 64 x 8 pixel
tile and 16 output channels and walks the input channels in chunks of 8: each
chunk's input tile with its halo and weight slice are staged in shared memory
(at most 56 KB at K = 7, whatever C) and accumulated into 2 pixels x 16
channels of float32 sums per thread.  A tensor-core version is later work.
"""

import torch
import torch.nn.functional as F

from memcnet_tpu_torch.ops.cuda import _lib

counter = _lib.LaunchCounter("conv2d_small")
KERNEL_SIZES = (3, 5, 7)


def reference(x, w, b=None, relu=False):
    """Plain PyTorch version: the same conv in float32, rounded once."""
    K = w.shape[2]
    out = F.conv2d(x.float(), w.float(), None if b is None else b.float(), padding=K // 2)
    if relu:
        out = out.clamp(min=0.0)
    return out.to(x.dtype)


def launch(x, w, b=None, relu=False):
    what = "conv2d_small"
    B, C, H, W = x.shape
    O, Cw, K, K2 = w.shape
    if Cw != C or K != K2 or K not in KERNEL_SIZES:
        raise ValueError(f"{what}: weight {tuple(w.shape)} does not fit input {tuple(x.shape)} "
                         f"(square odd K in {KERNEL_SIZES})")
    code = _lib.dtype_code(x.dtype)
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    bias = None if b is None else b.float().contiguous()
    _lib.check_cuda_args(what, x, w, *(() if bias is None else (bias,)))
    lib = _lib.lib()
    out = torch.empty((B, O, H, W), dtype=x.dtype, device=x.device)
    err = lib.memc_conv2d_small(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, C, H, W, O, K, int(relu), code, _lib.stream_ptr(x))
    _lib.check(err, what)
    counter.count += 1
    return out


class _ConvFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain version."""

    @staticmethod
    def forward(ctx, x, w, b, relu):
        ctx.relu = relu
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, *(() if b is None else (b,)))
        return launch(x, w, b, relu)

    @staticmethod
    def backward(ctx, g):
        x, w, *rest = ctx.saved_tensors
        relu = ctx.relu
        needs = list(ctx.needs_input_grad[:2]) + ([ctx.needs_input_grad[2]] if rest else [])
        grads = _lib.reference_grads(
            lambda xx, ww, *bb: reference(xx, ww, bb[0] if bb else None, relu),
            [x, w, *rest], needs, [g])
        return grads[0], grads[1], (grads[2] if rest else None), None


def conv2d_small(x, w, b=None, *, relu=False):
    """Stride-1 'same' conv: the kernel on CUDA tensors, the plain version on
    CPU tensors.  x (B, C, H, W), w (O, C, K, K), b (O,) or None."""
    if _lib.on_cuda(x, w, *(() if b is None else (b,))):
        return _ConvFunction.apply(x, w, b, relu)
    return reference(x, w, b, relu)
