"""K4: the small-input-channel convolution kernel, its plain version and its
launch count.

Replaces the TPU kernel ``memcnet_tpu/ops/pallas/conv_kernel.py::
conv2d_small``.  CUDA source: ``memcnet_tpu_torch/csrc/conv.cu``.

Function: PyTorch Conv2d with stride 1 and 'same' zero padding (K // 2) for
odd K in {3, 5, 7}, optional bias and fused ReLU, float32 accumulation of the
inputs' exact products, NCHW in and out, output rounded once to the input
type.  It serves any spatial size; the TPU path's 96x96 gate was a TPU
heuristic.

Its callers: the ctx conv (3 -> 64) and every conv of SPyNet's 7x7 stacks
(8 -> 32 -> 64 -> 32 -> 16 -> 2, bias, ReLU on the first four).

Two kernels, chosen by dtype (no switch, no fallback):

* bf16: a tensor-core implicit GEMM (``mma.sync`` m16n8k16, float32
  accumulators).  The GEMM's depth is C x K x K in (ky, kx, c) order, the
  channels in groups of CG = 4, 8 or 16, several kx taps per 16-deep step
  when CG < 16, the output channels padded to a multiple of 16 (at most 64
  per block).  ``pack_weights`` lays the weights out in that order once per
  weight tensor (cached while the tensor is unchanged).  SPyNet's convs are
  bound by their operations at the bf16 tensor rate, the ctx conv by writing
  its output.  For C <= 8 the outputs whose sum nearly cancels are recomputed
  in the float32 FMA order of the direct kernel (the tensor cores keep fewer
  low bits than a float32 sum there); ``abs_weight_sums`` feeds that test.
* float32: the direct kernel on the CUDA cores, exact float32 (no TF32),
  bound by its FMAs: a 64 x 8 pixel tile and 16 output channels per block,
  input channels walked in chunks of 8 staged in shared memory.
"""

from collections import OrderedDict

import torch
import torch.nn.functional as F

from memcnet_tpu_torch.ops.cuda import _lib

counter = _lib.LaunchCounter("conv2d_small")
KERNEL_SIZES = (3, 5, 7)
MAX_N = 64  # output channels per block of the bf16 kernel (its largest NT instance)
_PACK_CACHE_SIZE = 64
_packed = OrderedDict()  # weight tensor identity -> (weight, prepared), most recent last


def reference(x, w, b=None, relu=False):
    """Plain PyTorch version: the same conv in float32, rounded once."""
    K = w.shape[2]
    out = F.conv2d(x.float(), w.float(), None if b is None else b.float(), padding=K // 2)
    if relu:
        out = out.clamp(min=0.0)
    return out.to(x.dtype)


def pack_geometry(C, O, K):
    """The bf16 kernel's GEMM tiling of a (O, C, K, K) conv: channels per
    group CG, kx taps per 16-deep step TPS = 16 // CG, steps per kernel row
    G, channel chunks, output channels per block NT and output groups."""
    CG = 4 if C <= 4 else 8 if C <= 8 else 16
    TPS = 16 // CG
    NT = 16 * -(-min(O, MAX_N) // 16)
    return dict(CG=CG, TPS=TPS, G=-(-K // TPS), nchunks=-(-C // CG), NT=NT,
                n_groups=-(-O // NT))


def pack_weights(w, dtype):
    """(O, C, K, K) -> (n_groups, nchunks, K, G, NT, 16) in ``dtype``: for
    output-channel group og, channel chunk c, kernel row ky and step g, row n
    holds the 16-deep slice k = t * CG + ci of output channel og * NT + n, tap
    (ky, g * TPS + t), input channel c * CG + ci.  Taps past K, channels past
    C and output channels past O are zero."""
    O, C, K, _ = w.shape
    p = pack_geometry(C, O, K)
    CG, TPS, G, nch, NT, ng = (p[k] for k in ("CG", "TPS", "G", "nchunks", "NT", "n_groups"))
    wp = torch.zeros((ng * NT, nch * CG, K, G * TPS), dtype=dtype, device=w.device)
    wp[:O, :C, :, :K] = w.to(dtype)
    wp = wp.view(ng, NT, nch, CG, K, G, TPS).permute(0, 2, 4, 5, 1, 6, 3)
    return wp.reshape(ng, nch, K, G, NT, 16).contiguous()


def abs_weight_sums(w, dtype):
    """Per output channel (padded like pack_weights), the float32 sum of
    |w| over (c, ky, kx) in ``dtype``: with max|x| it bounds the size of the
    products the kernel sums, which sets its near-zero recompute threshold."""
    O, C, K, _ = w.shape
    p = pack_geometry(C, O, K)
    sums = torch.zeros(p["n_groups"] * p["NT"], dtype=torch.float32, device=w.device)
    sums[:O] = w.to(dtype).float().abs().sum((1, 2, 3))
    return sums


def _prepared_weights(w, dtype):
    """(pack_weights(w, dtype), abs_weight_sums(w, dtype)), computed once per
    weight tensor and reused while the tensor is alive and unmodified (the
    cache holds it)."""
    if w.is_inference():  # no version counter to tell a modified tensor
        return pack_weights(w, dtype), abs_weight_sums(w, dtype)
    key = (w.data_ptr(), w._version, tuple(w.shape), w.dtype, dtype, w.device)
    hit = _packed.get(key)
    if hit is not None:
        _packed.move_to_end(key)
        return hit[1]
    prepared = pack_weights(w, dtype), abs_weight_sums(w, dtype)
    _packed[key] = (w, prepared)
    if len(_packed) > _PACK_CACHE_SIZE:
        _packed.popitem(last=False)
    return prepared


def launch(x, w, b=None, relu=False):
    what = "conv2d_small"
    B, C, H, W = x.shape
    O, Cw, K, K2 = w.shape
    if Cw != C or K != K2 or K not in KERNEL_SIZES:
        raise ValueError(f"{what}: weight {tuple(w.shape)} does not fit input {tuple(x.shape)} "
                         f"(square odd K in {KERNEL_SIZES})")
    _lib.dtype_code(x.dtype)  # raises on a type the kernels do not take
    x = x.contiguous()
    w = w.contiguous()
    bias = None if b is None else b.float().contiguous()
    bias_ptr = None if bias is None else bias.data_ptr()
    _lib.check_cuda_args(what, x, w, *(() if bias is None else (bias,)))
    lib = _lib.lib()
    out = torch.empty((B, O, H, W), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        p = pack_geometry(C, O, K)
        wp, wabs = _prepared_weights(w, x.dtype)
        err = lib.memc_conv2d_igemm(
            x.data_ptr(), wp.data_ptr(), wabs.data_ptr(), bias_ptr, out.data_ptr(),
            B, C, H, W, O, K, p["CG"], p["NT"], int(relu), _lib.stream_ptr(x))
    else:
        w = w.to(x.dtype)
        err = lib.memc_conv2d_small(
            x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
            B, C, H, W, O, K, int(relu), _lib.stream_ptr(x))
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
