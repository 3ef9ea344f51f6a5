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

Two kernel bodies, chosen by dtype (no switch, no fallback):

* bf16 (``csrc/conv.cu``): a tensor-core implicit GEMM (``mma.sync``
  m16n8k16, float32 accumulators).  The GEMM's depth is C x K x K in (ky, kx,
  c) order, the channels in groups of CG = 4, 8 or 16, several kx taps per
  16-deep step when CG < 16, the output channels padded to a multiple of 16
  (at most 64 per block).  ``pack_weights`` lays the weights out in that
  order once per weight tensor (cached while the tensor is unchanged).
  SPyNet's convs are bound by their operations at the bf16 tensor rate, the
  ctx conv by writing its output.  For C <= 8 the outputs whose sum nearly
  cancels are recomputed in a float32 FMA chain (the tensor cores keep fewer
  low bits than a float32 sum there); ``abs_weight_sums`` feeds that test.
* float32 (``csrc/conv_f32.cu``): a 3xTF32 tensor-core implicit GEMM
  (``mma.sync`` m16n8k8 TF32, float32 accumulators): each operand split into
  a TF32 high part and a TF32 remainder (``split_tf32``), each product taken
  as lo*hi + hi*lo + hi*hi, the counterpart of the Pallas kernel's
  Precision.HIGHEST dot (``tf32x3_reference`` is the same arithmetic in
  plain PyTorch).  ``pack_f32_weights`` splits and packs the weights once per
  weight tensor and geometry.  Bound by 3 x its operations at 495 TFLOP/s
  (TF32).  ``f32_geometry`` picks the launch by shape: channel chunks of
  CG = 4 (C <= 4, two kx taps per 8-deep step) or 8; NT = 8, 16, 32 or 64
  output channels a block, the least that holds O (at most 64); a block
  8 * MT rows of 16 pixels, MT = 4 for NT of 16 or 32 and 2 for 64; then,
  while the launch has fewer than two blocks for each of the H100's 132
  SMs, MT halved down to 1 and then NT halved down to 8 (more output-channel
  groups).  Where O * K <= 16 and C <= 64 (SPyNet's 16 -> 2 convs) it runs
  the small-O variant instead: N = (o, kx), so that an MMA's columns hold
  taps rather than 6 of 8 padding channels, and a shifted sum over kx in
  the epilogue (``pack_f32_tap_weights``).
"""

from collections import OrderedDict

import torch
import torch.nn.functional as F

from memcnet_tpu_torch.ops.cuda import _lib

counter = _lib.LaunchCounter("conv2d_small")
# the float32 body's launches alone (counted in ``counter`` too)
f32_counter = _lib.LaunchCounter("conv2d_small[float32]")
KERNEL_SIZES = (3, 5, 7)
MAX_N = 64  # output channels per block of the bf16 kernel (its largest NT instance)
F32_NT = (8, 16, 32, 64)  # output channels per block of the float32 body
TAP_N = 16      # the float32 body's small-O variant: N = o * K + kx, padded to 16
TAP_MAX_C = 64  # ... with every chunk's weights staged at once
SMS = 132  # the H100's SMs; two blocks of the float32 body fit on one
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


def _cached(w, key, make):
    """``make()``, computed once per weight tensor and ``key`` and reused while
    the tensor is alive and unmodified (the cache holds it)."""
    if w.is_inference():  # no version counter to tell a modified tensor
        return make()
    key = (w.data_ptr(), w._version, tuple(w.shape), w.dtype, w.device) + key
    hit = _packed.get(key)
    if hit is not None:
        _packed.move_to_end(key)
        return hit[1]
    prepared = make()
    _packed[key] = (w, prepared)
    if len(_packed) > _PACK_CACHE_SIZE:
        _packed.popitem(last=False)
    return prepared


def _prepared_weights(w, dtype):
    """(pack_weights(w, dtype), abs_weight_sums(w, dtype)), cached per weight
    tensor (``_cached``)."""
    return _cached(w, (dtype,), lambda: (pack_weights(w, dtype), abs_weight_sums(w, dtype)))


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """(hi, lo): hi = TF32 of x, lo = TF32 of x - hi (exact in float32), so
    x = hi + lo to about 2^-22 of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32x3_reference(x, w, b=None, relu=False):
    """The float32 body's arithmetic in plain PyTorch: x and w split
    (``split_tf32``), the conv taken as conv(lo, hi) + conv(hi, lo) +
    conv(hi, hi) in float32 (products of two TF32 values are exact in
    float32; lo * lo, under 2^-22 of a product, is dropped), bias, ReLU."""
    K = w.shape[2]
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    out = (F.conv2d(xl, wh, padding=K // 2) + F.conv2d(xh, wl, padding=K // 2)
           + F.conv2d(xh, wh, padding=K // 2))
    if b is not None:
        out = out + b.float().view(1, -1, 1, 1)
    if relu:
        out = out.clamp(min=0.0)
    return out


def f32_geometry(B, C, H, W, O, K, *, small_o=True, max_mt=4):
    """The float32 body's launch for a (B, C, H, W) input and (O, C, K, K)
    weights: channels per chunk CG, kx taps per 8-deep step TPS = 8 // CG,
    steps per kernel row G, chunks, output channels per block NT and groups,
    pixel rows per warp MT (a block: 16 pixels by TH = 8 * MT rows), and
    ``taps``: the small-O variant, N = (o, kx), for O * K <= TAP_N and
    C <= TAP_MAX_C (NT = TAP_N, one group, CG = 8; a block 32 - (K - 1)
    output columns by TH rows).  Otherwise NT is the least of F32_NT that
    holds O (at most 64) and MT = 4 for NT of 16 or 32, else 2.  Then, while
    the launch has fewer than 2 * SMS blocks, MT halves down to 1, then NT
    (not with taps) down to 8.  ``small_o`` and ``max_mt`` give the earlier
    design steps' geometries (bench/conv_f32_steps.cu)."""
    taps = small_o and O * K <= TAP_N and C <= TAP_MAX_C
    CG = 8 if taps or C > 4 else 4
    TPS = 8 // CG
    NT = TAP_N if taps else next(n for n in F32_NT if n >= min(O, F32_NT[-1]))
    MT = min(max_mt, 4 if NT in (16, 32) and not taps else 2)
    width = 32 - (K - 1) if taps else 16

    def blocks():
        return -(-W // width) * -(-H // (8 * MT)) * B * -(-O // NT)

    while blocks() < 2 * SMS:
        if MT > 1:
            MT //= 2
        elif NT > F32_NT[0] and not taps:
            NT //= 2
        else:
            break
    return dict(CG=CG, TPS=TPS, G=-(-K // TPS), nchunks=-(-C // CG), NT=NT,
                n_groups=-(-O // NT), MT=MT, TH=8 * MT, taps=taps, width=width)


def pack_f32_weights(w, CG, NT, split=True):
    """(O, C, K, K) -> (n_groups, nchunks, K, G, NT, 4, 4) float32: for
    output-channel group og, chunk c, kernel row ky, step g, output channel n
    and thread t of an MMA group, (hi[t], hi[t + 4], lo[t], lo[t + 4]) of the
    8-deep slice k = tp * CG + ci (tap (ky, g * TPS + tp), input channel
    c * CG + ci) of output channel og * NT + n, split by ``split_tf32``.
    Taps past K, channels past C and output channels past O are zero.  With
    ``split=False`` (a design step of bench/conv_f32_steps.cu), (..., NT, 4,
    2): the raw (w[t], w[t + 4])."""
    O, C, K, _ = w.shape
    TPS = 8 // CG
    G, nch, ng = -(-K // TPS), -(-C // CG), -(-O // NT)
    wp = torch.zeros((ng * NT, nch * CG, K, G * TPS), dtype=torch.float32, device=w.device)
    wp[:O, :C, :, :K] = w.float()
    wp = wp.view(ng, NT, nch, CG, K, G, TPS).permute(0, 2, 4, 5, 1, 6, 3)
    wp = wp.reshape(ng, nch, K, G, NT, 8)
    if not split:
        return wp.view(ng, nch, K, G, NT, 2, 4).transpose(-1, -2).contiguous()
    return _split_fragments(wp)


def _split_fragments(wp):
    """(..., n, 8) weights, depth k = t + 4 j last -> (..., n, 4, 4): for
    thread t, (hi[t], hi[t + 4], lo[t], lo[t + 4]) (``split_tf32``)."""
    wp = wp.reshape(*wp.shape[:-1], 2, 4).transpose(-1, -2)
    hi, lo = split_tf32(wp)
    return torch.cat([hi, lo], dim=-1).contiguous()


def pack_f32_tap_weights(w):
    """The small-O variant's weights: (O, C, K, K) -> (nchunks, K, TAP_N, 4,
    4) float32: for chunk c and kernel row ky, column n = o * K + kx holds
    w[o, c * 8 + k, ky, kx] at depth k, split and laid out as
    ``pack_f32_weights``'s steps.  Columns past O * K and channels past C are
    zero."""
    O, C, K, _ = w.shape
    nch = -(-C // 8)
    wt = torch.zeros((TAP_N, nch * 8, K), dtype=torch.float32, device=w.device)
    wt[:O * K, :C] = w.float().permute(0, 3, 1, 2).reshape(O * K, C, K)
    return _split_fragments(wt.view(TAP_N, nch, 8, K).permute(1, 3, 0, 2))


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
        _lib.check(err, what)
    else:
        p = f32_geometry(B, C, H, W, O, K)
        wp = _cached(w, ("tf32x3", p["taps"], p["CG"], p["NT"]),
                     lambda: pack_f32_tap_weights(w) if p["taps"]
                     else pack_f32_weights(w, p["CG"], p["NT"]))
        err = lib.memc_conv2d_small(
            x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(), B, C, H, W, O, K,
            p["CG"], p["NT"], p["MT"], int(p["taps"]), int(relu), _lib.stream_ptr(x))
        _lib.check(err, what)
        f32_counter.count += 1
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
