// K4 -- direct convolution for small input-channel counts.
//
// Replaces the TPU kernel memcnet_tpu/ops/pallas/conv_kernel.py::conv2d_small
// (kernel _conv_kernel): stride 1, 'same' zero padding (K/2), odd K, optional
// fused bias and ReLU, float32 accumulation, NCHW in and out.  On the main
// paths it is the context extractor's 3 -> 64 7x7 conv (models/ctx.py) and
// every 7x7 conv of SPyNet's five-conv stacks, 8 -> 32 -> 64 -> 32 -> 16 -> 2,
// with ReLU fused on the first four (models/spynet.py).
//
// Bound on the H100: for the ctx conv in bf16 the output write (64 planes per
// input pixel triple) bounds the ideal kernel; SPyNet's convs are bound by
// their operations (up to 64*49 multiply-adds per output value), which the
// tensor cores would do at 989 TFLOP/s.  This direct form runs them on the
// float32 CUDA cores (67 TFLOP/s peak) and is bounded by those FMAs.
// Design: a block owns a 64 x 8 pixel tile and 16 output channels.  The input
// channels are staged in chunks of up to kChanChunk: each chunk's input tile
// plus its (K-1) halo (zero outside the image) and the block's 16-channel
// weight slice go to shared memory as float32 (56 KB at K = 7), the block
// accumulates the chunk into the same registers and synchronises before the
// next chunk overwrites the stage.  So shared memory no longer grows with C,
// and a C <= kChanChunk conv (the ctx conv) is one chunk, as before.  Each
// thread computes 2 pixels (x and x+32, so a warp reads consecutive shared
// words) x 16 output channels, reading the weights of one tap as four
// broadcast float4 loads that feed 32 FMAs.  With O = 2 (SPyNet's last conv)
// a block still computes 16 channels, 14 of them on zero weights: that conv
// is 1/16 of a SPyNet stack's work, so the waste is under 15% of the stack.
#include "common.cuh"

namespace memc {

constexpr int kTileW = 64;
constexpr int kTileH = 8;
constexpr int kOutGroup = 16;
constexpr int kChanChunk = 8;

// shared floats of one chunk of CC input channels: the input stage, then the
// weight stage (float4-aligned)
inline size_t conv_smem_floats(int CC, int K, size_t* in_floats) {
  const size_t sh = kTileH + K - 1, sw = kTileW + K - 1;
  *in_floats = (static_cast<size_t>(CC) * sh * sw + 3) & ~static_cast<size_t>(3);
  return *in_floats + static_cast<size_t>(CC) * K * K * kOutGroup;
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * kTileH)
conv2d_small_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out, int C, int H, int W,
                    int O, int relu, int n_groups, int CC, int in_floats) {
  extern __shared__ __align__(16) float sm[];
  constexpr int P = K / 2;
  constexpr int SH = kTileH + K - 1;
  constexpr int SW = kTileW + K - 1;
  float* in_s = sm;
  float* w_s = sm + in_floats;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / n_groups;
  const int og = blockIdx.z - b * n_groups;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int taps = C * K * K;

  float acc[2][kOutGroup];
#pragma unroll
  for (int o = 0; o < kOutGroup; ++o) acc[0][o] = acc[1][o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cn = min(CC, C - c0);
    if (c0 > 0) __syncthreads();  // every thread is done with the previous chunk
    const T* xb = x + (static_cast<int64_t>(b) * C + c0) * plane;
    for (int i = tid; i < cn * SH * SW; i += 32 * kTileH) {
      const int c = i / (SH * SW);
      const int rem = i - c * (SH * SW);
      const int r = rem / SW;
      const int q = rem - r * SW;
      const int gy = y0 - P + r;
      const int gx = x0 - P + q;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f32(xb[c * plane + static_cast<int64_t>(gy) * W + gx]);
      in_s[i] = v;
    }
    // the chunk's taps (c, ky, kx) are contiguous in each output channel's row
    const int ctaps = cn * K * K;
    for (int i = tid; i < ctaps * kOutGroup; i += 32 * kTileH) {
      const int tap = i / kOutGroup;
      const int oc = og * kOutGroup + (i - tap * kOutGroup);
      w_s[i] = oc < O ? to_f32(w[static_cast<int64_t>(oc) * taps + c0 * K * K + tap]) : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* rowp = in_s + (c * SH + ty + ky) * SW + tx;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float v0 = rowp[kx];
          const float v1 = rowp[kx + 32];
          const float4* wp = reinterpret_cast<const float4*>(w_s + ((c * K + ky) * K + kx) * kOutGroup);
#pragma unroll
          for (int q = 0; q < kOutGroup / 4; ++q) {
            const float4 wq = wp[q];
            acc[0][4 * q + 0] = fmaf(v0, wq.x, acc[0][4 * q + 0]);
            acc[0][4 * q + 1] = fmaf(v0, wq.y, acc[0][4 * q + 1]);
            acc[0][4 * q + 2] = fmaf(v0, wq.z, acc[0][4 * q + 2]);
            acc[0][4 * q + 3] = fmaf(v0, wq.w, acc[0][4 * q + 3]);
            acc[1][4 * q + 0] = fmaf(v1, wq.x, acc[1][4 * q + 0]);
            acc[1][4 * q + 1] = fmaf(v1, wq.y, acc[1][4 * q + 1]);
            acc[1][4 * q + 2] = fmaf(v1, wq.z, acc[1][4 * q + 2]);
            acc[1][4 * q + 3] = fmaf(v1, wq.w, acc[1][4 * q + 3]);
          }
        }
      }
    }
  }

  const int y = y0 + ty;
  if (y >= H) return;
  T* ob = out + static_cast<int64_t>(b) * O * plane + static_cast<int64_t>(y) * W;
#pragma unroll
  for (int o = 0; o < kOutGroup; ++o) {
    const int oc = og * kOutGroup + o;
    if (oc >= O) break;
    const float bv = bias != nullptr ? bias[oc] : 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int xx = x0 + tx + 32 * p;
      if (xx < W) {
        float v = acc[p][o] + bv;
        if (relu) v = fmaxf(v, 0.f);
        ob[oc * plane + xx] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int K>
cudaError_t launch_conv_k(const T* x, const T* w, const float* bias, T* out, int B, int C, int H,
                          int W, int O, int relu, cudaStream_t stream) {
  const int CC = C < kChanChunk ? C : kChanChunk;
  size_t in_floats = 0;
  const size_t smem = sizeof(float) * conv_smem_floats(CC, K, &in_floats);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv2d_small_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_groups = ceil_div(O, kOutGroup);
  const dim3 grid(ceil_div(W, kTileW), ceil_div(H, kTileH), B * n_groups);
  const dim3 block(32, kTileH);
  conv2d_small_kernel<T, K><<<grid, block, smem, stream>>>(x, w, bias, out, C, H, W, O, relu,
                                                           n_groups, CC, static_cast<int>(in_floats));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(const T* x, const T* w, const float* bias, T* out, int B, int C, int H,
                        int W, int O, int K, int relu, cudaStream_t stream) {
  switch (K) {
    case 3: return launch_conv_k<T, 3>(x, w, bias, out, B, C, H, W, O, relu, stream);
    case 5: return launch_conv_k<T, 5>(x, w, bias, out, B, C, H, W, O, relu, stream);
    case 7: return launch_conv_k<T, 7>(x, w, bias, out, B, C, H, W, O, relu, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace memc

// x: (B, C, H, W); w: (O, C, K, K) in x's type; bias: (O,) float32 or null;
// out: (B, O, H, W) in x's type.
MEMC_API int memc_conv2d_small(const void* x, const void* w, const void* bias, void* out, int B,
                               int C, int H, int W, int O, int K, int relu, int dtype,
                               void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0 || O == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bs = static_cast<const float*>(bias);
  if (dtype == memc::kFloat32) {
    return memc::launch_conv(static_cast<const float*>(x), static_cast<const float*>(w), bs,
                             static_cast<float*>(out), B, C, H, W, O, K, relu, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_conv(static_cast<const __nv_bfloat16*>(x),
                             static_cast<const __nv_bfloat16*>(w), bs,
                             static_cast<__nv_bfloat16*>(out), B, C, H, W, O, K, relu, st);
  }
  return cudaErrorInvalidValue;
}
