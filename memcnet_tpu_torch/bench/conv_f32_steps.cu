// The design steps of K4's float32 body, for timing only
// (memcnet_tpu_torch/bench/kernel_ab.py builds this file with nvcc and loads
// it with ctypes; it is not part of the kernel library).  Each step runs
// memc_conv2d_small's function:
//   0  the direct kernel that was K4's float32 body before the tensor-core
//      one: exact float32 FMAs on the CUDA cores, a 64 x 8 pixel tile and 16
//      output channels a block, input channels in chunks of 8 staged in
//      shared memory, 2 pixels x 16 channels of sums a thread (w is the
//      plain (O, C, K, K) weight);
//   1  the 3xTF32 body (csrc/conv_f32.cu) at the geometry (CG, NT, MT, taps)
//      given, w packed for it by ops/cuda/conv_kernel.py (pack_f32_weights,
//      or pack_f32_tap_weights with taps); kernel_ab.py times the first
//      GEMM's geometry (MT = 2, NT at least 16), NT = 8 for O <= 8, the wave
//      fitting (MT at most 2), MT = 4 for NT of 16 and 32, and as built
//      (f32_geometry: the taps in N for O * K <= 16), which must give the
//      entry's bits;
//   2  the body at the geometry given with one TF32 pass (hi * hi) for
//      K = 7: TF32 precision, not float32's; timed only, to show what the
//      two extra passes cost;
//   3  the GEMM for K = 7, CG = 8 and (NT, MT) of (64, 2) or (32, 4) with at
//      most one block an SM (255 registers a thread, no spills; 8 warps an
//      SM for 16): the same bits as step 1 (tried, slower);
//   4  the GEMM for K = 7 with each chunk's halo split once into (hi, lo)
//      pairs in shared memory after it lands, not each fragment in
//      registers as it is loaded (STAGED): the same bits (tried, slower);
//   5  the GEMM for K = 7 with raw weights (pack_f32_weights(split=False))
//      split in registers as they are loaded (WSPLIT off): half the weight
//      bytes read from shared memory, the same bits.
#include "conv_f32.cu"

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

template <int K>
__global__ void __launch_bounds__(32 * kTileH)
conv2d_direct_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out, int C, int H, int W,
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
    const float* xb = x + (static_cast<int64_t>(b) * C + c0) * plane;
    for (int i = tid; i < cn * SH * SW; i += 32 * kTileH) {
      const int c = i / (SH * SW);
      const int rem = i - c * (SH * SW);
      const int r = rem / SW;
      const int q = rem - r * SW;
      const int gy = y0 - P + r;
      const int gx = x0 - P + q;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[c * plane + static_cast<int64_t>(gy) * W + gx];
      in_s[i] = v;
    }
    // the chunk's taps (c, ky, kx) are contiguous in each output channel's row
    const int ctaps = cn * K * K;
    for (int i = tid; i < ctaps * kOutGroup; i += 32 * kTileH) {
      const int tap = i / kOutGroup;
      const int oc = og * kOutGroup + (i - tap * kOutGroup);
      w_s[i] = oc < O ? w[static_cast<int64_t>(oc) * taps + c0 * K * K + tap] : 0.f;
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
  float* ob = out + static_cast<int64_t>(b) * O * plane + static_cast<int64_t>(y) * W;
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
        ob[oc * plane + xx] = v;
      }
    }
  }
}

template <int K>
cudaError_t launch_direct_k(const float* x, const float* w, const float* bias, float* out, int B,
                            int C, int H, int W, int O, int relu, cudaStream_t stream) {
  const int CC = C < kChanChunk ? C : kChanChunk;
  size_t in_floats = 0;
  const size_t smem = sizeof(float) * conv_smem_floats(CC, K, &in_floats);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv2d_direct_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_groups = ceil_div(O, kOutGroup);
  const dim3 grid(ceil_div(W, kTileW), ceil_div(H, kTileH), B * n_groups);
  const dim3 block(32, kTileH);
  conv2d_direct_kernel<K><<<grid, block, smem, stream>>>(x, w, bias, out, C, H, W, O, relu,
                                                         n_groups, CC, static_cast<int>(in_floats));
  return cudaGetLastError();
}

}  // namespace memc

MEMC_API int memc_conv_f32_step(int step, const void* x, const void* w, const void* bias,
                                void* out, int B, int C, int H, int W, int O, int K, int CG,
                                int NT, int MT, int taps, int relu, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  const auto* bs = static_cast<const float*>(bias);
  auto* os = static_cast<float*>(out);
  if (step == 0) {
    const auto* ws = static_cast<const float*>(w);
    switch (K) {
      case 3: return memc::launch_direct_k<3>(xs, ws, bs, os, B, C, H, W, O, relu, st);
      case 5: return memc::launch_direct_k<5>(xs, ws, bs, os, B, C, H, W, O, relu, st);
      case 7: return memc::launch_direct_k<7>(xs, ws, bs, os, B, C, H, W, O, relu, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (step == 1) {
    return memc_conv2d_small(x, w, bias, out, B, C, H, W, O, K, CG, NT, MT, taps, relu, stream);
  }
  if (step == 3 && K == 7 && CG == 8 && !taps) {
    const auto* ws = static_cast<const float4*>(w);
    if (NT == 64 && MT == 2) {
      return memc::launch_tf32_t<7, 8, 64, 2, 3, 1>(xs, ws, bs, os, B, C, H, W, O, relu, st);
    }
    if (NT == 32 && MT == 4) {
      return memc::launch_tf32_t<7, 8, 32, 4, 3, 1>(xs, ws, bs, os, B, C, H, W, O, relu, st);
    }
    return cudaErrorInvalidValue;
  }
  if ((step == 4 || step == 5) && K == 7 && !taps) {
    const auto* ws = static_cast<const float4*>(w);
    return step == 4
               ? memc::launch_tf32_c<7, 3, 1>(xs, ws, bs, os, B, C, H, W, O, CG, NT, MT, relu, st)
               : memc::launch_tf32_c<7, 3, 2>(xs, ws, bs, os, B, C, H, W, O, CG, NT, MT, relu, st);
  }
  if (step == 2 && K == 7) {
    return memc::launch_f32_k<7, 1>(xs, static_cast<const float4*>(w), bs, os, B, C, H, W, O, CG,
                                    NT, MT, taps, relu, st);
  }
  return cudaErrorInvalidValue;
}
