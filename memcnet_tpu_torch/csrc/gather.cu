// K5 -- bilinear grid sample (grid_sample, zeros padding, align_corners=True).
//
// Replaces the TPU kernel memcnet_tpu/ops/pallas/gather_kernel.py::gather_bands
// (kernel _gather_kernel), whose one model use is nn/layers.py::
// grid_sample_bilinear through _grid_sample_fast: SPyNet's backward warp of
// the second frame, one call per pyramid level.  Per output pixel p and
// channel c, with (gx, gy) = ((grid + 1) * (W - 1) / 2, (grid + 1) * (H - 1) / 2)
// in float32:
//   out[c, p] = sum over the four taps (x0 + i, y0 + j), i, j in {0, 1}, of
//               x[c, tap] * w_ij, with x0 = floor(gx), y0 = floor(gy) and the
//               bilinear weights w_ij; a tap outside [0, W-1] x [0, H-1] adds 0.
// Weights and sums are float32; the result is rounded once to x's type, as the
// Pallas kernel does.
//
// Bound on the H100: memory -- x read once, the float32 grid read once, the
// output written once (4 loads and 4 FMAs per output value).  The TPU kernel's
// band plan, zero-ring pre-pad, 128-lane source padding and gather_ok budget
// were DMA geometry; here one thread per output pixel computes the four
// weights and tap offsets once and reuses them for every channel, and the
// zero ring becomes a bounds test per tap (weight 0, address clamped).
// Neighbouring threads read neighbouring grid entries and write neighbouring
// output words; smooth flows keep their taps in the same L1/L2 lines.
#include "common.cuh"

namespace memc {

template <typename T>
__global__ void __launch_bounds__(256)
grid_sample_kernel(const T* __restrict__ x, const float2* __restrict__ grid, T* __restrict__ out,
                   int C, int H, int W, int64_t HWo, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t b = idx / HWo;
  const int64_t p = idx - b * HWo;
  const float2 g = grid[idx];
  // same order as _grid_sample_xla (layers.py:336-337): (g + 1) * (W - 1) / 2;
  // clamping to [-2, W + 1] keeps the int conversion finite and changes no
  // output: every tap of a clamped landing is outside the frame either way
  float gx = (g.x + 1.f) * static_cast<float>(W - 1) * 0.5f;
  float gy = (g.y + 1.f) * static_cast<float>(H - 1) * 0.5f;
  gx = fminf(fmaxf(gx, -2.f), static_cast<float>(W) + 1.f);
  gy = fminf(fmaxf(gy, -2.f), static_cast<float>(H) + 1.f);
  const float fx0 = floorf(gx);
  const float fy0 = floorf(gy);
  const float wx = gx - fx0;
  const float wy = gy - fy0;
  const int x0 = static_cast<int>(fx0);
  const int y0 = static_cast<int>(fy0);

  // tap (j, i) at (y0 + j, x0 + i): weight 0 and offset 0 when outside
  float w[4];
  int64_t off[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int xi = x0 + i;
      const int yj = y0 + j;
      const bool in = xi >= 0 && xi < W && yj >= 0 && yj < H;
      const float wt = (i ? wx : 1.f - wx) * (j ? wy : 1.f - wy);
      w[2 * j + i] = in ? wt : 0.f;
      off[2 * j + i] = in ? static_cast<int64_t>(yj) * W + xi : 0;
    }
  }

  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* xb = x + b * C * plane;
  T* ob = out + b * C * HWo + p;
  for (int c = 0; c < C; ++c) {
    const T* xc = xb + c * plane;
    float acc = to_f32(xc[off[0]]) * w[0];
    acc = fmaf(to_f32(xc[off[1]]), w[1], acc);
    acc = fmaf(to_f32(xc[off[2]]), w[2], acc);
    acc = fmaf(to_f32(xc[off[3]]), w[3], acc);
    ob[c * HWo] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch_grid_sample(const T* x, const float* grid, T* out, int B, int C, int H, int W,
                               int Ho, int Wo, cudaStream_t stream) {
  const int64_t HWo = static_cast<int64_t>(Ho) * Wo;
  const int64_t total = static_cast<int64_t>(B) * HWo;
  grid_sample_kernel<T><<<ceil_div(total, 256), 256, 0, stream>>>(
      x, reinterpret_cast<const float2*>(grid), out, C, H, W, HWo, total);
  return cudaGetLastError();
}

}  // namespace memc

// x: (B, C, H, W) in dtype; grid: (B, Ho, Wo, 2) float32, [..., 0] = x;
// out: (B, C, Ho, Wo) in dtype.
MEMC_API int memc_grid_sample(const void* x, const void* grid, void* out, int B, int C, int H,
                              int W, int Ho, int Wo, int dtype, void* stream) {
  if (B == 0 || C == 0 || Ho == 0 || Wo == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(grid);
  if (dtype == memc::kFloat32) {
    return memc::launch_grid_sample(static_cast<const float*>(x), g, static_cast<float*>(out), B,
                                    C, H, W, Ho, Wo, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_grid_sample(static_cast<const __nv_bfloat16*>(x), g,
                                    static_cast<__nv_bfloat16*>(out), B, C, H, W, Ho, Wo, st);
  }
  return cudaErrorInvalidValue;
}
