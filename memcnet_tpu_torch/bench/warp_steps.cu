// K1's design steps, for timing only (memcnet_tpu_torch/bench/kernel_ab.py
// builds this file with nvcc and loads it with ctypes; it is not part of the
// kernel library).  One per-pixel gather kernel with the knobs that were
// tried on the way to csrc/warp.cu's design:
//   BX x BY   the block's pixel tile (the earlier one-thread-per-pixel kernel
//             used 128 x 1);
//   VEC       bf16 interior patches read with two aligned 8-byte loads per
//             filter row and a funnel shift instead of four 2-byte gathers;
//   DIAG 1    every tap reads the pixel itself (the instruction floor of 16
//             loads per channel with perfect locality);
//   DIAG 2    one gather per filter row (4 per channel).
// DIAG variants compute something else and are timed only.
#include <type_traits>

#include "warp.cu"

namespace memc {

__device__ __forceinline__ uint2 ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

template <typename T, int BX, int BY, bool VEC, int DIAG>
__global__ void __launch_bounds__(BX * BY)
step_kernel(WarpSources s, const float* __restrict__ flow, const T* __restrict__ filt, int H, int W) {
  constexpr int FS = 4;
  using Off = int64_t;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const Off plane = static_cast<Off>(H) * W;
  const Off pix = static_cast<Off>(y) * W + x;
  const float fx = flow[(2 * b) * plane + pix];
  const float fy = flow[(2 * b + 1) * plane + pix];
  const float x2 = static_cast<float>(x) + fx;
  const float y2 = static_cast<float>(y) + fy;
  const bool valid = x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(W - 1) &&
                     y2 <= static_cast<float>(H - 1) && fabsf(fx) < 0.5f * W && fabsf(fy) < 0.5f * H;
  if (!valid) {
    for (int k = 0; k < s.n; ++k) {
      const int C = s.channels[k];
      const T* src = static_cast<const T*>(s.src[k]) + b * C * plane + pix;
      T* out = static_cast<T*>(s.out[k]) + b * C * plane + pix;
      for (int c = 0; c < C; ++c) out[c * plane] = src[c * plane];
    }
    return;
  }
  const int ix = clampi(static_cast<int>(x2), 0, W - 1);
  const int iy = clampi(static_cast<int>(y2), 0, H - 1);
  const float alpha = x2 - static_cast<float>(ix);
  const float beta = y2 - static_cast<float>(iy);
  constexpr int half = FS / 2;
  Off row[FS];
  int col[FS];
#pragma unroll
  for (int j = 0; j < FS; ++j) row[j] = static_cast<Off>(clampi(iy + 1 - half + j, 0, H - 1)) * W;
#pragma unroll
  for (int i = 0; i < FS; ++i) col[i] = clampi(ix + 1 - half + i, 0, W - 1);
  if (DIAG == 1) {
#pragma unroll
    for (int j = 0; j < FS; ++j) row[j] = static_cast<Off>(y) * W;
#pragma unroll
    for (int i = 0; i < FS; ++i) col[i] = x;
  }
  const int c0 = ix + 1 - half;
  const int c4 = c0 & ~3;
  // vector rows: bf16 only, interior patches of 8-byte aligned rows (W % 4 == 0)
  const bool vec = VEC && !std::is_same<T, float>::value && W % 4 == 0 && DIAG == 0 && c0 >= 0 &&
                   c4 + 8 <= W;
  const int sel_hi = (c0 >> 1) & 1;
  const int shift = 16 * (c0 & 1);
  float wt[FS * FS];
  const T* fp = filt + static_cast<Off>(b) * FS * FS * plane + pix;
#pragma unroll
  for (int j = 0; j < FS; ++j) {
    const float wy = j >= half ? beta : 1.f - beta;
#pragma unroll
    for (int i = 0; i < FS; ++i) {
      const float wx = i >= half ? alpha : 1.f - alpha;
      wt[j * FS + i] = round_to<T>(to_f32(fp[(j * FS + i) * plane]) * wy * wx);
    }
  }
  for (int k = 0; k < s.n; ++k) {
    const int C = s.channels[k];
    const T* src = static_cast<const T*>(s.src[k]) + b * C * plane;
    T* out = static_cast<T*>(s.out[k]) + b * C * plane + pix;
    for (int c = 0; c < C; ++c) {
      const T* sp = src + c * plane;
      float acc = 0.f;
      if (VEC && vec) {
#pragma unroll
        for (int j = 0; j < FS; ++j) {
          const uint2 lo = ld2(reinterpret_cast<const __nv_bfloat16*>(sp + row[j] + c4));
          const uint2 hi = ld2(reinterpret_cast<const __nv_bfloat16*>(sp + row[j] + c4 + 4));
          const uint32_t u0 = sel_hi ? lo.y : lo.x;
          const uint32_t u1 = sel_hi ? hi.x : lo.y;
          const uint32_t u2 = sel_hi ? hi.y : hi.x;
          const uint32_t t01 = __funnelshift_r(u0, u1, shift);
          const uint32_t t23 = __funnelshift_r(u1, u2, shift);
          acc = fmaf(wt[j * FS + 0], __uint_as_float(t01 << 16), acc);
          acc = fmaf(wt[j * FS + 1], __uint_as_float(t01 & 0xffff0000u), acc);
          acc = fmaf(wt[j * FS + 2], __uint_as_float(t23 << 16), acc);
          acc = fmaf(wt[j * FS + 3], __uint_as_float(t23 & 0xffff0000u), acc);
        }
      } else if (DIAG == 2) {
#pragma unroll
        for (int j = 0; j < FS; ++j) {
          acc = fmaf(wt[j * FS] + wt[j * FS + 1] + wt[j * FS + 2] + wt[j * FS + 3],
                     to_f32(sp[row[j] + col[j]]), acc);
        }
      } else {
#pragma unroll
        for (int j = 0; j < FS; ++j)
#pragma unroll
          for (int i = 0; i < FS; ++i) acc = fmaf(wt[j * FS + i], to_f32(sp[row[j] + col[i]]), acc);
      }
      out[c * plane] = from_f32<T>(acc);
    }
  }
}

template <typename T, int BX, int BY, bool VEC, int DIAG>
int step(const WarpSources& s, const float* fl, const T* fi, int B, int H, int W, cudaStream_t st) {
  step_kernel<T, BX, BY, VEC, DIAG>
      <<<dim3(ceil_div(W, BX), ceil_div(H, BY), B), dim3(BX, BY), 0, st>>>(s, fl, fi, H, W);
  return cudaGetLastError();
}

template <typename T>
int run_step(int v, const WarpSources& s, const float* fl, const T* fi, int B, int H, int W,
             cudaStream_t st) {
  switch (v) {
    case 0: return step<T, 128, 1, false, 0>(s, fl, fi, B, H, W, st);
    case 1: return step<T, 32, 4, false, 0>(s, fl, fi, B, H, W, st);
    case 2: return step<T, 128, 1, true, 0>(s, fl, fi, B, H, W, st);
    case 3: return step<T, 32, 4, true, 0>(s, fl, fi, B, H, W, st);
    case 4: return step<T, 128, 1, false, 1>(s, fl, fi, B, H, W, st);
    case 5: return step<T, 128, 1, false, 2>(s, fl, fi, B, H, W, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace memc

MEMC_API int memc_warp_step(int v, const memc::WarpSources* s, const void* flow, const void* filt,
                            int B, int H, int W, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fl = static_cast<const float*>(flow);
  if (dtype == memc::kFloat32) {
    return memc::run_step(v, *s, fl, static_cast<const float*>(filt), B, H, W, st);
  }
  return memc::run_step(v, *s, fl, static_cast<const __nv_bfloat16*>(filt), B, H, W, st);
}
