// K2's tile entry (memc_project_tile_sums: a memset of S, the scatter, the
// raw fold) in steps, for timing only (memcnet_tpu_torch/bench/kernel_ab.py
// builds this file with nvcc and loads it with ctypes; it is not part of the
// kernel library).  Steps, each one launch on the caller's stream:
//   STEP 0  the memset of S, three float32 planes of each tile's extended
//           buffer;
//   STEP 1  the scatter as built (csrc/project.cu: a 3D grid, 32-bit offsets);
//   STEP 2  the first design's scatter: one thread per pixel on a 1D grid,
//           64-bit divisions;
//   STEP 3  the raw fold as built (a warp walks a 32-column strip, each S
//           value loaded once);
//   STEP 4  the first design's fold: one thread per element of every plane,
//           64-bit divisions, each S value loaded four times;
//   STEP 5  the memset of S4, S interleaved as (x, y, count, 0) per cell;
//   STEP 6  the scatter with one 4-wide vector atomic a pixel into S4
//           (sm_90's float4 atomicAdd, where the toolkit has it);
//   STEP 7  the raw fold of S4 into the three planes of out.
// Steps 1, 2 and 6 add into S or S4 (zero it first for a result); steps 3, 4
// and 7 read it.  Steps 3, 4 and 7 give the same bits from the same sums.
#include "project.cu"

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define MEMC_VEC_ATOMIC 1
#else
#define MEMC_VEC_ATOMIC 0
#endif

namespace memc {

template <typename T>
__global__ void __launch_bounds__(256)
first_tile_scatter_kernel(const T* __restrict__ flow, const int* __restrict__ origins,
                          float* __restrict__ sums, int H, int W, int halo, int halo_h, int Hg,
                          int Wg, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t b = idx / HW;
  const int64_t p = idx - b * HW;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const T* f = flow + 2 * b * HW + p;
  float fx = to_f32(f[0]);
  float fy = to_f32(f[HW]);
  const float bx = static_cast<float>(halo - 1);
  fx = fx < -bx ? -bx : (fx > bx ? bx : fx);
  if (halo_h) {
    const float by = static_cast<float>(halo_h - 1);
    fy = fy < -by ? -by : (fy > by ? by : fy);
  }
  const int x0 = origins[2 * b], y0 = origins[2 * b + 1];
  const float x2 = static_cast<float>(x0 + x) + fx;
  const float y2 = static_cast<float>(y0 + y) + fy;
  if (!(x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(Wg - 1) &&
        y2 <= static_cast<float>(Hg - 1)))
    return;
  const int He = H + 2 * halo_h, We = W + 2 * halo;
  const int ix = clampi(clampi(__float2int_rz(x2), 0, Wg - 1) - x0 + halo, 0, We - 1);
  const int iy = clampi(clampi(__float2int_rz(y2), 0, Hg - 1) - y0 + halo_h, 0, He - 1);
  const int64_t HWe = static_cast<int64_t>(He) * We;
  float* s = sums + 3 * b * HWe + static_cast<int64_t>(iy) * We + ix;
  atomicAdd(s, -fx);
  atomicAdd(s + HWe, -fy);
  atomicAdd(s + 2 * HWe, 1.f);
}

__global__ void __launch_bounds__(256)
first_raw_fold_kernel(const float* __restrict__ sums, float* __restrict__ out, int H, int W,
                      int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t q = idx / HW;
  const int64_t p = idx - q * HW;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const float* plane = sums + q * HW;
  const float t = fold_x(plane, y, x, W);
  const float tp = y > 0 ? fold_x(plane, y - 1, x, W) : 0.f;
  out[idx] = t + fold_term(tp, t, y, H);
}

// STEP 6: the scatter of project_tile_scatter_kernel with one float4 atomic
template <typename T>
__global__ void __launch_bounds__(256)
vec_tile_scatter_kernel(const T* __restrict__ flow, const int* __restrict__ origins,
                        float4* __restrict__ sums4, int H, int W, int halo, int halo_h, int Hg,
                        int Wg) {
#if MEMC_VEC_ATOMIC && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int b = blockIdx.z;
  const int HW = H * W;
  const T* f = flow + static_cast<int64_t>(b) * 2 * HW + y * W + x;
  float fx = to_f32(f[0]);
  float fy = to_f32(f[HW]);
  const float bx = static_cast<float>(halo - 1);
  fx = fx < -bx ? -bx : (fx > bx ? bx : fx);
  if (halo_h) {
    const float by = static_cast<float>(halo_h - 1);
    fy = fy < -by ? -by : (fy > by ? by : fy);
  }
  const int x0 = origins[2 * b], y0 = origins[2 * b + 1];
  const float x2 = static_cast<float>(x0 + x) + fx;
  const float y2 = static_cast<float>(y0 + y) + fy;
  if (!(x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(Wg - 1) &&
        y2 <= static_cast<float>(Hg - 1)))
    return;
  const int He = H + 2 * halo_h, We = W + 2 * halo;
  const int ix = clampi(clampi(__float2int_rz(x2), 0, Wg - 1) - x0 + halo, 0, We - 1);
  const int iy = clampi(clampi(__float2int_rz(y2), 0, Hg - 1) - y0 + halo_h, 0, He - 1);
  atomicAdd(sums4 + static_cast<int64_t>(b) * He * We + iy * We + ix,
            make_float4(-fx, -fy, 1.f, 0.f));
#endif
}

// STEP 7: project_raw_fold_kernel on S4, component c of tile b as plane 3 b + c
__global__ void __launch_bounds__(kTile * kTileWarps)
vec_raw_fold_kernel(const float4* __restrict__ sums4, float* __restrict__ out, int H, int W) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kTile + lane;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * kFoldRows;
  if (y0 >= H) return;
  const int HW = H * W;
  const float4* s = sums4 + static_cast<int64_t>(blockIdx.z) * HW;
  float* o = out + static_cast<int64_t>(blockIdx.z) * 3 * HW;
  const bool in = x < W;
  float tp[3] = {0.f, 0.f, 0.f};
  for (int r = 0; r <= kFoldRows; ++r) {
    const int y = y0 - 1 + r;
    const bool row = y >= 0 && y < H;
    const float4 c4 = row && in ? s[y * W + x] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 l4 = row && lane == 0 && x > 0 ? s[y * W + x - 1]
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    const float cur[3] = {c4.x, c4.y, c4.z}, left[3] = {l4.x, l4.y, l4.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float from_left = __shfl_up_sync(kFullMask, cur[c], 1);
      const float t = cur[c] + fold_term(lane == 0 ? left[c] : from_left, cur[c], x, W);
      if (r > 0 && in && y < H) o[c * HW + y * W + x] = t + fold_term(tp[c], t, y, H);
      tp[c] = t;
    }
  }
}

template <typename T>
cudaError_t tile_sums_step(int step, const T* flow, const int* origins, float* sums, float* out,
                           int B, int H, int W, int halo, int halo_h, int Hg, int Wg,
                           cudaStream_t st) {
  const int He = H + 2 * halo_h, We = W + 2 * halo;
  const int64_t cells = static_cast<int64_t>(B) * He * We;
  const dim3 tiles(words_for(W), ceil_div(H, 8), B), block(32, 8);
  switch (step) {
    case 0:
      return cudaMemsetAsync(sums, 0, sizeof(float) * 3 * cells, st);
    case 1:
      project_tile_scatter_kernel<T><<<tiles, block, 0, st>>>(flow, origins, sums, H, W, halo,
                                                              halo_h, Hg, Wg);
      break;
    case 2: {
      const int64_t total = static_cast<int64_t>(B) * H * W;
      first_tile_scatter_kernel<T><<<ceil_div(total, 256), 256, 0, st>>>(
          flow, origins, sums, H, W, halo, halo_h, Hg, Wg, total);
      break;
    }
    case 3:
      return launch_raw_fold(sums, out, 3 * B, He, We, st);
    case 4:
      first_raw_fold_kernel<<<ceil_div(3 * cells, 256), 256, 0, st>>>(sums, out, He, We,
                                                                       3 * cells);
      break;
    case 5:
      return cudaMemsetAsync(sums, 0, sizeof(float4) * cells, st);
    case 6:
      if (!MEMC_VEC_ATOMIC) return cudaErrorNotSupported;
      vec_tile_scatter_kernel<T><<<tiles, block, 0, st>>>(
          flow, origins, reinterpret_cast<float4*>(sums), H, W, halo, halo_h, Hg, Wg);
      break;
    case 7:
      vec_raw_fold_kernel<<<dim3(words_for(We), ceil_div(He, kTileWarps * kFoldRows), B),
                            dim3(kTile, kTileWarps), 0, st>>>(
          reinterpret_cast<const float4*>(sums), out, He, We);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace memc

// flow (B, 2, H, W) tiles, origins (B, 2) int32, as memc_project_tile_sums;
// sums: (B, 3, He, We) float32 for steps 0-4, (B, He, We, 4) for steps 5-7;
// out (B, 3, He, We) float32.
MEMC_API int memc_tile_sums_step(int step, const void* flow, const void* origins, void* sums,
                                 void* out, int B, int H, int W, int halo, int halo_h, int Hg,
                                 int Wg, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(origins);
  auto* s = static_cast<float*>(sums);
  auto* r = static_cast<float*>(out);
  if (dtype == memc::kFloat32) {
    return memc::tile_sums_step(step, static_cast<const float*>(flow), o, s, r, B, H, W, halo,
                                halo_h, Hg, Wg, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::tile_sums_step(step, static_cast<const __nv_bfloat16*>(flow), o, s, r, B, H, W,
                                halo, halo_h, Hg, Wg, st);
  }
  return cudaErrorInvalidValue;
}

// 1 where STEP 6's vector atomic was compiled in
MEMC_API int memc_tile_sums_vec_atomic() { return MEMC_VEC_ATOMIC; }
