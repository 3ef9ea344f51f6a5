// K5's SPyNet level input in design steps, for timing only
// (memcnet_tpu_torch/bench/kernel_ab.py builds this file with nvcc and loads
// it with ctypes; it is not part of the kernel library).  The kernel of
// csrc/gather.cu with PIX pixels a thread and these steps:
//   STEP 0  as built (the coarse-flow values of a thread's PIX pixels loaded
//           once, a window of PIX / 2 + 2 columns of two rows);
//   STEP 1  every tap of snd at the pixel itself (the grid without the flow):
//           the gathers' spread costs nothing, the bound of what staging
//           snd's source box in shared memory could gain;
//   STEP 2  no sample: snd is not read, the warped channels are 0;
//   STEP 3  copy floor: fst copied, nothing else read, 5 channels of 0;
//   STEP 4  the first design: four coarse-flow loads a pixel, no window.
// Steps 1-3 compute something else and are timed only.
#include "gather.cu"

namespace memc {

template <typename T, int PIX, int STEP>
__global__ void __launch_bounds__(256)
level_step_kernel(const T* __restrict__ fst, const T* __restrict__ snd,
                  const T* __restrict__ flow, T* __restrict__ out, LevelArgs a, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / a.groups;
  const int x0 = static_cast<int>(idx - row * a.groups) * PIX;
  const int y = static_cast<int>(row % a.H);
  const int64_t b = row / a.H;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;
  const int64_t cplane = static_cast<int64_t>(a.h) * a.w;
  const int64_t pix = static_cast<int64_t>(y) * a.W + x0;
  const Lerp ly = up_lerp(min(y, 2 * a.h - 1), a.h, a.up_scale_y);
  const float lin_y = linspace_pm1(y, a.H, a.step_y);
  const T* fl = flow + b * 2 * cplane;
  const T* snd_b = snd + b * 3 * plane;

  constexpr int NW = PIX / 2 + 2;
  const int c0 = up_lerp(min(x0, 2 * a.w - 1), a.w, a.up_scale_x).i0;
  float win[2][2][NW];
  if (STEP != 4) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < NW; ++k)
          win[ch][r][k] =
              to_f32(fl[ch * cplane + (r ? ly.i1 : ly.i0) * a.w + min(c0 + k, a.w - 1)]);
  }

  Vec<T, PIX> o[8];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = *reinterpret_cast<const Vec<T, PIX>*>(fst + (b * 3 + c) * plane + pix);
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int x = x0 + j;
    if (STEP == 3) {
#pragma unroll
      for (int c = 3; c < 8; ++c) o[c].v[j] = from_f32<T>(0.f);
      continue;
    }
    const Lerp lx = up_lerp(min(x, 2 * a.w - 1), a.w, a.up_scale_x);
    float up[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      float v00, v01, v10, v11;
      if (STEP != 4) {
        v00 = pick(win[ch][0], lx.i0 - c0);
        v01 = pick(win[ch][0], lx.i1 - c0);
        v10 = pick(win[ch][1], lx.i0 - c0);
        v11 = pick(win[ch][1], lx.i1 - c0);
      } else {
        const T* r0 = fl + ch * cplane + ly.i0 * a.w;
        const T* r1 = fl + ch * cplane + ly.i1 * a.w;
        v00 = to_f32(r0[lx.i0]);
        v01 = to_f32(r0[lx.i1]);
        v10 = to_f32(r1[lx.i0]);
        v11 = to_f32(r1[lx.i1]);
      }
      const float v = lerp2(ly.l0, lerp2(lx.l0, v00, lx.l1, v01), ly.l1,
                            lerp2(lx.l0, v10, lx.l1, v11));
      up[ch] = round_to<T>(v) * 2.f;
      o[6 + ch].v[j] = from_f32<T>(up[ch]);
    }
    if (STEP == 2) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o[3 + c].v[j] = from_f32<T>(0.f);
      continue;
    }
    const float lin_x = linspace_pm1(x, a.W, a.step_x);
    const float gxn = STEP == 1 ? lin_x : __fadd_rn(lin_x, __fmul_rn(up[0], a.inv_x));
    const float gyn = STEP == 1 ? lin_y : __fadd_rn(lin_y, __fmul_rn(up[1], a.inv_y));
    const Taps t = grid_taps(gxn, gyn, a.H, a.W);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[3 + c].v[j] = from_f32<T>(sample(snd_b + c * plane, t));
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    *reinterpret_cast<Vec<T, PIX>*>(out + (b * 8 + c) * plane + pix) = o[c];
}

template <typename T, int PIX>
cudaError_t launch_step(int step, const T* fst, const T* snd, const T* flow, T* out, int B, int H,
                        int W, cudaStream_t st) {
  const LevelArgs a = level_args(H, W, PIX);
  const int64_t total = static_cast<int64_t>(B) * H * a.groups;
  const int blocks = ceil_div(total, 256);
  auto k = level_step_kernel<T, PIX, 0>;
  switch (step) {
    case 0: break;
    case 1: k = level_step_kernel<T, PIX, 1>; break;
    case 2: k = level_step_kernel<T, PIX, 2>; break;
    case 3: k = level_step_kernel<T, PIX, 3>; break;
    case 4: k = level_step_kernel<T, PIX, 4>; break;
    default: return cudaErrorInvalidValue;
  }
  k<<<blocks, 256, 0, st>>>(fst, snd, flow, out, a, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step_pix(int step, int pix, const void* fst, const void* snd, const void* flow,
                            void* out, int B, int H, int W, cudaStream_t st) {
  const auto* f = static_cast<const T*>(fst);
  const auto* s = static_cast<const T*>(snd);
  const auto* fl = static_cast<const T*>(flow);
  auto* o = static_cast<T*>(out);
  if (W % pix) return cudaErrorInvalidValue;
  if (pix == 4) return launch_step<T, 4>(step, f, s, fl, o, B, H, W, st);
  if (pix == 8) return launch_step<T, 8>(step, f, s, fl, o, B, H, W, st);
  return cudaErrorInvalidValue;
}

}  // namespace memc

// step 0-4 as above; pix 4 or 8 pixels a thread (W a multiple of pix).
MEMC_API int memc_level_step(int step, int pix, const void* fst, const void* snd,
                             const void* flow, void* out, int B, int H, int W, int dtype,
                             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == memc::kFloat32)
    return memc::launch_step_pix<float>(step, pix, fst, snd, flow, out, B, H, W, st);
  if (dtype == memc::kBFloat16)
    return memc::launch_step_pix<__nv_bfloat16>(step, pix, fst, snd, flow, out, B, H, W, st);
  return cudaErrorInvalidValue;
}
