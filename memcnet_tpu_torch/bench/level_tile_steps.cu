// K5's level input on tiles (memc_spynet_level_input_tile) in variants, for
// timing only (memcnet_tpu_torch/bench/kernel_ab.py builds this file with
// nvcc and loads it with ctypes; it is not part of the kernel library).  All
// compute the entry's function and must give its bits:
//   STEP 0  the widest of 4, 2, 1 pixels a thread that fits (the untiled
//           kernel's choice), __launch_bounds__(256);
//   STEP 1  2 pixels a thread (where the tile width is even);
//   STEP 2  the entry as built: 1 pixel a thread on a (columns, rows,
//           tiles) grid;
//   STEP 3  step 0 with __launch_bounds__(256, 3): at most 85 registers;
//   STEP 4  step 0 with __launch_bounds__(256, 4): at most 64 registers;
//   STEP 5  the first design: one thread a pixel on a 1D grid, 64-bit
//           divisions, fst and all 8 channels as scalars, the four coarse
//           values of a pixel loaded apart.
#include "gather.cu"

namespace memc {

// The widest of 4, 2 and 1 pixels a thread that divides the tile width and
// fits fst's and out's alignment.
template <typename T>
int tile_pix(const T* fst, const T* out, int tw) {
  int pix = 4;
  while (pix > 1 && (tw % pix || !aligned(fst, pix * sizeof(T)) || !aligned(out, pix * sizeof(T))))
    pix /= 2;
  return pix;
}

// One thread's PIX pixels (column group g of row y of tile b): the untiled
// kernel's design on tile coordinates.
template <typename T, int PIX>
__device__ __forceinline__ void level_input_tile_pixels(const T* __restrict__ fst,
                                                        const T* __restrict__ snd,
                                                        const T* __restrict__ flow,
                                                        const int* __restrict__ origins,
                                                        T* __restrict__ out, const TileArgs& a,
                                                        int g, int y, int b) {
  const int x0 = g * PIX;
  const int plane = a.th * a.tw;
  const int pix = y * a.tw + x0;
  const T* fb = fst + static_cast<int64_t>(b) * 3 * plane;
  T* ob = out + static_cast<int64_t>(b) * 8 * plane;
  // fst, copied through first: its registers are free for the rest
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    *reinterpret_cast<Vec<T, PIX>*>(ob + c * plane + pix) =
        *reinterpret_cast<const Vec<T, PIX>*>(fb + c * plane + pix);
  }
  const int* o = origins + 6 * b;  // y0, x0, cy0, cx0, owned h, owned w
  const int own_w = o[5];
  Vec<T, PIX> v[5];  // the warp's 3 channels, then up's 2
  if (y >= o[4] || x0 >= own_w) {
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int j = 0; j < PIX; ++j) v[c].v[j] = from_f32<T>(0.f);
  } else {
    const LevelArgs& l = a.l;
    const int Y = o[0] + y;
    const int X0 = o[1] + x0;
    // the row terms, shared by the thread's pixels
    const Lerp ly = up_lerp(min(Y, 2 * l.h - 1), l.h, l.up_scale_y);
    const float lin_y = linspace_pm1(Y, l.H, l.step_y);
    const int r0 = clampi(ly.i0 - o[2], 0, a.hc - 1), r1 = clampi(ly.i1 - o[2], 0, a.hc - 1);
    // the coarse window of the thread's pixels, loaded once: global columns
    // c0 .. c0 + PIX / 2 + 1, each clamped into the tile's window
    constexpr int NW = PIX / 2 + 2;
    const int c0 = up_lerp(min(X0, 2 * l.w - 1), l.w, l.up_scale_x).i0;
    const int cplane = a.hc * a.wc;
    const T* fl = flow + static_cast<int64_t>(b) * 2 * cplane;
    float win[2][2][NW];  // [channel][row r0, r1][column]
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < NW; ++k)
          win[ch][r][k] = to_f32(
              fl[ch * cplane + (r ? r1 : r0) * a.wc + clampi(c0 + k - o[3], 0, a.wc - 1)]);
    const int GHW = l.H * l.W;
    const T* snd_b = snd + static_cast<int64_t>(b % a.S) * 3 * GHW;
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      if (x0 + j >= own_w) {
#pragma unroll
        for (int c = 0; c < 5; ++c) v[c].v[j] = from_f32<T>(0.f);
        continue;
      }
      const int X = X0 + j;
      const Lerp lx = up_lerp(min(X, 2 * l.w - 1), l.w, l.up_scale_x);
      float up[2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const float(&w0)[NW] = win[ch][0];
        const float(&w1)[NW] = win[ch][1];
        const float val =
            lerp2(ly.l0, lerp2(lx.l0, pick(w0, lx.i0 - c0), lx.l1, pick(w0, lx.i1 - c0)), ly.l1,
                  lerp2(lx.l0, pick(w1, lx.i0 - c0), lx.l1, pick(w1, lx.i1 - c0)));
        up[ch] = round_to<T>(val) * 2.f;  // exact
        v[3 + ch].v[j] = from_f32<T>(up[ch]);
      }
      // the float32 grid, each step rounded apart as the separate ops round it
      const float gxn = __fadd_rn(linspace_pm1(X, l.W, l.step_x), __fmul_rn(up[0], l.inv_x));
      const float gyn = __fadd_rn(lin_y, __fmul_rn(up[1], l.inv_y));
      const Taps t = grid_taps(gxn, gyn, l.H, l.W);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c].v[j] = from_f32<T>(sample(snd_b + c * GHW, t));
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) *reinterpret_cast<Vec<T, PIX>*>(ob + (3 + c) * plane + pix) = v[c];
}

template <typename T, int PIX, int MINB>
__global__ void __launch_bounds__(256, MINB)
level_tile_bounded_kernel(const T* __restrict__ fst, const T* __restrict__ snd,
                          const T* __restrict__ flow, const int* __restrict__ origins,
                          T* __restrict__ out, TileArgs a, int groups) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (g >= groups || y >= a.th) return;
  level_input_tile_pixels<T, PIX>(fst, snd, flow, origins, out, a, g, y, blockIdx.z);
}

template <typename T>
__global__ void __launch_bounds__(256)
level_tile_first_kernel(const T* __restrict__ fst, const T* __restrict__ snd,
                        const T* __restrict__ flow, const int* __restrict__ origins,
                        T* __restrict__ out, TileArgs a, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t plane = static_cast<int64_t>(a.th) * a.tw;
  const int64_t b = idx / plane;
  const int64_t pix = idx - b * plane;
  const int y = static_cast<int>(pix / a.tw);
  const int x = static_cast<int>(pix - static_cast<int64_t>(y) * a.tw);
  const int* o = origins + b * 6;
  T* ob = out + b * 8 * plane + pix;
#pragma unroll
  for (int c = 0; c < 3; ++c) ob[c * plane] = fst[(b * 3 + c) * plane + pix];
  if (y >= o[4] || x >= o[5]) {
#pragma unroll
    for (int c = 3; c < 8; ++c) ob[c * plane] = from_f32<T>(0.f);
    return;
  }
  const LevelArgs& l = a.l;
  const int Y = o[0] + y;
  const int X = o[1] + x;
  const Lerp ly = up_lerp(min(Y, 2 * l.h - 1), l.h, l.up_scale_y);
  const Lerp lx = up_lerp(min(X, 2 * l.w - 1), l.w, l.up_scale_x);
  const int r0 = clampi(ly.i0 - o[2], 0, a.hc - 1), r1 = clampi(ly.i1 - o[2], 0, a.hc - 1);
  const int c0 = clampi(lx.i0 - o[3], 0, a.wc - 1), c1 = clampi(lx.i1 - o[3], 0, a.wc - 1);
  const int64_t cplane = static_cast<int64_t>(a.hc) * a.wc;
  float up[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const T* f = flow + (b * 2 + ch) * cplane;
    const float v = lerp2(ly.l0, lerp2(lx.l0, to_f32(f[r0 * a.wc + c0]), lx.l1,
                                       to_f32(f[r0 * a.wc + c1])),
                          ly.l1, lerp2(lx.l0, to_f32(f[r1 * a.wc + c0]), lx.l1,
                                       to_f32(f[r1 * a.wc + c1])));
    up[ch] = round_to<T>(v) * 2.f;
    ob[(6 + ch) * plane] = from_f32<T>(up[ch]);
  }
  const float gxn = __fadd_rn(linspace_pm1(X, l.W, l.step_x), __fmul_rn(up[0], l.inv_x));
  const float gyn = __fadd_rn(linspace_pm1(Y, l.H, l.step_y), __fmul_rn(up[1], l.inv_y));
  const Taps t = grid_taps(gxn, gyn, l.H, l.W);
  const T* snd_b = snd + (b % a.S) * 3 * static_cast<int64_t>(l.H) * l.W;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    ob[(3 + c) * plane] = from_f32<T>(sample(snd_b + c * static_cast<int64_t>(l.H) * l.W, t));
}

template <typename T, int MINB>
void launch_bounded(const T* fst, const T* snd, const T* flow, const int* origins, T* out, int n,
                    int pix, const TileArgs& a, cudaStream_t st) {
  const int groups = a.tw / pix;
  const dim3 block(32, 8), grid(ceil_div(groups, 32), ceil_div(a.th, 8), n);
  if (pix == 4) {
    level_tile_bounded_kernel<T, 4, MINB><<<grid, block, 0, st>>>(fst, snd, flow, origins, out, a,
                                                                  groups);
  } else if (pix == 2) {
    level_tile_bounded_kernel<T, 2, MINB><<<grid, block, 0, st>>>(fst, snd, flow, origins, out, a,
                                                                  groups);
  } else {
    level_tile_bounded_kernel<T, 1, MINB><<<grid, block, 0, st>>>(fst, snd, flow, origins, out, a,
                                                                  groups);
  }
}

template <typename T>
cudaError_t level_tile_step(int step, const T* fst, const T* snd, const T* flow,
                            const int* origins, T* out, int n, int S, int th, int tw, int hc,
                            int wc, int GH, int GW, cudaStream_t st) {
  const int pix = step == 1 ? 2 : tile_pix(fst, out, tw);
  if (pix == 2 && tw % 2) return cudaErrorInvalidValue;
  const TileArgs a = tile_args(S, th, tw, hc, wc, GH, GW);
  switch (step) {
    case 0:
    case 1:
      launch_bounded<T, 1>(fst, snd, flow, origins, out, n, pix, a, st);
      break;
    case 2:
      return launch_level_input_tile(fst, snd, flow, origins, out, n, S, th, tw, hc, wc, GH, GW,
                                     st);
    case 3:
      launch_bounded<T, 3>(fst, snd, flow, origins, out, n, pix, a, st);
      break;
    case 4:
      launch_bounded<T, 4>(fst, snd, flow, origins, out, n, pix, a, st);
      break;
    case 5: {
      const int64_t total = static_cast<int64_t>(n) * th * tw;
      level_tile_first_kernel<T><<<ceil_div(total, 256), 256, 0, st>>>(fst, snd, flow, origins,
                                                                        out, a, total);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace memc

// The arguments of memc_spynet_level_input_tile, after the step.
MEMC_API int memc_level_tile_step(int step, const void* fst, const void* snd, const void* flow,
                                  const void* origins, void* out, int n, int S, int th, int tw,
                                  int hc, int wc, int GH, int GW, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* org = static_cast<const int*>(origins);
  if (dtype == memc::kFloat32) {
    using f = float;
    return memc::level_tile_step(step, static_cast<const f*>(fst), static_cast<const f*>(snd),
                                 static_cast<const f*>(flow), org, static_cast<f*>(out), n, S, th,
                                 tw, hc, wc, GH, GW, st);
  }
  if (dtype == memc::kBFloat16) {
    using bf = __nv_bfloat16;
    return memc::level_tile_step(step, static_cast<const bf*>(fst), static_cast<const bf*>(snd),
                                 static_cast<const bf*>(flow), org, static_cast<bf*>(out), n, S,
                                 th, tw, hc, wc, GH, GW, st);
  }
  return cudaErrorInvalidValue;
}
