// K5 -- bilinear grid sample (grid_sample, zeros padding, align_corners=True),
// and SPyNet's level input built around it in one pass.
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
// Pallas kernel does.  Both entries below share these taps (grid_taps, sample).
//
// memc_grid_sample: any (B, Ho, Wo, 2) float32 grid, one thread per output
// pixel (nn/layers.py::grid_sample_bilinear; no model path calls it).
//
// memc_spynet_level_input: the whole input of a SPyNet level, which PyTorch
// ops built around the grid sample in about 12 launches:
//   up   = 2 * the align_corners=True bilinear x2 upsample of the coarse flow
//          (B, 2, h, w), in the float32 order of PyTorch's CUDA
//          upsample_bilinear2d, rounded once to the type; the replicate pad
//          of an odd level is a clamp of the upsampled index;
//   grid = torch.linspace(-1, 1, W)[x] + up_x * (1 / ((W - 1) / 2)) (and the
//          same for y), each step rounded as PyTorch's CUDA ops round it;
//   out  = cat(fst, grid_sample(snd, grid), up), (B, 8, H, W) NCHW.
//
// memc_spynet_level_input_tile: the same on the tiles of a partitioned frame,
// on the frame's global coordinates (described beside its kernel below).
//
// Bound on the H100: memory.  The general entry reads x and the float32 grid
// once and writes the output once.  The level input reads the coarse flow, fst
// and snd once and writes the 8 channels once: at 768x1344, B = 2, bf16 that
// is 60 MB, 0.018 ms at 3.35 TB/s, against the 258 MB that the separate ops
// moved through device memory (the float32 grid and the 8-channel concat
// written and read again).  Design: a thread takes PIX neighbouring pixels of
// one row (4 where the width allows), so fst is read and all 8 channels are
// written as PIX-element vectors (8 or 16 bytes at PIX = 4); the row terms of
// the upsample and of the grid are computed once per thread, and the coarse
// flow of the thread's pixels is loaded once (16 loads for 4 pixels, not 32:
// each value serves about 4 outputs).  The taps of snd are gathered from
// global memory: a smooth flow keeps a warp's taps in a few L1/L2 lines.  On
// the H100 at 768x1344, B = 2, the same kernel with every tap at its own pixel
// is under a fifth faster (bench/level_steps.cu, PERF.md), so staging snd's
// source box in shared memory, as K1 does, could gain no more than that and
// is not done.  The TPU kernel's band plan, zero-ring pre-pad, 128-lane source
// padding and gather_ok budget were DMA geometry: here the zero ring is a
// bounds test per tap (weight 0, address 0).
#include "common.cuh"

namespace memc {

struct Taps {
  float w[4];
  int off[4];  // offsets in an H x W plane
};

// The four taps of the normalised grid point (gxn, gyn), in the order of
// _grid_sample_xla (layers.py:336-337): (g + 1) * (W - 1) / 2.  Clamping to
// [-2, W + 1] keeps the int conversion finite and changes no output: every tap
// of a clamped landing is outside the frame either way.
__device__ __forceinline__ Taps grid_taps(float gxn, float gyn, int H, int W) {
  float gx = (gxn + 1.f) * static_cast<float>(W - 1) * 0.5f;
  float gy = (gyn + 1.f) * static_cast<float>(H - 1) * 0.5f;
  gx = fminf(fmaxf(gx, -2.f), static_cast<float>(W) + 1.f);
  gy = fminf(fmaxf(gy, -2.f), static_cast<float>(H) + 1.f);
  const float fx0 = floorf(gx);
  const float fy0 = floorf(gy);
  const float wx = gx - fx0;
  const float wy = gy - fy0;
  const int x0 = static_cast<int>(fx0);
  const int y0 = static_cast<int>(fy0);
  Taps t;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int xi = x0 + i;
      const int yj = y0 + j;
      const bool in = xi >= 0 && xi < W && yj >= 0 && yj < H;
      const float wt = (i ? wx : 1.f - wx) * (j ? wy : 1.f - wy);
      t.w[2 * j + i] = in ? wt : 0.f;
      t.off[2 * j + i] = in ? yj * W + xi : 0;
    }
  }
  return t;
}

// One channel's 4-tap sum in float32 (not yet rounded).
template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ xc, const Taps& t) {
  float acc = to_f32(xc[t.off[0]]) * t.w[0];
  acc = fmaf(to_f32(xc[t.off[1]]), t.w[1], acc);
  acc = fmaf(to_f32(xc[t.off[2]]), t.w[2], acc);
  acc = fmaf(to_f32(xc[t.off[3]]), t.w[3], acc);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(256)
grid_sample_kernel(const T* __restrict__ x, const float2* __restrict__ grid, T* __restrict__ out,
                   int C, int H, int W, int64_t HWo, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t b = idx / HWo;
  const int64_t p = idx - b * HWo;
  const float2 g = grid[idx];
  const Taps t = grid_taps(g.x, g.y, H, W);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* xb = x + b * C * plane;
  T* ob = out + b * C * HWo + p;
  for (int c = 0; c < C; ++c) ob[c * HWo] = from_f32<T>(sample(xb + c * plane, t));
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

// ---- SPyNet's level input -----------------------------------------------

// One axis of the align_corners=True x2 upsample at output index dst, as
// upsample_bilinear2d_out_frame computes it: src = scale * dst, i = (int)src,
// the +1 neighbour clamped at the edge, lambda = src - i.
struct Lerp {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Lerp up_lerp(int dst, int in, float scale) {
  const float r = scale * static_cast<float>(dst);
  const int i = static_cast<int>(r);
  const float l1 = r - static_cast<float>(i);
  return {i, i + (i < in - 1 ? 1 : 0), 1.f - l1, l1};
}

// l0 * a + l1 * b as nvcc contracts PyTorch's expression: the first product
// fused into the sum, the second rounded
__device__ __forceinline__ float lerp2(float l0, float a, float l1, float b) {
  return __fmaf_rn(l0, a, __fmul_rn(l1, b));
}

// torch.linspace(-1, 1, n, dtype=float32, device="cuda")[i], n >= 2, as its
// CUDA kernel computes it: step = 2 / (n - 1) in float32; start + step * i
// below n / 2, end - step * (n - 1 - i) from there, each a fused multiply-add
__device__ __forceinline__ float linspace_pm1(int i, int n, float step) {
  return i < n / 2 ? __fmaf_rn(step, static_cast<float>(i), -1.f)
                   : __fmaf_rn(-step, static_cast<float>(n - 1 - i), 1.f);
}

struct LevelArgs {
  int H, W, h, w;                // level size; coarse flow size h = H / 2, w = W / 2
  float up_scale_y, up_scale_x;  // (h - 1) / (2h - 1) in float32, as PyTorch's host code
  float step_y, step_x;          // linspace steps 2 / (H - 1), 2 / (W - 1)
  float inv_y, inv_x;            // 1 / ((H - 1) / 2): a CUDA tensor divided by a scalar
  int groups;                    // PIX-pixel groups per row
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// v[d] for a d known only at run time, by selects (no local memory)
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int d) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = d == k ? v[k] : r;
  return r;
}

template <typename T, int PIX>
__global__ void __launch_bounds__(256)
spynet_level_input_kernel(const T* __restrict__ fst, const T* __restrict__ snd,
                          const T* __restrict__ flow, T* __restrict__ out, LevelArgs a,
                          int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / a.groups;  // b * H + y
  const int x0 = static_cast<int>(idx - row * a.groups) * PIX;
  const int y = static_cast<int>(row % a.H);
  const int64_t b = row / a.H;
  const int64_t plane = static_cast<int64_t>(a.H) * a.W;
  const int64_t cplane = static_cast<int64_t>(a.h) * a.w;
  const int64_t pix = static_cast<int64_t>(y) * a.W + x0;

  // the row terms, shared by the thread's pixels
  const Lerp ly = up_lerp(min(y, 2 * a.h - 1), a.h, a.up_scale_y);
  const float lin_y = linspace_pm1(y, a.H, a.step_y);
  const T* fl = flow + b * 2 * cplane;
  const T* snd_b = snd + b * 3 * plane;

  // the coarse-flow values of the thread's PIX pixels, loaded once: their
  // source columns lie in c0 .. c0 + PIX / 2 + 1 (the x2 scale is below 1/2)
  constexpr int NW = PIX / 2 + 2;
  const int c0 = up_lerp(min(x0, 2 * a.w - 1), a.w, a.up_scale_x).i0;
  float win[2][2][NW];  // [channel][row i0, i1][column]
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < NW; ++k)
        win[ch][r][k] = to_f32(fl[ch * cplane + (r ? ly.i1 : ly.i0) * a.w + min(c0 + k, a.w - 1)]);

  Vec<T, PIX> o[8];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = *reinterpret_cast<const Vec<T, PIX>*>(fst + (b * 3 + c) * plane + pix);
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int x = x0 + j;
    const Lerp lx = up_lerp(min(x, 2 * a.w - 1), a.w, a.up_scale_x);
    float up[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const float(&r0)[NW] = win[ch][0];
      const float(&r1)[NW] = win[ch][1];
      const float v = lerp2(ly.l0, lerp2(lx.l0, pick(r0, lx.i0 - c0), lx.l1, pick(r0, lx.i1 - c0)),
                            ly.l1, lerp2(lx.l0, pick(r1, lx.i0 - c0), lx.l1, pick(r1, lx.i1 - c0)));
      up[ch] = round_to<T>(v) * 2.f;  // exact
      o[6 + ch].v[j] = from_f32<T>(up[ch]);
    }
    // the float32 grid, each step rounded apart as the separate ops round it
    const float gxn = __fadd_rn(linspace_pm1(x, a.W, a.step_x), __fmul_rn(up[0], a.inv_x));
    const float gyn = __fadd_rn(lin_y, __fmul_rn(up[1], a.inv_y));
    const Taps t = grid_taps(gxn, gyn, a.H, a.W);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[3 + c].v[j] = from_f32<T>(sample(snd_b + c * plane, t));
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    *reinterpret_cast<Vec<T, PIX>*>(out + (b * 8 + c) * plane + pix) = o[c];
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The launch arguments of an H x W level, pix pixels a thread, each scalar
// computed on the host as PyTorch's host code computes it.
inline LevelArgs level_args(int H, int W, int pix) {
  LevelArgs a;
  a.H = H;
  a.W = W;
  a.h = H / 2;
  a.w = W / 2;
  a.up_scale_y = static_cast<float>(a.h - 1) / static_cast<float>(2 * a.h - 1);
  a.up_scale_x = static_cast<float>(a.w - 1) / static_cast<float>(2 * a.w - 1);
  a.step_y = 2.f / static_cast<float>(H - 1);
  a.step_x = 2.f / static_cast<float>(W - 1);
  a.inv_y = 1.f / static_cast<float>((H - 1) / 2.0);
  a.inv_x = 1.f / static_cast<float>((W - 1) / 2.0);
  a.groups = W / pix;
  return a;
}

template <typename T>
cudaError_t launch_level_input(const T* fst, const T* snd, const T* flow, T* out, int B, int H,
                               int W, cudaStream_t stream) {
  // the widest vector that divides the rows and fits the pointers' alignment
  int pix = 4;
  while (pix > 1 && (W % pix || !aligned(fst, pix * sizeof(T)) || !aligned(out, pix * sizeof(T))))
    pix /= 2;
  const LevelArgs a = level_args(H, W, pix);
  const int64_t total = static_cast<int64_t>(B) * H * a.groups;
  const int blocks = ceil_div(total, 256);
  if (pix == 4) {
    spynet_level_input_kernel<T, 4><<<blocks, 256, 0, stream>>>(fst, snd, flow, out, a, total);
  } else if (pix == 2) {
    spynet_level_input_kernel<T, 2><<<blocks, 256, 0, stream>>>(fst, snd, flow, out, a, total);
  } else {
    spynet_level_input_kernel<T, 1><<<blocks, 256, 0, stream>>>(fst, snd, flow, out, a, total);
  }
  return cudaGetLastError();
}

// ---- SPyNet's level input on the tiles of a partitioned frame ----------------
//
// The same pixel function on the frame's global coordinates: tile b's local
// pixel (y, x) is the level's (y0 + y, x0 + x), its coarse flow is a window
// whose global origin is (cy0, cx0), and it samples the second frame's whole
// level snd[b % S].  The row and column terms of the lerp, the linspace and
// the scales are the frame level's (level_args of GH x GW), in the untiled
// kernel's float32 order, so fst and up equal the untiled kernel's bit for
// bit.  A stacked tile's positions beyond those it owns get zero warp and up
// channels.
//
// Design: one thread a pixel on a (columns, rows, tiles) grid: no division,
// and 32-bit offsets inside a tile; fst is copied through first.  The
// untiled kernel's 4 pixels a thread (vectors of fst and the 8 channels, row
// terms and the coarse window shared by 4 pixels) ran 0.0500 ms against this
// design's 0.0408 in bf16 (float32 0.0635 against 0.0536) on the top level's
// tiles of 768x1344, B = 2, (1, 4), on an NVIDIA H100 80GB HBM3 at 700 W
// (bench/level_tile_steps.cu, PERF.md): the taps of snd are gathers, and one
// pixel a thread keeps four times as many in flight.

struct TileArgs {
  LevelArgs l;         // the frame level's: H = GH, W = GW, h = GH / 2, w = GW / 2
  int th, tw, hc, wc;  // tile size, coarse window size
  int S;               // samples of the whole level
};

// Block (32, 8) over 32 columns x 8 rows of a tile, grid (columns, rows,
// tiles).
template <typename T>
__global__ void __launch_bounds__(256)
spynet_level_input_tile_kernel(const T* __restrict__ fst, const T* __restrict__ snd,
                               const T* __restrict__ flow, const int* __restrict__ origins,
                               T* __restrict__ out, TileArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= a.tw || y >= a.th) return;
  const int b = blockIdx.z;
  const int plane = a.th * a.tw;
  const int p = y * a.tw + x;
  const T* fb = fst + static_cast<int64_t>(b) * 3 * plane + p;
  T* ob = out + static_cast<int64_t>(b) * 8 * plane + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) ob[c * plane] = fb[c * plane];
  const int* o = origins + 6 * b;  // y0, x0, cy0, cx0, owned h, owned w
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
  // the coarse window's rows and columns, clamped into the tile's window
  const int r0 = clampi(ly.i0 - o[2], 0, a.hc - 1) * a.wc;
  const int r1 = clampi(ly.i1 - o[2], 0, a.hc - 1) * a.wc;
  const int c0 = clampi(lx.i0 - o[3], 0, a.wc - 1), c1 = clampi(lx.i1 - o[3], 0, a.wc - 1);
  const int cplane = a.hc * a.wc;
  const T* fl = flow + static_cast<int64_t>(b) * 2 * cplane;
  float up[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const T* f = fl + ch * cplane;
    const float v = lerp2(ly.l0, lerp2(lx.l0, to_f32(f[r0 + c0]), lx.l1, to_f32(f[r0 + c1])),
                          ly.l1, lerp2(lx.l0, to_f32(f[r1 + c0]), lx.l1, to_f32(f[r1 + c1])));
    up[ch] = round_to<T>(v) * 2.f;  // exact
    ob[(6 + ch) * plane] = from_f32<T>(up[ch]);
  }
  // the float32 grid, each step rounded apart as the separate ops round it
  const float gxn = __fadd_rn(linspace_pm1(X, l.W, l.step_x), __fmul_rn(up[0], l.inv_x));
  const float gyn = __fadd_rn(linspace_pm1(Y, l.H, l.step_y), __fmul_rn(up[1], l.inv_y));
  const Taps t = grid_taps(gxn, gyn, l.H, l.W);
  const int GHW = l.H * l.W;
  const T* snd_b = snd + static_cast<int64_t>(b % a.S) * 3 * GHW;
#pragma unroll
  for (int c = 0; c < 3; ++c) ob[(3 + c) * plane] = from_f32<T>(sample(snd_b + c * GHW, t));
}

inline TileArgs tile_args(int S, int th, int tw, int hc, int wc, int GH, int GW) {
  TileArgs a;
  a.l = level_args(GH, GW, 1);
  a.th = th;
  a.tw = tw;
  a.hc = hc;
  a.wc = wc;
  a.S = S;
  return a;
}

template <typename T>
cudaError_t launch_level_input_tile(const T* fst, const T* snd, const T* flow,
                                    const int* origins, T* out, int n, int S, int th, int tw,
                                    int hc, int wc, int GH, int GW, cudaStream_t stream) {
  // 32-bit offsets inside a tile's 8 planes and a sample's 3 level planes
  if (8LL * th * tw > INT32_MAX || 3LL * GH * GW > INT32_MAX || 2LL * hc * wc > INT32_MAX ||
      n > 65535 || th > 8 * 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(tw, 32), ceil_div(th, 8), n);
  spynet_level_input_tile_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(
      fst, snd, flow, origins, out, tile_args(S, th, tw, hc, wc, GH, GW));
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

// fst, snd: (B, 3, H, W); flow: (B, 2, H / 2, W / 2), all in dtype, contiguous;
// out: (B, 8, H, W) in dtype = cat(fst, warp(snd, up), up).  H, W >= 2.
MEMC_API int memc_spynet_level_input(const void* fst, const void* snd, const void* flow,
                                     void* out, int B, int H, int W, int dtype, void* stream) {
  if (H < 2 || W < 2) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == memc::kFloat32) {
    return memc::launch_level_input(static_cast<const float*>(fst), static_cast<const float*>(snd),
                                    static_cast<const float*>(flow), static_cast<float*>(out), B,
                                    H, W, st);
  }
  if (dtype == memc::kBFloat16) {
    using bf = __nv_bfloat16;
    return memc::launch_level_input(static_cast<const bf*>(fst), static_cast<const bf*>(snd),
                                    static_cast<const bf*>(flow), static_cast<bf*>(out), B, H, W,
                                    st);
  }
  return cudaErrorInvalidValue;
}

// fst: (n, 3, th, tw) tiles; snd: (S, 3, GH, GW) whole levels, tile b samples
// snd[b % S]; flow: (n, 2, hc, wc) coarse-flow windows; origins: (n, 6) int32
// (y0, x0, cy0, cx0, owned h, owned w); all but origins in dtype, contiguous;
// out: (n, 8, th, tw) in dtype.  GH, GW >= 2, n % S == 0.
MEMC_API int memc_spynet_level_input_tile(const void* fst, const void* snd, const void* flow,
                                          const void* origins, void* out, int n, int S, int th,
                                          int tw, int hc, int wc, int GH, int GW, int dtype,
                                          void* stream) {
  if (GH < 2 || GW < 2 || S <= 0 || n % S || hc < 1 || wc < 1) return cudaErrorInvalidValue;
  if (n == 0 || th == 0 || tw == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* org = static_cast<const int*>(origins);
  if (dtype == memc::kFloat32) {
    return memc::launch_level_input_tile(
        static_cast<const float*>(fst), static_cast<const float*>(snd),
        static_cast<const float*>(flow), org, static_cast<float*>(out), n, S, th, tw, hc, wc, GH,
        GW, st);
  }
  if (dtype == memc::kBFloat16) {
    using bf = __nv_bfloat16;
    return memc::launch_level_input_tile(static_cast<const bf*>(fst), static_cast<const bf*>(snd),
                                         static_cast<const bf*>(flow), org, static_cast<bf*>(out),
                                         n, S, th, tw, hc, wc, GH, GW, st);
  }
  return cudaErrorInvalidValue;
}
