// K1 -- adaptive filter-interpolation warp, forward.
//
// Replaces the TPU kernel memcnet_tpu/ops/pallas/warp_kernel.py::
// filter_interp_warp_bands_hcw2 (kernel _warp_band_hcw2_kernel).  Per output
// pixel p with flow f: land at (x2, y2) = p + f in float32, gate on
// 0 <= x2 <= W-1, 0 <= y2 <= H-1, |fx| < W/2, |fy| < H/2, take the fs x fs
// edge-clamped patch whose top-left tap is (int(y2) + 1 - fs/2,
// int(x2) + 1 - fs/2), weight tap (j, i) by
//   filt[j*fs+i] * (j >= fs/2 ? beta : 1-beta) * (i >= fs/2 ? alpha : 1-alpha)
// (rounded to the source type, as the TPU kernel and the XLA formulation do
// for bf16) and sum in float32.  Invalid pixels copy the source through.
// Up to kMaxSources channel-split sources share one flow and filter and are
// written to separate outputs, so the model never concatenates frame and
// context.
//
// Bound on the H100: memory -- each output pixel reads 2 flow values, fs^2
// filter values and one value per channel of its fs x fs source patch, and
// writes one value per channel; counted once, that is 0.095 ms for star's
// 67-channel bf16 warp at 1344x768.  What held the one-thread-per-pixel
// kernel this replaced at 6.4x that bound was not DRAM and not the count of load
// instructions but the gathers' spread: fs^2 scalar gathers per channel, each
// warp-wide load touching several cache lines, the same source rows fetched
// again by the blocks of the neighbouring output rows (PERF.md times the
// steps: 16 loads per channel that all hit the pixel itself cost less than
// four real gathers).
//
// Design: a block owns a 32 x 8 pixel tile.  Each thread computes its
// pixel's gate, clamped tap rows and columns and its fs^2 tap weights once.
// The block reduces the bounding box of its valid pixels' patches; where that
// box holds at most 768 source pixels (smooth flow: about 40 x 14), the block
// walks the channels two at a time, loads each channel's box once with
// coalesced loads (the next pair's loads in flight while this pair is
// summed), stores the two channels interleaved in shared memory, and sums
// each pixel's taps from there: one shared load serves a tap of both
// channels.  Blocks whose patches spread wider (noisy or discontinuous flow)
// and launches of at most 4 channels in all (the 3-channel frame warps of
// MEMC_Net and MEMC_Net_s), where staging does not pay, gather straight from global memory as
// before.  Tap sums run in the same (j, i) order on both paths, so the two
// agree bit for bit.
//
// The tile entry (memc_filter_interp_warp_tile) is the same kernel with
// the TILE flag, for parallel/tiling.py's tiled warp (the JAX package's
// memcnet_tpu/parallel/tiling.py::_local_filter_interp, which runs no Pallas
// kernel): each sample is one tile of a larger frame, its sources extended
// by a halo of `halo` columns (and `halo_h` rows) on each side, its flow and
// filter and its output at the tile's own size.  Per pixel it clamps the
// flow to the halo budget (+-(halo - fs), and +-(halo_h - fs) when halo_h >
// 0), gates in the whole frame's coordinates (the tile's origin, per
// sample, plus the pixel; |f| < frame/2 on the clamped flow), takes the taps
// in the extended tile's coordinates clamped to its edges, and passes the
// extended tile's centre through where the gate fails.  The flag is a
// template parameter, so the global warp's instances are unchanged.
#include "common.cuh"

#include <climits>

namespace memc {

constexpr int kMaxSources = 4;
constexpr int kWarpBX = 32;   // block tile: 32 x 8 output pixels
constexpr int kWarpBY = 8;
constexpr int kGatherChannels = 4;  // up to this many channels in all: no box
constexpr int kBoxLoads = 3;  // box elements per thread and channel
constexpr int kBoxMax = kBoxLoads * kWarpBX * kWarpBY;  // largest box staged: 768 elements

// Mirrored by ctypes.Structure _WarpSources in ops/cuda/warp_kernel.py.
struct WarpSources {
  const void* src[kMaxSources];
  void* out[kMaxSources];
  int channels[kMaxSources];
  int n;
};

// The geometry of a tile launch (memc_filter_interp_warp_tile): the sources
// are (B, C, H + 2 halo_h, W + 2 halo) around (B, ., H, W) tiles of an
// Hg x Wg frame.
struct TileGeom {
  const int* origins;  // (B, 2) int32: each sample's tile origin (x, y) in the frame
  int halo, halo_h;
  int Hg, Wg;
};

// clamp to [-b, b]; NaN stays NaN (and fails the gate), as torch.clamp
__device__ __forceinline__ float clamp_flow(float f, float b) {
  return f < -b ? -b : (f > b ? b : f);
}

// The per-pixel part shared by both paths: gate, tap rows and columns
// (edge-clamped, in the source's coordinates) and tap weights rounded to the
// source type.
template <typename T, int FS, bool TILE>
struct PixelTaps {
  bool valid;
  int row[FS];  // clamped tap rows
  int col[FS];  // clamped tap columns
  float wt[FS * FS];

  __device__ __forceinline__ void init(const float* __restrict__ flow, const T* __restrict__ filt,
                                       int b, int x, int y, int H, int W, const TileGeom& g) {
    const int plane = H * W;
    const int pix = y * W + x;
    const float* fl = flow + static_cast<int64_t>(2 * b) * plane;
    float fx = fl[pix];
    float fy = fl[plane + pix];
    // the whole frame (Hg x Wg), this pixel's place in it, and the source
    // (sH x sW) the taps read, with the frame's (x0, y0) at (ox, oy)
    int Hg = H, Wg = W, sH = H, sW = W, gx = x, gy = y, ox = 0, oy = 0;
    if constexpr (TILE) {
      fx = clamp_flow(fx, static_cast<float>(g.halo - FS));
      if (g.halo_h) fy = clamp_flow(fy, static_cast<float>(g.halo_h - FS));
      Hg = g.Hg;
      Wg = g.Wg;
      sH = H + 2 * g.halo_h;
      sW = W + 2 * g.halo;
      const int x0 = g.origins[2 * b], y0 = g.origins[2 * b + 1];
      gx = x0 + x;
      gy = y0 + y;
      ox = g.halo - x0;
      oy = g.halo_h - y0;
    }
    const float x2 = static_cast<float>(gx) + fx;
    const float y2 = static_cast<float>(gy) + fy;
    valid = x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(Wg - 1) &&
            y2 <= static_cast<float>(Hg - 1) && fabsf(fx) < 0.5f * Wg && fabsf(fy) < 0.5f * Hg;
    if (!valid) return;
    // int() truncation == floor on the valid domain (x2, y2 >= 0)
    const int ix = clampi(static_cast<int>(x2), 0, Wg - 1);
    const int iy = clampi(static_cast<int>(y2), 0, Hg - 1);
    const float alpha = x2 - static_cast<float>(ix);
    const float beta = y2 - static_cast<float>(iy);
    constexpr int half = FS / 2;
#pragma unroll
    for (int j = 0; j < FS; ++j) row[j] = clampi(iy + oy + 1 - half + j, 0, sH - 1);
#pragma unroll
    for (int i = 0; i < FS; ++i) col[i] = clampi(ix + ox + 1 - half + i, 0, sW - 1);
    const T* fp = filt + static_cast<int64_t>(b) * FS * FS * plane + pix;
#pragma unroll
    for (int j = 0; j < FS; ++j) {
      const float wy = j >= half ? beta : 1.f - beta;
#pragma unroll
      for (int i = 0; i < FS; ++i) {
        const float wx = i >= half ? alpha : 1.f - alpha;
        const float w = to_f32(fp[(j * FS + i) * plane]) * wy;
        wt[j * FS + i] = round_to<T>(w * wx);
      }
    }
  }
};

// The plane of flat channel f (sources in order) of batch item b, and its
// output plane (planes of src_plane and out_plane elements).
template <typename T>
__device__ __forceinline__ void channel_planes(const WarpSources& s, int f, int b,
                                               int64_t src_plane, int64_t out_plane,
                                               const T** src, T** out) {
  int k = 0;
  while (f >= s.channels[k]) f -= s.channels[k++];
  const int64_t bc = static_cast<int64_t>(b) * s.channels[k] + f;
  *src = static_cast<const T*>(s.src[k]) + bc * src_plane;
  *out = static_cast<T*>(s.out[k]) + bc * out_plane;
}

// Two channels' values of one box element, interleaved in shared memory.
template <typename T>
struct __align__(2 * sizeof(T)) Pair {
  T a, b;
};

// H x W: the output (and flow and filter) planes; TILE reads sources of
// (H + 2 g.halo_h) x (W + 2 g.halo).
template <typename T, int FS, bool BOX, bool TILE>
__global__ void __launch_bounds__(kWarpBX * kWarpBY, 4)
filter_interp_warp_kernel(WarpSources s, const float* __restrict__ flow,
                          const T* __restrict__ filt, int H, int W, TileGeom g) {
  __shared__ Pair<T> box_s[BOX ? 2 : 1][BOX ? kBoxMax : 1];
  __shared__ int red_s[4][BOX ? kWarpBY : 1];
  const int x = blockIdx.x * kWarpBX + threadIdx.x;
  const int y = blockIdx.y * kWarpBY + threadIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.y * kWarpBX + threadIdx.x;
  const bool inside = x < W && y < H;
  const int plane = H * W;
  const int pix = y * W + x;
  // the source's row length, plane and the pixel's own place in it
  const int sW = TILE ? W + 2 * g.halo : W;
  const int src_plane = TILE ? (H + 2 * g.halo_h) * sW : plane;
  const int centre = TILE ? (y + g.halo_h) * sW + x + g.halo : pix;

  PixelTaps<T, FS, TILE> p;
  p.valid = false;
  if (inside) p.init(flow, filt, b, x, y, H, W, g);

  int total = 0;
  for (int k = 0; k < s.n; ++k) total += s.channels[k];
  bool use_box = false;
  int lo_x = 0, lo_y = 0, bw = 0, bh = 0;
  if constexpr (BOX) {
    // the block's source box: the bounding box of its valid pixels' patches
    int hi_x = INT_MIN, hi_y = INT_MIN;
    lo_x = lo_y = INT_MAX;
    if (p.valid) {
      lo_x = p.col[0];
      hi_x = p.col[FS - 1];
      lo_y = p.row[0];
      hi_y = p.row[FS - 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo_x = min(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, o));
      hi_x = max(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, o));
      lo_y = min(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, o));
      hi_y = max(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, o));
    }
    if (threadIdx.x == 0) {
      red_s[0][threadIdx.y] = lo_x;
      red_s[1][threadIdx.y] = hi_x;
      red_s[2][threadIdx.y] = lo_y;
      red_s[3][threadIdx.y] = hi_y;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarpBY; ++w) {
      lo_x = min(lo_x, red_s[0][w]);
      hi_x = max(hi_x, red_s[1][w]);
      lo_y = min(lo_y, red_s[2][w]);
      hi_y = max(hi_y, red_s[3][w]);
    }
    bw = hi_x - lo_x + 1;
    bh = hi_y - lo_y + 1;
    use_box = hi_x >= lo_x && bw <= kBoxMax && bh <= kBoxMax && bw * bh <= kBoxMax;  // uniform
  }

  if (!use_box) {
    // patches spread too far (or none valid): gather from global memory
    if (!inside) return;
    for (int k = 0; k < s.n; ++k) {
      const int C = s.channels[k];
      const T* src = static_cast<const T*>(s.src[k]) + static_cast<int64_t>(b) * C * src_plane;
      T* out = static_cast<T*>(s.out[k]) + static_cast<int64_t>(b) * C * plane + pix;
      for (int c = 0; c < C; ++c) {
        const T* sp = src + c * src_plane;
        if (!p.valid) {
          out[c * plane] = sp[centre];
          continue;
        }
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < FS; ++j) {
#pragma unroll
          for (int i = 0; i < FS; ++i) acc = fmaf(p.wt[j * FS + i], to_f32(sp[p.row[j] * sW + p.col[i]]), acc);
        }
        out[c * plane] = from_f32<T>(acc);
      }
    }
    return;
  }

  // box path: two channels at a time, each channel's box loaded once,
  // coalesced, into shared memory with the two channels interleaved (one
  // shared load serves a tap of both), the next pair's loads in flight while
  // this pair's taps are summed
  constexpr int kThreads = kWarpBX * kWarpBY;
  int ld_off[kBoxLoads];  // this thread's box elements: offset in the plane, -1 if none
#pragma unroll
  for (int r = 0; r < kBoxLoads; ++r) {
    const int i = tid + r * kThreads;
    const int br = i / bw;
    ld_off[r] = i < bw * bh ? (lo_y + br) * sW + lo_x + (i - br * bw) : -1;
  }
  int tap_off[FS * FS];
  if (p.valid) {
#pragma unroll
    for (int j = 0; j < FS; ++j)
#pragma unroll
      for (int i = 0; i < FS; ++i) tap_off[j * FS + i] = (p.row[j] - lo_y) * bw + p.col[i] - lo_x;
  }

  T v[2][kBoxLoads];
  auto load_pair = [&](int f0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (f0 + u < total) {
        const T* sp;
        T* op;
        channel_planes<T>(s, f0 + u, b, src_plane, plane, &sp, &op);
#pragma unroll
        for (int r = 0; r < kBoxLoads; ++r) {
          if (ld_off[r] >= 0) v[u][r] = sp[ld_off[r]];
        }
      }
    }
  };
  load_pair(0);
  for (int f0 = 0; f0 < total; f0 += 2) {
    Pair<T>* buf = box_s[(f0 >> 1) & 1];
#pragma unroll
    for (int r = 0; r < kBoxLoads; ++r) {
      if (ld_off[r] >= 0) buf[tid + r * kThreads] = Pair<T>{v[0][r], v[1][r]};
    }
    __syncthreads();
    if (f0 + 2 < total) load_pair(f0 + 2);
    if (!inside) continue;
    float acc[2] = {0.f, 0.f};
    if (p.valid) {
#pragma unroll
      for (int t = 0; t < FS * FS; ++t) {
        const Pair<T> q = buf[tap_off[t]];
        acc[0] = fmaf(p.wt[t], to_f32(q.a), acc[0]);
        acc[1] = fmaf(p.wt[t], to_f32(q.b), acc[1]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (f0 + u < total) {
        const T* sp;
        T* op;
        channel_planes<T>(s, f0 + u, b, src_plane, plane, &sp, &op);
        op[pix] = p.valid ? from_f32<T>(acc[u]) : sp[centre];
      }
    }
  }
}

template <typename T, bool TILE>
cudaError_t launch_warp(const WarpSources& s, const float* flow, const T* filt, int B, int H, int W,
                        int fs, const TileGeom& g, cudaStream_t stream) {
  if (static_cast<int64_t>(H + 2 * g.halo_h) * (W + 2 * g.halo) >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const dim3 block(kWarpBX, kWarpBY);
  const dim3 grid(ceil_div(W, kWarpBX), ceil_div(H, kWarpBY), B);
  int total = 0;
  for (int k = 0; k < s.n; ++k) total += s.channels[k];
  // a few channels do not repay staging the box: gather them directly
  const bool box = total > kGatherChannels;
  if (fs == 4) {
    if (box) filter_interp_warp_kernel<T, 4, true, TILE><<<grid, block, 0, stream>>>(s, flow, filt, H, W, g);
    else filter_interp_warp_kernel<T, 4, false, TILE><<<grid, block, 0, stream>>>(s, flow, filt, H, W, g);
  } else if (fs == 2) {
    if (box) filter_interp_warp_kernel<T, 2, true, TILE><<<grid, block, 0, stream>>>(s, flow, filt, H, W, g);
    else filter_interp_warp_kernel<T, 2, false, TILE><<<grid, block, 0, stream>>>(s, flow, filt, H, W, g);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool TILE>
cudaError_t warp_entry(const WarpSources* sources, const void* flow, const void* filt, int B,
                       int H, int W, int fs, int dtype, const TileGeom& g, void* stream) {
  if (sources->n < 1 || sources->n > kMaxSources) return cudaErrorInvalidValue;
  for (int k = 0; k < sources->n; ++k) {
    if (sources->channels[k] < 1) return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fl = static_cast<const float*>(flow);
  if (dtype == kFloat32) {
    return launch_warp<float, TILE>(*sources, fl, static_cast<const float*>(filt), B, H, W, fs, g,
                                    st);
  }
  if (dtype == kBFloat16) {
    return launch_warp<__nv_bfloat16, TILE>(*sources, fl, static_cast<const __nv_bfloat16*>(filt),
                                            B, H, W, fs, g, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace memc

// sources: struct of N source/output pointers; flow: (B, 2, H, W) float32;
// filt: (B, fs*fs, H, W) in the sources' type.  All NCHW, contiguous.
MEMC_API int memc_filter_interp_warp(const memc::WarpSources* sources, const void* flow,
                                     const void* filt, int B, int H, int W, int fs, int dtype,
                                     void* stream) {
  const memc::TileGeom none{nullptr, 0, 0, H, W};
  return memc::warp_entry<false>(sources, flow, filt, B, H, W, fs, dtype, none, stream);
}

// The tile entry.  sources: (B, C_k, H + 2 halo_h, W + 2 halo) halo-extended
// tiles; flow: (B, 2, H, W) float32; filt: (B, fs*fs, H, W) in the sources'
// type; origins: (B, 2) int32 on the device, each tile's (x, y) origin in the
// Hg x Wg frame; outputs (B, C_k, H, W).  halo_h = 0: H is not tiled.
MEMC_API int memc_filter_interp_warp_tile(const memc::WarpSources* sources, const void* flow,
                                          const void* filt, const void* origins, int B, int H,
                                          int W, int halo, int halo_h, int Hg, int Wg, int fs,
                                          int dtype, void* stream) {
  if (halo < fs || (halo_h != 0 && halo_h < fs) || origins == nullptr) return cudaErrorInvalidValue;
  const memc::TileGeom g{static_cast<const int*>(origins), halo, halo_h, Hg, Wg};
  return memc::warp_entry<true>(sources, flow, filt, B, H, W, fs, dtype, g, stream);
}
