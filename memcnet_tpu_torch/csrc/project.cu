// K2 and K3 -- the flow projection as one op on the card.
//
// Replaces the TPU kernels memcnet_tpu/ops/pallas/scatter_kernel.py::
// scatter_bands (K2, the base scatter) and memcnet_tpu/ops/pallas/
// fill_kernel.py::fill_holes (K3, the hole fill), and the XLA glue between
// them (memcnet_tpu/ops/projection.py::_scatter4, the divide,
// _directional_fill).  A call is at most four device operations:
//
//   K2  memset         zero the three float32 planes of the base sums S and,
//                      with the fill, the mask summaries behind them;
//       project_scatter_kernel
//                      one thread per source pixel reads the flow in its own
//                      type, takes the landing cell in float32 exactly as
//                      ops/cuda/project_kernel.py::landing_cells does, and
//                      atomicAdds (-fx, -fy, 1) into S at the base cell;
//       project_fold_kernel
//                      one thread per target pixel gathers the two border
//                      folds from S (the gather form of _shift_fold_last: T
//                      from S at x and x - 1, the result from T at y and
//                      y - 1, folded at x = W - 1 and y = H - 1, added in the
//                      plain version's order) and divides by the count.
//                      Without the fill it writes the result in the flow's
//                      type.  With it, it writes the float32 average and the
//                      has-value bitmask (count > 0) twice: by rows (one
//                      __ballot_sync per warp) and, transposed in shared
//                      memory, by columns; plus one summary bit per non-empty
//                      mask word;
//   K3  project_fill_kernel
//                      one thread per pixel: a hole takes the mean of the
//                      nearest value to its left, right and above (no
//                      down-scan: the reference disabled it by accident,
//                      my_lib_kernel.cu:1799; the JAX opt-in
//                      fix_down_scan_bug adds the nearest value below, the
//                      mirror of the up search in the same column masks);
//                      every pixel is written in the flow's type.
//
// K2's payload entry (memc_project_payload) serves the depth-weighted and
// the brightness-gated projections (memcnet_tpu/ops/projection.py::
// depth_flow_project and weighted_flow_project, whose _scatter4 runs
// scatter_bands on a payload of P = 3 or 4 planes): the same memset, a
// scatter of a float32 payload of P planes (built by PyTorch; zero where a
// gate fails) into the landing cells the flow sets, and the same fold, which
// divides planes 0 .. P-2 by plane P-1 where it is > 0 and takes "has a
// value" from plane P-1 > 0 (a sum of depths, or a count of gated pixels).
//
// Bound on the H100: memory -- the flow (and the payload) read once, the
// result written once;
// S (24.8 MB for B = 2 at 768x1344) and the average stay in the 50 MB L2.
// The TPU kernels' band plans and bucket walk turned a scatter into vector
// shifted adds and their cross-band carry relied on grid steps running in
// order; Hopper has float atomics in L2, and the nearest-value searches are
// bit scans: the word of the pixel first, then the summary word, which names
// the nearest non-empty word at once.  A search costs O(1 + L / 1024) word
// reads for a line of L pixels whatever the holes, so a flow whose every
// landing is invalid (every pixel a hole) costs no more than any other.
// Float sums land in a run-dependent order; counts (sums of 1.0) are exact.
//
// The tile entries serve parallel/tiling.py's tiled projection (the JAX
// package's memcnet_tpu/parallel/tiling.py::tiled_flow_project, whose
// scatter lands in a halo-extended buffer and so never takes the Pallas
// kernel).  Each sample is one tile of an Hg x Wg frame at its own origin:
//
//   K2  memc_project_tile_sums: a memset, project_tile_scatter_kernel (the
//       flow clamped to +-(halo - 1), and to +-(halo_h - 1) when halo_h > 0;
//       the gate in the frame's coordinates; (-fx, -fy, 1) atomicAdded at the
//       landing cell in the extended buffer's coordinates; a 3D grid with
//       32-bit offsets) and project_raw_fold_kernel (both +1 folds at the
//       extended buffer's own edges, no divide: a warp walks a 32-column
//       strip down the rows, so each S value is loaded once, where a fold
//       of one thread per element loads it four times).  The spill
//       exchange between tiles, the crop and the divide follow in PyTorch.
//   K2  memc_project_payload_tile: the payload entry on tile origins, for the
//       depth-weighted and gated projections on partitioned frames (whose
//       JAX ops GSPMD runs on frame_sharding-placed arrays): a memset,
//       project_payload_tile_scatter_kernel (each owned pixel of a tile lands
//       at the frame's cell, tile origin + local position in float32, and its
//       P planes are atomicAdded into its sample's whole-frame buffer, every
//       stacked tile of a sample into the same one) and project_raw_fold_kernel
//       over the P planes (the +1 folds at the frame's own border, so a
//       clamped right or bottom neighbour takes its contribution twice, as in
//       the untiled op).  No divide: parallel/partition.py's reduce gives each
//       tile its owned part of the sums first.
//   K3  memc_project_fill_carry: a memset, project_mask_kernel (the has-value
//       masks of a cropped tile from its count) and project_fill_kernel with
//       carries: where a tile's own bit search finds nothing, the nearest
//       value from the tiles to the left, to the right and (H tiled) above,
//       per row or column, takes its place.  No down search.
#include "common.cuh"

namespace memc {

constexpr int kTile = 32;  // the fold kernel's tile: 32 columns x 32 rows
constexpr int kTileWarps = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline int words_for(int bits) { return (bits + 31) / 32; }

// What the border-folding shift of one axis adds at index i of a line of L:
// "scatter to min(i + 1, L - 1)" (my_lib_kernel.cu:1668-1669 clamps), with
// prev the value at i - 1 and cur the value at i.  L = 1 doubles the value.
__device__ __forceinline__ float fold_term(float prev, float cur, int i, int L) {
  if (L == 1) return cur;
  if (i == 0) return 0.f;
  return i < L - 1 ? prev : prev + cur;
}

template <typename T>
__global__ void __launch_bounds__(256)
project_scatter_kernel(const T* __restrict__ flow, float* __restrict__ sums, int H, int W,
                       int64_t HW, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t b = idx / HW;
  const int64_t p = idx - b * HW;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const T* f = flow + 2 * b * HW + p;
  const float fx = to_f32(f[0]);
  const float fy = to_f32(f[HW]);
  const float x2 = static_cast<float>(x) + fx;
  const float y2 = static_cast<float>(y) + fy;
  // NaN fails every test, as in the plain version
  if (!(x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(W - 1) &&
        y2 <= static_cast<float>(H - 1)))
    return;
  // truncation equals floor on the valid domain (memcnet_tpu/ops/warp.py:107-109)
  const int ix = clampi(__float2int_rz(x2), 0, W - 1);
  const int iy = clampi(__float2int_rz(y2), 0, H - 1);
  float* s = sums + 3 * b * HW + static_cast<int64_t>(iy) * W + ix;
  atomicAdd(s, -fx);
  atomicAdd(s + HW, -fy);
  atomicAdd(s + 2 * HW, 1.f);
}

// The payload entry's scatter: the landing cell of project_scatter_kernel,
// and the P float32 planes of the payload added there.
template <typename T, int P>
__global__ void __launch_bounds__(256)
project_payload_scatter_kernel(const T* __restrict__ flow, const float* __restrict__ payload,
                               float* __restrict__ sums, int H, int W, int64_t HW,
                               int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t b = idx / HW;
  const int64_t p = idx - b * HW;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const T* f = flow + 2 * b * HW + p;
  const float x2 = static_cast<float>(x) + to_f32(f[0]);
  const float y2 = static_cast<float>(y) + to_f32(f[HW]);
  if (!(x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(W - 1) &&
        y2 <= static_cast<float>(H - 1)))
    return;
  const int ix = clampi(__float2int_rz(x2), 0, W - 1);
  const int iy = clampi(__float2int_rz(y2), 0, H - 1);
  const float* v = payload + P * b * HW + p;
  float* s = sums + P * b * HW + static_cast<int64_t>(iy) * W + ix;
#pragma unroll
  for (int c = 0; c < P; ++c) atomicAdd(s + c * HW, v[c * HW]);
}

// T (the x fold of S) at row y of one plane.
__device__ __forceinline__ float fold_x(const float* __restrict__ plane, int y, int x, int W) {
  const float* r = plane + static_cast<int64_t>(y) * W;
  const float cur = r[x];
  const float prev = x > 0 ? r[x - 1] : 0.f;
  return cur + fold_term(prev, cur, x, W);
}

// S has P planes; planes 0 and 1, divided by plane P-1, go to ``out``: the
// flow's type without the fill and float (the average) with it; planes
// 2 .. P-2, divided the same way, go to ``ex`` (B, P-3, H, W) in ExT.
// Block: 32 x 8 threads over a tile of 32 columns x 32 rows, grid
// (words_for(W), words_for(H), B), so tile (i, j) is row word i and column
// word j of the masks.
template <typename OutT, typename ExT, int P, bool kFill>
__global__ void __launch_bounds__(kTile * kTileWarps)
project_fold_kernel(const float* __restrict__ sums, OutT* __restrict__ out, ExT* __restrict__ ex,
                    uint32_t* __restrict__ rows, uint32_t* __restrict__ row_sums,
                    uint32_t* __restrict__ cols, uint32_t* __restrict__ col_sums, int H, int W) {
  __shared__ uint32_t tile_rows[kTile];
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kTile + lane;
  const int b = blockIdx.z;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const float* s = sums + P * b * HW;
  for (int r = threadIdx.y; r < kTile; r += kTileWarps) {
    const int y = blockIdx.y * kTile + r;  // the same for the whole warp
    bool has = false;
    if (y < H && x < W) {
      float v[P];
#pragma unroll
      for (int c = 0; c < P; ++c) {
        const float* plane = s + c * HW;
        const float t = fold_x(plane, y, x, W);
        const float tp = y > 0 ? fold_x(plane, y - 1, x, W) : 0.f;
        v[c] = t + fold_term(tp, t, y, H);
      }
      const float cnt = v[P - 1];
      const float den = cnt > 0.f ? cnt : 1.f;
      const int64_t p = static_cast<int64_t>(y) * W + x;
      OutT* o = out + 2 * b * HW + p;
      o[0] = from_f32<OutT>(v[0] / den);
      o[HW] = from_f32<OutT>(v[1] / den);
#pragma unroll
      for (int c = 2; c < P - 1; ++c)
        ex[(static_cast<int64_t>(b) * (P - 3) + c - 2) * HW + p] = from_f32<ExT>(v[c] / den);
      has = cnt > 0.f;
    }
    if (kFill) {
      const uint32_t word = __ballot_sync(kFullMask, has);
      if (lane == 0) {
        tile_rows[r] = word;
        if (y < H) {
          const int64_t line = static_cast<int64_t>(b) * H + y;
          const int nw = words_for(W);
          rows[line * nw + blockIdx.x] = word;
          if (word) {
            atomicOr(row_sums + line * words_for(nw) + blockIdx.x / 32,
                     1u << (blockIdx.x % 32));
          }
        }
      }
    }
  }
  if (!kFill) return;
  __syncthreads();
  if (threadIdx.y != 0 || x >= W) return;
  uint32_t word = 0;  // column x over the tile's 32 rows
  for (int r = 0; r < kTile; ++r) word |= ((tile_rows[r] >> lane) & 1u) << r;
  const int64_t line = static_cast<int64_t>(b) * W + x;
  const int nh = words_for(H);
  cols[line * nh + blockIdx.y] = word;
  if (word) atomicOr(col_sums + line * words_for(nh) + blockIdx.y / 32, 1u << (blockIdx.y % 32));
}

// Nearest set bit below i in a line's mask words, or -1: the word of i
// first, then the summary (bit k set = word k not empty) for the nearest
// non-empty word.
__device__ __forceinline__ int nearest_below(const uint32_t* __restrict__ words,
                                             const uint32_t* __restrict__ wsum, int i) {
  const int w = i / 32;
  const uint32_t m = words[w] & ((1u << (i % 32)) - 1u);
  if (m) return w * 32 + 31 - __clz(static_cast<int>(m));
  int s = w / 32;
  uint32_t sm = wsum[s] & ((1u << (w % 32)) - 1u);
  while (!sm && s > 0) sm = wsum[--s];
  if (!sm) return -1;
  const int ww = s * 32 + 31 - __clz(static_cast<int>(sm));
  return ww * 32 + 31 - __clz(static_cast<int>(words[ww]));
}

// Nearest set bit above i in a line of n bits, or n.
__device__ __forceinline__ int nearest_above(const uint32_t* __restrict__ words,
                                             const uint32_t* __restrict__ wsum, int i, int n) {
  const int w = i / 32;
  const uint32_t m = words[w] & ~((2u << (i % 32)) - 1u);  // 2u << 31 wraps to 0
  if (m) return w * 32 + __ffs(static_cast<int>(m)) - 1;
  const int nsum = words_for(words_for(n));
  int s = w / 32;
  uint32_t sm = wsum[s] & ~((2u << (w % 32)) - 1u);
  while (!sm && s + 1 < nsum) sm = wsum[++s];
  if (!sm) return n;
  const int ww = s * 32 + __ffs(static_cast<int>(sm)) - 1;
  return ww * 32 + __ffs(static_cast<int>(words[ww])) - 1;
}

// A carry in (B, 3, L) for line i of sample b, added where the search found
// nothing (the missing direction added 0 before it, so the sum's order is
// the plain version's).
__device__ __forceinline__ void carry_in(const float* __restrict__ carry, int b, int i, int L,
                                         bool missing, float* nx, float* ny, float* den) {
  const float* c = carry + static_cast<int64_t>(3 * b) * L + i;
  if (missing && c[0] > 0.f) {
    *nx += c[L];
    *ny += c[2 * L];
    *den += 1.f;
  }
}

// Block: 32 x 8 threads, one pixel each; grid (words_for(W), ceil(H / 8), B).
// kDown adds the nearest value below (fix_down_scan_bug).  kCarry: where a
// search finds nothing, the carry of its direction stands in for it: left
// and right (B, 3, H) per row, up (B, 3, W) per column or null (the tile
// entry's carries from the other tiles; plane 0 > 0 if there is a value,
// planes 1 and 2 the value).
template <typename T, bool kDown, bool kCarry>
__global__ void __launch_bounds__(256)
project_fill_kernel(const float* __restrict__ avg, const uint32_t* __restrict__ rows,
                    const uint32_t* __restrict__ row_sums, const uint32_t* __restrict__ cols,
                    const uint32_t* __restrict__ col_sums, T* __restrict__ out, int H, int W,
                    const float* __restrict__ left, const float* __restrict__ right,
                    const float* __restrict__ up) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const float* ax = avg + 2 * b * HW;
  const float* ay = ax + HW;
  const int64_t p = static_cast<int64_t>(y) * W + x;
  T* ox = out + 2 * b * HW + p;
  const int nw = words_for(W), nh = words_for(H);
  const int64_t rline = static_cast<int64_t>(b) * H + y;
  const uint32_t* rw = rows + rline * nw;
  if ((rw[x / 32] >> (x % 32)) & 1u) {
    ox[0] = from_f32<T>(ax[p]);
    ox[HW] = from_f32<T>(ay[p]);
    return;
  }
  // the plain version's order: ((0 + left) + right) + up, a missing
  // direction adding 0
  float nx = 0.f, ny = 0.f, den = 0.f;
  const uint32_t* rs = row_sums + rline * words_for(nw);
  const int l = nearest_below(rw, rs, x);
  const int64_t row = static_cast<int64_t>(y) * W;
  nx += l >= 0 ? ax[row + l] : 0.f;
  ny += l >= 0 ? ay[row + l] : 0.f;
  den += l >= 0 ? 1.f : 0.f;
  if constexpr (kCarry) carry_in(left, b, y, H, l < 0, &nx, &ny, &den);
  const int r = nearest_above(rw, rs, x, W);
  nx += r < W ? ax[row + r] : 0.f;
  ny += r < W ? ay[row + r] : 0.f;
  den += r < W ? 1.f : 0.f;
  if constexpr (kCarry) carry_in(right, b, y, H, r >= W, &nx, &ny, &den);
  const int64_t cline = static_cast<int64_t>(b) * W + x;
  const int u = nearest_below(cols + cline * nh, col_sums + cline * words_for(nh), y);
  const int64_t up_at = static_cast<int64_t>(u) * W + x;
  nx += u >= 0 ? ax[up_at] : 0.f;
  ny += u >= 0 ? ay[up_at] : 0.f;
  den += u >= 0 ? 1.f : 0.f;
  if constexpr (kCarry) {
    if (up != nullptr) carry_in(up, b, x, W, u < 0, &nx, &ny, &den);
  }
  if (kDown) {
    const int d = nearest_above(cols + cline * nh, col_sums + cline * words_for(nh), y, H);
    const int64_t down = static_cast<int64_t>(d) * W + x;
    nx += d < H ? ax[down] : 0.f;
    ny += d < H ? ay[down] : 0.f;
    den += d < H ? 1.f : 0.f;
  }
  ox[0] = from_f32<T>(den > 0.f ? nx / den : ax[p]);
  ox[HW] = from_f32<T>(den > 0.f ? ny / den : ay[p]);
}

// K2's tile entry's scatter: one thread per source pixel of a tile (B tiles
// of H x W, sources of an Hg x Wg frame at origins (x0, y0) per tile),
// landing in the (He, We) = (H + 2 halo_h, W + 2 halo) extended buffer.  The
// landing cell is the frame's, moved to the buffer, so tiles land where the
// global op lands.  Block (32, 8) over 32 columns x 8 rows of a tile, grid
// (words_for(W), ceil(H / 8), B): no division, 32-bit offsets in a tile.
template <typename T>
__global__ void __launch_bounds__(256)
project_tile_scatter_kernel(const T* __restrict__ flow, const int* __restrict__ origins,
                            float* __restrict__ sums, int H, int W, int halo, int halo_h, int Hg,
                            int Wg) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int b = blockIdx.z;
  const int HW = H * W;
  const T* f = flow + static_cast<int64_t>(b) * 2 * HW + y * W + x;
  float fx = to_f32(f[0]);
  float fy = to_f32(f[HW]);
  const float bx = static_cast<float>(halo - 1);
  fx = fx < -bx ? -bx : (fx > bx ? bx : fx);  // NaN stays NaN and fails the gate
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
  const int HWe = He * We;
  float* s = sums + static_cast<int64_t>(b) * 3 * HWe + iy * We + ix;
  atomicAdd(s, -fx);
  atomicAdd(s + HWe, -fy);
  atomicAdd(s + 2 * HWe, 1.f);
}

// K2's payload entry on tile origins: one thread per source pixel of B
// stacked tiles of H x W, each at its origin (y0, x0) in an Hg x Wg frame
// and owning its first (own_h, own_w) positions (origins: B x 4 int32, y0,
// x0, own_h, own_w); a pixel past them is a stacked tile's padding and adds
// nothing.  An owned pixel's P planes land at the frame's cell in the
// whole-frame buffer of its sample, b % S (the tile index is outermost).
template <typename T, int P>
__global__ void __launch_bounds__(256)
project_payload_tile_scatter_kernel(const T* __restrict__ flow, const float* __restrict__ payload,
                                    const int* __restrict__ origins, float* __restrict__ sums,
                                    int H, int W, int S, int Hg, int Wg, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t b = idx / HW;
  const int64_t p = idx - b * HW;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const int* o = origins + 4 * b;
  if (y >= o[2] || x >= o[3]) return;
  const T* f = flow + 2 * b * HW + p;
  const float x2 = static_cast<float>(o[1] + x) + to_f32(f[0]);
  const float y2 = static_cast<float>(o[0] + y) + to_f32(f[HW]);
  if (!(x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(Wg - 1) &&
        y2 <= static_cast<float>(Hg - 1)))
    return;
  const int ix = clampi(__float2int_rz(x2), 0, Wg - 1);
  const int iy = clampi(__float2int_rz(y2), 0, Hg - 1);
  const int64_t HWg = static_cast<int64_t>(Hg) * Wg;
  const float* v = payload + P * b * HW + p;
  float* s = sums + P * (b % S) * HWg + static_cast<int64_t>(iy) * Wg + ix;
#pragma unroll
  for (int c = 0; c < P; ++c) atomicAdd(s + c * HWg, v[c * HW]);
}

constexpr int kFoldRows = 16;  // rows a warp of project_raw_fold_kernel walks

// Both +1 folds of each H x W plane of S at the plane's own edges, in the
// plain version's order, no divide (the tile entries').  A warp walks
// kFoldRows rows of a 32-column strip of one plane: lane l holds column x,
// takes S at x - 1 from lane l - 1 by a shuffle (lane 0 loads it), and keeps
// the x fold of the row above in a register, so each S value is loaded once
// (and the row above the warp's first, and lane 0's column to the left).
// All its rows are loaded before the first is folded.  Block (32, 8), grid
// (words_for(W), ceil(H / (8 kFoldRows)), planes); 32-bit offsets in a plane.
__global__ void __launch_bounds__(kTile * kTileWarps)
project_raw_fold_kernel(const float* __restrict__ sums, float* __restrict__ out, int H, int W) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kTile + lane;
  const int y0 = (blockIdx.y * blockDim.y + threadIdx.y) * kFoldRows;
  if (y0 >= H) return;  // the whole warp
  const int64_t base = static_cast<int64_t>(blockIdx.z) * H * W;
  const float* s = sums + base;
  float* o = out + base;
  const bool in = x < W;
  float cur[kFoldRows + 1], left[kFoldRows + 1];  // rows y0 - 1 .. y0 + kFoldRows - 1
#pragma unroll
  for (int r = 0; r <= kFoldRows; ++r) {
    const int y = y0 - 1 + r;
    const bool row = y >= 0 && y < H;
    cur[r] = row && in ? s[y * W + x] : 0.f;
    left[r] = row && lane == 0 && x > 0 ? s[y * W + x - 1] : 0.f;
  }
  float tp = 0.f;  // T, the x fold, of the row above (0 above row 0)
#pragma unroll
  for (int r = 0; r <= kFoldRows; ++r) {
    const int y = y0 - 1 + r;
    const float from_left = __shfl_up_sync(kFullMask, cur[r], 1);
    const float t = cur[r] + fold_term(lane == 0 ? left[r] : from_left, cur[r], x, W);
    if (r > 0 && in && y < H) o[y * W + x] = t + fold_term(tp, t, y, H);
    tp = t;
  }
}

// The has-value masks (count > 0) of (B, H, W) counts, as project_fold_kernel
// writes them with the fill: block 32 x 8 over a tile of 32 columns x 32 rows,
// grid (words_for(W), words_for(H), B).
__global__ void __launch_bounds__(kTile * kTileWarps)
project_mask_kernel(const float* __restrict__ cnt, uint32_t* __restrict__ rows,
                    uint32_t* __restrict__ row_sums, uint32_t* __restrict__ cols,
                    uint32_t* __restrict__ col_sums, int H, int W) {
  __shared__ uint32_t tile_rows[kTile];
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kTile + lane;
  const int b = blockIdx.z;
  const int64_t HW = static_cast<int64_t>(H) * W;
  for (int r = threadIdx.y; r < kTile; r += kTileWarps) {
    const int y = blockIdx.y * kTile + r;
    const bool has = y < H && x < W && cnt[b * HW + static_cast<int64_t>(y) * W + x] > 0.f;
    const uint32_t word = __ballot_sync(kFullMask, has);
    if (lane == 0) {
      tile_rows[r] = word;
      if (y < H) {
        const int64_t line = static_cast<int64_t>(b) * H + y;
        const int nw = words_for(W);
        rows[line * nw + blockIdx.x] = word;
        if (word) atomicOr(row_sums + line * words_for(nw) + blockIdx.x / 32, 1u << (blockIdx.x % 32));
      }
    }
  }
  __syncthreads();
  if (threadIdx.y != 0 || x >= W) return;
  uint32_t word = 0;
  for (int r = 0; r < kTile; ++r) word |= ((tile_rows[r] >> lane) & 1u) << r;
  const int64_t line = static_cast<int64_t>(b) * W + x;
  const int nh = words_for(H);
  cols[line * nh + blockIdx.y] = word;
  if (word) atomicOr(col_sums + line * words_for(nh) + blockIdx.y / 32, 1u << (blockIdx.y % 32));
}

// The raw fold of `planes` H x W planes of S into out.
inline cudaError_t launch_raw_fold(const float* sums, float* out, int planes, int H, int W,
                                   cudaStream_t st) {
  const dim3 grid(words_for(W), ceil_div(H, kTileWarps * kFoldRows), planes);
  project_raw_fold_kernel<<<grid, dim3(kTile, kTileWarps), 0, st>>>(sums, out, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile_sums(const T* flow, const int* origins, float* sums, float* out, int B,
                             int H, int W, int halo, int halo_h, int Hg, int Wg, cudaStream_t st) {
  const int64_t He = H + 2 * halo_h, We = W + 2 * halo;
  // 32-bit offsets inside a tile's planes; B and 3 B planes on the grid's z
  if (2LL * H * W > INT32_MAX || 3 * He * We > INT32_MAX || 3LL * B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * 3 * B * He * We, st);
  if (err != cudaSuccess) return err;
  project_tile_scatter_kernel<T><<<dim3(words_for(W), ceil_div(H, 8), B), dim3(32, 8), 0, st>>>(
      flow, origins, sums, H, W, halo, halo_h, Hg, Wg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_raw_fold(sums, out, 3 * B, static_cast<int>(He), static_cast<int>(We), st);
}

template <typename T, int P>
cudaError_t launch_payload_tile(const T* flow, const float* payload, const int* origins,
                                float* sums, float* out, int B, int H, int W, int S, int Hg,
                                int Wg, cudaStream_t st) {
  if (static_cast<int64_t>(Hg) * Wg > INT32_MAX || static_cast<int64_t>(S) * P > 65535)
    return cudaErrorInvalidValue;
  const int64_t planes = static_cast<int64_t>(S) * P * Hg * Wg;
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * planes, st);
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(B) * H * W;
  project_payload_tile_scatter_kernel<T, P><<<ceil_div(total, 256), 256, 0, st>>>(
      flow, payload, origins, sums, H, W, S, Hg, Wg, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_raw_fold(sums, out, S * P, Hg, Wg, st);
}

template <typename T>
cudaError_t launch_payload_tile_p(const void* flow, const void* payload, const void* origins,
                                  void* sums, void* out, int B, int P, int H, int W, int S,
                                  int Hg, int Wg, cudaStream_t st) {
  auto* f = static_cast<const T*>(flow);
  auto* v = static_cast<const float*>(payload);
  auto* o = static_cast<const int*>(origins);
  auto* s = static_cast<float*>(sums);
  auto* r = static_cast<float*>(out);
  if (P == 3) return launch_payload_tile<T, 3>(f, v, o, s, r, B, H, W, S, Hg, Wg, st);
  if (P == 4) return launch_payload_tile<T, 4>(f, v, o, s, r, B, H, W, S, Hg, Wg, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_sums(const T* flow, float* sums, void* out, uint32_t* rows, uint32_t* row_sums,
                        uint32_t* cols, uint32_t* col_sums, int B, int H, int W, bool fill,
                        cudaStream_t st) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t total = B * HW;
  project_scatter_kernel<T><<<ceil_div(total, 256), 256, 0, st>>>(flow, sums, H, W, HW, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(words_for(W), words_for(H), B), block(kTile, kTileWarps);
  if (fill) {
    project_fold_kernel<float, float, 3, true><<<grid, block, 0, st>>>(
        sums, static_cast<float*>(out), nullptr, rows, row_sums, cols, col_sums, H, W);
  } else {
    project_fold_kernel<T, T, 3, false><<<grid, block, 0, st>>>(
        sums, static_cast<T*>(out), nullptr, nullptr, nullptr, nullptr, nullptr, H, W);
  }
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_payload(const T* flow, const float* payload, float* sums, void* out, T* ex,
                           uint32_t* rows, uint32_t* row_sums, uint32_t* cols,
                           uint32_t* col_sums, int B, int H, int W, bool fill, cudaStream_t st) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t total = B * HW;
  project_payload_scatter_kernel<T, P><<<ceil_div(total, 256), 256, 0, st>>>(
      flow, payload, sums, H, W, HW, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(words_for(W), words_for(H), B), block(kTile, kTileWarps);
  if (fill) {
    project_fold_kernel<float, T, P, true><<<grid, block, 0, st>>>(
        sums, static_cast<float*>(out), ex, rows, row_sums, cols, col_sums, H, W);
  } else {
    project_fold_kernel<T, T, P, false><<<grid, block, 0, st>>>(
        sums, static_cast<T*>(out), ex, nullptr, nullptr, nullptr, nullptr, H, W);
  }
  return cudaGetLastError();
}

// Zero S (P float32 planes) and, with the fill, the mask summaries, which
// must follow S in memory (row_sums, then col_sums) so that one memset
// covers all three.
inline cudaError_t zero_scratch(void* sums, void* row_sums, void* col_sums, void* rows,
                                void* cols, int B, int P, int H, int W, bool fill,
                                cudaStream_t st) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  size_t zero_bytes = sizeof(float) * P * B * HW;
  if (fill) {
    const int64_t nrs = static_cast<int64_t>(B) * H * words_for(words_for(W));
    auto* rs = static_cast<uint32_t*>(row_sums);
    if (reinterpret_cast<char*>(rs) != static_cast<char*>(sums) + zero_bytes ||
        static_cast<uint32_t*>(col_sums) != rs + nrs || rows == nullptr || cols == nullptr)
      return cudaErrorInvalidValue;
    const int64_t ncs = static_cast<int64_t>(B) * W * words_for(words_for(H));
    zero_bytes += sizeof(uint32_t) * (nrs + ncs);
  }
  return cudaMemsetAsync(sums, 0, zero_bytes, st);
}

template <typename T>
cudaError_t launch_payload_p(const void* flow, const void* payload, void* sums, void* out,
                             void* ex, void* rows, void* row_sums, void* cols, void* col_sums,
                             int B, int P, int H, int W, bool fill, cudaStream_t st) {
  auto* f = static_cast<const T*>(flow);
  auto* v = static_cast<const float*>(payload);
  auto* s = static_cast<float*>(sums);
  auto* r = static_cast<uint32_t*>(rows);
  auto* rs = static_cast<uint32_t*>(row_sums);
  auto* c = static_cast<uint32_t*>(cols);
  auto* cs = static_cast<uint32_t*>(col_sums);
  if (P == 3) {
    return launch_payload<T, 3>(f, v, s, out, static_cast<T*>(ex), r, rs, c, cs, B, H, W, fill,
                                st);
  }
  if (P == 4) {
    return launch_payload<T, 4>(f, v, s, out, static_cast<T*>(ex), r, rs, c, cs, B, H, W, fill,
                                st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace memc

// The four mask arrays of a (B, H, W) projection, in 32-bit words:
//   rows (B, H, words(W)), row_sums (B, H, words(words(W))),
//   cols (B, W, words(H)), col_sums (B, W, words(words(H))),
// bit k of word j = pixel 32 j + k of the line; bit k of summary word j =
// mask word 32 j + k is not empty.  Bits past the line's end are 0.
//
// flow: (B, 2, H, W) in dtype; sums: (B, 3, H, W) float32 scratch.
// Without fill (rows ... col_sums null): out (B, 2, H, W) in dtype, the
// projected flow.  With fill: out (B, 2, H, W) float32, the average, and the
// masks written; row_sums and col_sums must follow sums in memory in that
// order, so that one memset zeroes all three.
MEMC_API int memc_project_sums(const void* flow, void* sums, void* out, void* rows,
                               void* row_sums, void* cols, void* col_sums, int B, int H, int W,
                               int dtype, int fill, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = memc::zero_scratch(sums, row_sums, col_sums, rows, cols, B, 3, H, W,
                                       fill != 0, st);
  if (err != cudaSuccess) return err;
  auto* s = static_cast<float*>(sums);
  auto* r = static_cast<uint32_t*>(rows);
  auto* rs = static_cast<uint32_t*>(row_sums);
  auto* c = static_cast<uint32_t*>(cols);
  auto* cs = static_cast<uint32_t*>(col_sums);
  if (dtype == memc::kFloat32) {
    return memc::launch_sums(static_cast<const float*>(flow), s, out, r, rs, c, cs, B, H, W,
                             fill != 0, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_sums(static_cast<const __nv_bfloat16*>(flow), s, out, r, rs, c, cs, B, H,
                             W, fill != 0, st);
  }
  return cudaErrorInvalidValue;
}

// K2's payload entry.  flow: (B, 2, H, W) in dtype; payload: (B, P, H, W)
// float32, P = 3 or 4; sums: (B, P, H, W) float32 scratch.  out: (B, 2, H, W)
// in dtype without fill, float32 (the average) with it, planes 0 and 1 of the
// result; ex: (B, P-3, H, W) in dtype, planes 2 .. P-2 (null for P = 3); the
// masks and their layout as memc_project_sums's, from plane P-1 > 0.
MEMC_API int memc_project_payload(const void* flow, const void* payload, void* sums, void* out,
                                  void* ex, void* rows, void* row_sums, void* cols,
                                  void* col_sums, int B, int P, int H, int W, int dtype,
                                  int fill, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if ((P != 3 && P != 4) || (P == 4 && ex == nullptr)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = memc::zero_scratch(sums, row_sums, col_sums, rows, cols, B, P, H, W,
                                       fill != 0, st);
  if (err != cudaSuccess) return err;
  if (dtype == memc::kFloat32) {
    return memc::launch_payload_p<float>(flow, payload, sums, out, ex, rows, row_sums, cols,
                                         col_sums, B, P, H, W, fill != 0, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_payload_p<__nv_bfloat16>(flow, payload, sums, out, ex, rows, row_sums,
                                                 cols, col_sums, B, P, H, W, fill != 0, st);
  }
  return cudaErrorInvalidValue;
}

// avg: (B, 2, H, W) float32; the masks as above; out: (B, 2, H, W) in dtype.
// down: also search the nearest value below (fix_down_scan_bug).
MEMC_API int memc_project_fill(const void* avg, const void* rows, const void* row_sums,
                               const void* cols, const void* col_sums, void* out, int B, int H,
                               int W, int dtype, int down, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(memc::words_for(W), memc::ceil_div(H, 8), B), block(32, 8);
  const auto* a = static_cast<const float*>(avg);
  const auto* r = static_cast<const uint32_t*>(rows);
  const auto* rs = static_cast<const uint32_t*>(row_sums);
  const auto* c = static_cast<const uint32_t*>(cols);
  const auto* cs = static_cast<const uint32_t*>(col_sums);
  if (dtype == memc::kFloat32) {
    auto* o = static_cast<float*>(out);
    if (down) {
      memc::project_fill_kernel<float, true, false><<<grid, block, 0, st>>>(
          a, r, rs, c, cs, o, H, W, nullptr, nullptr, nullptr);
    } else {
      memc::project_fill_kernel<float, false, false><<<grid, block, 0, st>>>(
          a, r, rs, c, cs, o, H, W, nullptr, nullptr, nullptr);
    }
  } else if (dtype == memc::kBFloat16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (down) {
      memc::project_fill_kernel<__nv_bfloat16, true, false><<<grid, block, 0, st>>>(
          a, r, rs, c, cs, o, H, W, nullptr, nullptr, nullptr);
    } else {
      memc::project_fill_kernel<__nv_bfloat16, false, false><<<grid, block, 0, st>>>(
          a, r, rs, c, cs, o, H, W, nullptr, nullptr, nullptr);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K2's tile entry.  flow: (B, 2, H, W) tiles in dtype; origins: (B, 2) int32
// on the device, each tile's (x, y) origin in the Hg x Wg frame; sums:
// (B, 3, H + 2 halo_h, W + 2 halo) float32 scratch; out: the same shape,
// float32: the base sums of (-fx, -fy, 1) with both +1 folds at the
// extended buffer's edges.  halo_h = 0: H is not tiled.
MEMC_API int memc_project_tile_sums(const void* flow, const void* origins, void* sums, void* out,
                                    int B, int H, int W, int halo, int halo_h, int Hg, int Wg,
                                    int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if (halo < 1 || halo_h < 0 || origins == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(origins);
  auto* s = static_cast<float*>(sums);
  auto* r = static_cast<float*>(out);
  if (dtype == memc::kFloat32) {
    return memc::launch_tile_sums(static_cast<const float*>(flow), o, s, r, B, H, W, halo, halo_h,
                                  Hg, Wg, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_tile_sums(static_cast<const __nv_bfloat16*>(flow), o, s, r, B, H, W, halo,
                                  halo_h, Hg, Wg, st);
  }
  return cudaErrorInvalidValue;
}

// K2's payload entry on tile origins.  flow: (B, 2, H, W) tiles in dtype;
// payload: (B, P, H, W) float32, P = 3 or 4; origins: (B, 4) int32 on the
// device (y0, x0, own_h, own_w of each tile in the Hg x Wg frame); sums: (S,
// P, Hg, Wg) float32 scratch; out: the same shape, float32: each sample's
// whole-frame sums of its tiles' payloads with both +1 folds at the frame's
// border, no divide.  B must be a multiple of S; tile b is of sample b % S.
MEMC_API int memc_project_payload_tile(const void* flow, const void* payload,
                                       const void* origins, void* sums, void* out, int B, int P,
                                       int H, int W, int S, int Hg, int Wg, int dtype,
                                       void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if (S < 1 || B % S != 0 || Hg < 1 || Wg < 1 || origins == nullptr)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == memc::kFloat32) {
    return memc::launch_payload_tile_p<float>(flow, payload, origins, sums, out, B, P, H, W, S,
                                              Hg, Wg, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_payload_tile_p<__nv_bfloat16>(flow, payload, origins, sums, out, B, P,
                                                      H, W, S, Hg, Wg, st);
  }
  return cudaErrorInvalidValue;
}

// K3's carry entry.  avg: (B, 2, H, W) float32, the cropped tiles'
// average; cnt: (B, H, W) float32, their counts; masks: int32 scratch of
// row_sums, col_sums, rows, cols in that order (the layouts of
// memc_project_sums); left, right: (B, 3, H) float32 carries per row; up:
// (B, 3, W) per column, or null where H is not tiled; out: (B, 2, H, W) in
// dtype.
MEMC_API int memc_project_fill_carry(const void* avg, const void* cnt, void* masks,
                                     const void* left, const void* right, const void* up,
                                     void* out, int B, int H, int W, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if (left == nullptr || right == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nw = memc::words_for(W), nh = memc::words_for(H);
  auto* rs = static_cast<uint32_t*>(masks);
  uint32_t* cs = rs + static_cast<int64_t>(B) * H * memc::words_for(nw);
  uint32_t* r = cs + static_cast<int64_t>(B) * W * memc::words_for(nh);
  uint32_t* c = r + static_cast<int64_t>(B) * H * nw;
  // the summaries are ORed into; every mask word is written
  cudaError_t err = cudaMemsetAsync(rs, 0, sizeof(uint32_t) * (r - rs), st);
  if (err != cudaSuccess) return err;
  memc::project_mask_kernel<<<dim3(nw, nh, B), dim3(memc::kTile, memc::kTileWarps), 0, st>>>(
      static_cast<const float*>(cnt), r, rs, c, cs, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(nw, memc::ceil_div(H, 8), B), block(32, 8);
  const auto* a = static_cast<const float*>(avg);
  const auto* lf = static_cast<const float*>(left);
  const auto* rt = static_cast<const float*>(right);
  const auto* u = static_cast<const float*>(up);
  if (dtype == memc::kFloat32) {
    memc::project_fill_kernel<float, false, true><<<grid, block, 0, st>>>(
        a, r, rs, c, cs, static_cast<float*>(out), H, W, lf, rt, u);
  } else if (dtype == memc::kBFloat16) {
    memc::project_fill_kernel<__nv_bfloat16, false, true><<<grid, block, 0, st>>>(
        a, r, rs, c, cs, static_cast<__nv_bfloat16*>(out), H, W, lf, rt, u);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
