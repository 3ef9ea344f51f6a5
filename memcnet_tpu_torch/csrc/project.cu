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
//                      four pixels a thread, vector loads of the average
//                      and vector stores where the rows allow them, the row
//                      mask word read once per 32 pixels: a hole takes the
//                      mean of the nearest value to its left, right and
//                      above (no down-scan: the reference disabled it by
//                      accident, my_lib_kernel.cu:1799; the JAX opt-in
//                      fix_down_scan_bug adds the nearest value below, the
//                      mirror of the up search in the same column masks);
//                      every pixel is written in the flow's type.
//
// K2's payload entry (memc_project_payload) serves the depth-weighted (N7)
// and the brightness-gated (N8) projections (memcnet_tpu/ops/projection.py::
// depth_flow_project and weighted_flow_project, whose _scatter4 runs
// scatter_bands on a payload of P = 3 or 4 planes): the same memset, a
// scatter that builds each source pixel's payload itself from the op's
// inputs (DepthPayload: the flow and the depth; GatedPayload: the flow,
// frame1 at the pixel and frame2 at the truncated, clamped p + 2 f, the gate
// err <= threshold) and adds it at the landing cell the flow sets, and the
// same fold, which divides planes 0 .. P-2 by plane P-1 where it is > 0 and
// takes "has a value" from plane P-1 > 0 (a sum of depths, or a count of
// gated pixels).  No payload is written to or read from device memory.
//
// Bound on the H100: memory -- the flow (and the op's inputs) read once,
// the result written once;
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
//       project_op_scatter_kernel on tile origins (each owned pixel of a tile
//       lands at the frame's cell, tile origin + local position in float32,
//       builds its payload as the untiled entry does -- the gate reads frame2's
//       whole level -- and atomicAdds its P planes into its sample's
//       whole-frame buffer, every stacked tile of a sample into the same one;
//       a (columns, rows, tiles) grid with 32-bit offsets in a tile) and
//       project_raw_fold_kernel over the P planes (the +1 folds at the frame's
//       own border, so a clamped right or bottom neighbour takes its
//       contribution twice, as in the untiled op).  No divide:
//       parallel/partition.py's reduce gives each tile its owned part of the
//       sums first.
//   K3  memc_project_fill_tiles: the whole tiled fill of the cropped tiles
//       (the JAX _tiled_fill and chained_scan) in two launches:
//       project_mask_kernel (the has-value masks of every tile from its
//       counts; no summary words, so no memset and no atomics: a search
//       reads the words of a line one by one) and project_fill_tiles_kernel:
//       where a tile's own search finds nothing, the thread walks the tiles
//       stacked in the same batch (parallel/ring.py: (outer, t, inner), the
//       neighbour k tiles before b at b - k inner), nearest first and no
//       further than the frame's edge, and takes the last (first) projected
//       pixel of the same row (column) there -- what parallel/tiling.py::
//       _carry's ring hops pick, without them.  An axis across ranks takes
//       its carries (_edge_message + _carry over the ring) as arguments
//       instead.  No down search.
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

// A tracer's sum of the flow's per-pixel |f| = sqrt(fx^2 + fy^2): the
// source pixels of one whole block of 256 threads of a 1D grid summed in
// float32 (each warp's by shuffles, then the first warp's over the eight
// warps' sums), added to *acc by its first thread.  One atomic a block: with
// one a warp, the atomics queued on the one address and made K2 3.7 times as
// long on an H100 (8 flows of 768x1344).  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void add_magnitudes(const T* __restrict__ flow, int64_t HW,
                                               int64_t total, int64_t idx, double* acc) {
  constexpr int kWarps = 256 / 32;
  __shared__ float warp_sums[kWarps];
  float m = 0.f;
  if (idx < total) {
    const int64_t b = idx / HW;
    const T* f = flow + 2 * b * HW + (idx - b * HW);
    const float fx = to_f32(f[0]);
    const float fy = to_f32(f[HW]);
    m = sqrtf(fx * fx + fy * fy);
  }
  for (int o = 16; o > 0; o >>= 1) m += __shfl_xor_sync(kFullMask, m, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.f;
    for (int o = kWarps / 2; o > 0; o >>= 1) m += __shfl_xor_sync(kFullMask, m, o);
    if (threadIdx.x == 0 && m != 0.f) atomicAdd(acc, static_cast<double>(m));
  }
}

// K2's scatter; where flow_px is not null it also adds the flow's |f| to it.
template <typename T>
__global__ void __launch_bounds__(256)
project_scatter_kernel(const T* __restrict__ flow, float* __restrict__ sums, int H, int W,
                       int64_t HW, int64_t total, double* __restrict__ flow_px) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (flow_px) add_magnitudes(flow, HW, total, idx, flow_px);
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

// -- the payloads of N7 and N8, built where they are scattered -----------------
//
// op(b, p, HW, fx, fy, gx, gy, s, Hg, Wg, v): the payload of source pixel p
// of row b (H W = HW pixels a row), at the frame's position (gx, gy) of
// sample s's Hg x Wg frame, whose landing is valid; false where a gate fails.

enum PayloadOp : int { kDepthOp = 0, kGatedOp = 1 };

// N7 (ops/cuda/project_kernel.py::depth_payload): (-fx d, -fy d, d) in
// float32, d the pixel's depth.
template <typename A>
struct DepthPayload {
  static constexpr int P = 3;
  const A* depth;  // (B, 1, H, W), the flow's rows
  __device__ __forceinline__ bool operator()(int b, int p, int HW, float fx, float fy, int, int,
                                             int, int, int, float* v) const {
    const float d = to_f32(depth[static_cast<int64_t>(b) * HW + p]);
    v[0] = -fx * d;
    v[1] = -fy * d;
    v[2] = d;
    return true;
  }
};

// N8 (ops/cuda/project_kernel.py::brightness_error and gated_payload): err =
// d0/3 + d1/3 + d2/3 + 1e-8 in that order, with true division, dc = |frame1(p) -
// frame2(nn)| per channel, nn = trunc(clamp(p + 2 f)) in frame2's whole
// level; the gate err <= threshold (the threshold rounded to float32 by the
// caller); (-fx, -fy, err, 1).  The sums are rounded where the plain version
// rounds them: no fma contraction.
template <typename A>
struct GatedPayload {
  static constexpr int P = 4;
  const A* frame1;  // (B, 3, H, W), the flow's rows
  const A* frame2;  // (S, 3, Hg, Wg), each sample's whole level
  float threshold;
  __device__ __forceinline__ bool operator()(int b, int p, int HW, float fx, float fy, int gx,
                                             int gy, int s, int Hg, int Wg, float* v) const {
    const float x3 = fminf(fmaxf(__fadd_rn(static_cast<float>(gx), __fmul_rn(2.f, fx)), 0.f),
                           static_cast<float>(Wg - 1));
    const float y3 = fminf(fmaxf(__fadd_rn(static_cast<float>(gy), __fmul_rn(2.f, fy)), 0.f),
                           static_cast<float>(Hg - 1));
    const int64_t HWg = static_cast<int64_t>(Hg) * Wg;
    const A* a = frame1 + static_cast<int64_t>(b) * 3 * HW + p;
    const A* c = frame2 + static_cast<int64_t>(s) * 3 * HWg +
                 static_cast<int64_t>(__float2int_rz(y3)) * Wg + __float2int_rz(x3);
    const float d0 = fabsf(to_f32(a[0]) - to_f32(c[0]));
    const float d1 = fabsf(to_f32(a[HW]) - to_f32(c[HWg]));
    const float d2 = fabsf(to_f32(a[2 * HW]) - to_f32(c[2 * HWg]));
    const float err = __fadd_rn(
        __fadd_rn(__fadd_rn(__fdiv_rn(d0, 3.f), __fdiv_rn(d1, 3.f)), __fdiv_rn(d2, 3.f)), 1e-8f);
    if (!(err <= threshold)) return false;
    v[0] = -fx;
    v[1] = -fy;
    v[2] = err;
    v[3] = 1.f;
    return true;
  }
};

// K2's payload scatter, the payload built by ``op``: one thread per source
// pixel of B rows of H x W.  Block (32, 8) over 32 columns x 8 rows, grid
// (words_for(W), ceil(H / 8), B): no division, 32-bit offsets in a row.
// Untiled (origins null): row b is sample b's whole frame (S = B, Hg x Wg =
// H x W).  On tile origins (B x 4 int32: y0, x0, own_h, own_w, one address
// for the whole block): row b is a stacked tile of sample b % S's Hg x Wg
// frame at (y0, x0), and a pixel past its owned (own_h, own_w) is padding and
// adds nothing.  A valid landing (float32 frame position + f in the frame;
// NaN fails) adds the P planes at the frame's base cell of its sample's
// whole-frame sums.
template <typename T, class Op>
__global__ void __launch_bounds__(256)
project_op_scatter_kernel(const T* __restrict__ flow, Op op, const int* __restrict__ origins,
                          float* __restrict__ sums, int H, int W, int S, int Hg, int Wg) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int b = blockIdx.z;
  int gx = x, gy = y, s = b;
  if (origins != nullptr) {
    const int* o = origins + 4 * b;
    if (y >= o[2] || x >= o[3]) return;
    gy = o[0] + y;
    gx = o[1] + x;
    s = b % S;
  }
  const int HW = H * W, p = y * W + x;
  const T* f = flow + static_cast<int64_t>(b) * 2 * HW + p;
  const float fx = to_f32(f[0]);
  const float fy = to_f32(f[HW]);
  const float x2 = static_cast<float>(gx) + fx;
  const float y2 = static_cast<float>(gy) + fy;
  if (!(x2 >= 0.f && y2 >= 0.f && x2 <= static_cast<float>(Wg - 1) &&
        y2 <= static_cast<float>(Hg - 1)))
    return;
  float v[Op::P];
  if (!op(b, p, HW, fx, fy, gx, gy, s, Hg, Wg, v)) return;
  const int ix = clampi(__float2int_rz(x2), 0, Wg - 1);
  const int iy = clampi(__float2int_rz(y2), 0, Hg - 1);
  const int64_t HWg = static_cast<int64_t>(Hg) * Wg;
  float* d = sums + static_cast<int64_t>(s) * Op::P * HWg + static_cast<int64_t>(iy) * Wg + ix;
#pragma unroll
  for (int c = 0; c < Op::P; ++c) atomicAdd(d + c * HWg, v[c]);
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

// The highest set bit of a line's mask words [0, w), as a pixel index, or
// -1.  kSums: by the summary words (bit k of summary word j set = mask word
// 32 j + k not empty), which name the nearest non-empty word at once; else
// by reading the words down from w - 1.
template <bool kSums>
__device__ __forceinline__ int last_before(const uint32_t* __restrict__ words,
                                           const uint32_t* __restrict__ wsum, int w) {
  if (kSums) {
    if (w <= 0) return -1;
    int s = (w - 1) / 32;
    uint32_t sm = wsum[s] & (kFullMask >> (31 - (w - 1) % 32));
    while (!sm && s > 0) sm = wsum[--s];
    if (!sm) return -1;
    const int ww = s * 32 + 31 - __clz(static_cast<int>(sm));
    return ww * 32 + 31 - __clz(static_cast<int>(words[ww]));
  }
  for (int ww = w - 1; ww >= 0; --ww) {
    const uint32_t m = words[ww];
    if (m) return ww * 32 + 31 - __clz(static_cast<int>(m));
  }
  return -1;
}

// The lowest set bit of a line's mask words [w, words_for(n)) of a line of n
// pixels, or n.
template <bool kSums>
__device__ __forceinline__ int first_from(const uint32_t* __restrict__ words,
                                          const uint32_t* __restrict__ wsum, int w, int n) {
  const int nw = words_for(n);
  if (w >= nw) return n;
  if (kSums) {
    const int nsum = words_for(nw);
    int s = w / 32;
    uint32_t sm = wsum[s] & (kFullMask << (w % 32));
    while (!sm && s + 1 < nsum) sm = wsum[++s];
    if (!sm) return n;
    const int ww = s * 32 + __ffs(static_cast<int>(sm)) - 1;
    return ww * 32 + __ffs(static_cast<int>(words[ww])) - 1;
  }
  for (int ww = w; ww < nw; ++ww) {
    const uint32_t m = words[ww];
    if (m) return ww * 32 + __ffs(static_cast<int>(m)) - 1;
  }
  return n;
}

// Nearest set bit below i in a line's mask words, or -1: the word of i
// first, then the words below it.
template <bool kSums = true>
__device__ __forceinline__ int nearest_below(const uint32_t* __restrict__ words,
                                             const uint32_t* __restrict__ wsum, int i) {
  const int w = i / 32;
  const uint32_t m = words[w] & ((1u << (i % 32)) - 1u);
  if (m) return w * 32 + 31 - __clz(static_cast<int>(m));
  return last_before<kSums>(words, wsum, w);
}

// Nearest set bit above i in a line of n bits, or n.
template <bool kSums = true>
__device__ __forceinline__ int nearest_above(const uint32_t* __restrict__ words,
                                             const uint32_t* __restrict__ wsum, int i, int n) {
  const int w = i / 32;
  const uint32_t m = words[w] & ~((2u << (i % 32)) - 1u);  // 2u << 31 wraps to 0
  if (m) return w * 32 + __ffs(static_cast<int>(m)) - 1;
  return first_from<kSums>(words, wsum, w + 1, n);
}

// K3: 4 pixels a thread, so a warp fills 128 consecutive pixels of a row;
// kDown adds the nearest value below (fix_down_scan_bug).  Lane 8 k reads
// the row's mask word k of the warp's four and shares it by shuffle (one
// read per 32 pixels); each thread loads its 4 pixels of both average
// planes with one 16-byte load each and stores its 4 outputs with one
// 16-byte (float32) or 8-byte (bf16) store each, where the row is 16-byte
// aligned (vec: W % 4 == 0 and the pointers aligned), else pixel by pixel.
// A thread's holes are searched together, so their loads are in flight at
// once: left and right from the row word in the register, past it once for
// all of them (last_before, first_from); up (and down) per hole as
// nearest_below / nearest_above do, the four columns' words read together;
// then every value the sums take.  Summed in the plain version's order ((0
// + left) + right) + up (+ down), the result is the plain version's bit for
// bit.  Where count is not null, each warp adds its rows' pixels with no
// projected value to *count (one atomic a warp; a tracer's hole counter).
// Block: 32 x 8 threads; grid (ceil(W / 128), ceil(H / 8), B).
constexpr int kFillPx = 4;  // pixels a thread

template <typename T>
struct alignas(kFillPx * sizeof(T)) FillOut {
  T v[kFillPx];
};

template <typename T, bool kDown>
__global__ void __launch_bounds__(256)
project_fill_kernel(const float* __restrict__ avg, const uint32_t* __restrict__ rows,
                     const uint32_t* __restrict__ row_sums, const uint32_t* __restrict__ cols,
                     const uint32_t* __restrict__ col_sums, T* __restrict__ out, int H, int W,
                     bool vec, unsigned long long* __restrict__ count) {
  constexpr int P = kFillPx;
  const int lane = threadIdx.x;
  const int x0 = (blockIdx.x * 32 + lane) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (y >= H) return;  // the whole warp: one row
  const int nw = words_for(W), nh = words_for(H);
  const int64_t rline = static_cast<int64_t>(b) * H + y;
  const uint32_t* rw = rows + rline * nw;
  const int wd = blockIdx.x * 4 + lane / 8;  // this thread's mask word
  uint32_t word = 0;
  if (lane % 8 == 0 && wd < nw) word = rw[wd];
  word = __shfl_sync(kFullMask, word, lane & ~7);
  const int n = min(P, W - x0);  // pixels of this thread in the row, <= 0 past it
  const int bit0 = x0 % 32;
  const uint32_t mine = n >= P ? 0xfu : n > 0 ? (1u << n) - 1u : 0u;  // this thread's pixels
  const uint32_t holes = ~(word >> bit0) & mine;
  if (count) {  // the whole warp is here: only whole warps returned above
    const unsigned c = __reduce_add_sync(kFullMask, static_cast<unsigned>(__popc(holes)));
    if (lane == 0 && c) atomicAdd(count, static_cast<unsigned long long>(c));
  }
  if (n <= 0) return;
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t row = static_cast<int64_t>(y) * W;
  const float* ax = avg + 2 * b * HW;
  const float* ay = ax + HW;
  T* ox = out + 2 * b * HW + row + x0;
  float vx[P], vy[P];
  const bool whole = vec && n == P;
  if (whole) {
    const float4 qx = *reinterpret_cast<const float4*>(ax + row + x0);
    const float4 qy = *reinterpret_cast<const float4*>(ay + row + x0);
    vx[0] = qx.x, vx[1] = qx.y, vx[2] = qx.z, vx[3] = qx.w;
    vy[0] = qy.x, vy[1] = qy.y, vy[2] = qy.z, vy[3] = qy.w;
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      vx[k] = k < n ? ax[row + x0 + k] : 0.f;
      vy[k] = k < n ? ay[row + x0 + k] : 0.f;
    }
  }
  FillOut<T> px, py;
  if (holes) {
    // left and right of each hole: in the word, else past it (once for all)
    int l[P], r[P];
    bool far_l = false, far_r = false;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int bit = bit0 + k;
      const uint32_t lm = word & ((1u << bit) - 1u);
      const uint32_t rm = word & ~((2u << bit) - 1u);  // 2u << 31 wraps to 0
      l[k] = lm ? wd * 32 + 31 - __clz(static_cast<int>(lm)) : -1;
      r[k] = rm ? wd * 32 + __ffs(static_cast<int>(rm)) - 1 : W;
      far_l |= ((holes >> k) & 1u) && !lm;
      far_r |= ((holes >> k) & 1u) && !rm;
    }
    const uint32_t* rs = row_sums + rline * words_for(nw);
    const int fl = far_l ? last_before<true>(rw, rs, wd) : -1;
    const int fr = far_r ? first_from<true>(rw, rs, wd + 1, W) : W;
    // up (and down) of each hole, the columns' words read together
    int u[P], d[P];
    uint32_t um[P], dm[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      um[k] = dm[k] = 0;
      if ((holes >> k) & 1u) {
        const uint32_t m = cols[(static_cast<int64_t>(b) * W + x0 + k) * nh + y / 32];
        um[k] = m & ((1u << (y % 32)) - 1u);
        dm[k] = m & ~((2u << (y % 32)) - 1u);
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      u[k] = -1;
      d[k] = H;
      if (!((holes >> k) & 1u)) continue;
      const int64_t cline = static_cast<int64_t>(b) * W + x0 + k;
      const uint32_t* cw = cols + cline * nh;
      const uint32_t* cs = col_sums + cline * words_for(nh);
      u[k] = um[k] ? (y / 32) * 32 + 31 - __clz(static_cast<int>(um[k]))
                   : last_before<true>(cw, cs, y / 32);
      if (kDown) {
        d[k] = dm[k] ? (y / 32) * 32 + __ffs(static_cast<int>(dm[k])) - 1
                     : first_from<true>(cw, cs, y / 32 + 1, H);
      }
    }
    // the plain version's order ((0 + left) + right) + up (+ down), a
    // missing direction adding 0
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!((holes >> k) & 1u)) continue;
      const int x = x0 + k;
      const int lk = l[k] >= 0 ? l[k] : fl, rk = r[k] < W ? r[k] : fr;
      float nx = 0.f, ny = 0.f, den = 0.f;
      nx += lk >= 0 ? ax[row + lk] : 0.f;
      ny += lk >= 0 ? ay[row + lk] : 0.f;
      den += lk >= 0 ? 1.f : 0.f;
      nx += rk < W ? ax[row + rk] : 0.f;
      ny += rk < W ? ay[row + rk] : 0.f;
      den += rk < W ? 1.f : 0.f;
      const int64_t up_at = static_cast<int64_t>(u[k]) * W + x;
      nx += u[k] >= 0 ? ax[up_at] : 0.f;
      ny += u[k] >= 0 ? ay[up_at] : 0.f;
      den += u[k] >= 0 ? 1.f : 0.f;
      if (kDown) {
        const int64_t down = static_cast<int64_t>(d[k]) * W + x;
        nx += d[k] < H ? ax[down] : 0.f;
        ny += d[k] < H ? ay[down] : 0.f;
        den += d[k] < H ? 1.f : 0.f;
      }
      vx[k] = den > 0.f ? nx / den : vx[k];
      vy[k] = den > 0.f ? ny / den : vy[k];
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    px.v[k] = from_f32<T>(vx[k]);
    py.v[k] = from_f32<T>(vy[k]);
  }
  if (whole) {
    *reinterpret_cast<FillOut<T>*>(ox) = px;
    *reinterpret_cast<FillOut<T>*>(ox + HW) = py;
  } else {
    for (int k = 0; k < n; ++k) {
      ox[k] = px.v[k];
      ox[HW + k] = py.v[k];
    }
  }
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

// The has-value masks (count > 0) of (B, H, W) counts at cnt[b c_sb + y c_sy
// + x], as project_fold_kernel writes them with the fill, without summaries:
// block 32 x 8 over a tile of 32 columns x 32 rows, grid (words_for(W),
// words_for(H), B).  Every mask word is written (a ballot for a row word, the
// tile's rows transposed in shared memory for a column word).
__global__ void __launch_bounds__(kTile * kTileWarps)
project_mask_kernel(const float* __restrict__ cnt, int64_t c_sb, int c_sy,
                    uint32_t* __restrict__ rows, uint32_t* __restrict__ cols, int H, int W) {
  __shared__ uint32_t tile_rows[kTile];
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kTile + lane;
  const int b = blockIdx.z;
  const float* c = cnt + b * c_sb;
  for (int r = threadIdx.y; r < kTile; r += kTileWarps) {
    const int y = blockIdx.y * kTile + r;
    const bool has = y < H && x < W && c[y * c_sy + x] > 0.f;
    const uint32_t word = __ballot_sync(kFullMask, has);
    if (lane == 0) {
      tile_rows[r] = word;
      if (y < H) {
        rows[(static_cast<int64_t>(b) * H + y) * words_for(W) + blockIdx.x] = word;
      }
    }
  }
  __syncthreads();
  if (threadIdx.y != 0 || x >= W) return;
  uint32_t word = 0;
  for (int r = 0; r < kTile; ++r) word |= ((tile_rows[r] >> lane) & 1u) << r;
  cols[(static_cast<int64_t>(b) * W + x) * words_for(H) + blockIdx.y] = word;
}

// A tile axis of the tiled fill: stacked in this process's batch (t tiles,
// the neighbour k tiles before tile b at b - k inner, parallel/ring.py::
// TileRing's (outer, t, inner)) when t > 1 and no carries are given; else
// its carries come as arguments or it is not tiled.
struct Stack {
  int t, inner;
};

// The value a hole takes from one direction: found in its own tile (at
// (own_y, own_x) of avg row ``ab``), or where it is not, the carry given in
// (B, 3, L) per line (plane 0 > 0: there is a value), or the nearest stacked
// tile's edge value.  Adds to (nx, ny, den) only what it finds: the plain
// version's missing direction adds 0.
struct Acc {
  float nx = 0.f, ny = 0.f, den = 0.f;
  __device__ __forceinline__ void add(const float* a, int a_sc, int at) {
    nx += a[at];
    ny += a[a_sc + at];
    den += 1.f;
  }
  __device__ __forceinline__ void add_carry(const float* c, int64_t line, int L) {
    const float* v = c + line;  // c: (B, 3, L), line = 3 b L + i
    if (v[0] > 0.f) {
      nx += v[L];
      ny += v[2 * L];
      den += 1.f;
    }
  }
};

// K3's tile entry: the hole fill of B cropped tiles of H x W, their float32
// average at avg[b a_sb + c a_sc + y a_sy + x] and has-value masks (the
// layouts of memc_project_sums's rows and cols; no summaries), out (B, 2, H,
// W) in T.  Where a tile's own search finds nothing, the left and right
// searches continue over ``sw`` (or take ``left`` / ``right``, (B, 3, H)) and
// the up search over ``sh`` (or ``up``, (B, 3, W)).  Block: 32 x 8 threads,
// one pixel each; grid (words_for(W), ceil(H / 8), B).
template <typename T>
__global__ void __launch_bounds__(256)
project_fill_tiles_kernel(const float* __restrict__ avg, int64_t a_sb, int a_sc, int a_sy,
                          const uint32_t* __restrict__ rows, const uint32_t* __restrict__ cols,
                          T* __restrict__ out, int H, int W, Stack sw, Stack sh,
                          const float* __restrict__ left, const float* __restrict__ right,
                          const float* __restrict__ up) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int nw = words_for(W), nh = words_for(H);
  const float* ab = avg + b * a_sb;
  const int at = y * a_sy + x;
  T* o = out + static_cast<int64_t>(b) * 2 * H * W + y * W + x;
  const int64_t rline = static_cast<int64_t>(b) * H + y;
  const uint32_t* rw = rows + rline * nw;
  if ((rw[x / 32] >> (x % 32)) & 1u) {
    o[0] = from_f32<T>(ab[at]);
    o[H * W] = from_f32<T>(ab[a_sc + at]);
    return;
  }
  // the plain version's order: ((0 + left) + right) + up
  Acc acc;
  const int l = nearest_below<false>(rw, nullptr, x);
  if (l >= 0) {
    acc.add(ab, a_sc, y * a_sy + l);
  } else if (left != nullptr) {
    acc.add_carry(left, 3LL * b * H + y, H);
  } else if (sw.t > 1) {
    for (int k = 1, bb = b - sw.inner; k <= b / sw.inner % sw.t; ++k, bb -= sw.inner) {
      const int64_t line = static_cast<int64_t>(bb) * H + y;
      const int e = last_before<false>(rows + line * nw, nullptr, nw);
      if (e >= 0) {
        acc.add(avg + bb * a_sb, a_sc, y * a_sy + e);
        break;
      }
    }
  }
  const int r = nearest_above<false>(rw, nullptr, x, W);
  if (r < W) {
    acc.add(ab, a_sc, y * a_sy + r);
  } else if (right != nullptr) {
    acc.add_carry(right, 3LL * b * H + y, H);
  } else if (sw.t > 1) {
    for (int k = 1, bb = b + sw.inner; k < sw.t - b / sw.inner % sw.t; ++k, bb += sw.inner) {
      const int64_t line = static_cast<int64_t>(bb) * H + y;
      const int e = first_from<false>(rows + line * nw, nullptr, 0, W);
      if (e < W) {
        acc.add(avg + bb * a_sb, a_sc, y * a_sy + e);
        break;
      }
    }
  }
  const int64_t cline = static_cast<int64_t>(b) * W + x;
  const int u = nearest_below<false>(cols + cline * nh, nullptr, y);
  if (u >= 0) {
    acc.add(ab, a_sc, u * a_sy + x);
  } else if (up != nullptr) {
    acc.add_carry(up, 3LL * b * W + x, W);
  } else if (sh.t > 1) {
    for (int k = 1, bb = b - sh.inner; k <= b / sh.inner % sh.t; ++k, bb -= sh.inner) {
      const int64_t line = static_cast<int64_t>(bb) * W + x;
      const int e = last_before<false>(cols + line * nh, nullptr, nh);
      if (e >= 0) {
        acc.add(avg + bb * a_sb, a_sc, e * a_sy + x);
        break;
      }
    }
  }
  o[0] = from_f32<T>(acc.den > 0.f ? acc.nx / acc.den : ab[at]);
  o[H * W] = from_f32<T>(acc.den > 0.f ? acc.ny / acc.den : ab[a_sc + at]);
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

template <typename T>
cudaError_t launch_sums(const T* flow, float* sums, void* out, uint32_t* rows, uint32_t* row_sums,
                        uint32_t* cols, uint32_t* col_sums, int B, int H, int W, bool fill,
                        double* flow_px, cudaStream_t st) {
  const int64_t HW = static_cast<int64_t>(H) * W;
  const int64_t total = B * HW;
  project_scatter_kernel<T><<<ceil_div(total, 256), 256, 0, st>>>(flow, sums, H, W, HW, total,
                                                                   flow_px);
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

// Where the payload scatter writes and what follows it.  Untiled (origins
// null): S (B, P, H, W) zeroed by zero_scratch, then the fold-and-divide
// into out (and ex, and with the fill the masks); on tile origins: S (S_, P,
// Hg, Wg) zeroed here, then the raw fold into out.
struct PayloadArgs {
  const int* origins;
  float* sums;
  void* out;
  void* ex;
  uint32_t *rows, *row_sums, *cols, *col_sums;
  int B, H, W, S, Hg, Wg;
  bool fill;
  cudaStream_t st;
};

template <typename T, class Op>
cudaError_t launch_payload(const T* flow, const Op& op, const PayloadArgs& a) {
  constexpr int P = Op::P;
  if (3LL * a.H * a.W > INT32_MAX || a.B > 65535 || static_cast<int64_t>(a.S) * P > 65535)
    return cudaErrorInvalidValue;
  if (a.origins != nullptr) {
    const size_t bytes = sizeof(float) * a.S * P * static_cast<int64_t>(a.Hg) * a.Wg;
    const cudaError_t err = cudaMemsetAsync(a.sums, 0, bytes, a.st);
    if (err != cudaSuccess) return err;
  }
  project_op_scatter_kernel<T, Op>
      <<<dim3(words_for(a.W), ceil_div(a.H, 8), a.B), dim3(32, 8), 0, a.st>>>(
          flow, op, a.origins, a.sums, a.H, a.W, a.S, a.Hg, a.Wg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.origins != nullptr)
    return launch_raw_fold(a.sums, static_cast<float*>(a.out), a.S * P, a.Hg, a.Wg, a.st);
  const dim3 grid(words_for(a.W), words_for(a.H), a.B), block(kTile, kTileWarps);
  T* ex = static_cast<T*>(a.ex);
  if (a.fill) {
    project_fold_kernel<float, T, P, true><<<grid, block, 0, a.st>>>(
        a.sums, static_cast<float*>(a.out), ex, a.rows, a.row_sums, a.cols, a.col_sums, a.H, a.W);
  } else {
    project_fold_kernel<T, T, P, false><<<grid, block, 0, a.st>>>(
        a.sums, static_cast<T*>(a.out), ex, nullptr, nullptr, nullptr, nullptr, a.H, a.W);
  }
  return cudaGetLastError();
}

// The payload of ``op`` on inputs of type A (depth; frame1 and frame2).
template <typename T, typename A>
cudaError_t launch_payload_op(int op, const void* flow, const void* in1, const void* in2,
                              float threshold, const PayloadArgs& a) {
  const auto* f = static_cast<const T*>(flow);
  const auto* i1 = static_cast<const A*>(in1);
  if (op == kDepthOp) return launch_payload(f, DepthPayload<A>{i1}, a);
  if (op == kGatedOp && in2 != nullptr)
    return launch_payload(f, GatedPayload<A>{i1, static_cast<const A*>(in2), threshold}, a);
  return cudaErrorInvalidValue;
}

inline cudaError_t launch_payload_types(int op, const void* flow, const void* in1,
                                        const void* in2, float threshold, int dtype,
                                        int in_dtype, const PayloadArgs& a) {
  if (dtype == kFloat32 && in_dtype == kFloat32)
    return launch_payload_op<float, float>(op, flow, in1, in2, threshold, a);
  if (dtype == kFloat32 && in_dtype == kBFloat16)
    return launch_payload_op<float, __nv_bfloat16>(op, flow, in1, in2, threshold, a);
  if (dtype == kBFloat16 && in_dtype == kFloat32)
    return launch_payload_op<__nv_bfloat16, float>(op, flow, in1, in2, threshold, a);
  if (dtype == kBFloat16 && in_dtype == kBFloat16)
    return launch_payload_op<__nv_bfloat16, __nv_bfloat16>(op, flow, in1, in2, threshold, a);
  return cudaErrorInvalidValue;
}

// The tiled fill's two launches; masks: rows (B, H, words(W)), then cols
// (B, W, words(H)).
template <typename T>
cudaError_t launch_fill_tiles(const float* avg, int64_t a_sb, int a_sc, int a_sy,
                              const float* cnt, int64_t c_sb, int c_sy, uint32_t* masks, T* out,
                              int B, int H, int W, Stack sw, Stack sh, const float* left,
                              const float* right, const float* up, cudaStream_t st) {
  const int nw = words_for(W), nh = words_for(H);
  uint32_t* r = masks;
  uint32_t* c = r + static_cast<int64_t>(B) * H * nw;
  project_mask_kernel<<<dim3(nw, nh, B), dim3(kTile, kTileWarps), 0, st>>>(cnt, c_sb, c_sy, r, c,
                                                                           H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  project_fill_tiles_kernel<T><<<dim3(nw, ceil_div(H, 8), B), dim3(32, 8), 0, st>>>(
      avg, a_sb, a_sc, a_sy, r, c, out, H, W, sw, sh, left, right, up);
  return cudaGetLastError();
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
// order, so that one memset zeroes all three.  flow_px: a double on the
// device that gains the sum of the flow's per-pixel |f|, or null.
MEMC_API int memc_project_sums(const void* flow, void* sums, void* out, void* rows,
                               void* row_sums, void* cols, void* col_sums, int B, int H, int W,
                               int dtype, int fill, void* flow_px, void* stream) {
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
  auto* px = static_cast<double*>(flow_px);
  if (dtype == memc::kFloat32) {
    return memc::launch_sums(static_cast<const float*>(flow), s, out, r, rs, c, cs, B, H, W,
                             fill != 0, px, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_sums(static_cast<const __nv_bfloat16*>(flow), s, out, r, rs, c, cs, B, H,
                             W, fill != 0, px, st);
  }
  return cudaErrorInvalidValue;
}

// K2's payload entry, the payload built from the op's inputs.  op 0 (N7):
// in1 the depth (B, 1, H, W), P = 3; op 1 (N8): in1 frame1 and in2 frame2,
// (B, 3, H, W) each, the gate err <= threshold, P = 4.  flow in dtype, the
// inputs in in_dtype; sums: (B, P, H, W) float32 scratch.  out: (B, 2, H, W)
// in dtype without fill, float32 (the average) with it, planes 0 and 1 of
// the result; ex: (B, P-3, H, W) in dtype, planes 2 .. P-2 (null for P = 3);
// the masks and their layout as memc_project_sums's, from plane P-1 > 0.
MEMC_API int memc_project_payload(int op, const void* flow, const void* in1, const void* in2,
                                  float threshold, void* sums, void* out, void* ex, void* rows,
                                  void* row_sums, void* cols, void* col_sums, int B, int H,
                                  int W, int dtype, int in_dtype, int fill, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const int P = op == memc::kGatedOp ? 4 : 3;
  if (P == 4 && ex == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = memc::zero_scratch(sums, row_sums, col_sums, rows, cols, B, P, H, W,
                                       fill != 0, st);
  if (err != cudaSuccess) return err;
  const memc::PayloadArgs a{nullptr, static_cast<float*>(sums), out, ex,
                            static_cast<uint32_t*>(rows), static_cast<uint32_t*>(row_sums),
                            static_cast<uint32_t*>(cols), static_cast<uint32_t*>(col_sums),
                            B, H, W, B, H, W, fill != 0, st};
  return memc::launch_payload_types(op, flow, in1, in2, threshold, dtype, in_dtype, a);
}

// avg: (B, 2, H, W) float32; the masks as above; out: (B, 2, H, W) in dtype.
// down: also search the nearest value below (fix_down_scan_bug).  count: a
// uint64 on the device that gains the pixels with no projected value, or
// null.
MEMC_API int memc_project_fill(const void* avg, const void* rows, const void* row_sums,
                               const void* cols, const void* col_sums, void* out, int B, int H,
                               int W, int dtype, int down, void* count, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if (dtype != memc::kFloat32 && dtype != memc::kBFloat16) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(memc::ceil_div(W, 32 * memc::kFillPx), memc::ceil_div(H, 8), B), block(32, 8);
  const auto* a = static_cast<const float*>(avg);
  const auto* r = static_cast<const uint32_t*>(rows);
  const auto* rs = static_cast<const uint32_t*>(row_sums);
  const auto* c = static_cast<const uint32_t*>(cols);
  const auto* cs = static_cast<const uint32_t*>(col_sums);
  auto* n = static_cast<unsigned long long*>(count);
  const int esize = dtype == memc::kFloat32 ? 4 : 2;
  // whole rows of 4 pixels on 16-byte (and 4-element) boundaries
  const bool vec = W % memc::kFillPx == 0 && reinterpret_cast<uintptr_t>(avg) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (memc::kFillPx * esize) == 0;
  if (dtype == memc::kFloat32) {
    auto* o = static_cast<float*>(out);
    if (down) {
      memc::project_fill_kernel<float, true><<<grid, block, 0, st>>>(a, r, rs, c, cs, o, H, W, vec,
                                                                     n);
    } else {
      memc::project_fill_kernel<float, false><<<grid, block, 0, st>>>(a, r, rs, c, cs, o, H, W,
                                                                      vec, n);
    }
  } else {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (down) {
      memc::project_fill_kernel<__nv_bfloat16, true><<<grid, block, 0, st>>>(a, r, rs, c, cs, o,
                                                                              H, W, vec, n);
    } else {
      memc::project_fill_kernel<__nv_bfloat16, false><<<grid, block, 0, st>>>(a, r, rs, c, cs, o,
                                                                               H, W, vec, n);
    }
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

// K2's payload entry on tile origins, the payload built from the op's
// inputs (as memc_project_payload: op 0 in1 the depth tiles; op 1 in1 the
// frame1 tiles, in2 frame2's whole level (S, 3, Hg, Wg)).  flow: (B, 2, H,
// W) tiles in dtype, the inputs in in_dtype; origins: (B, 4) int32 on the
// device (y0, x0, own_h, own_w of each tile in the Hg x Wg frame); sums:
// (S, P, Hg, Wg) float32 scratch; out: the same shape, float32: each
// sample's whole-frame sums of its tiles' payloads with both +1 folds at the
// frame's border, no divide.  B must be a multiple of S; tile b is of sample
// b % S.
MEMC_API int memc_project_payload_tile(int op, const void* flow, const void* in1,
                                       const void* in2, float threshold, const void* origins,
                                       void* sums, void* out, int B, int H, int W, int S, int Hg,
                                       int Wg, int dtype, int in_dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  if (S < 1 || B % S != 0 || Hg < 1 || Wg < 1 || origins == nullptr ||
      static_cast<int64_t>(Hg) * Wg > INT32_MAX)
    return cudaErrorInvalidValue;
  const memc::PayloadArgs a{static_cast<const int*>(origins), static_cast<float*>(sums), out,
                            nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, S, Hg, Wg,
                            false, static_cast<cudaStream_t>(stream)};
  return memc::launch_payload_types(op, flow, in1, in2, threshold, dtype, in_dtype, a);
}

// K3's tile entry: the tiled fill.  avg: float32, the cropped tiles' average
// at avg[b a_sb + c a_sc + y a_sy + x] (c = 0, 1); cnt: float32, their
// counts at cnt[b c_sb + y c_sy + x]; masks: int32 scratch of rows, then
// cols (the layouts of memc_project_sums's; no summaries); out: (B, 2, H, W) in dtype.  The W axis: stacked as (t_w, inner_w) when
// left and right are null and t_w > 1, else left and right (B, 3, H) float32
// carries per row (both or neither); the H axis likewise with (t_h, inner_h)
// or up (B, 3, W) per column; t = 1 and no carries: not tiled.
MEMC_API int memc_project_fill_tiles(const void* avg, int64_t a_sb, int a_sc, int a_sy,
                                     const void* cnt, int64_t c_sb, int c_sy, void* masks,
                                     void* out, int B, int H, int W, int t_w, int inner_w,
                                     int t_h, int inner_h, const void* left, const void* right,
                                     const void* up, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  auto stacks = [B](int t, int inner) {
    return t >= 1 && inner >= 1 && B % (static_cast<int64_t>(t) * inner) == 0;
  };
  if ((left == nullptr) != (right == nullptr) || B > 65535 || 2LL * H * W > INT32_MAX ||
      !stacks(t_w, inner_w) || !stacks(t_h, inner_h))
    return cudaErrorInvalidValue;
  const memc::Stack sw{left != nullptr ? 1 : t_w, inner_w}, sh{up != nullptr ? 1 : t_h, inner_h};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(avg);
  const auto* c = static_cast<const float*>(cnt);
  auto* m = static_cast<uint32_t*>(masks);
  const auto* lf = static_cast<const float*>(left);
  const auto* rt = static_cast<const float*>(right);
  const auto* u = static_cast<const float*>(up);
  if (dtype == memc::kFloat32) {
    return memc::launch_fill_tiles(a, a_sb, a_sc, a_sy, c, c_sb, c_sy, m,
                                   static_cast<float*>(out), B, H, W, sw, sh, lf, rt, u, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::launch_fill_tiles(a, a_sb, a_sc, a_sy, c, c_sb, c_sy, m,
                                   static_cast<__nv_bfloat16*>(out), B, H, W, sw, sh, lf, rt, u,
                                   st);
  }
  return cudaErrorInvalidValue;
}
