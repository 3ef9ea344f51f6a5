// K3's tile entry (memc_project_fill_tiles) and K2's payload entry on tile
// origins (memc_project_payload_tile) in steps, for timing only
// (memcnet_tpu_torch/bench/kernel_ab.py builds this file with nvcc and
// loads it with ctypes; it is not part of the kernel library).  Each step is
// one launch on the caller's stream.
//
// memc_fill_tiles_step (the tiled fill of B stacked tiles of H x W):
//   STEP 0  the memset of the mask summaries (the carry entry's first op);
//   STEP 1  the mask pass with summaries ORed into them (the carry entry's
//           mask kernel, every word also written; sums_mask_kernel below);
//   STEP 2  the fill with summaries, walking the stacked tiles
//           (sums_fill_tiles_kernel below);
//   STEP 3  the mask pass without summaries (as built: no memset, no atomics);
//   STEP 4  the fill without summaries, walking the stacked tiles (as built);
//   STEP 5  the fill with summaries and every carry given (the carry
//           entry's design: left, right and up carries made before it).
// Steps 0, 1, 2 give the bits of steps 3, 4 and of steps 0, 1, 5.
//
// memc_payload_tile_step (N7 or N8 on B tiles of the Hg x Wg frames of S
// samples):
//   STEP 0  the memset of S's P planes;
//   STEP 1  the scatter that builds the payload (as built: a (columns, rows,
//           tiles) grid, 32-bit offsets);
//   STEP 2  the first design's scatter of a payload built beforehand (one
//           thread per pixel on a 1D grid, 64-bit divisions, each tile's
//           origins read per thread; P float32 planes read);
//   STEP 3  the raw fold of the P planes.
#include "project.cu"

namespace memc {

// STEP 2 of the payload: the scatter of a built payload (the first design)
template <typename T, int P>
__global__ void __launch_bounds__(256)
first_payload_tile_scatter_kernel(const T* __restrict__ flow, const float* __restrict__ payload,
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

// STEP 1 of the fill: csrc/project.cu's project_mask_kernel that also ORs
// the summary bits into zeroed summaries (the carry entry's mask kernel).
__global__ void __launch_bounds__(kTile * kTileWarps)
sums_mask_kernel(const float* __restrict__ cnt, int64_t c_sb, int c_sy,
                 uint32_t* __restrict__ rows, uint32_t* __restrict__ row_sums,
                 uint32_t* __restrict__ cols, uint32_t* __restrict__ col_sums, int H, int W) {
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
        const int64_t line = static_cast<int64_t>(b) * H + y;
        const int nw = words_for(W);
        rows[line * nw + blockIdx.x] = word;
        if (word)
          atomicOr(row_sums + line * words_for(nw) + blockIdx.x / 32, 1u << (blockIdx.x % 32));
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
  if (word)
    atomicOr(col_sums + line * words_for(nh) + blockIdx.y / 32, 1u << (blockIdx.y % 32));
}

// STEPS 2 and 5 of the fill: csrc/project.cu's project_fill_tiles_kernel
// whose searches past a word read the summary words.
template <typename T>
__global__ void __launch_bounds__(256)
sums_fill_tiles_kernel(const float* __restrict__ avg, int64_t a_sb, int a_sc, int a_sy,
                       const uint32_t* __restrict__ rows, const uint32_t* __restrict__ row_sums,
                       const uint32_t* __restrict__ cols, const uint32_t* __restrict__ col_sums,
                       T* __restrict__ out, int H, int W, Stack sw, Stack sh,
                       const float* __restrict__ left, const float* __restrict__ right,
                       const float* __restrict__ up) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int nw = words_for(W), nh = words_for(H);
  const int nrs = words_for(nw), ncs = words_for(nh);
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
  const uint32_t* rs = row_sums + rline * nrs;
  const int l = nearest_below<true>(rw, rs, x);
  if (l >= 0) {
    acc.add(ab, a_sc, y * a_sy + l);
  } else if (left != nullptr) {
    acc.add_carry(left, 3LL * b * H + y, H);
  } else if (sw.t > 1) {
    for (int k = 1, bb = b - sw.inner; k <= b / sw.inner % sw.t; ++k, bb -= sw.inner) {
      const int64_t line = static_cast<int64_t>(bb) * H + y;
      const int e = last_before<true>(rows + line * nw, row_sums + line * nrs, nw);
      if (e >= 0) {
        acc.add(avg + bb * a_sb, a_sc, y * a_sy + e);
        break;
      }
    }
  }
  const int r = nearest_above<true>(rw, rs, x, W);
  if (r < W) {
    acc.add(ab, a_sc, y * a_sy + r);
  } else if (right != nullptr) {
    acc.add_carry(right, 3LL * b * H + y, H);
  } else if (sw.t > 1) {
    for (int k = 1, bb = b + sw.inner; k < sw.t - b / sw.inner % sw.t; ++k, bb += sw.inner) {
      const int64_t line = static_cast<int64_t>(bb) * H + y;
      const int e = first_from<true>(rows + line * nw, row_sums + line * nrs, 0, W);
      if (e < W) {
        acc.add(avg + bb * a_sb, a_sc, y * a_sy + e);
        break;
      }
    }
  }
  const int64_t cline = static_cast<int64_t>(b) * W + x;
  const int u = nearest_below<true>(cols + cline * nh, col_sums + cline * ncs, y);
  if (u >= 0) {
    acc.add(ab, a_sc, u * a_sy + x);
  } else if (up != nullptr) {
    acc.add_carry(up, 3LL * b * W + x, W);
  } else if (sh.t > 1) {
    for (int k = 1, bb = b - sh.inner; k <= b / sh.inner % sh.t; ++k, bb -= sh.inner) {
      const int64_t line = static_cast<int64_t>(bb) * W + x;
      const int e = last_before<true>(cols + line * nh, col_sums + line * ncs, nh);
      if (e >= 0) {
        acc.add(avg + bb * a_sb, a_sc, e * a_sy + x);
        break;
      }
    }
  }
  o[0] = from_f32<T>(acc.den > 0.f ? acc.nx / acc.den : ab[at]);
  o[H * W] = from_f32<T>(acc.den > 0.f ? acc.ny / acc.den : ab[a_sc + at]);
}

template <typename T>
cudaError_t fill_step(int step, const float* avg, const float* cnt, uint32_t* masks, T* out,
                      int B, int H, int W, Stack sw, Stack sh, const float* left,
                      const float* right, const float* up, cudaStream_t st) {
  const int nw = words_for(W), nh = words_for(H);
  uint32_t* rs = masks;
  uint32_t* cs = rs + static_cast<int64_t>(B) * H * words_for(nw);
  uint32_t* r = cs + static_cast<int64_t>(B) * W * words_for(nh);
  uint32_t* c = r + static_cast<int64_t>(B) * H * nw;
  const int64_t a_sb = 2LL * H * W, c_sb = static_cast<int64_t>(H) * W;
  const dim3 mgrid(nw, nh, B), mblock(kTile, kTileWarps);
  const dim3 grid(nw, ceil_div(H, 8), B), block(32, 8);
  const Stack none{1, 1};
  switch (step) {
    case 0:
      return cudaMemsetAsync(rs, 0, sizeof(uint32_t) * (r - rs), st);
    case 1:
      sums_mask_kernel<<<mgrid, mblock, 0, st>>>(cnt, c_sb, W, r, rs, c, cs, H, W);
      break;
    case 2:
      sums_fill_tiles_kernel<T><<<grid, block, 0, st>>>(
          avg, a_sb, H * W, W, r, rs, c, cs, out, H, W, sw, sh, nullptr, nullptr, nullptr);
      break;
    case 3:
      project_mask_kernel<<<mgrid, mblock, 0, st>>>(cnt, c_sb, W, r, c, H, W);
      break;
    case 4:
      project_fill_tiles_kernel<T><<<grid, block, 0, st>>>(avg, a_sb, H * W, W, r, c, out, H, W, sw,
                                                           sh, nullptr, nullptr, nullptr);
      break;
    case 5:
      if (left == nullptr || right == nullptr) return cudaErrorInvalidValue;
      sums_fill_tiles_kernel<T><<<grid, block, 0, st>>>(
          avg, a_sb, H * W, W, r, rs, c, cs, out, H, W, none, none, left, right, up);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, class Op>
cudaError_t payload_step(int step, const T* flow, const Op& op, const float* payload,
                         const int* origins, float* sums, float* out, int B, int H, int W, int S,
                         int Hg, int Wg, cudaStream_t st) {
  constexpr int P = Op::P;
  switch (step) {
    case 0:
      return cudaMemsetAsync(sums, 0, sizeof(float) * S * P * static_cast<int64_t>(Hg) * Wg, st);
    case 1:
      project_op_scatter_kernel<T, Op><<<dim3(words_for(W), ceil_div(H, 8), B), dim3(32, 8), 0,
                                         st>>>(flow, op, origins, sums, H, W, S, Hg, Wg);
      break;
    case 2: {
      const int64_t total = static_cast<int64_t>(B) * H * W;
      first_payload_tile_scatter_kernel<T, P><<<ceil_div(total, 256), 256, 0, st>>>(
          flow, payload, origins, sums, H, W, S, Hg, Wg, total);
      break;
    }
    case 3:
      return launch_raw_fold(sums, out, S * P, Hg, Wg, st);
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t payload_step_op(int step, int op, const void* flow, const void* in1, const void* in2,
                            float threshold, const void* payload, const void* origins, void* sums,
                            void* out, int B, int H, int W, int S, int Hg, int Wg,
                            cudaStream_t st) {
  const auto* f = static_cast<const T*>(flow);
  const auto* pl = static_cast<const float*>(payload);
  const auto* o = static_cast<const int*>(origins);
  auto* s = static_cast<float*>(sums);
  auto* r = static_cast<float*>(out);
  const auto* i1 = static_cast<const float*>(in1);
  if (op == kDepthOp)
    return payload_step(step, f, DepthPayload<float>{i1}, pl, o, s, r, B, H, W, S, Hg, Wg, st);
  return payload_step(step, f, GatedPayload<float>{i1, static_cast<const float*>(in2), threshold},
                      pl, o, s, r, B, H, W, S, Hg, Wg, st);
}

}  // namespace memc

// avg (B, 2, H, W) and cnt (B, H, W) float32, contiguous; masks: int32
// scratch of row_sums, col_sums, rows, cols (the layouts of
// memc_project_sums's); out (B, 2, H, W) in dtype;
// the stacked axes (t_w, inner_w), (t_h, inner_h); left, right (B, 3, H) and
// up (B, 3, W) or null for STEP 5.
MEMC_API int memc_fill_tiles_step(int step, const void* avg, const void* cnt, void* masks,
                                  void* out, int B, int H, int W, int t_w, int inner_w, int t_h,
                                  int inner_h, const void* left, const void* right,
                                  const void* up, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const memc::Stack sw{t_w, inner_w}, sh{t_h, inner_h};
  const auto* a = static_cast<const float*>(avg);
  const auto* c = static_cast<const float*>(cnt);
  auto* m = static_cast<uint32_t*>(masks);
  const auto* lf = static_cast<const float*>(left);
  const auto* rt = static_cast<const float*>(right);
  const auto* u = static_cast<const float*>(up);
  if (dtype == memc::kFloat32) {
    return memc::fill_step(step, a, c, m, static_cast<float*>(out), B, H, W, sw, sh, lf, rt, u,
                           st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::fill_step(step, a, c, m, static_cast<__nv_bfloat16*>(out), B, H, W, sw, sh, lf,
                           rt, u, st);
  }
  return cudaErrorInvalidValue;
}

// As memc_project_payload_tile (op 0: in1 the depth tiles; op 1: in1 the
// frame1 tiles, in2 frame2's whole level; both float32), with payload (B, P,
// H, W) float32 built beforehand for STEP 2; sums and out (S, P, Hg, Wg).
MEMC_API int memc_payload_tile_step(int step, int op, const void* flow, const void* in1,
                                    const void* in2, float threshold, const void* payload,
                                    const void* origins, void* sums, void* out, int B, int H,
                                    int W, int S, int Hg, int Wg, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == memc::kFloat32) {
    return memc::payload_step_op<float>(step, op, flow, in1, in2, threshold, payload, origins,
                                        sums, out, B, H, W, S, Hg, Wg, st);
  }
  if (dtype == memc::kBFloat16) {
    return memc::payload_step_op<__nv_bfloat16>(step, op, flow, in1, in2, threshold, payload,
                                                origins, sums, out, B, H, W, S, Hg, Wg, st);
  }
  return cudaErrorInvalidValue;
}
