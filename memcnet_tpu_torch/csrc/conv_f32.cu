// K4's float32 body -- a 3xTF32 tensor-core implicit GEMM.
//
// Replaces the TPU kernel memcnet_tpu/ops/pallas/conv_kernel.py::conv2d_small
// (kernel _conv_kernel) for float32 inputs: stride 1, 'same' zero padding
// (K/2), K in {3, 5, 7}, optional fused bias (float32) and ReLU, NCHW in and
// out, float32 accumulation.  The Pallas kernel runs its float32 dot at
// Precision.HIGHEST, a multi-pass product on the TPU's matrix unit; this is
// the same idea on the H100's tensor cores.  (conv.cu holds the bf16 body;
// the float32 body lives in its own file so that nvcc builds both at once.)
//
// Bound on the H100: SPyNet's convs by their operations.  On the tensor cores
// three TF32 passes at 495 TFLOP/s (3 x flops / 495e12); the CUDA cores' FMA
// rate, 67 TFLOP/s, bounded the direct kernel this body replaced (kept as
// step 0 of bench/conv_f32_steps.cu).  The 3 -> 64 ctx conv too: its three
// passes take longer than writing its 64 output planes.
//
// 3xTF32.  Each float32 operand v is split into hi = tf32(v) and
// lo = tf32(v - hi), both rounded to nearest (cvt.rna.tf32.f32), and each
// product is taken as lo*hi + hi*lo + hi*hi in three
// mma.sync.m16n8k8.tf32 -> float32 steps into one float32 accumulator.  The
// term dropped, lo*lo, is below 2^-22 of the product, and the splits keep
// v to about 2^-22 of itself, so a sum of N products differs from the float32
// one by about 2^-21 * sum|x w| at worst, and far less where the errors do not
// line up (ops/cuda/conv_kernel.py::tf32x3_reference repeats the arithmetic
// on the CPU).  The tensor cores also cut each MMA's sum short at the
// accumulator's scale, an error that grows with the MMAs per output (3 per
// 8-deep step): at SPyNet's 64 -> 32 convs, 1,176 of them, the outputs sit
// up to 9e-5 from a float32 conv on the H100 (kernel_ab.py), against the
// card's 5e-4 rule.  Inputs are split in registers as their fragments are
// loaded; the wrapper splits the weights once (pack_f32_weights).
//
// GEMM view: M = output pixels, N = output channels, depth = C*K*K ordered
// (ky, kx, c), channels innermost, 8 deep per MMA step.  Channels go in
// chunks of CG = 8 (one kx tap a step) or, for C <= 4, CG = 4 (two
// neighbouring kx taps a step, so the 3-channel ctx conv pads its depth 21 ->
// 32 per kernel row rather than to 8 per tap; the tap past K meets zero
// weights and a zero halo column).  A block of 8 warps owns a 16-pixel-wide
// tile, TH = 8 * MT rows tall (each warp MT rows of 16 pixels, one m16 tile
// each), and NT output channels (8, 16, 32 or 64: NT / 8 n8 tiles; only the
// real ones written).  The wrapper (conv_kernel.f32_geometry) picks them by
// shape: NT the least that holds O (at most 64); MT = 4 for NT <= 32 (each
// warp's B fragments then serve 4 m16 tiles) and 2 for NT = 64 (64
// accumulators either way); then, while the launch has fewer than two
// blocks for each of the 132 SMs (two fit an SM), MT halved down to 1, then
// NT halved down to 8, so that SPyNet's smaller levels split their rows and
// output channels over more blocks rather than run under one wave.  Where
// O * K <= 16 and C <= 64 (SPyNet's 16 -> 2 convs) the taps go into N
// instead (conv2d_tf32x3_taps_kernel, below).
//
// Staging: a chunk's halo tile goes to shared memory channels-last by 4-byte
// cp.async (zeros past the frame, past C and past the taps), the next
// chunk's issued during the current one; a thread's A fragment element for
// channel k = t and k = t + 4 sits in one 8-byte word (CG = 8: channel
// order 0 4 1 5 2 6 3 7 within a pixel), so a half warp's loads cover 32
// distinct banks.  The split weights, packed by the wrapper to
// [group][chunk][ky][step][n][t][hi(t), hi(t + 4), lo(t), lo(t + 4)],
// stream one kernel row at a time through a two-stage cp.async ring (one
// barrier a row: the next row's copies are issued after it and land while
// this row computes) and load as one conflict-free 16-byte word per n8 tile.
// Epilogue: float32 bias, ReLU, and 32-byte row segments stored straight
// from the accumulators.
#include "common.cuh"

namespace memc {

constexpr int kTfTile = 16;  // tile width: one m16 MMA tile is one row of 16 pixels
constexpr int kTfWarps = 8;
constexpr int kTfThreads = 32 * kTfWarps;

template <int K, int CG, int NT, int MT, bool STAGED = false, bool WSPLIT = true>
struct Tf32Shape {
  static constexpr int P = K / 2;
  static constexpr int TPS = 8 / CG;                 // kx taps per 8-deep step
  static constexpr int G = (K + TPS - 1) / TPS;      // steps per kernel row
  static constexpr int TH = kTfWarps * MT;           // tile height
  static constexpr int SH = TH + K - 1;              // halo rows
  static constexpr int SWS = kTfTile + G * TPS - 1;  // halo columns (those past K - 1 are zero)
  static constexpr int IN_FLOATS = SH * SWS * CG;    // one chunk's halo
  // one kernel row of weights: split (hi, lo) pairs, or raw where WSPLIT is off
  static constexpr int W_FLOATS = G * NT * (WSPLIT ? 16 : 8);
  // STAGED: the raw halo, its split copy (twice the floats) and the weight
  // ring; else two raw halos and the ring
  static constexpr int HALO_FLOATS = (STAGED ? 3 : 2) * IN_FLOATS;
  static constexpr int SMEM = 4 * (HALO_FLOATS + 2 * W_FLOATS);
};

__device__ __forceinline__ uint32_t tf_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global, or zeros where !valid (src is then not read)
__device__ __forceinline__ void tf_cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void tf_cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void tf_cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void tf_cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n"); }
__device__ __forceinline__ void tf_cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32, to about 2^-22 of v
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared-memory slot of chunk channel ci within a pixel: CG = 8 keeps
// channels t and t + 4 side by side (slot 2t, 2t + 1)
template <int CG>
__device__ __forceinline__ int tf_slot(int ci) {
  return CG == 8 ? 2 * (ci & 3) + (ci >> 2) : ci;
}

// PASSES = 3: float32 products (3xTF32).  Each A fragment is split in
// registers as it is loaded.  Built only by bench/conv_f32_steps.cu, to time
// them: PASSES = 1 (hi*hi alone, TF32 precision), MINB = 1 (one block an SM,
// up to 255 registers a thread), STAGED (each chunk's halo split once into
// (hi, lo) pairs in shared memory: twice the fragment bytes read) and
// WSPLIT = false (raw weights, split in registers as they are loaded: half
// the weight bytes read, more instructions).
template <int K, int CG, int NT, int MT, int PASSES = 3, int MINB = 2, bool STAGED = false,
          bool WSPLIT = true>
__global__ void __launch_bounds__(kTfThreads, MINB)
conv2d_tf32x3_kernel(const float* __restrict__ x, const float4* __restrict__ wp,
                     const float* __restrict__ bias, float* __restrict__ out, int C, int H, int W,
                     int O, int relu, int n_groups, int nchunks) {
  using S = Tf32Shape<K, CG, NT, MT, STAGED, WSPLIT>;
  extern __shared__ __align__(16) float tf_smem[];
  float* in_s = tf_smem;                        // the halo buffers (S::HALO_FLOATS)
  float* w_s = tf_smem + S::HALO_FLOATS;        // a ring of two kernel rows of weights

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // MMA group: pixel (A, C) or output channel (B)
  const int t = lane & 3;   // thread in group: depth k = t, t + 4
  const int x0 = blockIdx.x * kTfTile;
  const int y0 = blockIdx.y * S::TH;
  const int b = blockIdx.z / n_groups;
  const int og = blockIdx.z - b * n_groups;
  const int plane = H * W;
  const float* xb = x + static_cast<int64_t>(b) * C * plane;

  // ---- a chunk's halo tile, channels-last; a warp reads along a row of one plane
  auto load_input = [&](int chunk, int buf) {
    const uint32_t base = tf_smem_addr(in_s + buf * S::IN_FLOATS);
    for (int i = tid; i < S::IN_FLOATS; i += kTfThreads) {
      const int col = i % S::SWS;
      const int rest = i / S::SWS;
      const int row = rest % S::SH;
      const int ci = rest / S::SH;
      const int ch = chunk * CG + ci;
      const int gy = y0 - S::P + row;
      const int gx = x0 - S::P + col;
      const bool ok = ch < C && col < kTfTile + K - 1 && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = ok ? xb + static_cast<int64_t>(ch) * plane + gy * W + gx : xb;
      tf_cp_async4(base + 4u * ((row * S::SWS + col) * CG + tf_slot<CG>(ci)), src, ok);
    }
  };
  // ---- STAGED: the raw halo split into (hi, lo) pairs, 16 bytes for each
  // raw 8-byte pair: CG = 8 (hi t, hi t + 4, lo t, lo t + 4), a thread's
  // fragment word at (pixel * 4 + t) * 4; CG = 4 (hi c, lo c, hi c + 1,
  // lo c + 1), channel c's pair at pixel * 8 + 2c
  auto split_input = [&]() {
    const float2* raw = reinterpret_cast<const float2*>(in_s);
    uint4* dst = reinterpret_cast<uint4*>(in_s + S::IN_FLOATS);
    for (int i = tid; i < S::IN_FLOATS / 2; i += kTfThreads) {
      const float2 v = raw[i];
      uint32_t h0, l0, h1, l1;
      tf32_split(v.x, h0, l0);
      tf32_split(v.y, h1, l1);
      dst[i] = CG == 8 ? make_uint4(h0, h1, l0, l1) : make_uint4(h0, l0, h1, l1);
    }
  };
  // ---- one kernel row (chunk, ky) of split weights
  auto load_weights = [&](int step, int buf) {
    const float4* src = wp + (static_cast<int64_t>(og) * nchunks * K + step) * (S::W_FLOATS / 4);
    const uint32_t base = tf_smem_addr(w_s + buf * S::W_FLOATS);
    for (int i = tid; i < S::W_FLOATS / 4; i += kTfThreads) tf_cp_async16(base + 16u * i, src + i);
  };

  float acc[MT][NT / 8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  const int steps = nchunks * K;
  load_input(0, 0);
  load_weights(0, 0);
  tf_cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int chunk = s / K;
    const int ky = s - chunk * K;
    // one barrier a step: step s's weights (and chunk's halo) have landed for
    // every thread, and every thread is done with step s - 1, whose buffers
    // the next loads overwrite; they land while step s computes
    tf_cp_async_wait_all();
    __syncthreads();
    if constexpr (STAGED) {
      if (ky == 0) {  // the chunk's raw halo has landed: split it, then fetch the next
        split_input();
        __syncthreads();
        if (chunk + 1 < nchunks) load_input(chunk + 1, 0);
      }
    } else {
      if (ky == 0 && chunk + 1 < nchunks) load_input(chunk + 1, (chunk + 1) & 1);
    }
    if (s + 1 < steps) load_weights(s + 1, (s + 1) & 1);
    tf_cp_async_commit();

    const float* in_c = STAGED ? in_s + S::IN_FLOATS : in_s + (chunk & 1) * S::IN_FLOATS;
    const float* w_c = w_s + (s & 1) * S::W_FLOATS;
#pragma unroll
    for (int gs = 0; gs < S::G; ++gs) {
      // A fragments of the warp's MT pixel rows, shifted by (ky, gs * TPS):
      // a0, a1 = pixels g, g + 8 at depth t; a2, a3 the same at depth t + 4
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int hr = warp * MT + m + ky;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = g + 8 * half + gs * S::TPS;
          if constexpr (STAGED) {
            if constexpr (CG == 8) {
              const uint4 v =
                  *reinterpret_cast<const uint4*>(in_c + (hr * S::SWS + q) * 16 + 4 * t);
              ah[m][half] = v.x;
              ah[m][2 + half] = v.y;
              al[m][half] = v.z;
              al[m][2 + half] = v.w;
            } else {  // depth t + 4 is the next tap: the next pixel's channel t
              const uint2 v0 =
                  *reinterpret_cast<const uint2*>(in_c + (hr * S::SWS + q) * 8 + 2 * t);
              const uint2 v1 =
                  *reinterpret_cast<const uint2*>(in_c + (hr * S::SWS + q + 1) * 8 + 2 * t);
              ah[m][half] = v0.x;
              al[m][half] = v0.y;
              ah[m][2 + half] = v1.x;
              al[m][2 + half] = v1.y;
            }
          } else {
            float v0, v1;
            if constexpr (CG == 8) {
              const float2 v =
                  *reinterpret_cast<const float2*>(in_c + (hr * S::SWS + q) * 8 + 2 * t);
              v0 = v.x;
              v1 = v.y;
            } else {
              v0 = in_c[(hr * S::SWS + q) * 4 + t];
              v1 = in_c[(hr * S::SWS + q + 1) * 4 + t];
            }
            if constexpr (PASSES == 3) {
              tf32_split(v0, ah[m][half], al[m][half]);
              tf32_split(v1, ah[m][2 + half], al[m][2 + half]);
            } else {
              ah[m][half] = tf32_rna(v0);
              ah[m][2 + half] = tf32_rna(v1);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        uint32_t bh0, bh1, bl0 = 0u, bl1 = 0u;
        if constexpr (WSPLIT) {
          const float4 bw =
              *reinterpret_cast<const float4*>(w_c + ((gs * NT + 8 * j + g) * 4 + t) * 4);
          bh0 = __float_as_uint(bw.x);
          bh1 = __float_as_uint(bw.y);
          bl0 = __float_as_uint(bw.z);
          bl1 = __float_as_uint(bw.w);
        } else {
          const float2 bw =
              *reinterpret_cast<const float2*>(w_c + ((gs * NT + 8 * j + g) * 4 + t) * 2);
          if constexpr (PASSES == 3) {
            tf32_split(bw.x, bh0, bl0);
            tf32_split(bw.y, bh1, bl1);
          } else {
            bh0 = tf32_rna(bw.x);
            bh1 = tf32_rna(bw.y);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if constexpr (PASSES == 3) {
            mma_tf32_1688(acc[m][j], al[m], bh0, bh1);
            mma_tf32_1688(acc[m][j], ah[m], bl0, bl1);
          }
          mma_tf32_1688(acc[m][j], ah[m], bh0, bh1);
        }
      }
    }
  }

  // ---- epilogue: bias, ReLU; c0, c1 = pixel g, channels 2t, 2t + 1; c2, c3 = pixel g + 8
  const int nreal = min(NT, O - og * NT);
  float* ob = out + (static_cast<int64_t>(b) * O + og * NT) * plane;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t + e;
      if (n >= nreal) continue;
      const float bv = bias != nullptr ? bias[og * NT + n] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int y = y0 + warp * MT + m;
        if (y >= H) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int xx = x0 + g + 8 * half;
          if (xx < W) {
            float v = acc[m][j][2 * half + e] + bv;
            if (relu) v = fmaxf(v, 0.f);
            ob[static_cast<int64_t>(n) * plane + y * W + xx] = v;
          }
        }
      }
    }
  }
}

template <int K, int CG, int NT, int MT, int PASSES = 3, int MINB = 2, bool STAGED = false,
          bool WSPLIT = true>
cudaError_t launch_tf32_t(const float* x, const float4* wp, const float* bias, float* out, int B,
                          int C, int H, int W, int O, int relu, cudaStream_t stream) {
  using S = Tf32Shape<K, CG, NT, MT, STAGED, WSPLIT>;
  auto kernel = conv2d_tf32x3_kernel<K, CG, NT, MT, PASSES, MINB, STAGED, WSPLIT>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
  }
  const int n_groups = ceil_div(O, NT);
  const int nchunks = ceil_div(C, CG);
  const dim3 grid(ceil_div(W, kTfTile), ceil_div(H, S::TH), B * n_groups);
  kernel<<<grid, kTfThreads, S::SMEM, stream>>>(x, wp, bias, out, C, H, W, O, relu, n_groups,
                                                nchunks);
  return cudaGetLastError();
}

// V: 0 as built; 1 STAGED, 2 WSPLIT off (bench/conv_f32_steps.cu only)
template <int K, int CG, int NT, int PASSES = 3, int V = 0>
cudaError_t launch_tf32_m(const float* x, const float4* wp, const float* bias, float* out, int B,
                          int C, int H, int W, int O, int MT, int relu, cudaStream_t st) {
  constexpr bool STAGED = V == 1, WSPLIT = V != 2;
  switch (MT) {
    case 1:
      return launch_tf32_t<K, CG, NT, 1, PASSES, 2, STAGED, WSPLIT>(x, wp, bias, out, B, C, H, W,
                                                                    O, relu, st);
    case 2:
      return launch_tf32_t<K, CG, NT, 2, PASSES, 2, STAGED, WSPLIT>(x, wp, bias, out, B, C, H, W,
                                                                    O, relu, st);
    case 4:  // 16 or 32 output channels: 64 accumulators, as MT = 2 at NT = 64
      if constexpr (NT == 16 || NT == 32) {
        return launch_tf32_t<K, CG, NT, 4, PASSES, 2, STAGED, WSPLIT>(x, wp, bias, out, B, C, H,
                                                                      W, O, relu, st);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int K, int CG, int PASSES = 3, int V = 0>
cudaError_t launch_tf32_n(const float* x, const float4* wp, const float* bias, float* out, int B,
                          int C, int H, int W, int O, int NT, int MT, int relu, cudaStream_t st) {
  switch (NT) {
    case 8:
      return launch_tf32_m<K, CG, 8, PASSES, V>(x, wp, bias, out, B, C, H, W, O, MT, relu, st);
    case 16:
      return launch_tf32_m<K, CG, 16, PASSES, V>(x, wp, bias, out, B, C, H, W, O, MT, relu, st);
    case 32:
      return launch_tf32_m<K, CG, 32, PASSES, V>(x, wp, bias, out, B, C, H, W, O, MT, relu, st);
    case 64:
      return launch_tf32_m<K, CG, 64, PASSES, V>(x, wp, bias, out, B, C, H, W, O, MT, relu, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int K, int PASSES = 3, int V = 0>
cudaError_t launch_tf32_c(const float* x, const float4* wp, const float* bias, float* out, int B,
                          int C, int H, int W, int O, int CG, int NT, int MT, int relu,
                          cudaStream_t st) {
  switch (CG) {
    case 4:
      return launch_tf32_n<K, 4, PASSES, V>(x, wp, bias, out, B, C, H, W, O, NT, MT, relu, st);
    case 8:
      return launch_tf32_n<K, 8, PASSES, V>(x, wp, bias, out, B, C, H, W, O, NT, MT, relu, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- small O: N = (output channel, kx tap) --------------------------------
//
// For O * K <= 16 (SPyNet's 16 -> 2 convs) one MMA's 8 columns would hold at
// most 2 real output channels.  This variant puts the kx taps into N
// instead: D[row][q][o * K + kx] = sum over (c, ky) of x[c][y + ky - P][q]
// w[o][c][ky][kx] for the 32 halo columns q of a block (two m16 tiles),
// depth 8 channels per step, one step per (chunk, ky); the A fragment is
// then loaded and split once per kernel row instead of once per tap.  The
// epilogue stages D in shared memory and sums out[y][p][o] = bias[o] + sum
// over kx of D[row][p + kx][o * K + kx] for the block's TW = 32 - (K - 1)
// output columns.  All weights (at most 8 chunks, 56 KB) are staged once.
constexpr int kTapN = 16;    // N = o * K + kx, padded
constexpr int kTapCols = 32;  // halo columns: two m16 tiles

template <int K, int MT>
struct TapShape {
  static constexpr int P = K / 2;
  static constexpr int TW = kTapCols - (K - 1);      // output columns a block
  static constexpr int TH = kTfWarps * MT;
  static constexpr int SH = TH + K - 1;
  static constexpr int IN_FLOATS = SH * kTapCols * 8;
  static constexpr int STEP_FLOATS = kTapN * 16;     // one (chunk, ky) of split weights
  static constexpr int D_STRIDE = kTapN + 1;         // odd: the epilogue's column reads spread
  static_assert(TH * kTapCols * D_STRIDE <= 2 * IN_FLOATS, "D fits the halo buffers");
};

template <int K, int MT, int PASSES = 3>
__global__ void __launch_bounds__(kTfThreads, 2)
conv2d_tf32x3_taps_kernel(const float* __restrict__ x, const float4* __restrict__ wp,
                          const float* __restrict__ bias, float* __restrict__ out, int C, int H,
                          int W, int O, int relu, int nchunks) {
  using S = TapShape<K, MT>;
  extern __shared__ __align__(16) float tf_smem[];
  float* in_s = tf_smem;                    // two chunks' halo tiles, then D
  float* w_s = tf_smem + 2 * S::IN_FLOATS;  // every (chunk, ky) step's weights

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * S::TW;
  const int y0 = blockIdx.y * S::TH;
  const int b = blockIdx.z;
  const int plane = H * W;
  const float* xb = x + static_cast<int64_t>(b) * C * plane;

  auto load_input = [&](int chunk, int buf) {
    const uint32_t base = tf_smem_addr(in_s + buf * S::IN_FLOATS);
    for (int i = tid; i < S::IN_FLOATS; i += kTfThreads) {
      const int col = i % kTapCols;
      const int rest = i / kTapCols;
      const int row = rest % S::SH;
      const int ci = rest / S::SH;
      const int ch = chunk * 8 + ci;
      const int gy = y0 - S::P + row;
      const int gx = x0 - S::P + col;
      const bool ok = ch < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = ok ? xb + static_cast<int64_t>(ch) * plane + gy * W + gx : xb;
      tf_cp_async4(base + 4u * ((row * kTapCols + col) * 8 + tf_slot<8>(ci)), src, ok);
    }
  };

  float acc[MT][2][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][mt][n][e] = 0.f;

  {
    const uint32_t base = tf_smem_addr(w_s);
    for (int i = tid; i < nchunks * K * S::STEP_FLOATS / 4; i += kTfThreads) {
      tf_cp_async16(base + 16u * i, wp + i);
    }
  }
  load_input(0, 0);
  tf_cp_async_commit();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk + 1 < nchunks) load_input(chunk + 1, (chunk + 1) & 1);
    tf_cp_async_commit();
    tf_cp_async_wait_one();
    __syncthreads();
    const float* in_c = in_s + (chunk & 1) * S::IN_FLOATS;
#pragma unroll 1
    for (int ky = 0; ky < K; ++ky) {
      uint32_t ah[MT][2][4], al[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int hr = warp * MT + m + ky;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = 16 * mt + g + 8 * half;
            const float2 v =
                *reinterpret_cast<const float2*>(in_c + (hr * kTapCols + q) * 8 + 2 * t);
            if constexpr (PASSES == 3) {
              tf32_split(v.x, ah[m][mt][half], al[m][mt][half]);
              tf32_split(v.y, ah[m][mt][2 + half], al[m][mt][2 + half]);
            } else {
              ah[m][mt][half] = tf32_rna(v.x);
              ah[m][mt][2 + half] = tf32_rna(v.y);
            }
          }
        }
      }
      const float* w_c = w_s + (chunk * K + ky) * S::STEP_FLOATS;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float4 bw = *reinterpret_cast<const float4*>(w_c + ((8 * n + g) * 4 + t) * 4);
        const uint32_t bh0 = __float_as_uint(bw.x), bh1 = __float_as_uint(bw.y);
        const uint32_t bl0 = __float_as_uint(bw.z), bl1 = __float_as_uint(bw.w);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if constexpr (PASSES == 3) {
              mma_tf32_1688(acc[m][mt][n], al[m][mt], bh0, bh1);
              mma_tf32_1688(acc[m][mt][n], ah[m][mt], bl0, bl1);
            }
            mma_tf32_1688(acc[m][mt][n], ah[m][mt], bh0, bh1);
          }
        }
      }
    }
    __syncthreads();  // the next chunk's halo overwrites this one's buffer
  }

  // ---- D to shared memory (over the halo buffers), then the shifted sums
  float* d_s = in_s;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 16 * mt + g + 8 * (e >> 1);
          d_s[((warp * MT + m) * kTapCols + q) * S::D_STRIDE + 8 * n + 2 * t + (e & 1)] =
              acc[m][mt][n][e];
        }
  __syncthreads();
  float* ob = out + static_cast<int64_t>(b) * O * plane;
  for (int i = tid; i < O * S::TH * S::TW; i += kTfThreads) {
    const int o = i / (S::TH * S::TW);
    const int rem = i - o * (S::TH * S::TW);
    const int r = rem / S::TW;
    const int p = rem - r * S::TW;
    const int y = y0 + r;
    const int xx = x0 + p;
    if (y < H && xx < W) {
      const float* d = d_s + (r * kTapCols + p) * S::D_STRIDE + o * K;
      float v = 0.f;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) v += d[kx * S::D_STRIDE + kx];
      v += bias != nullptr ? bias[o] : 0.f;
      if (relu) v = fmaxf(v, 0.f);
      ob[static_cast<int64_t>(o) * plane + y * W + xx] = v;
    }
  }
}

template <int K, int MT, int PASSES = 3>
cudaError_t launch_taps_t(const float* x, const float4* wp, const float* bias, float* out, int B,
                          int C, int H, int W, int O, int relu, cudaStream_t stream) {
  using S = TapShape<K, MT>;
  const int nchunks = ceil_div(C, 8);
  if (O * K > kTapN || nchunks > 8) return cudaErrorInvalidValue;
  const int smem = 4 * (2 * S::IN_FLOATS + nchunks * K * S::STEP_FLOATS);
  auto kernel = conv2d_tf32x3_taps_kernel<K, MT, PASSES>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ceil_div(W, S::TW), ceil_div(H, S::TH), B);
  kernel<<<grid, kTfThreads, smem, stream>>>(x, wp, bias, out, C, H, W, O, relu, nchunks);
  return cudaGetLastError();
}

template <int K, int PASSES = 3>
cudaError_t launch_taps_m(const float* x, const float4* wp, const float* bias, float* out, int B,
                          int C, int H, int W, int O, int MT, int relu, cudaStream_t st) {
  switch (MT) {
    case 1: return launch_taps_t<K, 1, PASSES>(x, wp, bias, out, B, C, H, W, O, relu, st);
    case 2: return launch_taps_t<K, 2, PASSES>(x, wp, bias, out, B, C, H, W, O, relu, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int K, int PASSES = 3>
cudaError_t launch_f32_k(const float* x, const float4* wp, const float* bias, float* out, int B,
                         int C, int H, int W, int O, int CG, int NT, int MT, int taps, int relu,
                         cudaStream_t st) {
  if (taps) return launch_taps_m<K, PASSES>(x, wp, bias, out, B, C, H, W, O, MT, relu, st);
  return launch_tf32_c<K, PASSES>(x, wp, bias, out, B, C, H, W, O, CG, NT, MT, relu, st);
}

}  // namespace memc

// float32 conv.  x: (B, C, H, W); wp: the weights split and packed by
// ops/cuda/conv_kernel.py::pack_f32_weights for this (CG, NT), or with taps
// (O * K <= 16, C <= 64) by pack_f32_tap_weights; bias: (O,) or null; out:
// (B, O, H, W).  H * W < 2^31.
MEMC_API int memc_conv2d_small(const void* x, const void* wp, const void* bias, void* out, int B,
                               int C, int H, int W, int O, int K, int CG, int NT, int MT, int taps,
                               int relu, void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0 || O == 0) return cudaSuccess;
  if (static_cast<int64_t>(H) * W >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const float*>(x);
  const auto* ws = static_cast<const float4*>(wp);
  const auto* bs = static_cast<const float*>(bias);
  auto* os = static_cast<float*>(out);
  switch (K) {
    case 3: return memc::launch_f32_k<3>(xs, ws, bs, os, B, C, H, W, O, CG, NT, MT, taps, relu, st);
    case 5: return memc::launch_f32_k<5>(xs, ws, bs, os, B, C, H, W, O, CG, NT, MT, taps, relu, st);
    case 7: return memc::launch_f32_k<7>(xs, ws, bs, os, B, C, H, W, O, CG, NT, MT, taps, relu, st);
    default: return cudaErrorInvalidValue;
  }
}
