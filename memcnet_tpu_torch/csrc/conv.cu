// K4 -- stride-1 'same' convolution for small input-channel counts.
//
// Replaces the TPU kernel memcnet_tpu/ops/pallas/conv_kernel.py::conv2d_small
// (kernel _conv_kernel): stride 1, 'same' zero padding (K/2), K in {3, 5, 7},
// optional fused bias (float32) and ReLU, exact products summed in float32,
// the output rounded once, NCHW in and out.  On the main paths it is the
// context extractor's 3 -> 64 7x7 conv (models/ctx.py) and every 7x7 conv of
// SPyNet's five-conv stacks, 8 -> 32 -> 64 -> 32 -> 16 -> 2, with ReLU fused
// on the first four (models/spynet.py).
//
// This file holds the bf16 body; the float32 body, a 3xTF32 tensor-core
// implicit GEMM, is csrc/conv_f32.cu (ops/cuda/conv_kernel.py chooses by the
// element type).
//
// bf16: a tensor-core implicit GEMM (conv2d_igemm_kernel).  Bound on the H100:
// SPyNet's convs by their operations (up to 64*49 multiply-adds per output
// value, 989 TFLOP/s in bf16), the ctx conv by writing its 64 output planes.
// GEMM view: M = output pixels, N = output channels, depth = C*K*K ordered
// (ky, kx, c), channels innermost.  A block owns a 16-pixel-wide tile, 16 rows
// tall for N = 48..64 and 32 rows for N <= 32, and up to 64 output channels
// (padded to a multiple of 16, only the real ones written); each of its 8
// warps owns 2 or 4 rows of 16 pixels (m16 tiles) times every n8 tile, in
// float32 accumulators.  The input channels go in chunks of CG = 16 (C > 8;
// C padded to a multiple of 16), 8 (4 < C <= 8) or 4 (C <= 4).  A chunk's
// halo tile is staged in shared memory channels-last, 16 bytes per unit --
// this transposes NCHW on the way in, and the next chunk's loads are issued
// into registers one chunk ahead.  With CG < 16 one 16-deep MMA step packs
// 16/CG neighbouring kx taps (the Pallas kernel packs taps into its
// contraction axis the same way), so C = 3 pads its depth 21 -> 32 per kernel
// row rather than to 16 per tap: a unit then holds 8/CG neighbouring pixels of
// the CG channels.  The weights, repacked once by the wrapper to
// [group][chunk][ky][kx group][n][16], stream one kernel row at a time through
// a two-stage cp.async ring.  Per tap group a warp takes its A fragments with
// one ldmatrix.x4 per m16 tile from the halo rows shifted by (ky, kx), its B
// fragments with one ldmatrix.x4 per 16 output channels, and issues
// mma.sync.m16n8k16 bf16 -> float32.  Units of the 32-byte rows (16-channel
// pixels, 16-wide weight rows) are XOR-swizzled so that the eight rows of an
// ldmatrix phase hit distinct banks.  Epilogue: float32 bias, ReLU, one
// rounding to bf16, staged through shared memory so that each output row goes
// out as 16-byte stores where W % 8 == 0.
//
// Short sums (C <= 8: the ctx conv and SPyNet's first conv).  The tensor
// cores align the 17 addends of an MMA (the accumulator and 16 products) to
// the largest and drop what falls below 2^-25 of it (measured on the H100),
// where a float32 FMA chain rounds each partial sum on its own scale.  So an
// output whose sum nearly cancels can land several bf16 units away from the
// float32 conv, which a float32 FMA chain reproduces exactly.  Such a conv has
// one chunk: its halo and all its weights are staged once (the product loop
// then needs no barrier), outputs with |value| < 2^-12 * sum|w| * max|x| are
// listed in shared memory and recomputed by a float32 FMA chain in (c, ky,
// kx) order from the staged halo and weights, as the old float32 direct
// kernel (step 0 of bench/conv_f32_steps.cu) summed them (a small fraction
// of the outputs), and only then rounded.
#include "common.cuh"

namespace memc {

// ------------------------------------------------------------------- bf16 --

constexpr int kIgTile = 16;           // tile width: one m16 MMA tile is one row of 16 pixels
constexpr int kIgWarps = 8;
constexpr int kIgThreads = 32 * kIgWarps;
// short sums: outputs with |value| < kShortSumTau * sum|w| * max|x| are recomputed
constexpr float kShortSumTau = 1.f / 4096.f;

template <int K, int CG, int NT>
struct IgemmShape {
  static constexpr bool SHORT = CG < 16;               // short sums: one chunk (C <= 8)
  static constexpr int MT = NT <= 32 ? 4 : 2;          // pixel rows (m16 tiles) per warp
  static constexpr int TH = kIgWarps * MT;             // tile height: 32 or 16 rows
  static constexpr int P = K / 2;
  static constexpr int TPS = 16 / CG;                  // kx taps per 16-deep step
  static constexpr int G = (K + TPS - 1) / TPS;        // steps per kernel row
  static constexpr int UPP = CG == 16 ? 2 : 1;         // 16-byte units per halo slot
  static constexpr int HS = CG == 16 ? 1 : 8 / CG;     // slot step of the upper k half
  static constexpr int SH = TH + K - 1;                // halo rows
  static constexpr int SWS = kIgTile + G * TPS - 1;    // halo slots per row
  static constexpr int IN_UNITS = SH * SWS * UPP;
  static constexpr int W_UNITS = G * NT * 2;           // one kernel row of weights
  static constexpr int IN_BUFS = SHORT ? 1 : 2;        // halo tiles staged
  static constexpr int W_ROWS = SHORT ? K : 2;         // kernel rows of weights staged
  static constexpr int ITEMS = (IN_UNITS + kIgThreads - 1) / kIgThreads;
  static constexpr int OUT_STRIDE = TH * kIgTile + 8;  // bf16 per output channel
  static constexpr int STAGE_BYTES = 16 * (IN_BUFS * IN_UNITS + W_ROWS * W_UNITS);
  static constexpr int OUT_BYTES = 2 * NT * OUT_STRIDE;
  // short sums keep the halo tile for the recompute: the output stage follows it
  static constexpr int OUT_OFFSET = SHORT ? STAGE_BYTES : 0;
  static constexpr int SMEM = SHORT ? STAGE_BYTES + OUT_BYTES
                                    : (STAGE_BYTES > OUT_BYTES ? STAGE_BYTES : OUT_BYTES);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

// 16-byte unit of a 32-byte row (two units per row), swizzled so that eight
// consecutive rows of one half fall on distinct banks
__device__ __forceinline__ int swz(int row, int half) { return 2 * row + (half ^ ((row >> 2) & 1)); }

template <int K, int CG, int NT>
__global__ void __launch_bounds__(kIgThreads, 2)
conv2d_igemm_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wp,
                    const float* __restrict__ wabs, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int C, int H, int W, int O, int relu,
                    int n_groups, int nchunks) {
  using S = IgemmShape<K, CG, NT>;
  extern __shared__ __align__(128) uint4 smem[];
  uint4* in_s = smem;                         // halo tiles of one or two chunks
  uint4* w_s = smem + S::IN_BUFS * S::IN_UNITS;  // all kernel rows (short) or a ring of two
  __shared__ float xmax_s[kIgWarps];      // short sums: max |x| over the halo, per warp
  __shared__ int list_n;                  // short sums: near-zero outputs to recompute
  __shared__ uint16_t list_s[S::SHORT ? NT * S::TH * kIgTile : 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kIgTile;
  const int y0 = blockIdx.y * S::TH;
  const int b = blockIdx.z / n_groups;
  const int og = blockIdx.z - b * n_groups;
  const int plane = H * W;
  const uint16_t* xb = x + static_cast<int64_t>(b) * C * plane;

  // ---- staging: a chunk's halo tile, channels-last, through registers
  uint4 pre[S::ITEMS];
  float xmax = 0.f;
  auto load_input = [&](int chunk) {
#pragma unroll
    for (int it = 0; it < S::ITEMS; ++it) {
      const int i = tid + it * kIgThreads;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (i < S::IN_UNITS) {
        const int row = i / (S::SWS * S::UPP);
        const int rem = i - row * (S::SWS * S::UPP);
        const int q = S::UPP == 2 ? rem >> 1 : rem;
        const int u = S::UPP == 2 ? rem & 1 : 0;
        const int gy = y0 - S::P + row;
        if (gy >= 0 && gy < H) {
          const uint16_t* rowp = xb + gy * W;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int col = CG == 4 ? q + (e >> 2) : q;
            const int ch = CG == 4 ? (e & 3) : (CG == 16 ? chunk * 16 + u * 8 + e : e);
            const int gx = x0 - S::P + col;
            // columns past the halo meet zero weights: stage zeros there too
            if (col < kIgTile + K - 1 && gx >= 0 && gx < W && ch < C) {
              const uint16_t bits = rowp[ch * plane + gx];
              v[e >> 1] |= static_cast<uint32_t>(bits) << (16 * (e & 1));
              if constexpr (S::SHORT) xmax = fmaxf(xmax, fabsf(__uint_as_float(uint32_t{bits} << 16)));
            }
          }
        }
      }
      pre[it] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_input = [&](int buf) {
#pragma unroll
    for (int it = 0; it < S::ITEMS; ++it) {
      const int i = tid + it * kIgThreads;
      if (i < S::IN_UNITS) {
        const int row = i / (S::SWS * S::UPP);
        const int rem = i - row * (S::SWS * S::UPP);
        const int unit = S::UPP == 2 ? swz(rem >> 1, rem & 1) : rem;
        in_s[buf * S::IN_UNITS + row * S::SWS * S::UPP + unit] = pre[it];
      }
    }
  };
  // ---- one kernel row of weights (chunk, ky) by cp.async
  auto load_weights = [&](int step, int buf) {
    const uint4* src = wp + (static_cast<int64_t>(og) * nchunks * K + step) * S::W_UNITS;
    for (int i = tid; i < S::W_UNITS; i += kIgThreads) {
      const int g = i / (NT * 2);
      const int rem = i - g * NT * 2;
      cp_async16(smem_addr(w_s + buf * S::W_UNITS + g * NT * 2 + swz(rem >> 1, rem & 1)), src + i);
    }
  };

  float acc[S::MT][NT / 8][4];
#pragma unroll
  for (int m = 0; m < S::MT; ++m)
#pragma unroll
    for (int n = 0; n < NT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // ldmatrix lane roles: A rows are pixels (lane & 15), k half lane >> 4;
  // B rows are output channels (8 * (lane >> 4) + (lane & 7)), k half (lane >> 3) & 1
  const int a_r = lane & 15;
  const int a_h = lane >> 4;
  const int b_n = ((lane >> 4) << 3) + (lane & 7);
  const int b_h = (lane >> 3) & 1;

  const int steps = nchunks * K;
  load_input(0);
  store_input(0);
  if constexpr (S::SHORT) {
    // one chunk: its halo and all its weights are staged once and stay to
    // the end, so the product loop needs no barrier
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    if (lane == 0) xmax_s[warp] = xmax;
    if (tid == 0) list_n = 0;
    for (int st = 0; st < K; ++st) load_weights(st, st);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  } else {
    load_weights(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int chunk = s / K;
    const int ky = s - chunk * K;
    if constexpr (!S::SHORT) {
      if (s + 1 < steps) load_weights(s + 1, (s + 1) & 1);
      cp_async_commit();  // possibly empty: keeps "all but the newest group" = step s
      if (ky == 0 && chunk + 1 < nchunks) load_input(chunk + 1);
      cp_async_wait_one();
      __syncthreads();
    }

    const uint32_t in_base = smem_addr(in_s + (chunk & 1) * S::IN_UNITS);
    const uint32_t w_base = smem_addr(w_s + (S::SHORT ? s : s & 1) * S::W_UNITS);
#pragma unroll
    for (int g = 0; g < S::G; ++g) {
      uint32_t bf[NT / 16][4];
#pragma unroll
      for (int j = 0; j < NT / 16; ++j) {
        ldmatrix_x4(bf[j], w_base + 16u * (g * NT * 2 + swz(16 * j + b_n, b_h)));
      }
#pragma unroll
      for (int m = 0; m < S::MT; ++m) {
        const int hr = warp * S::MT + m + ky;
        const int q = a_r + g * S::TPS + (S::UPP == 2 ? 0 : a_h * S::HS);
        const int unit = hr * S::SWS * S::UPP + (S::UPP == 2 ? swz(q, a_h) : q);
        uint32_t a[4];
        ldmatrix_x4(a, in_base + 16u * unit);
#pragma unroll
        for (int j = 0; j < NT / 16; ++j) {
          mma_bf16_16816(acc[m][2 * j], a, bf[j][0], bf[j][1]);
          mma_bf16_16816(acc[m][2 * j + 1], a, bf[j][2], bf[j][3]);
        }
      }
    }
    if constexpr (!S::SHORT) {
      if (ky == K - 1 && chunk + 1 < nchunks) store_input((chunk + 1) & 1);
      __syncthreads();
    }
  }

  // ---- epilogue: bias, ReLU, one rounding, staged per output channel
  __nv_bfloat16* out_s =
      reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) + S::OUT_OFFSET);
  const int nreal = min(NT, O - og * NT);
  float tau_x = 0.f;  // short sums: kShortSumTau * max|x|
  if constexpr (S::SHORT) {
#pragma unroll
    for (int w = 0; w < kIgWarps; ++w) tau_x = fmaxf(tau_x, xmax_s[w]);
    tau_x *= kShortSumTau;
  }

#pragma unroll
  for (int n = 0; n < NT / 8; ++n) {
    const int nc = n * 8 + (lane & 3) * 2;
    float bv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bv[e] = (bias != nullptr && nc + e < nreal) ? bias[og * NT + nc + e] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < S::MT; ++m) {
      const int py = warp * S::MT + m;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = nc + (e & 1);
        const int px = (lane >> 2) + 8 * (e >> 1);
        float v = acc[m][n][e] + bv[e & 1];
        if constexpr (S::SHORT) {
          // a tensor-core sum that nearly cancels may sit a few bf16 units off
          // the float32 one: list it for the exact recompute
          if (nn < nreal && y0 + py < H && x0 + px < W &&
              fabsf(v) < tau_x * wabs[og * NT + nn]) {
            list_s[atomicAdd(&list_n, 1)] = static_cast<uint16_t>((nn * S::TH + py) * kIgTile + px);
            continue;
          }
        }
        if (relu) v = fmaxf(v, 0.f);
        out_s[nn * S::OUT_STRIDE + py * kIgTile + px] = __float2bfloat16_rn(v);
      }
    }
  }
  if constexpr (S::SHORT) {
    __syncthreads();
    // the listed outputs again with the direct kernel's float32 FMA chain,
    // (c, ky, kx) order, over the staged halo and weights
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(in_s);
    const auto* ws = reinterpret_cast<const __nv_bfloat16*>(w_s);
#pragma unroll 1
    for (int i = tid; i < list_n; i += kIgThreads) {
      const int code = list_s[i];
      const int n = code / (S::TH * kIgTile);
      const int py = (code / kIgTile) % S::TH;
      const int px = code % kIgTile;
      float a = 0.f;
#pragma unroll 1
      for (int c = 0; c < C; ++c) {
#pragma unroll 1
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const float xv = __bfloat162float(xs[((py + ky) * S::SWS + px + kx) * 8 + c]);
            const int k = (kx % S::TPS) * CG + c;  // depth within the 16-wide step
            const float wv = __bfloat162float(
                ws[(ky * S::W_UNITS + (kx / S::TPS) * NT * 2 + swz(n, k >> 3)) * 8 + (k & 7)]);
            a = fmaf(xv, wv, a);
          }
        }
      }
      float v = a + (bias != nullptr ? bias[og * NT + n] : 0.f);
      if (relu) v = fmaxf(v, 0.f);
      out_s[n * S::OUT_STRIDE + py * kIgTile + px] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * O + og * NT) * plane;
  if ((W & 7) == 0) {
    for (int i = tid; i < nreal * S::TH * 2; i += kIgThreads) {
      const int n = i / (S::TH * 2);
      const int py = (i >> 1) % S::TH;
      const int px = (i & 1) * 8;
      const int y = y0 + py;
      const int xx = x0 + px;
      if (y < H && xx < W) {
        *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(n) * plane + y * W + xx) =
            *reinterpret_cast<const uint4*>(out_s + n * S::OUT_STRIDE + py * kIgTile + px);
      }
    }
  } else {
    for (int i = tid; i < nreal * S::TH * kIgTile; i += kIgThreads) {
      const int n = i / (S::TH * kIgTile);
      const int py = (i >> 4) % S::TH;
      const int px = i & 15;
      const int y = y0 + py;
      const int xx = x0 + px;
      if (y < H && xx < W) {
        ob[static_cast<int64_t>(n) * plane + y * W + xx] = out_s[n * S::OUT_STRIDE + py * kIgTile + px];
      }
    }
  }
}

template <int K, int CG, int NT>
cudaError_t launch_igemm_t(const uint16_t* x, const uint4* wp, const float* wabs, const float* bias,
                           __nv_bfloat16* out, int B, int C, int H, int W, int O, int relu,
                           cudaStream_t stream) {
  using S = IgemmShape<K, CG, NT>;
  // opt in always: the static recompute list of short sums counts against 48 KB too
  const cudaError_t err = cudaFuncSetAttribute(
      conv2d_igemm_kernel<K, CG, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const int n_groups = ceil_div(O, NT);
  const int nchunks = ceil_div(C, CG);
  const dim3 grid(ceil_div(W, kIgTile), ceil_div(H, S::TH), B * n_groups);
  conv2d_igemm_kernel<K, CG, NT><<<grid, kIgThreads, S::SMEM, stream>>>(
      x, wp, wabs, bias, out, C, H, W, O, relu, n_groups, nchunks);
  return cudaGetLastError();
}

template <int K, int CG>
cudaError_t launch_igemm_n(const uint16_t* x, const uint4* wp, const float* wabs, const float* bias,
                           __nv_bfloat16* out, int B, int C, int H, int W, int O, int NT, int relu,
                           cudaStream_t st) {
  switch (NT) {
    case 16: return launch_igemm_t<K, CG, 16>(x, wp, wabs, bias, out, B, C, H, W, O, relu, st);
    case 32: return launch_igemm_t<K, CG, 32>(x, wp, wabs, bias, out, B, C, H, W, O, relu, st);
    case 48: return launch_igemm_t<K, CG, 48>(x, wp, wabs, bias, out, B, C, H, W, O, relu, st);
    case 64: return launch_igemm_t<K, CG, 64>(x, wp, wabs, bias, out, B, C, H, W, O, relu, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t launch_igemm_c(const uint16_t* x, const uint4* wp, const float* wabs, const float* bias,
                           __nv_bfloat16* out, int B, int C, int H, int W, int O, int CG, int NT,
                           int relu, cudaStream_t st) {
  switch (CG) {
    case 4: return launch_igemm_n<K, 4>(x, wp, wabs, bias, out, B, C, H, W, O, NT, relu, st);
    case 8: return launch_igemm_n<K, 8>(x, wp, wabs, bias, out, B, C, H, W, O, NT, relu, st);
    case 16: return launch_igemm_n<K, 16>(x, wp, wabs, bias, out, B, C, H, W, O, NT, relu, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace memc

// bf16 tensor-core conv.  x: (B, C, H, W) bf16; wp: the weights repacked by
// ops/cuda/conv_kernel.py::pack_weights for this (CG, NT), bf16; bias: (O,)
// float32 or null; out: (B, O, H, W) bf16.  H * W < 2^31.
MEMC_API int memc_conv2d_igemm(const void* x, const void* wp, const void* wabs, const void* bias,
                               void* out, int B, int C, int H, int W, int O, int K, int CG, int NT,
                               int relu, void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0 || O == 0) return cudaSuccess;
  if (static_cast<int64_t>(H) * W >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  if (CG < 16 && C > CG) return cudaErrorInvalidValue;  // short sums stage one chunk
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const uint16_t*>(x);
  const auto* ws = static_cast<const uint4*>(wp);
  const auto* as = static_cast<const float*>(wabs);
  const auto* bs = static_cast<const float*>(bias);
  auto* os = static_cast<__nv_bfloat16*>(out);
  switch (K) {
    case 3: return memc::launch_igemm_c<3>(xs, ws, as, bs, os, B, C, H, W, O, CG, NT, relu, st);
    case 5: return memc::launch_igemm_c<5>(xs, ws, as, bs, os, B, C, H, W, O, CG, NT, relu, st);
    case 7: return memc::launch_igemm_c<7>(xs, ws, as, bs, os, B, C, H, W, O, CG, NT, relu, st);
    default: return cudaErrorInvalidValue;
  }
}
