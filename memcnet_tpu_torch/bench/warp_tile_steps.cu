// The design steps of K1's tile entry, for timing only
// (memcnet_tpu_torch/bench/kernel_ab.py builds this file with nvcc and loads
// it with ctypes; it is not part of the kernel library).  Each step runs
// memc_filter_interp_warp_tile's function, filter size 4, in another
// configuration (TileConfig in csrc/warp.cu), and steps 0-8 must give the
// entry's bits (all sum the taps in the same (j, i) order with fmaf):
//   0  the first design: K1's kernel with its TILE flag, 32 x 8 blocks, two
//      channels interleaved a stage, a barrier a pair;
//   1  as built (TileAsBuilt: 16 x 16 blocks, 16-byte box elements, two a
//      thread, at least 3 blocks an SM, bf16 fetched a value a register);
//   2  32 x 8 blocks (336-column tiles: the last column of blocks half empty);
//   3  three box elements a thread (a box of at most 768 source pixels);
//   4  at least 4 blocks an SM (64 registers a thread);
//   5  at least 2 blocks an SM (128 registers);
//   6  8-byte box elements (half the channels a stage);
//   7  bf16 packed as it is fetched (each load waits for the one before it);
//   8  as 7 with three box elements a thread: the design's first build.
// Steps 9 and 10 compute something else and are timed only: 9 stages and
// stores but sums no tap, 10 sums the taps of whatever the stage holds and
// fetches nothing.
#include "warp.cu"

namespace memc {

template <typename T>
cudaError_t tile_step(int step, const WarpSources& s, const float* flow, const T* filt, int B,
                      int H, int W, const TileGeom& g, cudaStream_t st) {
  constexpr int G = 16 / static_cast<int>(sizeof(T));
  switch (step) {
    case 0: {
      const dim3 block(kWarpBX, kWarpBY);
      const dim3 grid(ceil_div(W, kWarpBX), ceil_div(H, kWarpBY), B);
      int total = 0;
      for (int k = 0; k < s.n; ++k) total += s.channels[k];
      if (total > kGatherChannels) {
        filter_interp_warp_kernel<T, 4, true, true><<<grid, block, 0, st>>>(s, flow, filt, H, W, g);
      } else {
        filter_interp_warp_kernel<T, 4, false, true><<<grid, block, 0, st>>>(s, flow, filt, H, W, g);
      }
      return cudaGetLastError();
    }
    case 1:
      return launch_warp_tile<T>(s, flow, filt, B, H, W, 4, g, st);
    case 2:
      return launch_warp_tile_as<T, TileConfig<32, G, 3, 2>>(s, flow, filt, B, H, W, 4, g, st);
    case 3:
      return launch_warp_tile_as<T, TileConfig<16, G, 3, 3>>(s, flow, filt, B, H, W, 4, g, st);
    case 4:
      return launch_warp_tile_as<T, TileConfig<16, G, 4, 2>>(s, flow, filt, B, H, W, 4, g, st);
    case 5:
      return launch_warp_tile_as<T, TileConfig<16, G, 2, 2>>(s, flow, filt, B, H, W, 4, g, st);
    case 6:
      return launch_warp_tile_as<T, TileConfig<16, G / 2, 3, 2>>(s, flow, filt, B, H, W, 4, g, st);
    case 7:
      return launch_warp_tile_as<T, TileConfig<16, G, 3, 2, false>>(s, flow, filt, B, H, W, 4, g,
                                                                    st);
    case 8:
      return launch_warp_tile_as<T, TileConfig<16, G, 3, 3, false>>(s, flow, filt, B, H, W, 4, g,
                                                                    st);
    case 9:
      return launch_warp_tile_as<T, TileConfig<16, G, 3, 2, true, 1>>(s, flow, filt, B, H, W, 4, g,
                                                                      st);
    case 10:
      return launch_warp_tile_as<T, TileConfig<16, G, 3, 2, true, 2>>(s, flow, filt, B, H, W, 4, g,
                                                                      st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace memc

// The arguments of memc_filter_interp_warp_tile, filter size 4.
MEMC_API int memc_warp_tile_step(int step, const memc::WarpSources* s, const void* flow,
                                 const void* filt, const void* origins, int B, int H, int W,
                                 int halo, int halo_h, int Hg, int Wg, int dtype, void* stream) {
  const memc::TileGeom g{static_cast<const int*>(origins), halo, halo_h, Hg, Wg};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fl = static_cast<const float*>(flow);
  if (dtype == memc::kFloat32)
    return memc::tile_step<float>(step, *s, fl, static_cast<const float*>(filt), B, H, W, g, st);
  if (dtype == memc::kBFloat16) {
    return memc::tile_step<__nv_bfloat16>(step, *s, fl, static_cast<const __nv_bfloat16*>(filt), B,
                                          H, W, g, st);
  }
  return cudaErrorInvalidValue;
}
