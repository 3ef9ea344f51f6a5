// How mma.sync.m16n8k16 (bf16 in, float32 accumulate) adds: for timing-free
// inspection only (memcnet_tpu_torch/bench/kernel_ab.py builds and runs it).
// One warp multiplies A (16 x 16, row-major) by B given as Bt (8 x 16,
// row-major: B's columns) and adds C (16 x 8); D = A B + C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

__global__ void mma_probe_kernel(const __nv_bfloat16* A, const __nv_bfloat16* Bt, const float* C,
                                 float* D) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  auto pair = [](const __nv_bfloat16* p) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(p[0])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(p[1])) << 16);
  };
  const uint32_t a0 = pair(A + g * 16 + 2 * t), a1 = pair(A + (g + 8) * 16 + 2 * t);
  const uint32_t a2 = pair(A + g * 16 + 2 * t + 8), a3 = pair(A + (g + 8) * 16 + 2 * t + 8);
  const uint32_t b0 = pair(Bt + g * 16 + 2 * t), b1 = pair(Bt + g * 16 + 2 * t + 8);
  float c[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1], C[(g + 8) * 8 + 2 * t],
                C[(g + 8) * 8 + 2 * t + 1]};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  D[g * 8 + 2 * t] = c[0];
  D[g * 8 + 2 * t + 1] = c[1];
  D[(g + 8) * 8 + 2 * t] = c[2];
  D[(g + 8) * 8 + 2 * t + 1] = c[3];
}

extern "C" __attribute__((visibility("default"))) int memc_mma_probe(const void* A, const void* Bt,
                                                                     const void* C, void* D) {
  mma_probe_kernel<<<1, 32>>>(static_cast<const __nv_bfloat16*>(A),
                              static_cast<const __nv_bfloat16*>(Bt), static_cast<const float*>(C),
                              static_cast<float*>(D));
  return cudaDeviceSynchronize();
}
