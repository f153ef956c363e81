// Row gather by bulk copies (K5) for Hopper (sm_90a).
//
// `ge_dma_gather_rows` replaces benchmarks/dma_gather.py::pallas_row_gather:
// out[i, :] = table[ids[i], :], one DMA per row, B rows per grid step. On
// the TPU each grid step started B row DMAs from HBM into its VMEM output
// block on B semaphores and waited on all of them. The Hopper form of "one
// DMA per row" is the bulk-copy engine: one block per B ids; one thread
// issues B `cp.async.bulk` global -> shared copies of W * 4 bytes each,
// all completing on one `mbarrier` that expects their byte count; every
// thread waits on it, then the block writes the B rows out with 16-byte
// stores. An id outside [0, V) is not copied and its row is written as
// zeros, as K3 does. The result is bit-exact.
//
// Bound by device-memory bytes (each row read once, written once) and by
// how many copies are in flight: B per block, several blocks per SM.
// Requires W % 4 == 0 (16-byte rows, the bulk copy's unit), a 16-byte
// aligned contiguous table, N % B == 0 and B <= kMaxB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxB = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const float* __restrict__ table, int V,
                  const int* __restrict__ ids, int W, int B,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) float rows[];  // [B, W]
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_ids[kMaxB];
  const int64_t first = (int64_t)blockIdx.x * B;
  const uint32_t bar_a = smem_addr(&bar);
  for (int j = threadIdx.x; j < B; j += kThreads) s_ids[j] = ids[first + j];
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t row_bytes = (uint32_t)W * 4u;
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    for (int j = 0; j < B; ++j) {
      const int id = s_ids[j];
      bytes += (id >= 0 && id < V) ? row_bytes : 0u;
    }
    // the one arrival, with the bytes the copies will deliver
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_a), "r"(bytes) : "memory");
    for (int j = 0; j < B; ++j) {
      const int id = s_ids[j];
      if (id < 0 || id >= V) continue;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(rows + (int64_t)j * W)),
          "l"(table + (int64_t)id * W), "r"(row_bytes), "r"(bar_a)
          : "memory");
    }
  }
  // phase 0 completes once the arrival is made and every byte has landed
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar_a)
      : "memory");

  const int w4 = W / 4;
  const float4* src = reinterpret_cast<const float4*>(rows);
  float4* dst = reinterpret_cast<float4*>(out + first * W);
  for (int e = threadIdx.x; e < B * w4; e += kThreads) {
    const int id = s_ids[e / w4];
    dst[e] = (id >= 0 && id < V) ? src[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" {

int ge_dma_gather_rows(int device, const void* table, int V, const void* ids,
                       int N, int W, int B, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  if (W % 4 || B < 1 || B > kMaxB || N % B) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)B * W * 4;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(dma_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dma_gather_kernel<<<N / B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)table, V, (const int*)ids, W, B, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
