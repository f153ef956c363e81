// Row gather (K3) and row scatter-add (K2) for Hopper (sm_90a).
//
// K3 `ge_gather_rows` replaces the contract of
// graphembedding_tpu/ops/pallas_scatter.py::_gather_mm_kernel
// (entry gather_rows_matmul): out[i, :] = table[ids[i], :]. On the TPU
// that was a one-hot MXU matmul with bf16x2 splitting; here it is a plain
// copy, so it is bit-exact. One warp per row, 16-byte loads where the
// rows are 16-byte aligned. Bound by device-memory bytes (each row is
// read once and written once).
//
// K2 `ge_scatter_add_rows` replaces
// graphembedding_tpu/ops/pallas_scatter.py::_rmw_kernel (entry
// scatter_add_rows): table[ids[i], :] += grads[i, :], ids outside [0, V)
// dropped. As on the TPU, the caller sorts the ids first (a stable sort,
// which keeps the order of equal ids); the kernel then makes one
// read-modify-write per unique row. The block at the start of each run of
// equal ids finds the run's end with a ballot; each of its threads owns a
// column and adds the run's gradient rows to it in their original order,
// with the loads of 32 rows in flight, then stores the row once. Each
// element is thus summed in the order of a sequential loop over i, so the
// result is bit-equal to the plain version on the CPU and the same from
// run to run (no atomics). Bound by device-memory latency along the
// longest run (the most frequent id of the call): about its length over 32
// load latencies. The gradient rows are read once in all.
//
// Both take a table row stride `ld` (elements), so a column slice of a
// wider table (the upper half of the fused [V, 2D] table) needs no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const float* __restrict__ table, int64_t ld, int V,
                   const int* __restrict__ ids, int N, int C,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const int id = ids[row];
  float* dst = out + row * C;
  if (id < 0 || id >= V) {
    // callers clamp ids; an id outside the table reads nothing
    for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    return;
  }
  const float* src = table + (int64_t)id * ld;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < C / 4; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = __ldg(src + c);
  }
}

// gradient rows whose loads a thread keeps in flight before adding them
constexpr int kBatch = 32;

// One block per sorted position; only the block at the start of a run
// works. Thread t owns columns t, t + blockDim.x, ...; it adds the run's
// rows to them in order, loading kBatch rows ahead.
__global__ void scatter_add_sorted_kernel(float* __restrict__ table,
                                          int64_t ld, int V,
                                          const int* __restrict__ sids,
                                          const int64_t* __restrict__ order,
                                          const float* __restrict__ grads,
                                          int N, int C) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int id = sids[p];
  if (p > 0 && sids[p - 1] == id) return;  // not the start of a run
  if (id < 0 || id >= V) return;  // dropped, as XLA's scatter drops them
  int end = p + 1;
  for (;;) {  // sorted: lanes still in the run form a prefix of the warp
    const int q = end + lane;
    const unsigned in_run =
        __ballot_sync(0xffffffffu, q < N && sids[q] == id);
    end += __popc(in_run);
    if (in_run != 0xffffffffu) break;
  }
  float* dst = table + (int64_t)id * ld;
  for (int c = threadIdx.x; c - lane < C; c += blockDim.x) {
    // the whole warp stays in the loop for the shuffles below
    const bool mine_c = c < C;
    float acc = mine_c ? dst[c] : 0.f;
    for (int q0 = p; q0 < end; q0 += kBatch) {
      const int n = min(kBatch, end - q0);
      const int64_t row_l = lane < n ? order[q0 + lane] : 0;
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t row = __shfl_sync(0xffffffffu, row_l, u);
        v[u] = (u < n && mine_c) ? __ldg(grads + row * C + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < n) acc += v[u];
      }
    }
    if (mine_c) dst[c] = acc;
  }
}

inline unsigned blocks_for(int n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

const char* ge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ge_gather_rows(int device, const void* table, int64_t ld, int V,
                   const void* ids, int N, int C, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  const bool vec = ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0) && ld % 4 == 0 && C % 4 == 0;
  const dim3 grid(blocks_for(N)), block(kWarpsPerBlock * 32);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const int* i = (const int*)ids;
  if (vec) {
    gather_rows_kernel<true><<<grid, block, 0, s>>>(t, ld, V, i, N, C,
                                                   (float*)out);
  } else {
    gather_rows_kernel<false><<<grid, block, 0, s>>>(t, ld, V, i, N, C,
                                                    (float*)out);
  }
  return (int)cudaGetLastError();
}

int ge_scatter_add_rows(int device, void* table, int64_t ld, int V,
                        const void* sorted_ids, const void* order,
                        const void* grads, int N, int C, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  // one thread per column, up to 1024
  const int threads = C >= 1024 ? 1024 : (C + 31) / 32 * 32;
  scatter_add_sorted_kernel<<<N, threads, 0, (cudaStream_t)stream>>>(
      (float*)table, ld, V, (const int*)sorted_ids, (const int64_t*)order,
      (const float*)grads, N, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
