// Small-V row scatter-add (K4) for Hopper (sm_90a).
//
// `ge_scatter_add_small` replaces
// graphembedding_tpu/ops/pallas_scatter.py::_scatter_mm_kernel (entry
// scatter_add_matmul): table[ids[i], :] += grads[i, :], ids outside [0, V)
// dropped. On the TPU the whole [V_pad, C] accumulator stays in VMEM and
// the ids stream through it as one-hot MXU matmuls. A [2405, 128] table
// (1.2 MB) does not fit one SM's shared memory, and blocks run in no
// order, so here each block owns a tile of TV table rows:
//
//   1. it loads its rows into shared memory;
//   2. it streams the whole id list in chunks; each thread tests four
//      consecutive ids, and an ordered compaction (warp scan + warp
//      totals) appends the positions whose id falls in the tile to a
//      shared hit list, in index order;
//   3. when the list is near full, and at the end, thread t adds the
//      listed gradient rows to column t (and t + blockDim, ...) of the
//      tile in list order, with kBatch rows' loads in flight;
//   4. it writes the tile back once.
//
// Each element is summed in index order starting from its table value, the
// order of the plain version's sequential loop on the CPU: the result is
// bit-equal to it and the same from run to run (no atomics, no sort).
// Bound by reading the id list once per block, N * ceil(V / TV) id reads
// (from L2 after the first block), while the gradient rows are read once
// in all: a small-V kernel, which its caller gates on V.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kIdsPerThread = 4;
constexpr int kChunk = kThreads * kIdsPerThread;  // ids tested per round
constexpr int kHitCap = 2 * kChunk;  // hits buffered before a column pass
constexpr int kBatch = 16;  // gradient loads a thread keeps in flight

// Thread t adds the buffered hits, in order, to columns t, t + kThreads, ...
__device__ __forceinline__ void add_hits(float* __restrict__ tile,
                                         const int* __restrict__ hit_pos,
                                         const int* __restrict__ hit_row,
                                         int count,
                                         const float* __restrict__ grads,
                                         int C) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    for (int j0 = 0; j0 < count; j0 += kBatch) {
      const int n = min(kBatch, count - j0);
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[u] = u < n ? __ldg(grads + (int64_t)hit_pos[j0 + u] * C + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < n) tile[hit_row[j0 + u] * C + c] += v[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_add_small_kernel(float* __restrict__ table, int64_t ld, int V,
                         const int* __restrict__ ids,
                         const float* __restrict__ grads, int N, int C,
                         int TV) {
  extern __shared__ float tile[];  // [TV, C]
  __shared__ int hit_pos[kHitCap];
  __shared__ int hit_row[kHitCap];
  __shared__ int warp_tot[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * TV;
  const int nr = min(TV, V - r0);

  for (int e = tid; e < nr * C; e += kThreads) {
    const int r = e / C;
    tile[e] = table[(int64_t)(r0 + r) * ld + (e - r * C)];
  }

  int count = 0;  // hits buffered; the same in every thread
  for (int base = 0; base < N; base += kChunk) {
    const int i0 = base + tid * kIdsPerThread;
    int row[kIdsPerThread];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kIdsPerThread; ++u) {
      const int i = i0 + u;
      // an id outside [0, V) is outside every tile: dropped
      const int r = i < N ? ids[i] - r0 : -1;
      row[u] = (r >= 0 && r < nr) ? r : -1;
      mine += row[u] >= 0;
    }
    int incl = mine;  // inclusive scan of the hit counts over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();  // warp totals written; the tile loaded
    int off = count + incl - mine;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[w];
      off += w < warp ? t : 0;
      total += t;
    }
#pragma unroll
    for (int u = 0; u < kIdsPerThread; ++u) {
      if (row[u] >= 0) {
        hit_pos[off] = i0 + u;
        hit_row[off] = row[u];
        ++off;
      }
    }
    count += total;
    __syncthreads();  // hits visible; warp totals read
    if (count > kHitCap - kChunk || base + kChunk >= N) {
      add_hits(tile, hit_pos, hit_row, count, grads, C);
      count = 0;
      __syncthreads();  // the pass is done before the list is rewritten
    }
  }

  for (int e = tid; e < nr * C; e += kThreads) {
    const int r = e / C;
    table[(int64_t)(r0 + r) * ld + (e - r * C)] = tile[e];
  }
}

// Rows a block owns, so that its tile and hit list fit the 48 KB of shared
// memory a launch gets without an opt-in; below 1 (C > 10,224) the launch
// is refused.
int tile_rows(int C) {
  const int tv = (48 * 1024 - 2 * kHitCap * 4 - 64) / (4 * C);
  return tv < 16 ? tv : 16;
}

}  // namespace

extern "C" {

int ge_scatter_add_small(int device, void* table, int64_t ld, int V,
                         const void* ids, const void* grads, int N, int C,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || V == 0) return 0;
  const int tv = tile_rows(C);
  if (tv < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((V + tv - 1) / tv);
  scatter_add_small_kernel<<<blocks, kThreads, (size_t)tv * C * 4,
                             (cudaStream_t)stream>>>(
      (float*)table, ld, V, (const int*)ids, (const float*)grads, N, C, tv);
  return (int)cudaGetLastError();
}

}  // extern "C"
