// Row gather by bulk copies (K5) for Hopper (sm_90a).
//
// `ge_dma_gather_rows` replaces benchmarks/dma_gather.py::pallas_row_gather:
// out[i, :] = table[ids[i], :], one DMA per row, B rows per grid step. On
// the TPU each grid step started B row DMAs from HBM into its VMEM output
// block on B semaphores and waited on all of them. Here a grid step is a
// stage: B rows that land in shared memory by one `cp.async.bulk` each and
// leave it by one bulk store of the stage's B contiguous output rows. An
// id outside [0, V) is not copied and its row is written as zeros, as K3
// does. The result is bit-exact.
//
// Bound by device-memory bytes (each row read once, written once), which
// the card moves only with enough bytes in flight: at 3.35 TB/s and about
// 1.5 us of loaded latency, some 40 KB an SM. So the launch is persistent
// and every block is one warp that keeps a ring of S stages going:
//   - the grid is sized to the card (blocks_per_sm x SMs, at most N / B
//     blocks) and block b takes stages b, b + grid, b + 2 grid, ...;
//   - the ring's S stages sit in dynamic shared memory, each with a full
//     mbarrier whose phase flips on each reuse (parity = use count & 1);
//   - the warp reads a stage's ids with coalesced loads one stage ahead,
//     sums its bytes with a warp reduction for lane 0's one
//     `arrive.expect_tx`, and lane r issues row r's copy (the lanes loop
//     when B > 32);
//   - when a stage's barrier completes, the rows of ids outside [0, V) are
//     zeroed with plain stores, made visible to the copy engine by
//     `fence.proxy.async`, and lane 0 issues one bulk store of the stage
//     (global <- shared, a bulk group) while stages k+1 .. k+S-1 load;
//   - a slot is refilled once the store that last read it is done reading
//     (`cp.async.bulk.wait_group.read 0` at the top of the next step), and
//     the block exits only after `wait_group 0`.
// On the H100 at 1M x 256 rows this runs at the card's rate for random
// 1 KB rows, a few percent under a contiguous copy of the same bytes; the
// static order of stages leaves a tail that the hardware's own block
// scheduler would balance (PERF.md). The launch plan (S, grid,
// shared bytes) comes from the wrapper (`ops/rows.py::dma_gather_plan`).
// Requires W % 4 == 0 (16-byte rows, the bulk copy's unit), a 16-byte
// aligned contiguous table, N % B == 0, B <= kMaxB and S <= kMaxStages.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp a block
constexpr int kMaxB = 256;
constexpr int kMaxStages = 8;
constexpr int kChunks = kMaxB / 32;  // rows of a stage a lane may own

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// lane l holds the ids of rows l, l + 32, ... of the stage at `first`
__device__ __forceinline__ void load_ids(int (&id)[kChunks],
                                         const int* __restrict__ ids,
                                         int64_t first, int B, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int r = c * 32 + lane;
    if (c * 32 < B) id[c] = r < B ? ids[first + r] : 0;
  }
}

// one stage's loads: its bytes announced on its barrier by lane 0, then
// lane l copies rows l, l + 32, ...; the rows of ids outside [0, V) are
// marked in pad[] (a bit a row) and not copied
__device__ __forceinline__ void load_stage(
    const int (&id)[kChunks], const float* __restrict__ table, int V, int W,
    int B, float* dst, uint64_t* bar, uint32_t* pad, int lane) {
  const uint32_t row_bytes = (uint32_t)W * 4u;
  uint32_t bytes = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * 32 >= B) break;
    const int r = c * 32 + lane;
    const bool ok = r < B && id[c] >= 0 && id[c] < V;
    const uint32_t bad = __ballot_sync(0xffffffffu, r < B && !ok);
    if (lane == 0) pad[c] = bad;
    bytes += ok ? row_bytes : 0u;
  }
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (lane == 0) {
    // the one arrival, with the bytes the copies will deliver
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c * 32 >= B) break;
    const int r = c * 32 + lane;
    if (r < B && id[c] >= 0 && id[c] < V) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(dst + (int64_t)r * W)),
          "l"(table + (int64_t)id[c] * W), "r"(row_bytes),
          "r"(smem_addr(bar))
          : "memory");
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const float* __restrict__ table, int V,
                  const int* __restrict__ ids, int W, int B, int S,
                  int n_stages, float* __restrict__ out) {
  extern __shared__ __align__(128) float ring[];  // [S, B, W]
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ uint32_t pad_rows[kMaxStages][kChunks];  // ids outside [0, V)
  const int lane = threadIdx.x;
  const int64_t stage_floats = (int64_t)B * W;
  if (lane < S) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(smem_addr(&full[lane])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  // this block's stages: local stage j is global stage blockIdx.x + j grid
  const int64_t grid = gridDim.x;
  const int mine = (int)((n_stages - blockIdx.x + grid - 1) / grid);
  const int64_t step = grid * B * W;  // output floats from one j to the next
  // the ids of the next stage to load, read one stage ahead
  int id[kChunks];
  load_ids(id, ids, (int64_t)blockIdx.x * B, B, lane);
  int loaded = 0;
  auto load_next = [&]() {
    const int slot = loaded % S;
    load_stage(id, table, V, W, B, ring + slot * stage_floats, &full[slot],
               pad_rows[slot], lane);
    if (++loaded < mine) {
      load_ids(id, ids, ((int64_t)blockIdx.x + (int64_t)loaded * grid) * B,
               B, lane);
    }
  };

  // S - 1 stages ahead; each step refills the slot the last store read
  while (loaded < S - 1 && loaded < mine) load_next();
  float* dst = out + (int64_t)blockIdx.x * B * W;
  for (int j = 0; j < mine; ++j, dst += step) {
    if (loaded < mine) {
      if (lane == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      __syncwarp();
      load_next();
    }
    const int slot = j % S;
    float* src = ring + slot * stage_floats;
    mbar_wait(&full[slot], (uint32_t)(j / S) & 1u);
    uint32_t any_pad = 0;
    for (int c = 0; c * 32 < B; ++c) {
      for (uint32_t pad = pad_rows[slot][c]; pad; pad &= pad - 1) {
        float4* row = reinterpret_cast<float4*>(
            src + (int64_t)(c * 32 + __ffs(pad) - 1) * W);
        for (int e = lane; e < W / 4; e += kThreads) {
          row[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        any_pad = 1;
      }
    }
    if (any_pad) {
      // zero rows written by the generic proxy, read by the bulk store
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n"
          ::"l"(dst), "r"(smem_addr(src)), "r"((uint32_t)(stage_floats * 4))
          : "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int smem_set[64];  // the dynamic shared memory allowed so far, per device

}  // namespace

extern "C" {

int ge_dma_gather_rows(int device, const void* table, int V, const void* ids,
                       int N, int W, int B, int S, int grid, int smem,
                       void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  if (W % 4 || B < 1 || B > kMaxB || N % B || S < 1 || S > kMaxStages ||
      grid < 1 || grid > N / B || device < 0 || device >= 64 ||
      (int64_t)smem != (int64_t)S * B * W * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024 && smem > smem_set[device]) {
    e = cudaFuncSetAttribute(dma_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = smem;
  }
  dma_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)table, V, (const int*)ids, W, B, S, N / B, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
