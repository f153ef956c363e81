// Small-V row scatter-add (K4) for Hopper (sm_90a).
//
// `ge_scatter_add_small` replaces
// graphembedding_tpu/ops/pallas_scatter.py::_scatter_mm_kernel (entry
// scatter_add_matmul): table[ids[i], :] += grads[i, :], ids outside [0, V)
// dropped. On the TPU the whole [V_pad, C] accumulator stays in VMEM and
// the ids stream through it as one-hot MXU matmuls. A [2405, 128] table
// (1.2 MB) does not fit one SM's shared memory, and blocks run in no
// order, so here each block owns a tile of 16 table rows and a slice of up
// to 128 columns (LINE's [2405, 128] tables: 151 blocks), in one launch
// with no sort and no atomics:
//
//   1. one thread brings the id list into shared memory by bulk copy, in
//      chunks of 2,048 on a ring of two: the first two are asked for at
//      once, while the block loads its tile, and a chunk's slot is asked
//      for again as soon as it is read;
//   2. an ordered compaction (ballots, warp totals) appends the positions
//      whose id falls in the tile to a hit list, in index order;
//   3. once 64 hits are listed, and at the end, the hits' gradient slices
//      come into shared memory 64 at a time, in two buffers so that a
//      batch lands while the one before is added: one `cp.async.bulk` a
//      row, a batch on one mbarrier (plain loads where rows are not
//      16-byte aligned);
//   4. thread (column c, group g) adds the staged slices to column c of
//      the tile rows r with r % groups == g, in list order;
//   5. the tile is written back once.
//
// Each element is summed in index order starting from its table value, the
// order of the plain version's sequential loop on the CPU and of K2: the
// result is bit-equal to both and the same from run to run. What bounds
// it: not bytes (LINE's ctx call moves 5.6 MB, 1.7 us at 3.35 TB/s) but
// each block's chain of round trips (its tile and first ids, each later
// id chunk, its staged rows) and its instructions: every block tests the
// whole id list, so the work grows with N * V / 16. More blocks (C split
// to two slices, a block an SM and more) measured slower: they add id
// scans that compete for the SM's issue slots. A small-V kernel: its
// caller gates it on V (models/line.py::SMALL_V_ROWS).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;                // ids a chunk
constexpr int kRing = 2;                    // chunks in flight
constexpr int kItems = kChunk / kThreads;   // ids a thread tests a chunk
constexpr int kStage = 64;                  // gradient slices staged at once
constexpr int kHitCap = kStage + kChunk;    // hits listed before a flush
constexpr int kTileRows = 16;
constexpr int kMaxSlice = 128;              // columns a block at most

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the barrier's one arrival, announcing the bytes its copies will deliver
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  // shared memory read by the generic proxy before is rewritten by the
  // copy engine
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ids a chunk that come by bulk copy: whole 16-byte units of an aligned
// list; the rest of the chunk is read from device memory
__device__ __forceinline__ int bulk_ids_of(int N, int k, bool bulk_ids) {
  return bulk_ids ? min(kChunk, N - k * kChunk) & ~3 : 0;
}

__global__ void __launch_bounds__(kThreads)
scatter_add_small_kernel(float* __restrict__ table, int64_t ld, int V,
                         const int* __restrict__ ids,
                         const float* __restrict__ grads, int N, int C,
                         int CW, int col_threads, bool bulk_ids,
                         bool bulk_rows) {
  extern __shared__ __align__(128) int4 smem4[];
  int* ids_s = reinterpret_cast<int*>(smem4);           // [kRing][kChunk]
  int* hit_pos = ids_s + kRing * kChunk;                // [kHitCap]
  // [2][kStage][CW], then [kTileRows][CW]
  float* stage = reinterpret_cast<float*>(hit_pos + kHitCap);
  float* tile = stage + 2 * kStage * CW;
  // the id ring's slots, then the two stage buffers'
  __shared__ __align__(8) uint64_t bars[kRing + 2];
  uint64_t* stage_bar = &bars[kRing];
  __shared__ int warp_tot[kWarps];
  __shared__ unsigned char hit_row[kHitCap];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kTileRows;
  const int nr = min(kTileRows, V - r0);
  const int c0 = blockIdx.y * CW;
  const int cw = min(CW, C - c0);
  // thread (col, grp) adds to column col of the rows r with r % groups ==
  // grp; col_threads is a power of two >= CW
  const int col = tid & (col_threads - 1);
  const int groups = kThreads / col_threads;
  const int grp = tid / col_threads;
  const int nchunks = (N + kChunk - 1) / kChunk;

  auto issue_ids = [&](int k) {
    const int nb = bulk_ids_of(N, k, bulk_ids);
    if (nb > 0) {
      mbar_expect(&bars[k % kRing], (uint32_t)nb * 4u);
      bulk_copy(ids_s + (k % kRing) * kChunk, ids + (int64_t)k * kChunk,
                (uint32_t)nb * 4u, &bars[k % kRing]);
    }
  };
  if (tid == 0) {
    for (int b = 0; b < kRing + 2; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kRing && k < nchunks; ++k) issue_ids(k);
  }
  for (int r = warp; r < nr; r += kWarps) {
    const float* src = table + (int64_t)(r0 + r) * ld + c0;
    for (int c = lane; c < cw; c += 32) tile[r * CW + c] = src[c];
  }
  __syncthreads();  // the barriers initialised

  uint32_t stage_parity = 0;  // bit b: the phase stage buffer b waits for
  int count = 0;  // hits listed; the same in every thread
  // the gradient slices of hits h0 .. h0 + m - 1 into stage buffer b
  auto stage_rows = [&](int h0, int m, int b) {
    float* dst = stage + b * kStage * CW;
    if (bulk_rows) {
      if (warp == 0) {
        if (lane == 0) mbar_expect(&stage_bar[b], (uint32_t)(m * cw) * 4u);
        __syncwarp();
        for (int h = lane; h < m; h += 32)
          bulk_copy(dst + h * CW, grads + (int64_t)hit_pos[h0 + h] * C + c0,
                    (uint32_t)cw * 4u, &stage_bar[b]);
      }
    } else {
      for (int h = warp; h < m; h += kWarps) {
        const float* src = grads + (int64_t)hit_pos[h0 + h] * C + c0;
        for (int c = lane; c < cw; c += 32) dst[h * CW + c] = __ldg(src + c);
      }
    }
  };
  for (int k = 0; k < nchunks; ++k) {
    const int base = k * kChunk;
    const int n = min(kChunk, N - base);
    const int nb = bulk_ids_of(N, k, bulk_ids);
    const int* ib = ids_s + (k % kRing) * kChunk;
    if (nb > 0) mbar_wait(&bars[k % kRing], (uint32_t)(k / kRing) & 1u);

    // ordered compaction: warp w tests ids w * 32 * kItems + u * 32 + lane
    unsigned hits[kItems];
    int rows[kItems];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int j = warp * 32 * kItems + u * 32 + lane;
      const int id = j < nb ? ib[j] : (j < n ? __ldg(ids + base + j) : -1);
      // an id outside [0, V) is outside every tile: dropped
      rows[u] = id - r0;
      hits[u] = __ballot_sync(0xffffffffu,
                              j < n && rows[u] >= 0 && rows[u] < nr);
      mine += __popc(hits[u]);
    }
    if (lane == 0) warp_tot[warp] = mine;
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[w];
      off += w < warp ? t : 0;
      total += t;
    }
    const unsigned below_me = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (hits[u] >> lane & 1u) {
        const int h = off + __popc(hits[u] & below_me);
        hit_pos[h] = base + warp * 32 * kItems + u * 32 + lane;
        hit_row[h] = (unsigned char)rows[u];
      }
      off += __popc(hits[u]);
    }
    count += total;
    __syncthreads();  // hits listed; warp_tot and this chunk's slot read
    if (tid == 0 && k + kRing < nchunks) issue_ids(k + kRing);
    if (count < kStage && k + 1 < nchunks) continue;

    const int batches = (count + kStage - 1) / kStage;
    for (int b = 0; b < 2 && b < batches; ++b)
      stage_rows(b * kStage, min(kStage, count - b * kStage), b);
    for (int b = 0; b < batches; ++b) {
      const int h0 = b * kStage, m = min(kStage, count - h0);
      const float* st = stage + (b & 1) * kStage * CW;
      if (bulk_rows) {
        mbar_wait(&stage_bar[b & 1], stage_parity >> (b & 1) & 1u);
        stage_parity ^= 1u << (b & 1);
      } else {
        __syncthreads();
      }
      if (col < cw) {
        for (int h = 0; h < m; ++h) {
          const int r = hit_row[h0 + h];
          if ((r & (groups - 1)) == grp)  // groups: a power of two
            tile[r * CW + col] += st[h * CW + col];
        }
      }
      __syncthreads();  // the staged slices are read
      if (b + 2 < batches)
        stage_rows(h0 + 2 * kStage, min(kStage, count - h0 - 2 * kStage),
                   b & 1);
    }
    count = 0;
  }

  for (int r = warp; r < nr; r += kWarps) {
    float* dst = table + (int64_t)(r0 + r) * ld + c0;
    for (int c = lane; c < cw; c += 32) dst[c] = tile[r * CW + c];
  }
}

// columns a block for C split in s slices: a multiple of 4, so that every
// slice starts on a 16-byte boundary of an aligned row
inline int slice_width(int C, int s) {
  return ((C + s - 1) / s + 3) / 4 * 4;
}

}  // namespace

extern "C" {

int ge_scatter_add_small(int device, void* table, int64_t ld, int V,
                         const void* ids, const void* grads, int N, int C,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || V == 0 || C == 0) return 0;
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (V + kTileRows - 1) / kTileRows;
  int slices = (C + kMaxSlice - 1) / kMaxSlice;
  // more slices only while the grid would be under one block an SM: two
  // (LINE's [2405, 128]: 302 blocks, not 151) measured slower on an H100
  while ((int64_t)tiles * slices < sms && slice_width(C, 2 * slices) >= 32)
    slices *= 2;
  const int CW = slice_width(C, slices);
  slices = (C + CW - 1) / CW;
  int col_threads = 32;
  while (col_threads < CW) col_threads *= 2;
  const bool bulk_ids = (uintptr_t)ids % 16 == 0;
  const bool bulk_rows = (uintptr_t)grads % 16 == 0 && C % 4 == 0;
  const size_t smem = (size_t)(kRing * kChunk + kHitCap) * 4 +
                      (size_t)(2 * kStage + kTileRows) * CW * 4;
  static size_t smem_set[64] = {};  // the opt-in made so far, by device
  if (smem > smem_set[device & 63]) {
    e = cudaFuncSetAttribute(scatter_add_small_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[device & 63] = smem;
  }
  scatter_add_small_kernel<<<dim3(tiles, slices), kThreads, smem,
                             (cudaStream_t)stream>>>(
      (float*)table, ld, V, (const int*)ids, (const float*)grads, N, C, CW,
      col_threads, bulk_ids, bulk_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
