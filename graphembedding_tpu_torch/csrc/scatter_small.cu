// Small-V row scatter-add (K4) for Hopper (sm_90a).
//
// `ge_scatter_add_small` replaces
// graphembedding_tpu/ops/pallas_scatter.py::_scatter_mm_kernel (entry
// scatter_add_matmul): table[ids[i], :] += grads[i, :], ids outside [0, V)
// dropped. On the TPU the whole [V_pad, C] accumulator stays in VMEM and
// the ids stream through it as one-hot MXU matmuls. A [2405, 128] table
// (1.2 MB) does not fit one SM's shared memory, and blocks run in no
// order. Each element is summed in index order starting from its table
// value, the order of the plain version's sequential loop on the CPU and
// of K2, with no float atomics: the result is bit-equal to both and the
// same from run to run, under either of two plans (the caller picks one,
// ops/rows.py::small_plan).
//
// The scan plan (few ids a table row, LINE's scatters): one block owns a
// tile of 16 table rows and a slice of up to 128 columns, in one launch
// with no sort:
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
// What bounds it: each block's chain of round trips and its instructions;
// every block tests the whole id list (the work grows with N * V / 16),
// and one block adds all the hits of its tile: where a few rows take most
// ids (the hierarchical-softmax tree's root and top levels) that block's
// round trips run in series while the others wait.
//
// The group plan (many ids a row, or hot rows: the hierarchical-softmax
// scatters) splits the work by hits, in one cooperative launch of a
// persistent grid (a block an SM) whose phases are separated by grid
// barriers:
//
//   1-3. group the ids by row, stably: each tile of 1,024 ids counts its
//        rows in shared memory (V + 1 <= 16,385 counters: an id outside
//        [0, V) is the key V, dropped); per row, a warp of each block of
//        32 rows turns the counts of its range of tiles into counts in the
//        tiles before, and the rows' totals into prefixes in their block;
//        each tile scans the blocks' totals, then places its positions
//        warp after warp (`match` ranks equal rows in a warp, all warps at
//        once beforehand), so a row's positions keep index order. Every
//        run longer than 64 rows is listed by its length class
//        floor(log2(length));
//   4. sum, two kinds of unit at once:
//      - a long run, in slices of 16 columns, is a ring unit: a block's
//        first unit is its own index, each later one the next from a
//        counter, longest class first, so the root's eight slices start
//        at once on eight SMs and a block that holds a long unit takes no
//        other meanwhile. In a block, warp 0 streams each unit's gradient
//        slices into a ring of 4 shared-memory stages of 256 rows by
//        `cp.async` (16 bytes a lane, eight rows a warp instruction, in
//        straight-line code; the positions of two stages load a chunk
//        ahead, the run's table slice with its first stage) and hands a
//        stage over once its copies have landed, two stages later
//        (`cp.async.wait_group`, then an mbarrier arrival); warp 1 adds
//        each stage's rows to the slice in order, a lane a column, writes
//        the slice once, and hands the stage back on a second mbarrier;
//      - a run of at most 64 rows is a warp item (run, 128 columns): the
//        block's other warps (every warp of a block with no ring unit) sum
//        items in a fixed order, 16 rows' loads in flight a lane, the next
//        item's bounds loading beside this one's rows.
//      Rows that are not 16-byte aligned go by warp items of 32 columns
//      only, long runs too.
//
// What bounds it: the longest serial chain that bit-equality forbids
// splitting, a long run's adds (the root of the DeepWalk hs=1 tree takes
// 4,699 a column a step), after the grouping's three grid barriers; not
// bytes (28.5 MB at that step's tree scatter: 8.4 us at 3.35 TB/s). On an
// NVIDIA H100 (700 W; benchmarks/scatter_phases.py) that call takes about
// 36 us: 4 counting, 4 of prefixes, 6 placing, 20 summing, of which the
// root's slices take some 19 at about 7 cycles a row (shared-memory load
// and dependent add; the add's own latency would allow 4). Tried and
// dropped there: one `cp.async.bulk` a row (0.19 ms a call: about 2 us to
// issue a stage); the copies in a loop of branches, each behind its own
// shuffle and address conversion (0.6 us a stage whether one or four
// producer warps issued it, and with no copy issued at all: the chain of
// dependent instructions, not the memory, set it); 64-row stages (0.0457
// against 0.0384 ms at 256 rows: the consumer's overhead a stage); three
// blocks an SM (0.0497 against 0.0468 at one); and run starts by a
// decoupled look-back across the blocks of keys in place of each tile's
// scan (no faster).
// K4 is a small-V kernel: its caller takes it up to SMALL_V_ROWS rows
// (ops/rows.py::scatter_add_table), K2 above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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


// ---- the group plan --------------------------------------------------------

constexpr int kGItems = 4;                  // ids a thread counts a tile
constexpr int kGTile = kThreads * kGItems;  // ids a tile
constexpr int kMaxKeys = 16384 + 1;         // rows V, and the dropped key V
constexpr int kLong = 64;          // rows of a run that a ring unit sums
constexpr int kRingCols = 16;      // columns of a ring unit
constexpr int kRowParts = kRingCols / 4;       // 16-byte parts of a row
constexpr int kRowsACopy = 32 / kRowParts;     // rows a warp's copy covers
constexpr int kRingStages = 4;
constexpr int kRingRows = 256;     // gradient slices a stage
constexpr int kChunkStages = 2;    // stages whose positions load at once
constexpr int kStagePos = kRingRows / 32;     // positions a lane a stage
constexpr int kInFlight = 2;       // stages a producer lane has in flight
constexpr int kRingFloats = kRingStages * kRingRows * kRingCols;
constexpr int kBatch = 16;  // gradient rows whose loads a lane keeps in flight
constexpr int kTileBatch = 16;  // tiles' counts a lane loads at once
constexpr int kKeyBatch = 8;    // blocks of keys whose totals load at once
constexpr int kClasses = 32;       // run lengths by floor(log2(length))
constexpr int kFirstClass = 6;     // the class of a run of kLong + 1 rows
// dynamic shared memory: the counters and the key blocks' prefixes
// (grouping), then the ring and each stage's first values (sum)
constexpr int kGroupSmem =
    ((kRingFloats + kRingStages * kRingCols) > kMaxKeys + kMaxKeys / 32 + 1
         ? (kRingFloats + kRingStages * kRingCols)
         : kMaxKeys + kMaxKeys / 32 + 1) * 4;

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state) : "r"(smem_addr(bar)) : "memory");
}

// 16 bytes from device memory to the shared address dst, through L2 only;
// zeros where bytes is 0 (nothing is read)
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// an int from L2, issued where it is written: a load of positions ahead of
// their use is not moved down to the use
__device__ __forceinline__ int load_ahead(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// this thread's copies since the last commit become one group
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most n of this thread's groups of copies are in flight
template <int n>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// ints of the long runs' lists: class c (c >= kFirstClass) holds at most
// N >> c runs, those of at least 2^c rows
__host__ __device__ inline int64_t class_list_size(int N) {
  int64_t n = 0;
  for (int c = kFirstClass; c < kClasses; ++c) n += N >> c;
  return n;
}

__host__ __device__ inline int64_t class_offset(int c, int N) {
  int64_t n = 0;
  for (int k = kFirstClass; k < c; ++k) n += N >> k;
  return n;
}

// Where each of the group plan's arrays starts in its int32 scratch: the
// grouped positions [N], the tiles' counts [T][V + 1], the keys' prefixes
// in their blocks of 32 [V + 1], the blocks' totals, the long runs' class
// counts [kClasses] and the ring units handed out, the run starts
// [V + 1], the long runs' lists.
struct GroupScratch {
  int64_t spos, hist, key_pre, block_tot, cls_cnt, start, cls_list, size;
};

__host__ __device__ inline GroupScratch group_scratch(int N, int V) {
  const int64_t K = (int64_t)V + 1, T = (N + kGTile - 1) / kGTile;
  GroupScratch s;
  s.spos = 0;
  s.hist = N;
  s.key_pre = s.hist + T * K;
  s.block_tot = s.key_pre + K;
  s.cls_cnt = s.block_tot + (K + 31) / 32;
  s.start = s.cls_cnt + kClasses + 1;
  s.cls_list = s.start + K;
  s.size = s.cls_list + class_list_size(N);
  return s;
}

// Exclusive scan of x over the block (in thread order); *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int off = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    off += w < warp ? t : 0;
    sum += t;
  }
  __syncthreads();  // warp_tot may be written again
  *total = sum;
  return off + incl - x;
}

// 1-3: the positions of each row's ids in index order (spos), the run
// starts (start[k]: row k's first; start[V]: the kept ids) and the long
// runs by class. cnt: V + 1 counters in shared memory. Ends at a grid
// barrier.
__device__ void group_by_row(int* cnt, int* warp_tot, int (*part)[32],
                             cg::grid_group& grid,
                             const int* __restrict__ ids, int V, int N,
                             int* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = V + 1;
  const int T = (N + kGTile - 1) / kGTile;
  const GroupScratch L = group_scratch(N, V);
  int* spos = scratch + L.spos;
  int* hist = scratch + L.hist;
  int* key_pre = scratch + L.key_pre;
  int* block_tot = scratch + L.block_tot;
  const int KB = (K + 31) / 32;  // blocks of 32 keys
  int* block_pre = cnt + K;       // their prefixes, in shared memory
  int* cls_cnt = scratch + L.cls_cnt;
  int* start = scratch + L.start;
  int* cls_list = scratch + L.cls_list;
  const unsigned below_me = (1u << lane) - 1u;
  if (blockIdx.x == 0 && tid <= kClasses) cls_cnt[tid] = 0;  // and units
  // 1. each tile's count of each key, one atomic a key a warp
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    __syncthreads();  // the last tile's counts are written out
    for (int k = tid; k < K; k += kThreads) cnt[k] = 0;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kGItems; ++u) {
      const int i = tile * kGTile + u * kThreads + tid;
      int key = -1;
      if (i < N) {
        const int id = __ldg(ids + i);
        key = (id < 0 || id >= V) ? V : id;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key >= 0 && (peers & below_me) == 0)
        atomicAdd(&cnt[key], __popc(peers));
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads)
      hist[(int64_t)tile * K + k] = cnt[k];
  }
  grid.sync();
  // 2. per key, each tile's count becomes the count in the tiles before
  // it; blocks of 32 keys, a warp a range of tiles (its counts loaded
  // kTileBatch at once); per block, each key's total becomes the total of
  // the keys before it in the block, and the block's total is kept; a run
  // longer than kLong is listed in its length class
  {
    const int per = (T + kWarps - 1) / kWarps;  // tiles a warp
    const int t_begin = min(T, warp * per), t_end = min(T, t_begin + per);
    for (int kb = blockIdx.x; kb * 32 < K; kb += gridDim.x) {
      const int k = kb * 32 + lane;
      // the key's counts in this warp's first kTileBatch tiles stay in
      // registers; any further ones are loaded again below
      int c[kTileBatch], mine = 0;
#pragma unroll
      for (int j = 0; j < kTileBatch; ++j) {
        c[j] = k < K && t_begin + j < t_end
                   ? __ldcg(hist + (int64_t)(t_begin + j) * K + k) : 0;
        mine += c[j];
      }
      for (int t0 = t_begin + kTileBatch; k < K && t0 < t_end;
           t0 += kTileBatch) {
#pragma unroll
        for (int j = 0; j < kTileBatch; ++j)
          mine += t0 + j < t_end ? __ldcg(hist + (int64_t)(t0 + j) * K + k)
                                 : 0;
      }
      part[warp][lane] = mine;
      __syncthreads();
      int run = 0, all = 0;  // in the tiles before this warp's, in all
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int x = part[w][lane];
        run += w < warp ? x : 0;
        all += x;
      }
      __syncthreads();  // part may be written again
      for (int t0 = t_begin; k < K && t0 < t_end; t0 += kTileBatch) {
        if (t0 > t_begin) {
#pragma unroll
          for (int j = 0; j < kTileBatch; ++j)
            c[j] = t0 + j < t_end ? __ldcg(hist + (int64_t)(t0 + j) * K + k)
                                  : 0;
        }
#pragma unroll
        for (int j = 0; j < kTileBatch; ++j) {
          if (t0 + j < t_end) {
            hist[(int64_t)(t0 + j) * K + k] = run;
            run += c[j];
          }
        }
      }
      if (warp == 0) {  // the keys' prefixes in the block, its total
        int incl = all;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        if (k < K) key_pre[k] = incl - all;
        if (lane == 31) block_tot[kb] = incl;
        if (k < V && all > kLong) {
          const int c = 31 - __clz(all);
          cls_list[class_offset(c, N) + atomicAdd(&cls_cnt[c], 1)] = k;
        }
      }
    }
  }
  grid.sync();
  // 3. the tile's positions to their places: key k's next place starts at
  // the count of smaller keys in all tiles (the prefix of k's block of 32
  // keys, from a scan of the blocks' totals, plus k's prefix in its block)
  // plus that of k in earlier tiles
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int base = tile * kGTile + warp * 32 * kGItems;
    int key[kGItems];
    unsigned peers[kGItems];  // the lanes of the warp with the same key
#pragma unroll
    for (int u = 0; u < kGItems; ++u) {
      const int i = base + u * 32 + lane;
      const int id = i < N ? __ldg(ids + i) : 0;
      key[u] = i >= N ? -1 : (id < 0 || id >= V) ? V : id;
      peers[u] = __match_any_sync(0xffffffffu, key[u]);
    }
    int before = 0;  // the key blocks' totals become prefixes
    for (int b0 = 0; b0 < KB; b0 += kThreads) {
      const int b = b0 + tid;
      int sum;
      const int e = block_exclusive_scan(
          b < KB ? __ldcg(block_tot + b) : 0, warp_tot, &sum);
      if (b < KB) block_pre[b] = before + e;
      before += sum;
    }
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += kKeyBatch * kThreads) {
      int kp[kKeyBatch], pre[kKeyBatch];
#pragma unroll
      for (int e = 0; e < kKeyBatch; ++e) {
        const int k = k0 + e * kThreads + tid;
        kp[e] = k < K ? __ldcg(key_pre + k) : 0;
        pre[e] = k < K ? __ldcg(hist + (int64_t)tile * K + k) : 0;
      }
#pragma unroll
      for (int e = 0; e < kKeyBatch; ++e) {
        const int k = k0 + e * kThreads + tid;
        if (k < K) {
          const int s = block_pre[k >> 5] + kp[e];
          cnt[k] = s + pre[e];
          if (tile == 0) start[k] = s;
        }
      }
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int u = 0; u < kGItems; ++u) {
          const int k = key[u];
          const int below = __popc(peers[u] & below_me);
          const int first = k >= 0 ? cnt[k] : 0;
          __syncwarp();
          if (k >= 0 && below == 0) cnt[k] = first + __popc(peers[u]);
          __syncwarp();
          if (k >= 0 && k < V) spos[first + below] = base + u * 32 + lane;
        }
      }
      __syncthreads();
    }
  }
  grid.sync();
}

// Columns a warp item sums: one a lane, four with 16-byte loads
template <bool kVec>
__host__ __device__ constexpr int item_cols() {
  return kVec ? 128 : 32;
}

// table[id, slice] += grads[spos[q], slice] for q = q_begin .. q_end - 1,
// in that order, from the table's value: lane l owns kVW adjacent columns
// of the warp's slice. Gradient rows' loads go kB at a time, and each
// batch's positions load beside the batch before's rows.
template <bool kVec>
__device__ __forceinline__ void sum_item(float* __restrict__ table,
                                         int64_t ld,
                                         const float* __restrict__ grads,
                                         int C, const int* spos, int q_begin,
                                         int q_end, int id, int slice) {
  constexpr int kVW = kVec ? 4 : 1;
  constexpr int kB = kBatch;
  const int lane = threadIdx.x & 31;
  const int c = slice * item_cols<kVec>() + lane * kVW;
  const bool mine = c < C;
  float* dst = table + (int64_t)id * ld + c;
  float acc[kVW];
  if constexpr (kVec) {
    const float4 t4 = mine ? *reinterpret_cast<const float4*>(dst)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[0] = t4.x, acc[1] = t4.y, acc[2] = t4.z, acc[3] = t4.w;
  } else {
    acc[0] = mine ? *dst : 0.f;
  }
  int pos = lane < q_end - q_begin && lane < kB ? __ldcg(spos + q_begin + lane)
                                                : 0;
  for (int q0 = q_begin; q0 < q_end; q0 += kB) {
    const int n = min(kB, q_end - q0);
    float v[kB][kVW];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int64_t row = __shfl_sync(0xffffffffu, pos, u);
      const float* src = grads + row * C + c;
      const bool load = u < n && mine;
      if constexpr (kVec) {
        const float4 g4 = load ? __ldg(reinterpret_cast<const float4*>(src))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u][0] = g4.x, v[u][1] = g4.y, v[u][2] = g4.z, v[u][3] = g4.w;
      } else {
        v[u][0] = load ? __ldg(src) : 0.f;
      }
    }
    const int q1 = q0 + kB;
    pos = lane < q_end - q1 && lane < kB ? load_ahead(spos + q1 + lane) : 0;
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      if (u < n) {
#pragma unroll
        for (int e = 0; e < kVW; ++e) acc[e] += v[u][e];
      }
    }
  }
  if (mine) {
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      *dst = acc[0];
    }
  }
}

// The row of the r-th long run: classes from the longest down
__device__ __forceinline__ int long_run_row(const int* cls_n,
                                            const int* cls_list, int N,
                                            int r) {
  int64_t off = class_list_size(N);
  for (int c = kClasses - 1; c >= kFirstClass; --c) {
    off -= N >> c;
    if (r < cls_n[c]) return __ldcg(cls_list + off + r);
    r -= cls_n[c];
  }
  return 0;  // not reached: r < the long runs
}

// A stage's record: the row, the first column, the rows it holds and its
// flags (a unit's first stage, its last, the ring's end)
constexpr int kFirst = 1, kLast = 2, kEnd = 4;

struct Ring {
  float* rows;    // [kRingStages][kRingRows][kRingCols]
  float* first;   // [kRingStages][kRingCols]: the slice's table values
  int4* meta;     // [kRingStages]
  uint64_t* full;   // a stage landed: each producer lane's arrival once
                    // its copies of the stage have
  uint64_t* empty;  // a stage added: one arrival
};

// Warp 0 of a ring block: long units into the ring, the block's first
// unit u = blockIdx.x, each later one the next from a counter (so units
// go out longest first to the blocks that are free), then a stage that
// marks the end.
__device__ void ring_produce(const Ring& ring, const float* table,
                             int64_t ld, const float* __restrict__ grads,
                             int C, const int* spos, const int* start,
                             const int* cls_n, const int* cls_list, int N,
                             int units, int slices, int* next_unit) {
  const int lane = threadIdx.x & 31;
  const int sub = lane / kRowParts, part = lane % kRowParts;
  const uint32_t rows_s = smem_addr(ring.rows);
  uint32_t g = 0;  // stages filled
  int u = blockIdx.x;
  while (u < units) {
    const int row = long_run_row(cls_n, cls_list, N, (int)(u / slices));
    const int c0 = (int)(u % slices) * kRingCols;
    const int cw = min(kRingCols, C - c0);
    const int q_begin = __ldcg(start + row), q_end = __ldcg(start + row + 1);
    const float t0 = lane < cw ? table[(int64_t)row * ld + c0 + lane] : 0.f;
    // the positions of a chunk of kChunkStages stages, rows lane + 32 * m
    // of the chunk in cur[m]; the next chunk's load while this one's
    // copies are issued
    int cur[kStagePos * kChunkStages], nxt[kStagePos * kChunkStages];
#pragma unroll
    for (int m = 0; m < kStagePos * kChunkStages; ++m) {
      const int q = q_begin + m * 32 + lane;
      cur[m] = q < q_end ? load_ahead(spos + q) : 0;
    }
    for (int q0 = q_begin; q0 < q_end; q0 += kChunkStages * kRingRows) {
#pragma unroll
      for (int m = 0; m < kStagePos * kChunkStages; ++m) {
        const int q = q0 + kChunkStages * kRingRows + m * 32 + lane;
        nxt[m] = q < q_end ? load_ahead(spos + q) : 0;
      }
#pragma unroll
      for (int s = 0; s < kChunkStages; ++s) {
        const int qs = q0 + s * kRingRows;
        if (qs < q_end) {
          const int n = min(kRingRows, q_end - qs);
          const int j = g % kRingStages;
          if (g >= kRingStages)
            mbar_wait(&ring.empty[j], (g / kRingStages - 1) & 1u);
          if (qs == q_begin && lane < kRingCols)
            ring.first[j * kRingCols + lane] = t0;
          if (lane == 0)
            ring.meta[j] = make_int4(
                row, c0, n, (qs == q_begin ? kFirst : 0) |
                                (qs + n == q_end ? kLast : 0));
          // lane (sub, part) copies bytes 16 * part of rows sub +
          // kRowsACopy * i; row r's position is in lane r % 32, in
          // cur[kStagePos * s + r / 32]. Straight-line code: the positions
          // first, then the copies (a row past the stage's or a column
          // past the slice's is zeros)
          constexpr int kCopies = kRingRows / kRowsACopy;
          constexpr int kCopiesA32 = 32 / kRowsACopy;  // copies for 32 rows
          int p[kCopies];
#pragma unroll
          for (int i = 0; i < kCopies; ++i)
            p[i] = __shfl_sync(0xffffffffu,
                               cur[kStagePos * s + i / kCopiesA32],
                               sub + kRowsACopy * (i % kCopiesA32));
          const uint32_t dst =
              rows_s +
              (uint32_t)((j * kRingRows + sub) * kRingCols + part * 4) * 4u;
#pragma unroll
          for (int i = 0; i < kCopies; ++i) {
            const bool ok = sub + kRowsACopy * i < n && part * 4 < cw;
            copy16(dst + (uint32_t)(i * kRowsACopy * kRingCols * 4),
                   grads + (ok ? (int64_t)p[i] * C + c0 + part * 4 : 0),
                   ok ? 16u : 0u);
          }
          // the stage kInFlight before this one has landed: hand it over
          commit_copies();
          if (g >= kInFlight) {
            wait_copies<kInFlight>();
            mbar_arrive(&ring.full[(g - kInFlight) % kRingStages]);
          }
          ++g;
        }
      }
#pragma unroll
      for (int m = 0; m < kStagePos * kChunkStages; ++m) cur[m] = nxt[m];
    }
    int next = 0;
    if (lane == 0) next = atomicAdd(next_unit, 1);
    u = (int)gridDim.x + __shfl_sync(0xffffffffu, next, 0);
  }
  wait_copies<0>();  // the last stages, then a stage that marks the end
  for (uint32_t h = g > kInFlight ? g - kInFlight : 0; h < g; ++h)
    mbar_arrive(&ring.full[h % kRingStages]);
  const int j = g % kRingStages;
  if (g >= kRingStages) mbar_wait(&ring.empty[j], (g / kRingStages - 1) & 1u);
  if (lane == 0) ring.meta[j] = make_int4(0, 0, 0, kEnd);
  mbar_arrive(&ring.full[j]);
}

// Warp 1 of a ring block: adds each stage's rows in order to the unit's
// slice, a lane a column, until the end; writes each slice once.
__device__ void ring_consume(const Ring& ring, float* table, int64_t ld,
                             int C) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (uint32_t g = 0;; ++g) {
    const int j = g % kRingStages;
    mbar_wait(&ring.full[j], (g / kRingStages) & 1u);
    const int4 m = ring.meta[j];  // row, first column, rows, flags
    if (m.w & kEnd) break;
    if (m.w & kFirst) acc = ring.first[j * kRingCols + lane % kRingCols];
    const float* st = ring.rows + j * kRingRows * kRingCols + lane;
    if (m.z == kRingRows) {  // a whole stage: 64 loads ahead of their adds
#pragma unroll
      for (int r0 = 0; r0 < kRingRows; r0 += 64) {
        float v[64];
#pragma unroll
        for (int r = 0; r < 64; ++r) v[r] = st[(r0 + r) * kRingCols];
#pragma unroll
        for (int r = 0; r < 64; ++r) acc += v[r];
      }
    } else {
      for (int r = 0; r < m.z; ++r) acc += st[r * kRingCols];
    }
    if ((m.w & kLast) && lane < kRingCols && lane < C - m.y)
      table[(int64_t)m.x * ld + m.y + lane] = acc;
    __syncwarp();  // the stage is read
    if (lane == 0) mbar_arrive(&ring.empty[j]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
scatter_add_grouped_kernel(float* __restrict__ table, int64_t ld, int V,
                           const int* __restrict__ ids,
                           const float* __restrict__ grads, int N, int C,
                           int* __restrict__ scratch) {
  extern __shared__ __align__(128) int4 gsmem4[];
  __shared__ int warp_tot[kWarps];
  __shared__ int part[kWarps][32];
  __shared__ int cls_n[kClasses];
  __shared__ int4 meta[kRingStages];
  __shared__ __align__(8) uint64_t full[kRingStages], empty[kRingStages];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5;
  if (kVec && tid == 0) {
    for (int j = 0; j < kRingStages; ++j) {
      mbar_init_count(&full[j], 32);
      mbar_init_count(&empty[j], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // 1-3. the counters in the dynamic shared memory the ring takes later
  group_by_row(reinterpret_cast<int*>(gsmem4), warp_tot, part, grid, ids, V,
               N, scratch);

  // 4. sum: ring units of the long runs (16-byte rows only), warp items of
  // the other runs (of every run without the ring)
  const GroupScratch L = group_scratch(N, V);
  const int* spos = scratch + L.spos;
  const int* start = scratch + L.start;
  const int slices = (C + kRingCols - 1) / kRingCols;
  int units = 0;
  if (kVec) {
    if (tid < kClasses) cls_n[tid] = __ldcg(scratch + L.cls_cnt + tid);
    __syncthreads();
    int runs = 0;
    for (int c = kFirstClass; c < kClasses; ++c) runs += cls_n[c];
    units = runs * slices;
  }
  const int ring_blocks = min(units, (int)gridDim.x);
  const bool ring_block = (int)blockIdx.x < ring_blocks;
  float* rows = reinterpret_cast<float*>(gsmem4);
  const Ring ring{rows, rows + kRingFloats, meta, full, empty};
  constexpr int kRingWarps = 2;
  if (ring_block && warp == 0) {
    ring_produce(ring, table, ld, grads, C, spos, start, cls_n,
                 scratch + L.cls_list, N, units, slices,
                 scratch + L.cls_cnt + kClasses);
  } else if (ring_block && warp == 1) {
    ring_consume(ring, table, ld, C);
  } else {
    constexpr int S_cols = item_cols<kVec>();
    const int S = (C + S_cols - 1) / S_cols;
    // item warps: the others of a ring block, all of any other block
    const int64_t nw = (int64_t)ring_blocks * (kWarps - kRingWarps) +
                       (int64_t)(gridDim.x - ring_blocks) * kWarps;
    int64_t it = ring_block
                     ? (int64_t)blockIdx.x * (kWarps - kRingWarps) + warp -
                           kRingWarps
                     : (int64_t)ring_blocks * (kWarps - kRingWarps) +
                           (int64_t)(blockIdx.x - ring_blocks) * kWarps + warp;
    const int64_t items = (int64_t)V * S;
    int q0 = 0, q1 = 0;
    if (it < items) {
      q0 = __ldcg(start + it / S);
      q1 = __ldcg(start + it / S + 1);
    }
    while (it < items) {
      const int64_t next = it + nw;
      int n0 = 0, n1 = 0;
      if (next < items) {
        n0 = __ldcg(start + next / S);
        n1 = __ldcg(start + next / S + 1);
      }
      if (q1 > q0 && (!kVec || q1 - q0 <= kLong))  // longer: a ring unit
        sum_item<kVec>(table, ld, grads, C, spos, q0, q1, (int)(it / S),
                       (int)(it % S));
      it = next, q0 = n0, q1 = n1;
    }
  }
  __syncthreads();  // the block's sums are written
}

// Blocks of the group plan's grid: all that can be resident (a
// cooperative launch needs all), one an SM.
template <bool kVec>
cudaError_t launch_grouped(int device, float* table, int64_t ld, int V,
                           const int* ids, const float* grads, int N, int C,
                           int* scratch, cudaStream_t stream) {
  static int cached[2][64] = {};  // blocks an SM, by device
  int& per_sm = cached[kVec][device & 63];
  if (per_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_add_grouped_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kGroupSmem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_add_grouped_kernel<kVec>, kThreads, kGroupSmem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
  }
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  void* args[] = {&table, &ld, &V, &ids, &grads, &N, &C, &scratch};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(scatter_add_grouped_kernel<kVec>),
      dim3(per_sm * sms), dim3(kThreads), args, kGroupSmem, stream);
}

}  // namespace

extern "C" {

// int32 elements of the group plan's scratch for N ids into V rows
int64_t ge_scatter_add_small_scratch(int N, int V) {
  return group_scratch(N, V).size;
}

// group != 0: the group plan (V + 1 <= 16,385, scratch of
// ge_scatter_add_small_scratch ints); else the scan plan (any V, no
// scratch)
int ge_scatter_add_small(int device, void* table, int64_t ld, int V,
                         const void* ids, const void* grads, int N, int C,
                         void* scratch, int group, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || V == 0 || C == 0) return 0;
  if (group) {
    if (V + 1 > kMaxKeys || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    const bool vec = (uintptr_t)table % 16 == 0 &&
                     (uintptr_t)grads % 16 == 0 && ld % 4 == 0 && C % 4 == 0;
    float* t = (float*)table;
    const int* i = (const int*)ids;
    const float* g = (const float*)grads;
    const cudaStream_t s = (cudaStream_t)stream;
    e = vec ? launch_grouped<true>(device, t, ld, V, i, g, N, C,
                                   (int*)scratch, s)
            : launch_grouped<false>(device, t, ld, V, i, g, N, C,
                                    (int*)scratch, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
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
