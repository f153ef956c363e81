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
// dropped. Each element is summed in index order starting from its table
// value, the order of the plain version's sequential loop on the CPU, so
// the two agree bit for bit and the result is the same from run to run (no
// atomics on the table). It is one cooperative launch of a persistent
// grid, in grid-wide phases; each id outside [0, V) becomes the key V, a
// bucket after every row that is dropped:
//
//   1-2. group the ids, with int32 positions and no library sort:
//      - where V + 1 <= 4096 (Wiki's 2,405 rows), one stable counting
//        pass: each tile of 1,024 ids counts its keys, the tiles' counts
//        become prefixes per key, and each tile places its keys warp after
//        warp (`match` ranks equal keys within a warp), so equal ids keep
//        index order. The runs of equal ids are then the rows themselves;
//      - else a stable LSD radix sort over only bit_length(V) bits (20 at
//        V = 1M: three passes of 7). A pass counts each tile's digits (a
//        block ranks its tile in index order with warp `match` and
//        per-warp counters), every block scans the tiles' counts for its
//        offsets and places its tile; an ordered compaction then lists the
//        runs;
//   3. sum, long runs first: a block takes each run longer than 64 rows,
//      one column slice at a time, loading up to 256 of its rows into
//      shared memory at once and adding them in order in one warp; then
//      warps take items (run, 32-column slice, 128 with 16-byte loads) in a
//      fixed order, each adding its run's rows in index order with 16
//      rows' loads in flight, and writing the slice once.
//
// What bounds it: not bytes (46 MB at the DeepWalk step's token call, 14
// us at 3.35 TB/s) but latency: the grouping is three grid barriers, each
// behind a round trip to L2 and, in phase 1-2's last step, a placement
// that goes warp after warp; the sum is chains of dependent loads (a run's
// bounds, its positions, its rows), and a run's sum is a serial chain that
// bit-equality forbids splitting. Registers decide how many chains are in
// flight: the kernel is kept at 64 registers a thread, four blocks an SM.
//
// Both take a table row stride `ld` (elements), so a column slice of a
// wider table (the upper half of the fused [V, 2D] table) needs no copy.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// ---- K2 ------------------------------------------------------------------

constexpr int kThreads = 256;  // K2's block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                   // keys a thread ranks a tile
constexpr int kTile = kThreads * kItems;    // keys a tile
constexpr int kMaxDigitBits = 8;
constexpr int kMaxDigits = 1 << kMaxDigitBits;
constexpr int kBatch = 16;  // gradient rows whose loads a lane keeps in flight
constexpr int kLong = 64;   // rows of a run that a whole block sums
constexpr int kStageFloats = 8192;  // a block's staged gradient slices
constexpr int kHistCap = 4096;  // tiles' digit counts a block stages at once

struct SortShared {
  int warp_cnt[kWarps][kMaxDigits];  // a warp's count of each digit
  int total[kMaxDigits];             // the tile's count of each digit
  int base[kMaxDigits];              // where the tile's digits go
  int warp_tot[kWarps];
  int hist[kHistCap];                // tiles' digit counts, staged
};

constexpr int kSmallKeys = 4096;     // keys (V + 1) of the one-pass grouping

struct SmallShared {                 // the one-pass grouping's counters
  int cnt[kSmallKeys];
  int warp_tot[kWarps];
};

struct SumShared {                   // the long runs' sums
  float stage[kStageFloats];         // [rows][slice columns]
  int pos[kThreads];                 // the staged rows' positions
  int2 run[32];                      // a group's long runs: first, row
  int end[32];
  unsigned found;
};

__device__ __forceinline__ int tiles_of(int N) {
  return (N + kTile - 1) / kTile;
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

// Loads one tile's keys and values and ranks each key among the tile's keys
// of the same digit, in index order. Warp w holds keys w * 32 * kItems +
// u * 32 + lane (u = 0 .. kItems - 1), so (warp, item, lane) is index order.
// On return sh.total holds the tile's count of each digit; dig is -1 past N.
__device__ void rank_tile(SortShared& sh, const int* ids, const int* keys,
                          const int* vals, bool first, int V, int N,
                          int tile, int shift, int R, int (&key)[kItems],
                          int (&val)[kItems], int (&dig)[kItems],
                          int (&rank)[kItems]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the counters' last readers are done
  for (int e = tid; e < kWarps * kMaxDigits; e += kThreads)
    (&sh.warp_cnt[0][0])[e] = 0;
  __syncthreads();
  const unsigned below_me = (1u << lane) - 1u;
  const int base = tile * kTile + warp * 32 * kItems;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = base + u * 32 + lane;
    const bool ok = i < N;
    int k = V, v = 0;
    if (ok && first) {
      const int id = __ldg(ids + i);
      k = (id < 0 || id >= V) ? V : id;
      v = i;
    } else if (ok) {
      k = __ldcg(keys + i);  // written by this launch: not through L1
      v = __ldcg(vals + i);
    }
    key[u] = k;
    val[u] = v;
    const int d = ok ? (k >> shift) & (R - 1) : -1;
    dig[u] = d;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int below = __popc(peers & below_me);
    const int before = ok ? sh.warp_cnt[warp][d] : 0;
    rank[u] = before + below;
    __syncwarp();
    if (ok && below == 0) sh.warp_cnt[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (tid < R) {  // the warps' counts become offsets; their sum the tile's
    int s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = sh.warp_cnt[w][tid];
      sh.warp_cnt[w][tid] = s;
      s += c;
    }
    sh.total[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kItems; ++u)
    if (dig[u] >= 0) rank[u] += sh.warp_cnt[warp][dig[u]];
}

// Digit tid's count over all T tiles (*all) and over the tiles before
// `tile` (*before), for tid < R; the counts come into shared memory
// together, kHistCap at a time.
__device__ void digit_counts(SortShared& sh, const int* hist, int T, int R,
                             int tile, int* all, int* before) {
  const int tid = threadIdx.x;
  const int per = kHistCap / R;  // tiles staged at once
  *all = 0;
  *before = 0;
  for (int t0 = 0; t0 < T; t0 += per) {
    const int n = min(per, T - t0) * R;
    __syncthreads();  // the last stage's readers are done
#pragma unroll 4
    for (int e = tid; e < n; e += kThreads)
      sh.hist[e] = __ldcg(hist + (int64_t)t0 * R + e);
    __syncthreads();
    if (tid < R) {
      for (int e = tid, t = t0; e < n; e += R, ++t) {
        const int c = sh.hist[e];
        *all += c;
        *before += t < tile ? c : 0;
      }
    }
  }
}

// Run starts of a tile of sorted keys: bit u of starts[u] (lane) marks
// position tile * kTile + warp * 32 * kItems + u * 32 + lane, whose key is
// key[u]; returns the warp's count of starts and adds its count of kept
// keys to *kept.
__device__ __forceinline__ int tile_run_starts(const int* skeys, int V,
                                               int N, int tile,
                                               unsigned (&starts)[kItems],
                                               int (&key)[kItems],
                                               int* kept) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = tile * kTile + warp * 32 * kItems;
  int n = 0;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int p = base + u * 32 + lane;
    const int k = p < N ? __ldcg(skeys + p) : V;
    key[u] = k;
    const bool keep = k < V;
    const bool start = keep && (p == 0 || __ldcg(skeys + p - 1) != k);
    starts[u] = __ballot_sync(0xffffffffu, start);
    n += __popc(starts[u]);
    *kept += __popc(__ballot_sync(0xffffffffu, keep));
  }
  return n;
}

// Columns a warp sums: one a lane, four with 16-byte loads
template <bool kVec>
__host__ __device__ constexpr int slice_cols() {
  return kVec ? 128 : 32;
}

// table[id, slice] += grads[spos[q], slice] for q = q_begin .. q_end - 1,
// in that order, from the table's value: lane l owns kVW adjacent columns
// of the warp's slice. Gradient rows' loads go kB at a time, and each
// batch's positions load beside the batch before's rows.
template <bool kVec>
__device__ __forceinline__ void sum_slice(float* __restrict__ table,
                                          int64_t ld,
                                          const float* __restrict__ grads,
                                          int C, const int* spos,
                                          int q_begin, int q_end, int id,
                                          int slice) {
  constexpr int kVW = kVec ? 4 : 1;
  constexpr int kB = kBatch;
  const int lane = threadIdx.x & 31;
  const int c = slice * slice_cols<kVec>() + lane * kVW;
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
    pos = lane < q_end - q1 && lane < kB ? __ldcg(spos + q1 + lane) : 0;
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

// sum_slice for a run longer than kLong, by the whole block: each chunk's
// positions come in together, then the eight warps load a slice of up to
// kStageFloats / 32 kVW rows into shared memory (all in flight at once)
// and warp 0 adds them in order. The block's threads all call it.
template <bool kVec>
__device__ void block_sum_slice(SumShared& ss, float* __restrict__ table,
                                int64_t ld, const float* __restrict__ grads,
                                int C, const int* spos, int q_begin,
                                int q_end, int id, int slice) {
  constexpr int kVW = kVec ? 4 : 1;
  constexpr int kCols = slice_cols<kVec>();
  constexpr int kRows = kStageFloats / kCols;  // a chunk
  constexpr int kPerWarp = kRows / kWarps;
  static_assert(kRows <= kThreads, "a chunk's positions, one a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = slice * kCols + lane * kVW;
  const bool mine = c < C;
  float* dst = table + (int64_t)id * ld + c;
  float acc[kVW] = {};
  if (warp == 0 && mine) {
#pragma unroll
    for (int e = 0; e < kVW; ++e) acc[e] = dst[e];
  }
  for (int q0 = q_begin; q0 < q_end; q0 += kRows) {
    const int n = min(kRows, q_end - q0);
    __syncthreads();  // the last chunk's readers are done
    if (tid < n) ss.pos[tid] = __ldcg(spos + q0 + tid);
    __syncthreads();
    float v[kPerWarp][kVW];
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int r = warp * kPerWarp + u;
      const bool load = r < n && mine;
      const float* src = grads + (int64_t)ss.pos[load ? r : 0] * C + c;
      if constexpr (kVec) {
        const float4 g4 = load ? __ldg(reinterpret_cast<const float4*>(src))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u][0] = g4.x, v[u][1] = g4.y, v[u][2] = g4.z, v[u][3] = g4.w;
      } else {
        v[u][0] = load ? __ldg(src) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u)
#pragma unroll
      for (int e = 0; e < kVW; ++e)
        ss.stage[(warp * kPerWarp + u) * kCols + lane * kVW + e] = v[u][e];
    __syncthreads();
    if (warp == 0) {
#pragma unroll 8
      for (int r = 0; r < n; ++r)
#pragma unroll
        for (int e = 0; e < kVW; ++e)
          acc[e] += ss.stage[r * kCols + lane * kVW + e];
    }
  }
  if (warp == 0 && mine) {
#pragma unroll
    for (int e = 0; e < kVW; ++e) dst[e] = acc[e];
  }
}

// 1-2 for any V: LSD radix passes of digit_bits over the keys (ids, an id
// outside [0, V) as V), then the runs by an ordered compaction. scratch:
// keys and positions twice (ping-pong), the tiles' digit counts, the
// tiles' run and kept counts, then the runs (U + 1).
__device__ void group_radix(SortShared& sh, cg::grid_group& grid,
                            const int* __restrict__ ids, int V, int N, int T,
                            int* scratch, int passes, int digit_bits,
                            int* U_out, int2** runs_out,
                            const int** spos_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = 1 << digit_bits;
  int* keys[2] = {scratch, scratch + N};
  int* vals[2] = {scratch + 2 * (int64_t)N, scratch + 3 * (int64_t)N};
  int* hist = scratch + 4 * (int64_t)N;
  int* tile_cnt = hist + (int64_t)T * kMaxDigits;
  int2* runs = reinterpret_cast<int2*>(tile_cnt + 2 * T);
  // with a tile a block at most, a pass's ranks stay in registers across
  // its grid barrier; otherwise the second phase ranks its tiles again
  const bool carry = (int)gridDim.x >= T;

  int key[kItems], val[kItems], dig[kItems], rank[kItems];
  int sum;
  // 1. group: LSD radix passes
  for (int pass = 0; pass < passes; ++pass) {
    const bool first = pass == 0;
    const int* kin = keys[(pass + 1) & 1];
    const int* vin = vals[(pass + 1) & 1];
    int* kout = keys[pass & 1];
    int* vout = vals[pass & 1];
    const int shift = pass * digit_bits;
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
      rank_tile(sh, ids, kin, vin, first, V, N, tile, shift, R, key, val,
                dig, rank);
      if (tid < R) hist[(int64_t)tile * R + tid] = sh.total[tid];
    }
    grid.sync();
    for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
      // offset of (digit d, this tile): all smaller digits, then digit d
      // in the tiles before this one
      int all, before;
      digit_counts(sh, hist, T, R, tile, &all, &before);
      const int off = block_exclusive_scan(all, sh.warp_tot, &sum);
      if (tid < R) sh.base[tid] = off + before;
      if (carry) {
        __syncthreads();
      } else {
        rank_tile(sh, ids, kin, vin, first, V, N, tile, shift, R, key, val,
                  dig, rank);  // its barriers publish sh.base
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        if (dig[u] < 0) continue;
        const int p = sh.base[dig[u]] + rank[u];
        kout[p] = key[u];
        vout[p] = val[u];
      }
    }
    grid.sync();
  }
  const int* skeys = keys[(passes + 1) & 1];
  const int* spos = vals[(passes + 1) & 1];

  // 2. runs: count each tile's run starts and kept keys, then place them
  unsigned starts[kItems];
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    int kept = 0;
    const int n = tile_run_starts(skeys, V, N, tile, starts, key, &kept);
    int runs_in_tile, kept_all;
    block_exclusive_scan(lane == 0 ? n : 0, sh.warp_tot, &runs_in_tile);
    block_exclusive_scan(lane == 0 ? kept : 0, sh.warp_tot, &kept_all);
    if (tid == 0) {
      tile_cnt[2 * tile] = runs_in_tile;
      tile_cnt[2 * tile + 1] = kept_all;
    }
  }
  grid.sync();
  int U = 0, kept_total = 0;  // runs, kept keys
  {
    int r = 0, k = 0;
    for (int t = tid; t < T; t += kThreads) {
      r += __ldcg(tile_cnt + 2 * t);
      k += __ldcg(tile_cnt + 2 * t + 1);
    }
    block_exclusive_scan(r, sh.warp_tot, &U);
    block_exclusive_scan(k, sh.warp_tot, &kept_total);
  }
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    int r = 0;
    for (int t = tid; t < tile; t += kThreads) r += __ldcg(tile_cnt + 2 * t);
    int before;
    block_exclusive_scan(r, sh.warp_tot, &before);
    int kept = 0;
    const int n = tile_run_starts(skeys, V, N, tile, starts, key, &kept);
    int dummy;
    int off = before +
              block_exclusive_scan(lane == 0 ? n : 0, sh.warp_tot, &dummy);
    off = __shfl_sync(0xffffffffu, off, 0);
    const int base = tile * kTile + warp * 32 * kItems;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int p = base + u * 32 + lane;
      // runs before this position: this run's index if it starts here
      const int k = off + __popc(starts[u] & ((1u << lane) - 1u));
      if (starts[u] >> lane & 1u) runs[k] = make_int2(p, key[u]);
      off += __popc(starts[u]);
    }
  }
  if (blockIdx.x == 0 && tid == 0) runs[U] = make_int2(kept_total, V);
  grid.sync();

  *U_out = U;
  *runs_out = runs;
  *spos_out = spos;
}

// Where the one-pass grouping's runs start in its scratch (int2-aligned)
__host__ __device__ inline int64_t small_runs_offset(int64_t N, int64_t T,
                                                     int64_t K) {
  return (N + (T + 1) * K + kSmallKeys / kThreads + 1) & ~(int64_t)1;
}

// 1-2 when every key fits a block's counters (V + 1 <= kSmallKeys): one
// counting pass over whole ids. Each tile counts its keys; per key, the
// tiles' counts become prefixes over the tiles, and per block of kThreads
// keys the keys' totals become prefixes over the keys; each tile then
// places its keys, warp after warp, so that equal keys keep index order.
// The runs are the rows themselves: runs[k] = {first position of id k, k},
// empty where id k is absent, and runs[V] = {kept keys, V}. scratch: the
// positions [N], the tiles' counts [T][V + 1], the keys' prefixes
// [V + 1], the key blocks' sums, the runs.
__device__ void group_small(SmallShared& sm, cg::grid_group& grid,
                            const int* __restrict__ ids, int V, int N, int T,
                            int* scratch, int2** runs_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = V + 1;
  int* spos = scratch;
  int* hist = scratch + N;
  int* total = hist + (int64_t)T * K;
  int* block_sum = total + K;
  int2* runs = reinterpret_cast<int2*>(scratch + small_runs_offset(N, T, K));
  *runs_out = runs;
  // A. each tile's count of each key
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    __syncthreads();  // the last tile's counts are written out
    for (int k = tid; k < K; k += kThreads) sm.cnt[k] = 0;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = tile * kTile + u * kThreads + tid;
      if (i < N) {
        const int id = __ldg(ids + i);
        atomicAdd(&sm.cnt[(id < 0 || id >= V) ? V : id], 1);
      }
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads)
      hist[(int64_t)tile * K + k] = sm.cnt[k];
  }
  grid.sync();
  // B. per key, each tile's count becomes the count in the tiles before
  // it; per block of keys, each key's total the total of the keys before
  for (int kb = blockIdx.x; kb * kThreads < K; kb += gridDim.x) {
    const int k = kb * kThreads + tid;
    int run = 0;
    for (int t0 = 0; k < K && t0 < T; t0 += 8) {
      int c[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        c[j] = t0 + j < T ? __ldcg(hist + (int64_t)(t0 + j) * K + k) : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (t0 + j < T) {
          hist[(int64_t)(t0 + j) * K + k] = run;
          run += c[j];
        }
      }
    }
    int sum;
    const int before = block_exclusive_scan(run, sm.warp_tot, &sum);
    if (k < K) total[k] = before;
    if (tid == 0) block_sum[kb] = sum;
  }
  grid.sync();
  // C. the tile's keys to their places: key k's next place starts at the
  // count of smaller keys in all tiles plus that of k in earlier tiles
  const unsigned below_me = (1u << lane) - 1u;
  for (int tile = blockIdx.x; tile < T; tile += gridDim.x) {
    const int base = tile * kTile + warp * 32 * kItems;
    int key[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = base + u * 32 + lane;
      const int id = i < N ? __ldg(ids + i) : 0;
      key[u] = i >= N ? -1 : (id < 0 || id >= V) ? V : id;
    }
    int blocks_before = 0;  // the totals of the key blocks before k's
#pragma unroll 4
    for (int kb = 0; kb * kThreads < K; ++kb) {
      const int k = kb * kThreads + tid;
      if (k < K) {
        const int start = blocks_before + __ldcg(total + k);
        sm.cnt[k] = start + __ldcg(hist + (int64_t)tile * K + k);
        if (tile == 0) runs[k] = make_int2(start, k);
      }
      blocks_before += __ldcg(block_sum + kb);
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const int k = key[u];
          const unsigned peers = __match_any_sync(0xffffffffu, k);
          const int below = __popc(peers & below_me);
          const int first = k >= 0 ? sm.cnt[k] : 0;
          __syncwarp();
          if (k >= 0 && below == 0) sm.cnt[k] = first + __popc(peers);
          __syncwarp();
          if (k >= 0 && k < V) spos[first + below] = base + u * 32 + lane;
        }
      }
      __syncthreads();
    }
  }
  grid.sync();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(float* __restrict__ table, int64_t ld, int V,
                        const int* __restrict__ ids,
                        const float* __restrict__ grads, int N, int C,
                        int* scratch, int passes, int digit_bits) {
  __shared__ union {
    SortShared sort;
    SmallShared small;
    SumShared sum;
  } shared;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = tiles_of(N);
  constexpr int kSlice = slice_cols<kVec>();
  int U;              // runs: runs[r] = {first sorted position, row}
  int2* runs;         // and runs[U] = {kept keys, V}
  const int* spos;    // sorted positions
  if (passes == 0) {  // 1-2. one counting pass over whole ids
    U = V;
    group_small(shared.small, grid, ids, V, N, T, scratch, &runs);
    spos = scratch;
  } else {            // 1-2. radix passes, then the runs
    group_radix(shared.sort, grid, ids, V, N, T, scratch, passes,
                digit_bits, &U, &runs, &spos);
  }

  // 3. sum, long runs first. Round 1: block items (32 runs, column slice)
  // in a fixed order; a block finds the runs longer than kLong among its 32
  // and sums their slice together. A group's runs are `groups` apart, so
  // the frequent ids, which are often neighbours, fall to different
  // blocks. Round 2: warp items (run, column slice) of the other runs, in
  // a fixed order, the next item's bounds loading beside this one's rows;
  // the slices of one run go to neighbouring warps.
  const int S = (C + kSlice - 1) / kSlice;
  const int groups = (U + 31) / 32;
  SumShared& ss = shared.sum;
  for (int64_t it = blockIdx.x; it < (int64_t)groups * S; it += gridDim.x) {
    if (warp == 0) {
      const int r = (int)(it / S) + lane * groups;
      const int2 run = r < U ? __ldcg(runs + r) : make_int2(0, 0);
      const int end = r < U ? __ldcg(&runs[r + 1].x) : 0;
      const unsigned found = __ballot_sync(~0u, end - run.x > kLong);
      ss.run[lane] = run;
      ss.end[lane] = end;
      if (lane == 0) ss.found = found;
    }
    __syncthreads();
    for (unsigned found = ss.found; found; found &= found - 1) {
      const int l = __ffs(found) - 1;
      block_sum_slice<kVec>(ss, table, ld, grads, C, spos, ss.run[l].x,
                            ss.end[l], ss.run[l].y, (int)(it % S));
    }
    __syncthreads();  // the group's runs are read
  }
  const int64_t items = (int64_t)U * S;
  const int64_t nw = (int64_t)gridDim.x * kWarps;
  int64_t it = (int64_t)blockIdx.x * kWarps + warp;
  int2 run = make_int2(0, 0);
  int end = 0;
  if (it < items) {
    run = __ldcg(runs + it / S);
    end = __ldcg(&runs[it / S + 1].x);
  }
  while (it < items) {
    const int64_t next = it + nw;
    int2 next_run = make_int2(0, 0);
    int next_end = 0;
    if (next < items) {
      next_run = __ldcg(runs + next / S);
      next_end = __ldcg(&runs[next / S + 1].x);
    }
    if (end > run.x && end - run.x <= kLong)  // longer: round 1's
      sum_slice<kVec>(table, ld, grads, C, spos, run.x, end, run.y,
                      (int)(it % S));
    it = next, run = next_run, end = next_end;
  }
}

inline unsigned blocks_for(int n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

int64_t scatter_scratch_ints(int N, int V) {
  const int64_t T = (N + kTile - 1) / kTile;
  if (V + 1 <= kSmallKeys)
    return small_runs_offset(N, T, V + 1) + 2 * ((int64_t)V + 1);
  return 6 * (int64_t)N + T * kMaxDigits + 2 * T + 2;
}

// Blocks of K2's grid: as many as can be resident (a cooperative launch
// needs all), fewer when the work is smaller.
template <bool kVec>
cudaError_t scatter_grid(int device, int N, int V, int C, int* blocks) {
  static int cached[2][64] = {};
  int& per_sm = cached[kVec][device & 63];
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_add_rows_kernel<kVec>, kThreads, 0);
    if (e != cudaSuccess) return e;
  }
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t slices = (C + slice_cols<kVec>() - 1) / slice_cols<kVec>();
  const int64_t want =
      (std::min<int64_t>(N, V) * slices + kWarps - 1) / kWarps;
  const int64_t tiles = (N + kTile - 1) / kTile;
  *blocks = (int)std::max<int64_t>(
      1, std::min<int64_t>((int64_t)per_sm * sms, std::max(want, tiles)));
  return cudaSuccess;
}

template <bool kVec>
cudaError_t launch_scatter(int device, float* table, int64_t ld, int V,
                           const int* ids, const float* grads, int N, int C,
                           int* scratch, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t e = scatter_grid<kVec>(device, N, V, C, &blocks);
  if (e != cudaSuccess) return e;
  // keys are 0 .. V (V: dropped): one counting pass where they fit a
  // block's counters (passes = 0), else bit_length(V) bits in radix passes
  // of at most kMaxDigitBits
  const int bits = 32 - __builtin_clz((unsigned)V);
  int passes = V + 1 <= kSmallKeys
                   ? 0 : (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  int digit_bits = passes ? (bits + passes - 1) / passes : 0;
  void* args[] = {&table, &ld, &V, &ids, &grads, &N, &C, &scratch, &passes,
                  &digit_bits};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(scatter_add_rows_kernel<kVec>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
}

}  // namespace

extern "C" {

// Once a process and device, before a launch is captured in a CUDA graph:
// the gather's kernels loaded and K2's resident blocks an SM read, so that
// a launch after that makes no host API call that a capture could refuse
int ge_prepare_rows(int device) {
  cudaError_t e = cudaSetDevice(device);
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, gather_rows_kernel<true>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, gather_rows_kernel<false>);
  int blocks = 0;
  if (e == cudaSuccess) e = scatter_grid<true>(device, 1, 1, 1, &blocks);
  if (e == cudaSuccess) e = scatter_grid<false>(device, 1, 1, 1, &blocks);
  return (int)e;
}

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

// int32 elements of the scratch buffer K2 needs for N ids into V rows
int64_t ge_scatter_add_rows_scratch(int N, int V) {
  return scatter_scratch_ints(N, V);
}

int ge_scatter_add_rows(int device, void* table, int64_t ld, int V,
                        const void* ids, const void* grads, int N, int C,
                        void* scratch, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0 || V == 0 || C == 0) return 0;
  const bool vec = ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)grads % 16 == 0) && ld % 4 == 0 && C % 4 == 0;
  float* t = (float*)table;
  const int* i = (const int*)ids;
  const float* g = (const float*)grads;
  const cudaStream_t s = (cudaStream_t)stream;
  e = vec ? launch_scatter<true>(device, t, ld, V, i, g, N, C,
                                 (int*)scratch, s)
          : launch_scatter<false>(device, t, ld, V, i, g, N, C,
                                  (int*)scratch, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
