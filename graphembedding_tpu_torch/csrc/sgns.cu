// SGNS block gradients (K1) for Hopper (sm_90a).
//
// Replaces graphembedding_tpu/ops/pallas_sgns.py::_kernel (entry
// sgns_block_grads_pallas); oracle sgns_block_grads_xla. Per packed group
// g of PL positions (P walks of length L) with K shared negatives:
//   logits = yin . yout^T                       [PL, PL]
//   g_pos  = (sigmoid(logits) - 1) * mask
//   nlog   = yin . vn^T                          [PL, K]
//   g_neg  = sigmoid(nlog) * n_pairs * neg_w * neg_ok
//   d_yin  = g_pos . yout + g_neg . vn,  d_yout = g_pos^T . yin,
//   d_vn   = sum over the r = G / G2 groups sharing vn of g_neg^T . yin
//   loss[g] = -(sum log_sigmoid(logits) * mask
//               + sum log_sigmoid(-nlog) * n_pairs * neg_w * neg_ok)
// With r > 1 each group's loss holds its own share of the negative term,
// as the Pallas kernel's does; sums over a sharing group equal the oracle's.
//
// What bounds it. At the DeepWalk step's shapes (G = 336, PL = 120,
// D = 128, K = 64, r = 4) a call moves about 118 MB through device memory
// (35 us at 3.35 TB/s) and, with PL padded to 128 and each product done
// three times in split TF32, issues about 19 GFLOP to the tensor cores
// (38 us at 495 TFLOP/s): near the ridge, with either floor some
// 0.04-0.06 ms. What binds is neither. mma.sync cannot reach wgmma's rate,
// and the splits, fragment loads and epilogues are issued beside it; a
// block spends about 42 us on its products, and about 6 us waiting for
// its first rows, which the blocks of a wave all ask for at once. With
// one block an SM and clusters of 4, 128 blocks are resident: 336 make
// three waves, about 0.15 ms on an H100 (PERF.md). The design answers
// each bound:
//
// - Tensor cores at FP32 accuracy. All six products run as
//   mma.sync.m16n8k8 TF32 with f32 accumulation, each operand split as
//   x = hi + lo (hi rounded to TF32 to nearest, ties away, as
//   cvt.rna.tf32.f32 rounds; lo the remainder, cut toward zero) and the
//   product taken as lo.hi + hi.lo + hi.hi, small terms first. One TF32
//   pass keeps about three digits, which misses the rtol 2e-4 the kernel
//   is held to; three passes hold it (tests/test_torch_sgns_tf32.py
//   emulates both). The tensor core rounds its f32 sums toward zero, so
//   each k-step's three products go to a fresh fragment that is added to
//   the running sum in round-to-nearest.
//   mma.sync is used rather than wgmma because its fragments are loaded
//   from shared memory by hand, in any layout: four of the six products
//   read yin, yout or vn along the row as an MN-major B operand, which
//   wgmma takes only for 16-bit types, and transposed copies would not
//   fit. The reduction index is reordered within each step of 8 so that an
//   operand stored along it loads two k-slots in one 64-bit access. The
//   two products over g_pos skip the steps of 8 where it is zero (the
//   window mask is a band about the diagonal).
// - Filling the card. One block (16 warps, a 32 x 32 or 32 x 16 tile of
//   each product a warp) per packing group: G = 336 blocks. The r groups
//   sharing one negative set form a thread-block cluster; each leaves its
//   d_vn partial in shared memory and, after a cluster barrier, block q
//   sums its share of the rows over the cluster's blocks through
//   distributed shared memory in rank order 0..r-1. No atomics, so the
//   result is the same bits from run to run. r is at most 8, the portable
//   cluster size.
// - Overlapping copies with arithmetic. yin, yout and vn rows (strided
//   column slices of the fused [V, 2D] table; one copy a row), the mask
//   (one copy a row) and this group's neg_ok slice arrive by cp.async.bulk
//   on three mbarriers. The rows come first; the mask is asked for once
//   they are in and lands while yin . yout^T runs; vn and neg_ok land in
//   yout's place while g_pos^T . yin runs. Every input is read from device
//   memory once; n_pairs comes from the mask in shared memory; d_yin's
//   positive half is read back once, before its negative half's products.
//   The [PL, PL] and [PL, K] intermediates never leave the SM.
//
// Shared memory (floats; PLp, Kp, Dp are PL, K, D rounded up to 32, pads
// zeroed, rows spaced by 4 extra floats against bank conflicts): yin
// [PLp][Dp+4]; a second tile that holds yout, then vn with neg_ok after it,
// then the d_vn partial; the gradient logits [PLp][max(PLp,Kp)+4], which
// first receive the mask in place; small arrays for n_pairs and the loss.
// About 205 KB at the step's shapes (ops/sgns.py _smem_bytes mirrors it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 32;      // PL, K and D are padded to multiples of this
constexpr int kMaxCluster = 8;
constexpr int kBarBytes = 32;  // three mbarriers at the start of the pool

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// the layout of the shared-memory pool, computed alike on host and device
struct Plan {
  int PLp, Kp, Dp, ldy, ldg;
  int off_yin, off_b, off_g, off_npp, off_np, off_red, off_live, floats;
  __host__ __device__ Plan(int PL, int D, int K) {
    PLp = round_up(PL, kPad);
    Kp = round_up(K, kPad);
    Dp = round_up(D, kPad);
    ldy = Dp + 4;
    ldg = (PLp > Kp ? PLp : Kp) + 4;
    const int nb_pos = PLp * ldy, nb_neg = Kp * ldy + round_up(PL * K, 4);
    off_yin = 0;
    off_b = off_yin + PLp * ldy;
    off_g = off_b + (nb_pos > nb_neg ? nb_pos : nb_neg);
    off_npp = off_g + PLp * ldg;
    off_np = off_npp + (PLp / 32) * PLp;
    off_red = off_np + PLp;
    off_live = off_red + kWarps;
    floats = off_live + 2 * (PLp / 32);  // live steps of the g_pos products
  }
  __host__ __device__ int bytes() const { return kBarBytes + 4 * floats; }
};

// sigmoid(x) and log(1 + exp(-|x|)) from one exponential, stable for both
// signs: log_sigmoid(x) = min(x, 0) - sp, log_sigmoid(-x) = min(-x, 0) - sp
__device__ __forceinline__ float sigmoid_sp(float x, float& sp) {
  const float e = __expf(-fabsf(x));
  const float inv = __fdividef(1.f, 1.f + e);
  sp = __logf(1.f + e);
  return x >= 0.f ? inv : e * inv;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// the barrier's one arrival, announcing the bytes its copies will deliver
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// rows x (D floats) from device memory (row stride ld) to shared memory
// (row stride lds), one bulk copy a row, issued by the lanes of one warp
__device__ __forceinline__ void copy_rows(float* dst, int lds,
                                          const float* src, int64_t ld,
                                          int rows, int D, uint32_t bar,
                                          int lane) {
  for (int i = lane; i < rows; i += 32)
    bulk_copy(dst + i * lds, src + i * ld, (uint32_t)D * 4u, bar);
}

// piece j of 32 of n floats (n % 4 == 0), as a bulk copy
__device__ __forceinline__ void copy_piece(float* dst, const float* src,
                                           int n, int j, uint32_t bar) {
  const int piece = round_up((n + 31) / 32, 4);
  const int a = j * piece, b = min(n, a + piece);
  if (a < b) bulk_copy(dst + a, src + a, (uint32_t)(b - a) * 4u, bar);
}

// zero rows rows..rows_p-1 and columns cols..ld-1 of rows 0..rows-1
__device__ void zero_pads(float* s, int ld, int rows, int rows_p, int cols) {
  for (int e = threadIdx.x; e < (rows_p - rows) * ld; e += blockDim.x)
    s[rows * ld + e] = 0.f;
  const int w = ld - cols;
  for (int e = threadIdx.x; e < rows * w; e += blockDim.x)
    s[(e / w) * ld + cols + e % w] = 0.f;
}

// x = hi + lo in TF32 (10 mantissa bits): hi rounded to nearest with ties
// away from zero, the rounding of cvt.rna.tf32.f32, done with two integer
// operations where the conversion would take the slower path; lo, the
// exact remainder x - hi, cut toward zero (one operation; it errs by less
// than 2^-21 |x|, as CUTLASS's 3xTF32 cuts its small part)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// the operand pairs of mma_tile: two neighbours along a row, or the same
// column of two neighbouring rows
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 rows2(const float* p, int ld) {
  return make_float2(p[0], p[ld]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's (16 MT) x (8 NT) tile of A . B at rows m0, columns n0, summed
// over Kd (a multiple of 8) in split TF32 and added to acc. A(i, k) gives
// the pair A[i][k], A[i][k+1] and B(k, n) the pair B[k][n], B[k+1][n], read
// from shared memory, so either operand may be read transposed. Within each
// step of 8 the reduction index is reordered, the same for A and B: the
// m16n8k8 fragment's k-slots t and t+4 (g = lane / 4, t = lane % 4) take
// k = 2t and 2t+1, so an operand stored along k loads both in one 64-bit
// access, and one stored across k reads rows 2t, 2t+1 on distinct banks.
// Fragments: A (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (t, g), (t+4, g);
// C (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
//
// With kSkip, bit j of k_live clear says that A is zero over the tile's
// rows for reduction indices 8j..8j+7: that step is skipped, by the whole
// warp (Kd is then at most 256).
template <int MT, int NT, bool kSkip, class FA, class FB>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4], FA A, FB B,
                                         int m0, int n0, int Kd,
                                         uint32_t k_live) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 2 * t; k < Kd; k += 8) {
    if (kSkip && !(k_live >> (k >> 3) & 1u)) continue;
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int i = m0 + mt * 16 + g;
      const float2 top = A(i, k), bottom = A(i + 8, k);
      split_tf32(top.x, ah[mt][0], al[mt][0]);
      split_tf32(bottom.x, ah[mt][1], al[mt][1]);
      split_tf32(top.y, ah[mt][2], al[mt][2]);
      split_tf32(bottom.y, ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b = B(k, n0 + nt * 8 + g);
      split_tf32(b.x, bh[nt][0], bl[nt][0]);
      split_tf32(b.y, bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // the tensor core rounds its f32 sums toward zero: each k-step's
        // three products go to a fresh fragment, added to the running sum
        // in round-to-nearest, so the bias does not grow with Kd
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(c, al[mt], bh[nt]);
        mma_tf32(c, ah[mt], bl[nt]);
        mma_tf32(c, ah[mt], bh[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += c[e];
      }
  }
}

struct AllSteps {  // a product that skips nothing
  static constexpr bool kSkip = false;
  __device__ uint32_t operator()(int) const { return ~0u; }
};

// a product over g_pos: bits[m0 / 32] are the live steps of its tiles at
// output rows m0..m0+31
struct LiveSteps {
  static constexpr bool kSkip = true;
  const uint32_t* bits;
  __device__ uint32_t operator()(int m0) const { return bits[m0 / 32]; }
};

struct Zero {  // a product that starts from C = 0
  __device__ void operator()(int, int, float& v0, float& v1) const {
    v0 = v1 = 0.f;
  }
};

// every (16 MT) x (8 NT) tile of an M x N product C = C0 + A . B, spread
// over the warps; init(i, n, v0, v1) sets the pair C0[i][n], C0[i][n+1]
// and epi(i, n, v0, v1) takes C's (n even); steps(m0) gives each tile's
// k_live
template <int MT, int NT, class FA, class FB, class Epi,
          class Steps = AllSteps, class Init = Zero>
__device__ __forceinline__ void product(int M, int N, int Kd, FA A, FB B,
                                        Epi epi, Steps steps = {},
                                        Init init = {}) {
  constexpr int TM = 16 * MT, TN = 8 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tn = N / TN, tiles = (M / TM) * tn;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int m0 = (tile / tn) * TM, n0 = (tile % tn) * TN;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          init(m0 + mt * 16 + g + 8 * h, n0 + nt * 8 + 2 * t,
               acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    mma_tile<MT, NT, Steps::kSkip>(acc, A, B, m0, n0, Kd, steps(m0));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          epi(m0 + mt * 16 + g + 8 * h, n0 + nt * 8 + 2 * t,
              acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  }
}

// kLdy, kLdg: the row strides when known at compile time (0: from Plan)
template <int kLdy, int kLdg>
__global__ void __launch_bounds__(kThreads, 1)
sgns_block_grads_kernel(const float* __restrict__ yin, int64_t ld_yin,
                        const float* __restrict__ yout, int64_t ld_yout,
                        const float* __restrict__ vn, int64_t ld_vn,
                        const float* __restrict__ mask,
                        const float* __restrict__ neg_ok,
                        float* __restrict__ d_yin, float* __restrict__ d_yout,
                        float* __restrict__ d_vn, float* __restrict__ loss,
                        int PL, int D, int K, float neg_w, int mask_bulk,
                        int ok_bulk) {
  extern __shared__ __align__(128) unsigned char pool[];
  const Plan p(PL, D, K);
  const int PLp = p.PLp, Kp = p.Kp, Dp = p.Dp;
  const int PLr = round_up(PL, 8);  // sums over positions stop here
  const int ldy = kLdy ? kLdy : p.ldy, ldg = kLdg ? kLdg : p.ldg;
  uint64_t* bars = reinterpret_cast<uint64_t*>(pool);
  float* smem = reinterpret_cast<float*>(pool + kBarBytes);
  float* s_yin = smem + p.off_yin;  // [PLp][ldy]
  float* s_b = smem + p.off_b;      // yout [PLp][ldy]; vn [Kp][ldy] + neg_ok
  float* s_ok = s_b + Kp * ldy;     // [PL][K] this group's neg_ok slice
  float* s_g = smem + p.off_g;      // mask, then g_pos, then g_neg
  float* s_npp = smem + p.off_npp;  // [PLp / 32][PLp] partial n_pairs
  float* s_np = smem + p.off_np;    // [PLp] n_pairs
  float* s_red = smem + p.off_red;  // [kWarps] loss partials
  // bit j of rows_live[c] (cols_live[c]): g_pos has an entry in columns
  // (rows) 8j..8j+7 of rows (columns) 32c..32c+31
  uint32_t* s_rows_live = reinterpret_cast<uint32_t*>(smem + p.off_live);
  uint32_t* s_cols_live = s_rows_live + PLp / 32;

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t g = blockIdx.x;
  const int64_t g2 = g / r;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t bar_rows = smem_addr(bars), bar_mask = smem_addr(bars + 1),
                 bar_neg = smem_addr(bars + 2);
  const float* mask_g = mask + g * PL * PL;

  if (tid == 0) {
    mbar_init(bar_rows);
    mbar_init(bar_mask);
    mbar_init(bar_neg);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // each barrier's one arrival, with the bytes its copies will bring
    mbar_expect(bar_rows, 2u * PL * D * 4u);
    mbar_expect(bar_mask, mask_bulk ? PL * PL * 4u : 0u);
  }
  zero_pads(s_yin, ldy, PL, PLp, D);
  zero_pads(s_b, ldy, PL, PLp, D);
  for (int c = tid; c < 2 * (PLp / 32); c += kThreads) s_rows_live[c] = 0u;
  if (!mask_bulk)
    for (int e = tid; e < PL * PL; e += kThreads)
      s_g[(e / PL) * ldg + e % PL] = mask_g[e];
  __syncthreads();

  // warps 0-3 issue the row copies, half of yin's or of yout's rows each
  if (warp < 4) {
    const int h = PL / 2, r0 = (warp & 1) * h, n = (warp & 1) ? PL - h : h;
    if (warp < 2)
      copy_rows(s_yin + r0 * ldy, ldy, yin + (g * PL + r0) * ld_yin, ld_yin,
                n, D, bar_rows, lane);
    else
      copy_rows(s_b + r0 * ldy, ldy, yout + (g * PL + r0) * ld_yout, ld_yout,
                n, D, bar_rows, lane);
  }

  float part = 0.f;  // this thread's share of -loss[g]

  // logits = yin . yout^T; g_pos replaces the mask in place, and each
  // (row, 32-column tile) leaves its mask sum for n_pairs
  mbar_wait(bar_rows);
  // the mask is asked for only now, so that it takes no share of the
  // bandwidth the rows came by; it lands while the product runs
  if (warp < 4 && mask_bulk) {
    const int q = (PL + 3) / 4, m0 = warp * q, mn = min(PL, m0 + q) - m0;
    if (mn > 0)
      copy_rows(s_g + m0 * ldg, ldg, mask_g + m0 * PL, PL, mn, PL, bar_mask,
                lane);
  }
  bool mask_ready = false;
  product<2, 4>(
      PLp, PLp, Dp, [&](int i, int k) { return pair(s_yin + i * ldy + k); },
      [&](int k, int m) { return pair(s_b + m * ldy + k); },
      [&](int i, int m, float x0, float x1) {
        if (!mask_ready) {
          mbar_wait(bar_mask);
          mask_ready = true;
        }
        float rs = 0.f;
        const float xs[2] = {x0, x1};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* at = s_g + i * ldg + m + c;
          const float mv = (i < PL && m + c < PL) ? *at : 0.f;
          float sp;
          const float sg = sigmoid_sp(xs[c], sp);
          if (mv > 0.f) part += (fminf(xs[c], 0.f) - sp) * mv;
          *at = (sg - 1.f) * mv;
          rs += mv;
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        // lane t = 0 holds the row's 8 columns; the same lane meets the
        // tile's four 8-column slices in order
        if ((lane & 3) == 0) {
          float* at = s_npp + (m / 32) * PLp + i;
          *at = m % 32 == 0 ? rs : *at + rs;
        }
      });
  __syncthreads();
  for (int i = tid; i < PLp; i += kThreads) {
    float s = 0.f;
    for (int c = 0; c < PLp / 32; ++c) s += s_npp[c * PLp + i];
    s_np[i] = s;
  }
  // g_pos is zero wherever the mask is: for the step's window (same walk,
  // offset up to 5) outside a band about the diagonal. The two products
  // over g_pos skip the steps of 8 that meet only zeros. A warp scans
  // each 8-row block, a lane four columns; the bits are set with atomicOr,
  // whose order does not matter.
  for (int a = warp; a < PLp / 8; a += kWarps)
    for (int c0 = 0; c0 < PLp; c0 += 128) {
      const int c = c0 + 4 * lane;
      bool any = false;
      if (c < PLp)
        for (int i = 8 * a; i < 8 * a + 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(s_g + i * ldg + c);
          any |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
        }
      any |= __shfl_xor_sync(0xffffffffu, any, 1);  // an 8 x 8 tile
      if (any && c < PLp && !(lane & 1)) {
        atomicOr(s_rows_live + a / 4, 1u << (c / 8));
        atomicOr(s_cols_live + c / 32, 1u << a);
      }
    }
  __syncthreads();

  // d_yin = g_pos . yout (the negative half is added below)
  float* dyin_g = d_yin + g * PL * D;
  float* dyout_g = d_yout + g * PL * D;
  product<2, 4>(
      PLp, Dp, PLr, [&](int i, int m) { return pair(s_g + i * ldg + m); },
      [&](int m, int d) { return rows2(s_b + m * ldy + d, ldy); },
      [&](int i, int d, float v0, float v1) {
        if (i < PL && d < D)
          *reinterpret_cast<float2*>(dyin_g + (int64_t)i * D + d) =
              make_float2(v0, v1);
      },
      LiveSteps{s_rows_live});
  if (tid == 0)
    mbar_expect(bar_neg, K * D * 4u + (ok_bulk ? PL * K * 4u : 0u));
  __syncthreads();

  // yout is spent: vn and neg_ok come into its place while d_yout runs
  zero_pads(s_b, ldy, K, Kp, D);
  const float* ok_g = neg_ok + g * PL * K;  // this group's [PL, K] slice
  if (!ok_bulk)
    for (int e = tid; e < PL * K; e += kThreads) s_ok[e] = ok_g[e];
  // order this thread's reads of yout (and, through the barrier above,
  // the others') before the copies that overwrite it; a warp issues its
  // copies one after another, so they are dealt out over all the warps
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int c = lane * kWarps + warp; c < K + (ok_bulk ? 32 : 0);
       c += kThreads) {
    if (c < K)
      bulk_copy(s_b + c * ldy, vn + (g2 * K + c) * ld_vn, D * 4u, bar_neg);
    else
      copy_piece(s_ok, ok_g, PL * K, c - K, bar_neg);
  }

  // d_yout = g_pos^T . yin
  product<2, 4>(
      PLp, Dp, PLr,
      [&](int m, int i) { return rows2(s_g + i * ldg + m, ldg); },
      [&](int i, int d) { return rows2(s_yin + i * ldy + d, ldy); },
      [&](int m, int d, float v0, float v1) {
        if (m < PL && d < D)
          *reinterpret_cast<float2*>(dyout_g + (int64_t)m * D + d) =
              make_float2(v0, v1);
      },
      LiveSteps{s_cols_live});
  __syncthreads();

  // nlog = yin . vn^T; g_neg replaces g_pos
  mbar_wait(bar_neg);
  product<2, 2>(
      PLp, Kp, Dp, [&](int i, int d) { return pair(s_yin + i * ldy + d); },
      [&](int d, int k) { return pair(s_b + k * ldy + d); },
      [&](int i, int k, float x0, float x1) {
        const float xs[2] = {x0, x1};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool in = i < PL && k + c < K;
          const float w = in ? s_np[i] * neg_w * s_ok[i * K + k + c] : 0.f;
          float sp;
          const float sg = sigmoid_sp(xs[c], sp);
          if (in) part += (fminf(-xs[c], 0.f) - sp) * w;
          s_g[i * ldg + k + c] = sg * w;
        }
      });
  __syncthreads();

  // d_yin += g_neg . vn: the sum starts from the positive half, which the
  // same thread wrote above, read before the tile's products so that the
  // reads are in flight together
  const auto dyin_at = [&](int i, int d) {
    return reinterpret_cast<float2*>(dyin_g + (int64_t)i * D + d);
  };
  product<2, 4>(
      PLp, Dp, Kp, [&](int i, int k) { return pair(s_g + i * ldg + k); },
      [&](int k, int d) { return rows2(s_b + k * ldy + d, ldy); },
      [&](int i, int d, float v0, float v1) {
        if (i < PL && d < D) *dyin_at(i, d) = make_float2(v0, v1);
      },
      AllSteps{}, [&](int i, int d, float& v0, float& v1) {
        const float2 o =
            i < PL && d < D ? *dyin_at(i, d) : make_float2(0.f, 0.f);
        v0 = o.x;
        v1 = o.y;
      });
  __syncthreads();

  // this group's d_vn = g_neg^T . yin takes vn's place
  product<2, 2>(
      Kp, Dp, PLr, [&](int k, int i) { return rows2(s_g + i * ldg + k, ldg); },
      [&](int i, int d) { return rows2(s_yin + i * ldy + d, ldy); },
      [&](int k, int d, float v0, float v1) {
        *reinterpret_cast<float2*>(s_b + k * ldy + d) = make_float2(v0, v1);
      });
  part = warp_sum(part);
  if (lane == 0) s_red[warp] = part;
  cluster.sync();

  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += s_red[w];
    loss[g] = -s;
  }
  // block `rank` sums its share of d_vn's float4s over the cluster's
  // blocks in rank order, the r reads in flight together
  const int d4 = D / 4, n4 = K * d4, share = (n4 + r - 1) / r;
  const int e_end = min(n4, (rank + 1) * share);
  float4* dvn_g = reinterpret_cast<float4*>(d_vn + g2 * K * D);
  for (int e = rank * share + tid; e < e_end; e += kThreads) {
    const int off = (e / d4) * ldy + 4 * (e % d4);
    float4 v[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < r)
        v[j] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(s_b, j) + off);
    float4 s = v[0];
#pragma unroll
    for (int j = 1; j < kMaxCluster; ++j)
      if (j < r) {
        s.x += v[j].x;
        s.y += v[j].y;
        s.z += v[j].z;
        s.w += v[j].w;
      }
    dvn_g[e] = s;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

extern "C" int ge_sgns_block_grads(
    int device, const void* yin, int64_t ld_yin, const void* yout,
    int64_t ld_yout, const void* vn, int64_t ld_vn, const void* mask,
    const void* neg_ok, void* d_yin, void* d_yout, void* d_vn, void* loss,
    int G, int G2, int PL, int D, int K, float neg_w, int smem,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  // smem is the caller's mirror of Plan (ops/sgns.py _smem_bytes)
  const Plan p(PL, D, K);
  if (G2 <= 0 || G % G2 != 0 || G / G2 > kMaxCluster || D % 4 != 0 ||
      smem != p.bytes())
    return (int)cudaErrorInvalidValue;
  // the DeepWalk step's shapes (D = 128, PL and K up to 128) take strides
  // known at compile time; any other takes them from Plan
  const auto kernel = p.ldy == 132 && p.ldg == 132
                          ? sgns_block_grads_kernel<132, 132>
                          : sgns_block_grads_kernel<0, 0>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  // bulk copies move 16-byte-aligned multiples of 16 bytes
  const int mask_bulk = PL % 4 == 0 && (uintptr_t)mask % 16 == 0;
  const int ok_bulk = (PL * K) % 4 == 0 && (uintptr_t)neg_ok % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G / G2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const float*)yin, ld_yin,
                         (const float*)yout, ld_yout, (const float*)vn, ld_vn,
                         (const float*)mask, (const float*)neg_ok,
                         (float*)d_yin, (float*)d_yout, (float*)d_vn,
                         (float*)loss, PL, D, K, neg_w, mask_bulk, ok_bulk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
