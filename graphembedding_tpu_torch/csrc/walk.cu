// Random walks for Hopper (sm_90a): each corpus one launch.
//
// None of these kernels replaces a Pallas kernel. The JAX package walks
// every walker in lockstep under an XLA `lax.scan` (Mosaic has no vector
// gather), and the port first copied that as a Python loop of torch ops,
// several launches a hop. Here each walker walks its whole row inside one
// launch, its state in registers:
//
//   K6 `ge_walk_first_order`: first-order walks, one thread a walker;
//      uniform next hop (graphembedding_tpu/ops/walk.py:84 uniform_walks)
//      or one alias draw a hop (:111 weighted_walks);
//   K7 `ge_walk_exact_pq`: the exact (p,q) walk (:141 node2vec_walks), one
//      warp a walker, the lanes over cur's padded row: each candidate's
//      weight times {1/p, 1, 1/q} by its class against prev (membership by
//      a binary search in prev's padded row), a Gumbel-max draw, and a warp
//      argmax whose ties go to the first column;
//   K8 `ge_walk_rejection_pq`: the rejection (p,q) walk (:248
//      node2vec_walks_rejection), one thread a walker: alias (or uniform
//      slot) proposals from N(cur), the prev-point envelope or the upper
//      bound, membership by a binary search in prev's CSR row or padded
//      row, the first accepted proposal, else the last one drawn;
//   K9 `ge_walk_multilayer`: Struc2Vec's multilayer walk
//      (graphembedding_tpu/models/struc2vec.py:485 multilayer_walks), one
//      thread a walker holding (vertex, layer), from the per-(layer,
//      vertex) tables the wrapper builds.
//
// Each computes what its plain version in graphembedding_tpu_torch
// (ops/walk.py, models/struc2vec.py) computes, in the same float32
// operations, each rounded on its own (no contraction into an fma), so
// that with the same uniforms the walks are equal. The uniforms come from
// `draws` (the plain version's draws, in its order and layout) where it
// is given, else from Philox4x32-10 keyed by the 64-bit seed at `seed` (a
// device tensor the wrapper draws from the caller's generator), with the
// counter (try, hop, walker).
//
// What bounds them: not bytes (a hop reads a few words of the graph and
// writes one id; Wiki's corpus moves about 10 MB) but the chain of a
// walk's dependent reads: each hop's reads wait for the previous hop's id
// (K6: row_ptr and degree, then col_idx; the alias adds accept and
// alias). The design puts one walker on a thread (a warp for K7), and
// enough walkers in flight to hide each read's latency behind the others.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// flags of ge_walk_rejection_pq
constexpr int kEnvelope = 1;  // the prev-point mixture (else upper bound)
constexpr int kDense = 2;     // membership in prev's padded row (else CSR)
constexpr int kRowSlots = 4;  // uniform slots of cur's padded row

struct Rng {
  const float* draws;  // shared draws, or null: Philox
  uint32_t k0, k1;     // Philox key
};

__device__ __forceinline__ Rng make_rng(const float* draws,
                                        const int64_t* seed) {
  Rng r{draws, 0u, 0u};
  if (draws == nullptr) {
    const uint64_t s = (uint64_t)seed[0];
    r.k0 = (uint32_t)s;
    r.k1 = (uint32_t)(s >> 32);
  }
  return r;
}

// Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1)
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1,
                                        uint32_t c2, uint32_t c3,
                                        uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// a uniform in [0, 1) from 24 random bits
__device__ __forceinline__ float unit(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// the four uniforms of counter (try, hop, walker)
__device__ __forceinline__ float4 philox_uniforms(const Rng& r, uint32_t tri,
                                                  uint32_t hop,
                                                  int64_t walker) {
  const uint4 x = philox(tri, hop, (uint32_t)walker,
                         (uint32_t)((uint64_t)walker >> 32), r.k0, r.k1);
  return make_float4(unit(x.x), unit(x.y), unit(x.z), unit(x.w));
}

// min(floor(u * n), n - 1) for n >= 1, as the plain versions compute it
__device__ __forceinline__ int64_t uniform_pick(float u, int64_t n) {
  const int64_t pick = (int64_t)__fmul_rn(u, (float)n);
  return pick < n - 1 ? pick : n - 1;
}

// `ops.alias.alias_draw`: the local slot drawn from row tables at `off`
// of `n` >= 1 entries (flat reads clamped to the tables' last slot)
__device__ __forceinline__ int64_t alias_slot(const float* __restrict__ acc,
                                              const int* __restrict__ ali,
                                              int64_t last, int64_t off,
                                              int64_t n, float u1, float u2) {
  const int64_t pick = uniform_pick(u1, n);
  int64_t flat = off + pick;
  flat = flat < last ? flat : last;
  return u2 < acc[flat] ? pick : (int64_t)ali[flat];
}

// the first position in row[0, n) whose value is >= x (lower bound)
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ row,
                                               int64_t n, int x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// is x in the padded row (ascending ids, then -1 pads, read as a value
// above every id)? A negative x is in no row.
__device__ __forceinline__ bool padded_contains(const int* __restrict__ row,
                                                int D, int x) {
  if (x < 0) return false;
  int lo = 0, hi = D;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int v = row[mid];
    if (v >= 0 && v < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < D && row[lo] == x;
}

// ---- K6: first-order walks ---------------------------------------------

template <bool kAlias>
__global__ void __launch_bounds__(kThreads)
first_order_walk_kernel(const int64_t* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const int* __restrict__ degree,
                        const float* __restrict__ accept,
                        const int* __restrict__ alias, int64_t E,
                        const int64_t* __restrict__ starts, int64_t B, int L,
                        const float* __restrict__ draws,
                        const int64_t* __restrict__ seed,
                        int* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const Rng rng = make_rng(draws, seed);
  int* row = out + b * L;
  int64_t cur = starts[b];
  row[0] = (int)cur;
  for (int t = 1; t < L; ++t) {
    const int64_t deg = cur >= 0 ? (int64_t)degree[cur] : 0;
    if (deg <= 0) {
      // dead (-1) or at a node without out-edges: -1 from here on
      for (; t < L; ++t) row[t] = -1;
      return;
    }
    float u1, u2 = 0.f;
    if (rng.draws != nullptr) {
      // the plain version draws one [B] a hop (uniform) or two (alias)
      if (kAlias) {
        u1 = rng.draws[(int64_t)(2 * (t - 1)) * B + b];
        u2 = rng.draws[(int64_t)(2 * (t - 1) + 1) * B + b];
      } else {
        u1 = rng.draws[(int64_t)(t - 1) * B + b];
      }
    } else {
      const float4 u = philox_uniforms(rng, 0, t, b);
      u1 = u.x;
      u2 = u.y;
    }
    const int64_t rp = row_ptr[cur];
    const int64_t slot =
        kAlias ? alias_slot(accept, alias, E - 1, rp, deg, u1, u2)
               : uniform_pick(u1, deg);
    int64_t at = rp + slot;
    at = at < E - 1 ? at : E - 1;
    cur = col[at];
    row[t] = (int)cur;
  }
}

// ---- K7: the exact (p,q) walk ------------------------------------------

constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
exact_pq_walk_kernel(const int* __restrict__ degree,
                     const int* __restrict__ nbr,
                     const float* __restrict__ nbr_w, int D,
                     const int64_t* __restrict__ starts, int64_t B, int L,
                     float inv_p, float inv_q,
                     const float* __restrict__ draws,
                     const int64_t* __restrict__ seed,
                     int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const Rng rng = make_rng(draws, seed);
  int* row = out + b * L;
  int64_t cur = starts[b], prev = -1;
  if (lane == 0) row[0] = (int)cur;
  for (int t = 1; t < L; ++t) {
    const int deg = cur >= 0 ? degree[cur] : 0;
    if (deg <= 0) {
      for (int s = t + lane; s < L; s += 32) row[s] = -1;
      return;
    }
    const int* cand_row = nbr + cur * (int64_t)D;
    const float* w_row = nbr_w + cur * (int64_t)D;
    const int* prev_row = prev >= 0 ? nbr + prev * (int64_t)D : nullptr;
    const float* u_row =
        rng.draws != nullptr
            ? rng.draws + ((int64_t)(t - 1) * B + b) * (int64_t)D
            : nullptr;
    float best = -INFINITY;
    int best_j = D;
    for (int j = lane; j < D; j += 32) {
      const int cand = cand_row[j];
      float w = w_row[j];
      if (t > 1) {
        const float f = cand == prev ? inv_p
                        : padded_contains(prev_row, D, cand) ? 1.f
                                                             : inv_q;
        w = __fmul_rn(w, f);
      }
      float u = u_row != nullptr ? u_row[j]
                                 : philox_uniforms(rng, j, t, b).x;
      u = fmaxf(u, 1e-20f);
      const float gumbel = -logf(-logf(u));
      const float score = w > 0.f ? logf(fmaxf(w, 1e-30f)) : -INFINITY;
      const float s = __fadd_rn(score, gumbel);
      // within a lane the columns rise, so only a larger score wins
      if (s > best) {
        best = s;
        best_j = j;
      }
    }
    // the warp's argmax, ties to the first column (torch.argmax)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, o);
      if (ob > best || (ob == best && oj < best_j)) {
        best = ob;
        best_j = oj;
      }
    }
    // every score -inf (no positive weight): column 0
    if (best_j >= D) best_j = 0;
    prev = cur;
    cur = cand_row[best_j];
    if (lane == 0) row[t] = (int)cur;
  }
}

// ---- K8: the rejection (p,q) walk --------------------------------------

// position of x in CSR row [lo, lo + n): (found, first slot >= x)
__device__ __forceinline__ bool csr_find(const int* __restrict__ col,
                                         int64_t lo, int64_t n, int x,
                                         int64_t* pos) {
  const int64_t at = lo + lower_bound(col + lo, n, x);
  *pos = at;
  return at < lo + n && col[at] == x;
}

__global__ void __launch_bounds__(kThreads)
rejection_pq_walk_kernel(
    const int64_t* __restrict__ row_ptr, const int* __restrict__ col,
    const int* __restrict__ degree, const float* __restrict__ accept,
    const int* __restrict__ alias, int64_t E,
    const float* __restrict__ edge_weight, const float* __restrict__ wsum,
    const int* __restrict__ nbr, int D,
    const int64_t* __restrict__ starts, int64_t B, int L, int P, int R,
    int flags, float a_coef, float beta, float acc_prev, float acc_shared,
    float acc_other, const float* __restrict__ draws,
    const int64_t* __restrict__ seed, int* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const bool envelope = flags & kEnvelope, dense = flags & kDense;
  const bool row_slots = dense && (flags & kRowSlots);
  // uniforms a proposal in the plain version's order: the slot, the
  // alias coin, the prev point's coin, the acceptance
  const int k = 2 + (row_slots ? 0 : 1) + (envelope ? 1 : 0);
  const Rng rng = make_rng(draws, seed);
  int* row = out + b * L;
  int64_t cur = starts[b], prev = -1;
  row[0] = (int)cur;
  if (L < 2) return;
  int t = 1;
  {
    // the first hop: a plain weighted draw
    const int64_t deg = cur >= 0 ? (int64_t)degree[cur] : 0;
    if (deg > 0) {
      float u1, u2;
      if (rng.draws != nullptr) {
        u1 = rng.draws[b];
        u2 = rng.draws[B + b];
      } else {
        const float4 u = philox_uniforms(rng, 0, 1, b);
        u1 = u.x;
        u2 = u.y;
      }
      const int64_t rp = row_ptr[cur];
      int64_t at = rp + alias_slot(accept, alias, E - 1, rp, deg, u1, u2);
      at = at < E - 1 ? at : E - 1;
      prev = cur;
      cur = col[at];
    } else {
      cur = -1;
    }
    row[1] = (int)cur;
  }
  const int64_t stride = (int64_t)B * P;  // one [B, P] draw
  for (t = 2; t < L; ++t) {
    const int64_t deg = cur >= 0 ? (int64_t)degree[cur] : 0;
    if (deg <= 0) {
      for (; t < L; ++t) row[t] = -1;
      return;
    }
    const int64_t rp = row_ptr[cur];
    float p_point = 0.f;
    if (envelope) {
      // the prev point's mass: a_coef * w(cur -> prev), 0 where absent
      int64_t pos;
      const bool found = csr_find(col, rp, deg, (int)prev, &pos);
      const float w_prev =
          found ? (edge_weight != nullptr ? edge_weight[pos] : 1.f) : 0.f;
      const float a = __fmul_rn(a_coef, w_prev);
      const float den = fmaxf(__fadd_rn(a, __fmul_rn(beta, wsum[cur])),
                              1e-30f);
      p_point = __fdiv_rn(a, den);
    }
    const int64_t prow = row_ptr[prev];
    const int64_t pdeg = degree[prev];
    int y = 0;
    bool accepted = false;
    for (int r = 0; r < R && !accepted; ++r) {
      const float* base =
          rng.draws != nullptr
              ? rng.draws + 2 * (int64_t)B +
                    ((int64_t)(t - 2) * R + r) * k * stride + b * P
              : nullptr;
      for (int i = 0; i < P; ++i) {
        float us[4];
        if (base != nullptr) {
          for (int s = 0; s < k; ++s) us[s] = base[s * stride + i];
        } else {
          const float4 u = philox_uniforms(rng, r * P + i, t, b);
          us[0] = u.x;
          us[1] = u.y;
          us[2] = u.z;
          us[3] = u.w;
        }
        int s = 0;
        const float u1 = us[s++];
        int cand;
        if (row_slots) {
          cand = nbr[cur * (int64_t)D + uniform_pick(u1, deg)];
        } else {
          const float u2 = us[s++];
          int64_t at = rp + alias_slot(accept, alias, E - 1, rp, deg, u1, u2);
          at = at < E - 1 ? at : E - 1;
          cand = col[at];
        }
        if (envelope && us[s++] < p_point) cand = (int)prev;
        const float ua = us[s];
        bool in_prev;
        if (dense) {
          in_prev = padded_contains(nbr + prev * (int64_t)D, D, cand);
        } else {
          int64_t pos;
          in_prev = csr_find(col, prow, pdeg, cand, &pos);
        }
        const float ratio = cand == prev ? acc_prev
                            : in_prev    ? acc_shared
                                         : acc_other;
        y = cand;  // none accepted: the last proposal drawn
        if (ua < ratio) {
          accepted = true;
          break;
        }
      }
    }
    prev = cur;
    cur = y;
    row[t] = (int)cur;
  }
}

// ---- K9: Struc2Vec's multilayer walk -----------------------------------

__global__ void __launch_bounds__(kThreads)
multilayer_walk_kernel(const int64_t* __restrict__ deg,
                       const int64_t* __restrict__ first,
                       const float* __restrict__ p_up,
                       const bool* __restrict__ can_up,
                       const int* __restrict__ cols,
                       const float* __restrict__ acc,
                       const int* __restrict__ ali, int64_t V, int64_t KE,
                       const int64_t* __restrict__ starts, int64_t B, int L,
                       int M, float stay_prob,
                       const float* __restrict__ draws,
                       const int64_t* __restrict__ seed,
                       int* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const Rng rng = make_rng(draws, seed);
  int* row = out + b * L;
  int64_t v = starts[b], layer = 0;
  row[0] = (int)v;
  const int64_t rows = 4 * (int64_t)M + 2;  // uniforms an emission

  // a neighbor step in the layer of idx, or a stay without an edge there
  auto neighbor_step = [&](int64_t idx, float u1, float u2) -> int64_t {
    const int64_t d = deg[idx];
    const int64_t f = first[idx];
    int64_t at = f + alias_slot(acc, ali, KE - 1, f, d > 1 ? d : 1, u1, u2);
    at = at < KE - 1 ? at : KE - 1;
    return d > 0 ? (int64_t)cols[at] : v;
  };

  for (int step = 1; step < L; ++step) {
    const float* u_col =
        rng.draws != nullptr ? rng.draws + (int64_t)(step - 1) * rows * B + b
                             : nullptr;
    bool stepped = false;
    for (int i = 0; i < M; ++i) {
      float r, u1, u2, r2;
      if (u_col != nullptr) {
        r = u_col[(4 * (int64_t)i) * B];
        u1 = u_col[(4 * (int64_t)i + 1) * B];
        u2 = u_col[(4 * (int64_t)i + 2) * B];
        r2 = u_col[(4 * (int64_t)i + 3) * B];
      } else {
        const float4 u = philox_uniforms(rng, i, step, b);
        r = u.x;
        u1 = u.y;
        u2 = u.z;
        r2 = u.w;
      }
      if (r < stay_prob) {
        v = neighbor_step(layer * V + v, u1, u2);
        stepped = true;
        break;
      }
      // a layer move for a walker that has not stepped
      const int64_t idx = layer * V + v;
      const float pu = p_up[idx];
      if (r2 <= pu) {
        if (can_up[idx]) ++layer;
      } else if (r2 > pu && layer > 0) {
        --layer;
      }
    }
    if (!stepped) {
      float u1, u2;
      if (u_col != nullptr) {
        u1 = u_col[(rows - 2) * B];
        u2 = u_col[(rows - 1) * B];
      } else {
        const float4 u = philox_uniforms(rng, M, step, b);
        u1 = u.x;
        u2 = u.y;
      }
      v = neighbor_step(layer * V + v, u1, u2);
    }
    row[step] = (int)v;
  }
}

int64_t blocks_for(int64_t threads) {
  return (threads + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" {

int ge_walk_first_order(int device, const void* row_ptr, const void* col,
                        const void* degree, const void* accept,
                        const void* alias, int64_t E, const void* starts,
                        int64_t B, int L, const void* draws,
                        const void* seed, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || L == 0) return 0;
  if ((draws == nullptr) == (seed == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks_for(B)), block(kThreads);
  const auto* rp = (const int64_t*)row_ptr;
  const int* c = (const int*)col;
  const int* d = (const int*)degree;
  const auto* st = (const int64_t*)starts;
  const float* dr = (const float*)draws;
  const auto* sd = (const int64_t*)seed;
  if (accept != nullptr) {
    first_order_walk_kernel<true><<<grid, block, 0, s>>>(
        rp, c, d, (const float*)accept, (const int*)alias, E, st, B, L, dr,
        sd, (int*)out);
  } else {
    first_order_walk_kernel<false><<<grid, block, 0, s>>>(
        rp, c, d, nullptr, nullptr, E, st, B, L, dr, sd, (int*)out);
  }
  return (int)cudaGetLastError();
}

int ge_walk_exact_pq(int device, const void* degree, const void* nbr,
                     const void* nbr_w, int D, const void* starts, int64_t B,
                     int L, float inv_p, float inv_q, const void* draws,
                     const void* seed, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || L == 0) return 0;
  if ((draws == nullptr) == (seed == nullptr) || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((B + kWarps - 1) / kWarps)), block(kThreads);
  exact_pq_walk_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)degree, (const int*)nbr, (const float*)nbr_w, D,
      (const int64_t*)starts, B, L, inv_p, inv_q, (const float*)draws,
      (const int64_t*)seed, (int*)out);
  return (int)cudaGetLastError();
}

int ge_walk_rejection_pq(int device, const void* row_ptr, const void* col,
                         const void* degree, const void* accept,
                         const void* alias, int64_t E,
                         const void* edge_weight, const void* wsum,
                         const void* nbr, int D, const void* starts,
                         int64_t B, int L, int P, int R, int flags,
                         float a_coef, float beta, float acc_prev,
                         float acc_shared, float acc_other,
                         const void* draws, const void* seed, void* out,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || L == 0) return 0;
  if ((draws == nullptr) == (seed == nullptr) || P < 1 || R < 1 ||
      ((flags & kEnvelope) && wsum == nullptr) ||
      ((flags & kDense) && (nbr == nullptr || D < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  rejection_pq_walk_kernel<<<(unsigned)blocks_for(B), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int64_t*)row_ptr, (const int*)col, (const int*)degree,
      (const float*)accept, (const int*)alias, E,
      (const float*)edge_weight, (const float*)wsum, (const int*)nbr, D,
      (const int64_t*)starts, B, L, P, R, flags, a_coef, beta, acc_prev,
      acc_shared, acc_other, (const float*)draws, (const int64_t*)seed,
      (int*)out);
  return (int)cudaGetLastError();
}

int ge_walk_multilayer(int device, const void* deg, const void* first,
                       const void* p_up, const void* can_up,
                       const void* cols, const void* acc, const void* ali,
                       int64_t V, int64_t KE, const void* starts, int64_t B,
                       int L, int M, float stay_prob, const void* draws,
                       const void* seed, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || L == 0) return 0;
  if ((draws == nullptr) == (seed == nullptr) || KE < 1 || M < 0) {
    return (int)cudaErrorInvalidValue;
  }
  multilayer_walk_kernel<<<(unsigned)blocks_for(B), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t*)deg, (const int64_t*)first, (const float*)p_up,
      (const bool*)can_up, (const int*)cols, (const float*)acc,
      (const int*)ali, V, KE, (const int64_t*)starts, B, L, M, stay_prob,
      (const float*)draws, (const int64_t*)seed, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
