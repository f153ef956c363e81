// Hierarchical-softmax block gradients (K10) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package scores the hs=1 step with XLA
// einsums (graphembedding_tpu/train/hsoftmax.py, hs_block_chunk's step),
// and the port did the same with three batched float32 products over a
// dense [G, PL, PL * T] grid (ops/hs.py hs_block_grads_plain, which K10
// is held against). Per packing group g of PL positions, for each window
// pair (center l, context m), the same rule as the plain version:
//   window_ok[l, m] && dm[l, m] <= eff[l] && tok[l] >= 0 && tok[m] >= 0,
// and each level t of m's Huffman path (points[tok[m], t] >= 0):
//   x      = <w_in[tok[l]], w_tree[points[tok[m], t]]>
//   g      = (1 - codes[tok[m], t]) - 1 / (1 + expf(-x))
//   d_yin[l]     += g * w_tree[points[tok[m], t]]
//   d_tree[m, t] += g * w_in[tok[l]]
//   loss         -= log_sigmoid(+-x)   (+ where the code is 0)
// d_yin is [G * PL, D] and d_tree [G * PL * T, D], with zero rows where no
// pair reaches (pads, levels past a path's end), as the plain version
// gives them; `parts` [G, PL] holds each walk's loss at its first position
// and zeros elsewhere.
//
// What bounds it. At the DeepWalk hs=1 step (G = 42, PL = 120 = 12 walks
// of 10, D = 128, T = 15 or 21) a window pair has on average 4.6 partners
// and a path 13-15 levels, so the useful work is ~306k (pair, level)
// scores of 3 x 128 FMAs, 0.24 GFLOP (3.5 us at 67 TFLOP/s in FFMA). The
// bytes are set by writing d_tree once (39 MB at T = 15, 54 MB at T = 21:
// 12-16 us at 3.35 TB/s), reading the tree rows of each context once and
// the centers' rows. The dense form spent ~97% of its products and
// elementwise traffic on entries its mask zeroes. What is left to bound
// K10 is latency: a walk's contexts are scored in turn, each behind its
// gathered rows and the barriers between its passes. The design:
//
// - Only the window's pairs. A block takes the walks whose first position
//   lies in its slice of kQ positions of one group (a walk starts where
//   dm[0, p] == 0: dm is the offset within the walk; window_ok pairs only
//   positions of one walk, as window_geometry builds it). The block owns
//   its walks' rows of d_yin, d_tree and parts, so every sum is taken in
//   one block, in a fixed order, with no atomics: the same bits from run
//   to run. d_tree[m, t] sums its centers in ascending l; d_yin[l] sums
//   over contexts in ascending m, then levels in ascending t; a logit
//   sums four partial dot products, each in column order.
// - Contexts in turn, one ahead. While the block scores context m, one
//   warp lists context m + 1's centers (a ballot over the walk), another
//   its path's depth and labels, and cp.async brings m + 1's path rows of
//   w_tree and its first kCT centers' rows of w_in into the other pair of
//   buffers. A context then costs two barriers and three passes: one
//   thread a (center, level) dot product over D (rows spaced D + 4 floats,
//   so a quarter-warp's float4 reads fall on distinct banks), one thread a
//   (level, 4 columns) of d_tree, written straight to device memory
//   (coalesced), one thread a (center, 4 columns) of d_yin, added into the
//   walk's rows in device memory, which only this block touches (they
//   stay in L1/L2). Centers past kCT (windows over 8) go in later tiles.
// - Full float32 on FFMA, no TF32 and no fast-math intrinsics: expf and
//   log1pf as torch computes sigmoid and log_sigmoid. The products are
//   too few for the tensor cores to pay.
// - Any D (16-byte vectors where D and the row strides are multiples of
//   4, else single floats), any walk length and window, any depth T
//   (shared memory grows as 2 (T + kCT) (D + 4) floats); ops/hs.py
//   _smem_bytes mirrors Plan and refuses a launch above the 227 KB a
//   block may have.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQ = 8;    // positions of a group whose walks a block owns
constexpr int kCT = 16;  // centers of one context scored at a time
constexpr int kSmemOptIn = 232448;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// the layout of the shared-memory pool in floats, alike on host and device
struct Plan {
  int Dp, off_yin, off_g, off_lab, off_cent, off_misc, off_red, floats;
  __host__ __device__ Plan(int PL, int D, int T) {
    Dp = round_up(D, 4) + 4;
    off_yin = 2 * T * Dp;               // two buffers of T tree rows
    off_g = off_yin + 2 * kCT * Dp;     // two buffers of kCT center rows
    off_lab = off_g + kCT * T;          // g of (center, level)
    off_cent = off_lab + 3 * T;         // three slots of labels
    off_misc = off_cent + 3 * PL;       // three slots of centers
    off_red = off_misc + 7 + 2 * kQ;    // counts, walk starts and ends
    floats = off_red + kWarps;          // the loss's warp sums
  }
  __host__ __device__ int bytes() const { return 4 * floats; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// VEC floats a vector: 4 (16-byte loads) or 1
template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // acc + s * v, element by element
  static __device__ __forceinline__ T axpy(float s, T v, T acc) {
    acc.x = fmaf(s, v.x, acc.x);
    acc.y = fmaf(s, v.y, acc.y);
    acc.z = fmaf(s, v.z, acc.z);
    acc.w = fmaf(s, v.w, acc.w);
    return acc;
  }
  // acc + a * b, element by element (four partial dot products)
  static __device__ __forceinline__ T fma(T a, T b, T acc) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.y = fmaf(a.y, b.y, acc.y);
    acc.z = fmaf(a.z, b.z, acc.z);
    acc.w = fmaf(a.w, b.w, acc.w);
    return acc;
  }
  static __device__ __forceinline__ float sum(T v) {
    return (v.x + v.y) + (v.z + v.w);
  }
  static __device__ __forceinline__ void copy_async(float* s,
                                                    const float* g) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_addr(s)), "l"(g) : "memory");
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T axpy(float s, T v, T acc) {
    return fmaf(s, v, acc);
  }
  static __device__ __forceinline__ T fma(T a, T b, T acc) {
    return fmaf(a, b, acc);
  }
  static __device__ __forceinline__ float sum(T v) { return v; }
  static __device__ __forceinline__ void copy_async(float* s,
                                                    const float* g) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"(smem_addr(s)), "l"(g) : "memory");
  }
};

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
hs_block_grads_kernel(const float* __restrict__ w_in, int64_t ld_in,
                      const float* __restrict__ w_tree, int64_t ld_tree,
                      const int* __restrict__ tok, const int* __restrict__ eff,
                      const int* __restrict__ points,
                      const float* __restrict__ codes,
                      const uint8_t* __restrict__ window_ok,
                      const int64_t* __restrict__ dm, float* d_yin,
                      float* __restrict__ d_tree, float* __restrict__ parts,
                      int PL, int D, int T, int n_slices) {
  using V = Vec<VEC>;
  const Plan plan(PL, D, T);
  const int Dp = plan.Dp, DV = D / VEC;
  extern __shared__ __align__(16) float smem[];
  float* tree = smem;                       // [2][T][Dp]
  float* yin = smem + plan.off_yin;         // [2][kCT][Dp]
  float* gt = smem + plan.off_g;            // [kCT][T]
  float* lab = smem + plan.off_lab;         // [3][T]: 1 - code
  int* cent = reinterpret_cast<int*>(smem + plan.off_cent);  // [3][PL]
  int* misc = reinterpret_cast<int*>(smem + plan.off_misc);
  float* red = smem + plan.off_red;         // [kWarps]
  int* n_cent = misc;                       // [3]
  int* depth = misc + 3;                    // [3]
  int& n_walks = misc[6];
  int* starts = misc + 7;                   // [kQ]
  int* ends = starts + kQ;                  // [kQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x / n_slices;
  const int p0 = (blockIdx.x % n_slices) * kQ;
  const int p1 = min(p0 + kQ, PL);
  const int64_t row0 = (int64_t)g * PL;     // the group's first position
  const int* tk = tok + row0;
  const int* ef = eff + row0;

  // the walks starting in [p0, p1), each to the next start or PL; loss
  // slots of the other positions are zero
  if (warp == 0) {
    int n = 0;
    bool open = false;  // the last walk listed still wants its end
    for (int c = p0; c < PL && (open || c < p1); c += 32) {
      const int p = c + lane;
      unsigned bits = __ballot_sync(0xffffffffu, p < PL && dm[p] == 0);
      for (; bits; bits &= bits - 1) {
        const int q = c + __ffs(bits) - 1;
        if (open) ends[n - 1] = q;
        open = q < p1;
        if (!open) break;
        starts[n++] = q;
      }
    }
    if (open) ends[n - 1] = PL;
    n_walks = n;
  }
  if (tid < p1 - p0 && dm[p0 + tid] != 0) parts[row0 + p0 + tid] = 0.f;
  __syncthreads();

  // context m's centers (warp 0) and its path's depth and labels (warp 1)
  // into slot k
  auto scan = [&](int m, int k, int s, int e) {
    const int tm = tk[m];
    if (warp == 0) {
      int n = 0;
      for (int l0 = s; l0 < e; l0 += 32) {
        const int l = l0 + lane;
        bool ok = false;
        if (tm >= 0 && l < e) {
          const int64_t lm = (int64_t)l * PL + m;
          const int tl = tk[l], el = ef[l];
          const int64_t d = dm[lm];
          const bool w = window_ok[lm] != 0;
          ok = (tl >= 0) & w & (d <= el);
        }
        const unsigned bits = __ballot_sync(0xffffffffu, ok);
        if (ok) cent[k * PL + n + __popc(bits & ((1u << lane) - 1u))] = l;
        n += __popc(bits);
      }
      if (lane == 0) n_cent[k] = n;
    } else if (warp == 1) {  // the levels up to the path's first -1
      int d = 0;
      if (tm >= 0) {
        const int* pts = points + (int64_t)tm * T;
        const float* cd = codes + (int64_t)tm * T;
        d = T;
        for (int t0 = 0; t0 < T; t0 += 32) {
          const int t = t0 + lane;
          bool stop = false;
          if (t < T) {
            stop = pts[t] < 0;
            lab[k * T + t] = 1.f - cd[t];
          }
          const unsigned end = __ballot_sync(0xffffffffu, stop);
          if (end) {
            d = t0 + __ffs(end) - 1;
            break;
          }
        }
      }
      if (lane == 0) depth[k] = d;
    }
  };

  // context m's path rows and its first kCT centers' rows into buffer b,
  // by cp.async (slot k scanned and visible)
  auto fetch = [&](int m, int k, int b) {
    const int tm = tk[m];
    if (tm < 0) return;
    const int* pts = points + (int64_t)tm * T;
    float* dst = tree + b * T * Dp;
    for (int i = tid; i < depth[k] * DV; i += kThreads) {
      const int t = i / DV, v = i - t * DV;
      V::copy_async(dst + t * Dp + v * VEC,
                    w_tree + (int64_t)pts[t] * ld_tree + v * VEC);
    }
    const int tc = min(n_cent[k], kCT);
    dst = yin + b * kCT * Dp;
    for (int i = tid; i < tc * DV; i += kThreads) {
      const int c = i / DV, v = i - c * DV;
      V::copy_async(dst + c * Dp + v * VEC,
                    w_in + (int64_t)tk[cent[k * PL + c]] * ld_in + v * VEC);
    }
  };

  for (int w = 0; w < n_walks; ++w) {
    const int s = starts[w], e = ends[w];
    float loss = 0.f;  // this thread's share of the walk's log-likelihood
    for (int i = tid; i < (e - s) * DV; i += kThreads) {
      const int l = s + i / DV, v = i % DV;
      V::store(d_yin + (row0 + l) * D + v * VEC, V::zero());
    }
    scan(s, 0, s, e);
    __syncthreads();
    fetch(s, 0, 0);
    async_commit();
    for (int m = s; m < e; ++m) {
      const int j = m - s, k = j % 3, b = j & 1;
      if (m + 1 < e) scan(m + 1, (j + 1) % 3, s, e);
      __syncthreads();  // m + 1 scanned; context m - 1's buffers free
      if (m + 1 < e) fetch(m + 1, (j + 1) % 3, b ^ 1);
      async_commit();
      async_wait<1>();  // context m's rows have landed
      __syncthreads();
      const int nc = n_cent[k], dep = depth[k];
      const int* cl = cent + k * PL;
      const float* lb = lab + k * T;
      const float* tr = tree + b * T * Dp;
      float* yb = yin + b * kCT * Dp;
      float* dt = d_tree + (row0 + m) * T * D;
      if (nc == 0) {
        for (int i = tid; i < T * DV; i += kThreads)
          V::store(dt + (i / DV) * D + (i % DV) * VEC, V::zero());
      }
      for (int c0 = 0; c0 < nc; c0 += kCT) {
        const int tc = min(kCT, nc - c0);
        if (c0 > 0) {  // a later tile of centers, loaded here
          __syncthreads();
          for (int i = tid; i < tc * DV; i += kThreads) {
            const int c = i / DV, v = i - c * DV;
            V::store(yb + c * Dp + v * VEC,
                     V::load(w_in + (int64_t)tk[cl[c0 + c]] * ld_in +
                             v * VEC));
          }
          __syncthreads();
        }
        // g of each (center, level)
        for (int i = tid; i < tc * dep; i += kThreads) {
          const int c = i / dep, t = i - c * dep;
          const float* a = yb + c * Dp;
          const float* r = tr + t * Dp;
          typename V::T acc = V::zero();
          for (int v = 0; v < DV; ++v)
            acc = V::fma(V::load(a + v * VEC), V::load(r + v * VEC), acc);
          const float x = V::sum(acc), label = lb[t];
          gt[c * T + t] = label - 1.f / (1.f + expf(-x));
          const float z = label > 0.5f ? x : -x;  // sgn = 2 label - 1
          loss += fminf(z, 0.f) - log1pf(expf(-fabsf(z)));
        }
        __syncthreads();
        // d_tree[m, t] over this tile's centers (rows past the path: 0)
        for (int i = tid; i < T * DV; i += kThreads) {
          const int t = i / DV, v = i - t * DV;
          float* out = dt + t * D + v * VEC;
          if (t >= dep) {
            if (c0 == 0) V::store(out, V::zero());
            continue;
          }
          typename V::T acc = c0 == 0 ? V::zero() : V::load(out);
          for (int c = 0; c < tc; ++c)
            acc = V::axpy(gt[c * T + t], V::load(yb + c * Dp + v * VEC),
                          acc);
          V::store(out, acc);
        }
        // d_yin[l] += the path's rows, level by level
        for (int i = tid; i < tc * DV; i += kThreads) {
          const int c = i / DV, v = i - c * DV;
          float* out = d_yin + (row0 + cl[c0 + c]) * D + v * VEC;
          typename V::T acc = V::load(out);
          for (int t = 0; t < dep; ++t)
            acc = V::axpy(gt[c * T + t], V::load(tr + t * Dp + v * VEC),
                          acc);
          V::store(out, acc);
        }
      }
    }
    async_wait<0>();
    // the walk's loss: warps by a fixed butterfly, then in warp order
    for (int o = 16; o > 0; o >>= 1)
      loss += __shfl_xor_sync(0xffffffffu, loss, o);
    if (lane == 0) red[warp] = loss;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int i = 0; i < kWarps; ++i) sum += red[i];
      parts[row0 + s] = -sum;
    }
    __syncthreads();
  }
}

// the most dynamic shared memory each instantiation has been opted into on
// each device (by ge_prepare_hs, or by the first call that needs more): a
// launch after that makes no host API call but the launch
int smem_set[2][64];

cudaError_t opt_in(bool vec, int device, int smem) {
  int& set = smem_set[vec][device & 63];
  if (smem <= set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      vec ? hs_block_grads_kernel<4> : hs_block_grads_kernel<1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) set = smem;
  return e;
}

}  // namespace

// Once a process and device, before a launch is captured: both
// instantiations opted into the most dynamic shared memory
extern "C" int ge_prepare_hs(int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = opt_in(true, device, kSmemOptIn);
  if (e == cudaSuccess) e = opt_in(false, device, kSmemOptIn);
  return (int)e;
}

extern "C" int ge_hs_block_grads(
    int device, const void* w_in, int64_t ld_in, const void* w_tree,
    int64_t ld_tree, const void* tok, const void* eff, const void* points,
    const void* codes, const void* window_ok, const void* dm, void* d_yin,
    void* d_tree, void* parts, int G, int PL, int D, int T, int vec,
    int smem, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  // smem is the caller's mirror of Plan (ops/hs.py _smem_bytes)
  if (G <= 0 || PL <= 0 || D <= 0 || T <= 0 || smem != Plan(PL, D, T).bytes()
      || smem > kSmemOptIn || (vec && (D % 4 || ld_in % 4 || ld_tree % 4)))
    return (int)cudaErrorInvalidValue;
  e = opt_in(vec != 0, device, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_slices = (PL + kQ - 1) / kQ;
  const dim3 grid((unsigned)G * n_slices), block(kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    hs_block_grads_kernel<4><<<grid, block, smem, s>>>(
        (const float*)w_in, ld_in, (const float*)w_tree, ld_tree,
        (const int*)tok, (const int*)eff, (const int*)points,
        (const float*)codes, (const uint8_t*)window_ok, (const int64_t*)dm,
        (float*)d_yin, (float*)d_tree, (float*)parts, PL, D, T, n_slices);
  else
    hs_block_grads_kernel<1><<<grid, block, smem, s>>>(
        (const float*)w_in, ld_in, (const float*)w_tree, ld_tree,
        (const int*)tok, (const int*)eff, (const int*)points,
        (const float*)codes, (const uint8_t*)window_ok, (const int64_t*)dm,
        (float*)d_yin, (float*)d_tree, (float*)parts, PL, D, T, n_slices);
  return (int)cudaGetLastError();
}
