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
//   d_vn  += g_neg^T . yin   (summed over the r = G / G2 groups that
//                             share one negative set)
//   loss[g] = -(sum log_sigmoid(logits) * mask
//               + sum log_sigmoid(-nlog) * n_pairs * neg_w * neg_ok)
// With r > 1 each group's loss holds its own share of the negative term,
// as the Pallas kernel's does; sums over a sharing group equal the oracle's.
//
// Design. The TPU kernel ran its grid in order and carried d_vn across the
// r grid steps that share it. Thread blocks on Hopper run in no order, so
// one block (CTA) owns one sharing group and loops over its r packing
// groups, summing d_vn in shared memory; nothing carries across blocks.
// The rows of one group (yin, yout, then vn in yout's place), the
// gradient logits and the d_vn sum are staged in dynamic shared memory
// (about 213 KB at PL = 120, D = 128, K = 64), so the [PL, PL] and [PL, K]
// intermediates never go to device memory. The six products run on the
// FP32 CUDA cores from shared memory, each thread holding a small
// register tile. What bounds it: FP32 FMA issue from shared memory
// (about 17 MFLOP per group), with one block per SM because of the shared
// memory it needs; G2 = 84 blocks at the slice's shapes leave 48 of 132
// SMs idle. Tensor cores (wgmma), a TMA pipeline and fusion with the row
// gather and scatter are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kNtM = 4;  // rows of an NT register tile
constexpr int kNtN = 4;  // (strided) columns of an NT register tile
constexpr int kNnM = 8;  // rows of an NN register tile (x one float4)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float log_sigmoid_f(float x) {
  // -softplus(-x), stable for both signs
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// rows x D floats from device memory (row stride ld) into shared memory
// (row stride lds), 16 bytes per load
__device__ void load_rows(float* dst, int lds, const float* src, int64_t ld,
                          int rows, int D) {
  const int q4 = D / 4;
  for (int i = threadIdx.x; i < rows * q4; i += blockDim.x) {
    const int r = i / q4, q = i % q4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + r * ld) + q);
    *reinterpret_cast<float4*>(dst + r * lds + 4 * q) = v;
  }
}

// C[i][j] = sum_d A[i][d] * B[j][d] for i < M, j < N, with A and B in
// shared memory (row stride lds = D + 4). A thread owns rows i0..i0+3 and
// columns j0 + c * nj: neighbouring threads read neighbouring rows of B,
// which the 4-float row padding spreads over all 32 banks.
template <class Epi>
__device__ void nt_product(const float* A, const float* B, int lds, int M,
                           int N, int D, Epi epi) {
  const int tm = (M + kNtM - 1) / kNtM;
  const int nj = (N + kNtN - 1) / kNtN;
  for (int t = threadIdx.x; t < tm * nj; t += blockDim.x) {
    const int i0 = (t / nj) * kNtM, j0 = t % nj;
    const float* a_row[kNtM];
    const float* b_row[kNtN];
#pragma unroll
    for (int r = 0; r < kNtM; ++r) a_row[r] = A + min(i0 + r, M - 1) * lds;
#pragma unroll
    for (int c = 0; c < kNtN; ++c)
      b_row[c] = B + min(j0 + c * nj, N - 1) * lds;
    float acc[kNtM][kNtN];
#pragma unroll
    for (int r = 0; r < kNtM; ++r)
#pragma unroll
      for (int c = 0; c < kNtN; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 a[kNtM], b[kNtN];
#pragma unroll
      for (int r = 0; r < kNtM; ++r)
        a[r] = *reinterpret_cast<const float4*>(a_row[r] + d);
#pragma unroll
      for (int c = 0; c < kNtN; ++c)
        b[c] = *reinterpret_cast<const float4*>(b_row[c] + d);
#pragma unroll
      for (int r = 0; r < kNtM; ++r)
#pragma unroll
        for (int c = 0; c < kNtN; ++c) {
          float s = acc[r][c];
          s = fmaf(a[r].x, b[c].x, s);
          s = fmaf(a[r].y, b[c].y, s);
          s = fmaf(a[r].z, b[c].z, s);
          s = fmaf(a[r].w, b[c].w, s);
          acc[r][c] = s;
        }
    }
#pragma unroll
    for (int r = 0; r < kNtM; ++r) {
      if (i0 + r >= M) continue;
#pragma unroll
      for (int c = 0; c < kNtN; ++c) {
        const int j = j0 + c * nj;
        if (j < N) epi(i0 + r, j, acc[r][c]);
      }
    }
  }
}

// C[i][4q..4q+3] = sum_k A(i, k) * B[k][4q..4q+3] for i < M, k < Kd, with
// A(i, k) = A[i * a_i + k * a_k] (so A may be read transposed) and B in
// shared memory (row stride ldb). A thread owns kNnM rows and one float4
// column; a warp spans neighbouring columns, so its B loads are contiguous
// and its A loads broadcast. The same (M, D) always maps an element to the
// same thread, which lets callers accumulate in place without a barrier.
template <class Epi>
__device__ void nn_product(const float* A, int a_i, int a_k, const float* B,
                           int ldb, int M, int Kd, int D, Epi epi) {
  const int q4 = D / 4;
  const int tm = (M + kNnM - 1) / kNnM;
  for (int t = threadIdx.x; t < tm * q4; t += blockDim.x) {
    const int i0 = (t / q4) * kNnM, q = t % q4;
    int a_off[kNnM];
#pragma unroll
    for (int r = 0; r < kNnM; ++r) a_off[r] = min(i0 + r, M - 1) * a_i;
    float4 acc[kNnM];
#pragma unroll
    for (int r = 0; r < kNnM; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < Kd; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + 4 * q);
#pragma unroll
      for (int r = 0; r < kNnM; ++r) {
        const float a = A[a_off[r] + k * a_k];
        acc[r].x = fmaf(a, b.x, acc[r].x);
        acc[r].y = fmaf(a, b.y, acc[r].y);
        acc[r].z = fmaf(a, b.z, acc[r].z);
        acc[r].w = fmaf(a, b.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < kNnM; ++r)
      if (i0 + r < M) epi(i0 + r, q, acc[r]);
  }
}

__device__ __forceinline__ void add4(float4* p, float4 v) {
  float4 o = *p;
  o.x += v.x;
  o.y += v.y;
  o.z += v.z;
  o.w += v.w;
  *p = o;
}

__global__ void __launch_bounds__(kThreads, 1)
sgns_block_grads_kernel(const float* __restrict__ yin, int64_t ld_yin,
                        const float* __restrict__ yout, int64_t ld_yout,
                        const float* __restrict__ vn, int64_t ld_vn,
                        const float* __restrict__ mask,
                        const float* __restrict__ neg_ok,
                        float* __restrict__ d_yin, float* __restrict__ d_yout,
                        float* __restrict__ d_vn, float* __restrict__ loss,
                        int r, int PL, int D, int K, float neg_w) {
  extern __shared__ __align__(16) float smem[];
  const int lds = D + 4;
  const int mk = max(PL, K);
  float* s_yin = smem;                        // [PL][lds]
  float* s_yb = s_yin + PL * lds;             // [mk][lds]: yout, then vn
  float* s_g = s_yb + mk * lds;               // g_pos [PL][PL] / g_neg [PL][K]
  float* s_dvn = s_g + round4(PL * mk);       // [K][D]
  float* s_np = s_dvn + K * D;                // [PL] n_pairs
  float* s_red = s_np + round4(PL);           // [32] loss partials

  const int g2 = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < K * D; i += blockDim.x) s_dvn[i] = 0.f;

  for (int j = 0; j < r; ++j) {
    const int64_t g = (int64_t)g2 * r + j;
    load_rows(s_yin, lds, yin + g * PL * ld_yin, ld_yin, PL, D);
    load_rows(s_yb, lds, yout + g * PL * ld_yout, ld_yout, PL, D);
    const float* mask_g = mask + g * PL * PL;
    for (int i = warp; i < PL; i += nwarps) {
      float s = 0.f;
      for (int m = lane; m < PL; m += 32) s += mask_g[(int64_t)i * PL + m];
      s = warp_sum(s);
      if (lane == 0) s_np[i] = s;
    }
    __syncthreads();

    float part = 0.f;  // this thread's share of -loss[g]
    nt_product(s_yin, s_yb, lds, PL, PL, D, [&](int i, int m, float x) {
      const float mv = mask_g[(int64_t)i * PL + m];
      s_g[i * PL + m] = (sigmoid_f(x) - 1.f) * mv;
      if (mv > 0.f) part += log_sigmoid_f(x) * mv;
    });
    __syncthreads();

    float* dyin_g = d_yin + g * PL * D;
    float* dyout_g = d_yout + g * PL * D;
    nn_product(s_g, PL, 1, s_yb, lds, PL, PL, D, [&](int i, int q, float4 v) {
      reinterpret_cast<float4*>(dyin_g + (int64_t)i * D)[q] = v;
    });
    nn_product(s_g, 1, PL, s_yin, lds, PL, PL, D, [&](int m, int q, float4 v) {
      reinterpret_cast<float4*>(dyout_g + (int64_t)m * D)[q] = v;
    });
    __syncthreads();

    load_rows(s_yb, lds, vn + (int64_t)g2 * K * ld_vn, ld_vn, K, D);
    __syncthreads();

    const float* ok_g = neg_ok + g * PL * K;  // this group's [PL, K] slice
    nt_product(s_yin, s_yb, lds, PL, K, D, [&](int i, int k, float x) {
      const float w = s_np[i] * neg_w * ok_g[(int64_t)i * K + k];
      s_g[i * K + k] = sigmoid_f(x) * w;
      part += log_sigmoid_f(-x) * w;
    });
    __syncthreads();

    // the same thread wrote these d_yin elements above: no barrier needed
    nn_product(s_g, K, 1, s_yb, lds, PL, K, D, [&](int i, int q, float4 v) {
      add4(reinterpret_cast<float4*>(dyin_g + (int64_t)i * D) + q, v);
    });
    nn_product(s_g, 1, K, s_yin, lds, K, PL, D, [&](int k, int q, float4 v) {
      add4(reinterpret_cast<float4*>(s_dvn + k * D) + q, v);
    });

    part = warp_sum(part);
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += s_red[w];
      loss[g] = -s;
    }
  }
  __syncthreads();
  float4* dvn_g = reinterpret_cast<float4*>(d_vn + (int64_t)g2 * K * D);
  for (int i = tid; i < K * D / 4; i += blockDim.x)
    dvn_g[i] = reinterpret_cast<const float4*>(s_dvn)[i];
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
  if (G2 <= 0 || G % G2 != 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(sgns_block_grads_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sgns_block_grads_kernel<<<G2, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)yin, ld_yin, (const float*)yout, ld_yout,
      (const float*)vn, ld_vn, (const float*)mask, (const float*)neg_ok,
      (float*)d_yin, (float*)d_yout, (float*)d_vn, (float*)loss, G / G2, PL,
      D, K, neg_w);
  return (int)cudaGetLastError();
}
