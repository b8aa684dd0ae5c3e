// The one-thread-per-system K x K factor-solve(-sample) recurrence of K2
// (lam_rows.cu) and K3 (batched_solve.cu).  K1 and K4 run the lane-group
// design of chol_group.cuh instead.
//
// One thread owns one SPD system.  Its precision Q sits row-major in a
// per-thread tile of shared memory (a[i * K + j] = Q[i][j]); the lower
// Cholesky factor L overwrites the lower triangle column by column, which
// keeps register use flat in K (K = 16 would need 136 registers for L
// alone).  The callers give every thread a tile of K * K + 1 floats: the
// stride is odd, so the 32 threads of a warp hit 32 distinct banks.
//
// Operation order is the TPU kernels': division by L_jj in the Cholesky
// and in the forward solve, the t-sums accumulated in increasing t, and
// in the backward solves either multiplication by 1/L_jj
// (dcfm_tpu/ops/pallas_gaussian.py, K2) or division by L_jj
// (dcfm_tpu/ops/batched_solve.py, K3) - the DIV_BWD flag.  NOISE adds the
// draw L' y = z to the mean (K2); without it the result is the solve
// x = Q^{-1} b alone (K3).

#pragma once

#include <cuda_runtime.h>

namespace dcfm {

template <int K, bool DIV_BWD, bool NOISE>
__device__ __forceinline__ void factor_solve(float* a, const float (&b)[K],
                                             const float (&z)[K],
                                             float (&x)[K]) {
  // ---- Cholesky, column j from the columns before it ------------------
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int i = j; i < K; ++i) {
      float s = a[i * K + j];
#pragma unroll
      for (int u = 0; u < j; ++u) s = s - a[i * K + u] * a[j * K + u];
      a[i * K + j] = s;
    }
    const float d = sqrtf(a[j * K + j]);
    a[j * K + j] = d;
#pragma unroll
    for (int i = j + 1; i < K; ++i) a[i * K + j] = a[i * K + j] / d;
  }

  // ---- forward solve L v = b --------------------------------------------
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float acc = b[j];
#pragma unroll
    for (int u = 0; u < j; ++u) acc = acc - a[j * K + u] * v[u];
    v[j] = acc / a[j * K + j];
  }

  // ---- backward solves L' m = v (and L' y = z), fused ---------------------
  float m[K], y[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float acc_m = v[j];
    float acc_y = z[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      const float lij = a[i * K + j];
      acc_m = acc_m - lij * m[i];
      if constexpr (NOISE) acc_y = acc_y - lij * y[i];
    }
    const float d = a[j * K + j];
    if constexpr (DIV_BWD) {
      m[j] = acc_m / d;
      y[j] = acc_y / d;
    } else {
      const float inv = 1.0f / d;
      m[j] = acc_m * inv;
      y[j] = acc_y * inv;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if constexpr (NOISE) x[j] = m[j] + y[j];
    else x[j] = m[j];
  }
}

// B independent systems: Q (B, K, K), b and z (B, K), out (B, K), all
// row-major float32.  The block stages its rows' Q tiles through shared
// memory in one coalesced sweep (a thread's own Q is K * K floats apart
// from its neighbour's, so direct per-thread loads would not coalesce).
template <int K, int T, bool DIV_BWD, bool NOISE>
__global__ void __launch_bounds__(T)
solve_kernel(const float* __restrict__ q, const float* __restrict__ b,
             const float* __restrict__ z, float* __restrict__ out,
             long long n) {
  constexpr int KK = K * K;
  constexpr int S = KK + 1;
  __shared__ float tile[T * S];

  const long long first = static_cast<long long>(blockIdx.x) * T;
  const long long left = n - first;
  const int count = left < T ? static_cast<int>(left) : T;

  const float* src = q + first * KK;
  for (int e = threadIdx.x; e < count * KK; e += T) {
    const int s = e / KK;
    tile[s * S + (e - s * KK)] = src[e];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= count) return;
  const long long row = first + t;
  float bv[K], zv[K], x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bv[j] = b[row * K + j];
    if constexpr (NOISE) zv[j] = z[row * K + j];
    else zv[j] = 0.0f;
  }
  factor_solve<K, DIV_BWD, NOISE>(tile + t * S, bv, zv, x);
#pragma unroll
  for (int j = 0; j < K; ++j) out[row * K + j] = x[j];
}

template <int K, bool DIV_BWD, bool NOISE>
cudaError_t launch_solve(const float* q, const float* b, const float* z,
                         float* out, long long n, cudaStream_t stream) {
  // block width: the staged tile stays under the 48 KB static shared
  // memory limit at every K (K = 16: 32 * 257 * 4 B = 32.9 KB), and at the
  // full-width K = 8 batch (B = 10,048) the 157 blocks cover all 132 SMs
  constexpr int T = K <= 8 ? 64 : 32;
  const long long blocks = (n + T - 1) / T;
  solve_kernel<K, T, DIV_BWD, NOISE>
      <<<static_cast<unsigned int>(blocks), T, 0, stream>>>(q, b, z, out, n);
  return cudaGetLastError();
}

// The K = 1..16 dispatch of one variant; any other K, or a batch too large
// for the grid, is cudaErrorInvalidValue.
template <bool DIV_BWD, bool NOISE>
int dispatch_solve(const void* q, const void* b, const void* z, void* out,
                   long long n, int k, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* bf = static_cast<const float*>(b);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 0x7fffffffLL * 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
#define DCFM_CASE(KV) \
    case KV: return static_cast<int>(launch_solve<KV, DIV_BWD, NOISE>(qf, bf, zf, of, n, st));
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
    DCFM_CASE(5) DCFM_CASE(6) DCFM_CASE(7) DCFM_CASE(8)
    DCFM_CASE(9) DCFM_CASE(10) DCFM_CASE(11) DCFM_CASE(12)
    DCFM_CASE(13) DCFM_CASE(14) DCFM_CASE(15) DCFM_CASE(16)
#undef DCFM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dcfm
