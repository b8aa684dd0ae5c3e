// K1: batched small-K factor-solve-sample for the Lambda update.
//
// Replaces dcfm_tpu/ops/pallas_gaussian.py::_chol_sample_kernel.  For B
// independent SPD precisions Q_j (K x K, K <= 16, row-major (B, K, K)
// float32) with linear terms b_j and standard normals z_j (both (B, K)),
// it returns x_j = Q_j^{-1} b_j + L_j^{-T} z_j, L_j the lower Cholesky
// factor of Q_j (Rue 2001): L v = b, L' m = v, L' y = z, x = m + y.
//
// Operation order is the TPU kernel's: division by L_jj in the Cholesky
// and in the forward solve, multiplication by 1/L_jj in the two backward
// solves, the t-sums accumulated in increasing t.
//
// Bound: device-memory bytes.  At the full-width Lambda update (B = 10,048
// rows, K = 8) one call moves 10,048 * (64 + 3 * 8) * 4 B = 3.5 MB - about
// 1 us at 3.35 TB/s - against ~4 MFLOP, so launch overhead (several us)
// dominates, not arithmetic.  What the design does about it: one launch
// per sweep over ALL shards' rows (the caller flattens (g, P) into B), one
// thread per system so the K-deep recurrence runs in registers and shared
// memory and nothing but the inputs and the output touches device memory,
// and Q is staged through shared memory by the whole block in one
// coalesced sweep (a thread's own Q is K*K floats apart from its
// neighbour's, so direct per-thread loads would not coalesce).  The
// factor is formed in place in the staged tile, which keeps register use
// flat in K (K = 16 would need 136 registers for L alone); the tile row
// stride K*K + 1 is odd, so the threads of a warp hit distinct banks.
// Launch overhead itself is left to a later change (CUDA graphs).

#include <cuda_runtime.h>

namespace {

template <int K, int T>
__global__ void __launch_bounds__(T)
chol_sample_kernel(const float* __restrict__ q, const float* __restrict__ b,
                   const float* __restrict__ z, float* __restrict__ out,
                   long long n) {
  constexpr int KK = K * K;
  constexpr int S = KK + 1;
  __shared__ float tile[T * S];

  const long long first = static_cast<long long>(blockIdx.x) * T;
  const long long left = n - first;
  const int count = left < T ? static_cast<int>(left) : T;

  // coalesced staging of this block's count * K * K contiguous floats
  const float* src = q + first * KK;
  for (int e = threadIdx.x; e < count * KK; e += T) {
    const int s = e / KK;
    tile[s * S + (e - s * KK)] = src[e];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= count) return;
  float* a = tile + t * S;          // a[i * K + j] = Q[i][j]; L overwrites
                                    // the lower triangle column by column

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

  const long long row = first + t;
  const float* bj = b + row * K;
  const float* zj = z + row * K;

  // ---- forward solve L v = b --------------------------------------------
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float acc = bj[j];
#pragma unroll
    for (int u = 0; u < j; ++u) acc = acc - a[j * K + u] * v[u];
    v[j] = acc / a[j * K + j];
  }

  // ---- the two backward solves L' m = v and L' y = z, fused ---------------
  float m[K], y[K];
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    float acc_m = v[j];
    float acc_y = zj[j];
#pragma unroll
    for (int i = j + 1; i < K; ++i) {
      const float lij = a[i * K + j];
      acc_m = acc_m - lij * m[i];
      acc_y = acc_y - lij * y[i];
    }
    const float inv = 1.0f / a[j * K + j];
    m[j] = acc_m * inv;
    y[j] = acc_y * inv;
  }

  float* oj = out + row * K;
#pragma unroll
  for (int j = 0; j < K; ++j) oj[j] = m[j] + y[j];
}

template <int K>
cudaError_t launch(const float* q, const float* b, const float* z, float* out,
                   long long n, cudaStream_t stream) {
  // block width: the staged tile stays under the 48 KB static shared
  // memory limit at every K (K = 16: 32 * 257 * 4 B = 32.9 KB), and at the
  // full-width K = 8 batch the 157 blocks cover all 132 SMs
  constexpr int T = K <= 8 ? 64 : 32;
  const long long blocks = (n + T - 1) / T;
  chol_sample_kernel<K, T><<<static_cast<unsigned int>(blocks), T, 0, stream>>>(
      q, b, z, out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dcfm_chol_sample(const void* q, const void* b, const void* z,
                                void* out, long long n, int k, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* bf = static_cast<const float*>(b);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 0x7fffffffLL * 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch<1>(qf, bf, zf, of, n, st);
    case 2: return launch<2>(qf, bf, zf, of, n, st);
    case 3: return launch<3>(qf, bf, zf, of, n, st);
    case 4: return launch<4>(qf, bf, zf, of, n, st);
    case 5: return launch<5>(qf, bf, zf, of, n, st);
    case 6: return launch<6>(qf, bf, zf, of, n, st);
    case 7: return launch<7>(qf, bf, zf, of, n, st);
    case 8: return launch<8>(qf, bf, zf, of, n, st);
    case 9: return launch<9>(qf, bf, zf, of, n, st);
    case 10: return launch<10>(qf, bf, zf, of, n, st);
    case 11: return launch<11>(qf, bf, zf, of, n, st);
    case 12: return launch<12>(qf, bf, zf, of, n, st);
    case 13: return launch<13>(qf, bf, zf, of, n, st);
    case 14: return launch<14>(qf, bf, zf, of, n, st);
    case 15: return launch<15>(qf, bf, zf, of, n, st);
    case 16: return launch<16>(qf, bf, zf, of, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* dcfm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
