// K2: the fused Lambda update ("pallas-fused").
//
// Replaces dcfm_tpu/ops/pallas_gaussian.py::_lam_rows_kernel (wrapper
// lam_update_pallas).  For G shards of P loading rows each, with the
// shard's factor cross-moment E_g (K x K), the row's prior precisions
// plam_j (K), residual precision ps_j, data term ey_j = ((eta'Y)')_j (K)
// and standard normals z_j (K), it forms
//
//   Q_j = diag(plam_j) + ps_j E_g,   b_j = ps_j ey_j
//
// in the kernel and draws x_j = Q_j^{-1} b_j + L_j^{-T} z_j with K1's
// recurrence (chol_recurrence.cuh, multiplication by 1/L_jj in the
// backward solves).  The TPU kernel's order is kept: the diagonal is
// ps_j E_jj + plam_j, b is ps_j ey_j.  Inputs E (G, K, K), plam, ey, z and
// the output (G, P, K), ps (G, P), all row-major float32, K <= 16.
//
// Bound: device-memory bytes.  At full width (G = 64, P = 157, K = 8) a
// call reads G P (3K + 1) + G K^2 floats and writes G P K: 1.34 MB, 0.40
// us at 3.35 TB/s.  The (G P, K, K) precision tensor (2.57 MB) that K1 is
// handed is never written, and neither are the diag_embed and broadcast
// add that would form it.  Design: a grid over (row tile, shard), so the
// rows of a block share one E; the block stages that E (under 1 KB) into
// shared memory once, and every thread reads it as a broadcast.  Each
// thread writes the lower triangle of its own Q into its shared-memory
// tile and factors it in place.  The ragged last tile of a shard is
// masked, not padded.  (On the TPU the kernel lost to K1 because
// broadcasting the shard-constant E across vector lanes cost ~35 us a grid
// step; a shared-memory broadcast read has no such cost.)

#include "chol_recurrence.cuh"

namespace {

template <int K, int T>
__global__ void __launch_bounds__(T)
lam_rows_kernel(const float* __restrict__ e, const float* __restrict__ plam,
                const float* __restrict__ ps, const float* __restrict__ eyt,
                const float* __restrict__ z, float* __restrict__ out, int p) {
  constexpr int KK = K * K;
  constexpr int S = KK + 1;
  __shared__ float es[KK];
  __shared__ float tile[T * S];

  const long long g = blockIdx.y;
  for (int i = threadIdx.x; i < KK; i += T) es[i] = e[g * KK + i];
  __syncthreads();

  const int r = blockIdx.x * T + threadIdx.x;
  if (r >= p) return;
  const long long row = g * p + r;
  const float w = ps[row];
  float* a = tile + threadIdx.x * S;
  float bv[K], zv[K], x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int i = j + 1; i < K; ++i) a[i * K + j] = w * es[i * K + j];
    a[j * K + j] = w * es[j * K + j] + plam[row * K + j];
    bv[j] = w * eyt[row * K + j];
    zv[j] = z[row * K + j];
  }
  dcfm::factor_solve<K, false, true>(a, bv, zv, x);
#pragma unroll
  for (int j = 0; j < K; ++j) out[row * K + j] = x[j];
}

template <int K>
cudaError_t launch(const float* e, const float* plam, const float* ps,
                   const float* eyt, const float* z, float* out, int g, int p,
                   cudaStream_t stream) {
  // 32 rows a block: a shard's P = 157 rows fill 5 tiles with 3 idle
  // threads; the tile is 32 * 257 * 4 B = 32.9 KB at K = 16
  constexpr int T = 32;
  const dim3 grid(static_cast<unsigned int>((p + T - 1) / T),
                  static_cast<unsigned int>(g));
  lam_rows_kernel<K, T><<<grid, T, 0, stream>>>(e, plam, ps, eyt, z, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dcfm_lam_rows(const void* e, const void* plam, const void* ps,
                             const void* eyt, const void* z, void* out,
                             int g, int p, int k, void* stream) {
  const float* ef = static_cast<const float*>(e);
  const float* lf = static_cast<const float*>(plam);
  const float* pf = static_cast<const float*>(ps);
  const float* yf = static_cast<const float*>(eyt);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g <= 0 || p <= 0 || g > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
#define DCFM_CASE(KV) \
    case KV: return static_cast<int>(launch<KV>(ef, lf, pf, yf, zf, of, g, p, st));
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
    DCFM_CASE(5) DCFM_CASE(6) DCFM_CASE(7) DCFM_CASE(8)
    DCFM_CASE(9) DCFM_CASE(10) DCFM_CASE(11) DCFM_CASE(12)
    DCFM_CASE(13) DCFM_CASE(14) DCFM_CASE(15) DCFM_CASE(16)
#undef DCFM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
