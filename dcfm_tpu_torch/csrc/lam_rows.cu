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
// in the kernel and draws x_j = Q_j^{-1} b_j + L_j^{-T} z_j with the
// lane-group recurrence of K1 (chol_group.cuh::chol_group_solve,
// multiplication by 1/L_jj in the backward solves).  The TPU kernel's order
// is kept: the product ps_j E_iu first, then the diagonal's + plam_i, and
// b_i = ps_j ey_i, each rounded on its own (__fmul_rn / __fadd_rn are never
// contracted into an FMA).  Inputs E (G, K, K), plam, ey, z and the output
// (G, P, K), ps (G, P), all row-major float32, K <= 16.
//
// Bound: device-memory bytes.  At full width (G = 64, P = 157, K = 8) a
// call reads G P (3K + 1) + G K^2 floats and writes G P K: 1.34 MB, 0.40
// us at 3.35 TB/s.  The (G P, K, K) precision tensor (2.57 MB) that K1 is
// handed is never written, and neither are the diag_embed and broadcast
// add that would form it.
//
// Design: one group of W >= K lanes per loading row, over a flat grid of
// all G P rows (the fit's 10,048 rows are exactly 628 blocks of 16
// groups, 80,384 threads).  Lane i of a group owns row i of Q_j: it reads
// ps_j (one address for the whole group), plam_ji, ey_ji and z_ji (32
// contiguous bytes a group at K = 8, 128 a warp) and row i of E_g, and
// forms its row of Q_j and b_ji in registers.  Only the entries u <= i of
// a lane's row reach the result, so E's upper triangle is never used
// (under bf16 moments E need not be symmetric to the last bit).  Idle
// lanes (i >= K) and groups past the last row carry an identity row, run
// every shuffle and store nothing; no lane returns early.  Tensor cores
// and TMA do not apply: each row is a K <= 16 serial recurrence with no
// product to put on wgmma, and rows of 32 bytes gain nothing from a TMA
// descriptor.  The launch uses static shared memory only, allocates
// nothing and does not synchronise, so it can be captured in a CUDA graph.

#include "chol_group.cuh"

namespace {

using dcfm::group_tile_stride;
using dcfm::group_width;

template <int K, int T, bool VEC>
__global__ void __launch_bounds__(T)
lam_rows_kernel(const float* __restrict__ e, const float* __restrict__ plam,
                const float* __restrict__ ps, const float* __restrict__ eyt,
                const float* __restrict__ z, float* __restrict__ out,
                long long rows, int p) {
  constexpr int W = group_width(K);
  constexpr int G = T / W;                      // rows per block
  constexpr int GS = group_tile_stride(W);
  static_assert(T % 32 == 0 && K >= 1 && K <= 16, "shape");
  static_assert(!VEC || K % 4 == 0, "float4 rows of E need K % 4 == 0");
  __shared__ float tile[K > 1 ? G * GS : 1];

  const int lane = static_cast<int>(threadIdx.x) % W;   // the row it owns
  const int grp = static_cast<int>(threadIdx.x) / W;
  const long long row = static_cast<long long>(blockIdx.x) * G + grp;
  const bool live = row < rows && lane < K;

  float r[K];                 // row `lane` of Q_j, then of L (lower part)
  float acc_b = 0.0f, acc_z = 0.0f;
  if (live) {
    const float w = ps[row];
    const float pl = plam[row * K + lane];
    const float ey = eyt[row * K + lane];
    acc_z = z[row * K + lane];
    // the row's shard; 32-bit division where the batch allows it (64-bit
    // is a subroutine)
    const long long shard = rows <= 0x7fffffffLL
        ? static_cast<unsigned int>(row) / static_cast<unsigned int>(p)
        : row / p;
    const float* src = e + (shard * K + lane) * K;
    float er[K];
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < K; u += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + u);
        er[u] = v.x;
        er[u + 1] = v.y;
        er[u + 2] = v.z;
        er[u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < K; ++u) er[u] = src[u];
    }
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const float s = __fmul_rn(w, er[u]);
      r[u] = u == lane ? __fadd_rn(s, pl) : s;
    }
    acc_b = __fmul_rn(w, ey);
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u) r[u] = u == lane ? 1.0f : 0.0f;
  }

  const float x = dcfm::chol_group_solve<K, false, true>(
      r, acc_b, acc_z, lane, tile + grp * GS);
  if (live) out[row * K + lane] = x;
}

template <int K>
cudaError_t launch(const float* e, const float* plam, const float* ps,
                   const float* eyt, const float* z, float* out,
                   long long rows, int p, cudaStream_t stream) {
  constexpr int T = dcfm::kGroupBlock;
  constexpr int G = T / group_width(K);
  const unsigned int blocks = static_cast<unsigned int>((rows + G - 1) / G);
  bool vec = false;
  if constexpr (K % 4 == 0)
    vec = (reinterpret_cast<std::uintptr_t>(e) & 15) == 0;
  if (vec)
    lam_rows_kernel<K, T, K % 4 == 0>
        <<<blocks, T, 0, stream>>>(e, plam, ps, eyt, z, out, rows, p);
  else
    lam_rows_kernel<K, T, false>
        <<<blocks, T, 0, stream>>>(e, plam, ps, eyt, z, out, rows, p);
  return cudaGetLastError();
}

}  // namespace

// G * P rows in one launch, at most dcfm::kMaxSystems of them (the grid's
// 2^31 - 1 blocks of 8 rows at the widest group) with P < 2^31; more, or K
// outside 1..16, is cudaErrorInvalidValue.
extern "C" int dcfm_lam_rows(const void* e, const void* plam, const void* ps,
                             const void* eyt, const void* z, void* out,
                             long long g, long long p, int k, void* stream) {
  const float* ef = static_cast<const float*>(e);
  const float* lf = static_cast<const float*>(plam);
  const float* pf = static_cast<const float*>(ps);
  const float* yf = static_cast<const float*>(eyt);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g <= 0 || p <= 0 || p > 0x7fffffffLL || g > dcfm::kMaxSystems / p)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
#define DCFM_CASE(KV) \
    case KV: return static_cast<int>(launch<KV>(ef, lf, pf, yf, zf, of, g * p, static_cast<int>(p), st));
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
    DCFM_CASE(5) DCFM_CASE(6) DCFM_CASE(7) DCFM_CASE(8)
    DCFM_CASE(9) DCFM_CASE(10) DCFM_CASE(11) DCFM_CASE(12)
    DCFM_CASE(13) DCFM_CASE(14) DCFM_CASE(15) DCFM_CASE(16)
#undef DCFM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
