// The K x K factor-solve(-sample) of K1, K4, K3 and K2: one lane group per
// system.
//
// x = Q^{-1} b + L^{-T} z for B independent SPD precisions Q (K x K,
// K <= 16, float32), L the lower Cholesky factor of Q: L v = b, L' m = v,
// L' y = z, x = m + y (without SAMPLE, x = m alone).  One recurrence,
// chol_group_solve, and three loaders: chol_group_kernel below reads Q
// (B, K, K) from device memory (K1, K4 and, without SAMPLE, K3);
// lam_rows.cu forms each row of Q in registers (K2).
//
// Layout.  Each system gets a group of W lanes, W the power of two >= K
// (1, 2, 4, 8 or 16), so a warp holds 32 / W systems.  Lane i owns row i:
// it loads Q's row i straight into registers (float4 loads when K % 4 == 0
// and Q is 16-byte aligned; at K = 8 the four systems of a warp read 1 KB
// of contiguous memory), and b_i and z_i.  Every value that crosses lanes
// goes through __shfl_sync with width W, so nothing crosses into a
// neighbour's group: a NaN or non-SPD system poisons its own row of the
// output and no other.  Lanes k >= K of a group and groups past the end of
// the batch carry an identity row, execute every shuffle and write nothing.
//
// Arithmetic order.  Every entry sees the TPU kernels' operation sequence:
// the Cholesky is written right-looking (after column u is final, every
// lane subtracts L_iu L_ju from its entries j > u), which subtracts the
// products of each entry in increasing u, as the left-looking TPU loop
// does, with division by L_jj.  The forward solve rides along as an extra
// column (at step u, v_u = acc_u / L_uu is broadcast and lanes i > u
// subtract L_iu v_u), again in increasing u, so its dependent chain
// overlaps the factorization's; lane u's acc_u / L_uu and the other lanes'
// Q_iu / L_uu are one division instruction.  That matters because the
// kernels are bound by instruction throughput, not by memory or by the
// chain's latency: at the fit's batch every SM holds ~19 warps of 500 to
// 750 instructions each at K = 8, and an IEEE float32 division or square
// root is ~10 of them.  The two backward solves run by columns
// in descending order (lane i forms m_i and y_i and broadcasts both, lanes
// j < i subtract L_ij m_i and L_ij y_i), so their sums run in decreasing i
// where the TPU kernels' run in increasing i: a change of float32 rounding
// only.  They need column j of L in lane j: L is transposed once through a
// small per-group shared-memory tile (rows of W + 1 floats, groups W banks
// apart, so both the row stores and the column loads are free of bank
// conflicts).  DIV_BWD divides by L_jj in the backward solves (K4 and K3,
// dcfm_tpu/ops/batched_solve.py); without it they multiply by 1/L_jj (K1
// and K2, dcfm_tpu/ops/pallas_gaussian.py).
//
// Each launch uses static shared memory only, allocates nothing and does
// not synchronise, so it can be captured in a CUDA graph.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dcfm {

constexpr unsigned kFullMask = 0xffffffffu;

// lanes per system: the power of two >= k
__host__ __device__ constexpr int group_width(int k) {
  return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
}

// floats per group tile: W rows of W + 1, rounded up to W modulo the 32
// banks, so that the 32 / W groups of a warp fall on disjoint banks
__host__ __device__ constexpr int group_tile_stride(int w) {
  int s = w * (w + 1);
  while (s % 32 != w % 32) ++s;
  return s;
}

// Everything after the loads: the recurrence on one system whose row `lane`
// the calling lane holds in r (entries u <= lane are read, the rest are
// carried along and never reach the result), with b_lane in acc_b and
// z_lane in acc_z.  `mine` is the group's transpose tile (unused at K = 1).
// Returns x_lane.  Every lane of the warp must call it: it shuffles with
// the full mask.  Without SAMPLE the y chain and acc_z drop out and the
// result is the plain solve x = Q^{-1} b.
template <int K, bool DIV_BWD, bool SAMPLE>
__device__ __forceinline__ float chol_group_solve(float (&r)[K], float acc_b,
                                                  float acc_z, const int lane,
                                                  float* mine) {
  constexpr int W = group_width(K);
  constexpr int RS = W + 1;                     // tile row stride

  // ---- Cholesky with the forward solve L v = b as an extra column: once
  // column u of L is final, v_u = acc_u / L_uu and lanes i > u subtract
  // L_iu v_u, then the trailing update of Q.  One division a step serves
  // both: lane u divides its acc_u, lanes i > u their Q_iu ---------------
  float dg = 1.0f;            // L_{lane, lane}
  float v = 0.0f;             // v_lane
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const float d = sqrtf(__shfl_sync(kFullMask, r[u], u, W));
    const float q = (lane == u ? acc_b : r[u]) / d;
    r[u] = lane == u ? d : (lane > u ? q : r[u]);
    if (lane == u) {
      dg = d;
      v = q;
    }
    const float vu = __shfl_sync(kFullMask, q, u, W);
    if (lane > u) acc_b = acc_b - q * vu;
#pragma unroll
    for (int j = u + 1; j < K; ++j)
      r[j] = r[j] - r[u] * __shfl_sync(kFullMask, r[u], j, W);
  }

  // ---- transpose L within the group: c[t] = L_{t, lane} for t > lane ----
  float c[K];
  if constexpr (K > 1) {
#pragma unroll
    for (int u = 0; u < K; ++u) mine[lane * RS + u] = r[u];
    __syncwarp();
#pragma unroll
    for (int t = 0; t < K; ++t) c[t] = mine[t * RS + lane];
  }

  // ---- backward solves L' m = v and L' y = z, fused, by columns ----------
  float am = v, ay = acc_z;
  const float inv = 1.0f / dg;
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    float mt, yt = 0.0f;
    if constexpr (DIV_BWD) {
      mt = am / dg;
      if constexpr (SAMPLE) yt = ay / dg;
    } else {
      mt = am * inv;
      if constexpr (SAMPLE) yt = ay * inv;
    }
    mt = __shfl_sync(kFullMask, mt, t, W);
    if constexpr (SAMPLE) yt = __shfl_sync(kFullMask, yt, t, W);
    if (lane < t) {
      am = am - c[t] * mt;
      if constexpr (SAMPLE) ay = ay - c[t] * yt;
    }
  }
  if constexpr (!SAMPLE) return DIV_BWD ? am / dg : am * inv;
  else if constexpr (DIV_BWD) return am / dg + ay / dg;
  else return am * inv + ay * inv;
}

// The loader of K1, K4 and K3: Q (n, K, K), b and z (n, K) from device
// memory (z is not read without SAMPLE).
template <int K, int T, bool DIV_BWD, bool SAMPLE, bool VEC>
__global__ void __launch_bounds__(T)
chol_group_kernel(const float* __restrict__ q, const float* __restrict__ b,
                  const float* __restrict__ z, float* __restrict__ out,
                  long long n) {
  constexpr int W = group_width(K);
  constexpr int G = T / W;                      // systems per block
  constexpr int GS = group_tile_stride(W);      // tile stride per group
  static_assert(T % 32 == 0 && K >= 1 && K <= 16, "shape");
  static_assert(!VEC || K % 4 == 0, "float4 rows need K % 4 == 0");
  __shared__ float tile[K > 1 ? G * GS : 1];

  const int lane = static_cast<int>(threadIdx.x) % W;   // the row it owns
  const int grp = static_cast<int>(threadIdx.x) / W;
  const long long sys = static_cast<long long>(blockIdx.x) * G + grp;
  const bool live = sys < n && lane < K;

  float r[K];                 // row `lane` of Q, then of L (lower part)
  float acc_b = 0.0f, acc_z = 0.0f;
  if (live) {
    const float* row = q + (sys * K + lane) * K;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < K; u += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + u);
        r[u] = v.x;
        r[u + 1] = v.y;
        r[u + 2] = v.z;
        r[u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < K; ++u) r[u] = row[u];
    }
    acc_b = b[sys * K + lane];
    if constexpr (SAMPLE) acc_z = z[sys * K + lane];
  } else {
#pragma unroll
    for (int u = 0; u < K; ++u) r[u] = u == lane ? 1.0f : 0.0f;
  }

  const float x = chol_group_solve<K, DIV_BWD, SAMPLE>(
      r, acc_b, acc_z, lane, tile + grp * GS);
  if (live) out[sys * K + lane] = x;
}

// threads per block of every lane-group kernel: at the fit's batch
// (B = 10,048, K = 8) that is 628 blocks of 16 systems, 4.8 per SM on the
// 132 SMs, all resident at once (about 19 warps per SM) and even to within
// one block per SM
constexpr int kGroupBlock = 128;

template <int K, bool DIV_BWD, bool SAMPLE>
cudaError_t launch_chol_group(const float* q, const float* b, const float* z,
                              float* out, long long n, cudaStream_t stream) {
  constexpr int T = kGroupBlock;
  constexpr int G = T / group_width(K);
  const unsigned int blocks = static_cast<unsigned int>((n + G - 1) / G);
  bool vec = false;
  if constexpr (K % 4 == 0)
    vec = (reinterpret_cast<std::uintptr_t>(q) & 15) == 0;
  if (vec)
    chol_group_kernel<K, T, DIV_BWD, SAMPLE, K % 4 == 0>
        <<<blocks, T, 0, stream>>>(q, b, z, out, n);
  else
    chol_group_kernel<K, T, DIV_BWD, SAMPLE, false>
        <<<blocks, T, 0, stream>>>(q, b, z, out, n);
  return cudaGetLastError();
}

// the most systems one launch takes: the grid's 2^31 - 1 blocks at the
// widest group (8 systems a block)
constexpr long long kMaxSystems = 0x7fffffffLL * (kGroupBlock / 16);

// The K = 1..16 dispatch; any other K, or a batch too large for the grid,
// is cudaErrorInvalidValue.  z may be null without SAMPLE.
template <bool DIV_BWD, bool SAMPLE>
int dispatch_chol_group(const void* q, const void* b, const void* z,
                        void* out, long long n, int k, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* bf = static_cast<const float*>(b);
  const float* zf = static_cast<const float*>(z);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > kMaxSystems) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
#define DCFM_CASE(KV) \
    case KV: return static_cast<int>(launch_chol_group<KV, DIV_BWD, SAMPLE>(qf, bf, zf, of, n, st));
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
    DCFM_CASE(5) DCFM_CASE(6) DCFM_CASE(7) DCFM_CASE(8)
    DCFM_CASE(9) DCFM_CASE(10) DCFM_CASE(11) DCFM_CASE(12)
    DCFM_CASE(13) DCFM_CASE(14) DCFM_CASE(15) DCFM_CASE(16)
#undef DCFM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dcfm
