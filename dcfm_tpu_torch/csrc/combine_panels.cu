// The combine: a saved draw's packed covariance panels added into the
// posterior-mean accumulator in place (and their squares into the second
// moment's under posterior_sd).
//
// Replaces no TPU kernel: the JAX package forms a draw's panels with an
// XLA einsum (dcfm_tpu/models/conditionals.py::covariance_panels) and adds
// them in the same jit.  Its plain version is ops/combine.py's
// combine_panels_plain: two batched GEMMs into a (Q, P, P) temporary, then
// the adds.  For each packed pair q of n, with r = rows[q] and c = cols[q]
// (int64 shard indices into the (G, P, K) loadings and (G, P) residual
// precisions, read where they lie: no gathers):
//
//   M     = Lam_r H_rc (scaled estimator: h given, read through its
//           strides) or Lam_r (plain rule), rounded to float32, P x K
//   b_ij  = (sum_k M_ik Lam_c_jk) * s, then + d / ps_r_i where i == j
//   acc_ij += b_ij;  sq_ij += b_ij * b_ij (sq given)
//
// with s = 1 (scaled estimator, or a diagonal pair) else rho, and d = 1 on
// a diagonal pair (r == c), else 0 (the plain path adds the zero term too).
// Each step is rounded on its own as the plain path's separate kernels
// round it (__fmul_rn, __fadd_rn, __fdiv_rn: nothing contracts into an
// FMA).  Each K-term sum is one FMA chain in increasing k, which cuBLAS's
// order may differ from (at the fits' shapes on an H100 the two agreed bit
// for bit).  The padded pairs (aliases of pair (0, 0)) are formed like any
// other.
//
// Bound: device-memory bytes.  The accumulator is read once and written
// once, 8 P^2 bytes a panel (16 with sq): at BASELINE config 5 (33,024
// panels of 196 x 196, K = 8) 10.15 GB, 3.03 ms at 3.35 TB/s, against
// 2K + 3 operations an entry (20 GFLOP, 0.3 ms at 67 TFLOP/s).  So the
// design moves the accumulator's bytes and nothing more, with as many of
// them in flight as the registers allow.  A block takes one panel, or a
// slab of its rows where they would not fit 48 KB of shared memory.  It
// stages the slab's Lam_r rows and H_rc in shared memory in one round of
// loads and forms M there, a row a thread.  Then each thread owns W
// adjacent columns, with their K loadings of Lam_c in registers (loaded
// while the slab is staged), and walks the rows; the block's R row groups
// take R adjacent rows side by side, so its loads cover a contiguous
// stretch of the panel.  W = 4 (float4 loads and stores) where P % 4 == 0
// and the accumulators are 16-byte aligned, as at config 5's P = 196;
// W = 1 where not, as at the north star's P = 157.  A thread's rows go in
// batches through two register buffers, the next batch's loads in flight
// while this one is formed and stored (rows_in_flight).  The accumulator
// is streamed with evict-first hints (__ldcs / __stcs): it is touched once
// a draw, and L2 keeps the loadings every panel reads.  K is a template
// for 1..16 and the second moment a template flag; above K = 16 a
// run-time-K kernel forms M from global memory and reads Lam_c through L1
// in its dot loop.  A launch allocates nothing and does not synchronise,
// so it can be captured in a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // the most threads a block
constexpr int kSmemFloats = 12288;  // 48 KB of shared memory a block

struct Args {
  float* acc;                // (n, P, P)
  float* sq;                 // (n, P, P), or nullptr: no second moment
  const float* lam;          // (G, P, K)
  const float* ps;           // (G, P)
  const float* h;            // (G, G, K, K) at strides hs0..hs3, or
                             // nullptr: the plain rule
  long long hs0, hs1, hs2, hs3;
  const long long* rows;     // (n,)
  const long long* cols;     // (n,)
  long long items;           // n * slabs
  int slabs;                 // slabs a panel
  int slab;                  // rows a slab
  int P;
  int K;
  int units;                 // column units of a row: P / W
  int unit_threads;          // threads of a row group: min(units, kThreads)
  int row_groups;            // R: kThreads / unit_threads
  float rho;
};

// rows of the accumulator a thread has in flight in each of its two
// register buffers: as many as the registers left beside Lam_c's W x K
// allow under __launch_bounds__(kThreads, 2) (128 a thread; on an H100, 6
// rows at W = 4 and 8 at W = 1 measured fastest at K = 8), half as many
// with the second moment's
template <int KT, int W, bool SQ>
__host__ __device__ constexpr int rows_in_flight() {
  const int r = W == 4 ? (KT <= 8 ? 6 : KT <= 12 ? 4 : 2)
                       : (KT > 0 && KT <= 8 ? 8 : 4);
  return SQ ? (r + 1) / 2 : r;
}

template <int W>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = __ldcs(p + w);
  }
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) __stcs(p + w, v[w]);
  }
}

// one row-stepped batch of a thread's rows ib, ib + step, ...: load
template <int W, bool SQ, int R>
__device__ __forceinline__ void load_rows(const float* acc_q,
                                          const float* sq_q, int ib, int i1,
                                          int step, int P, int j0,
                                          float (&va)[R][W],
                                          float (&vs)[R][W]) {
#pragma unroll
  for (int x = 0; x < R; ++x) {
    const int i = ib + x * step;
    if (i < i1) {
      const long long at = static_cast<long long>(i) * P + j0;
      load_cols<W>(acc_q + at, va[x]);
      if constexpr (SQ) load_cols<W>(sq_q + at, vs[x]);
    }
  }
}

// ... then form the batch's entries, add them and store
template <int KT, int W, bool SQ, int R>
__device__ __forceinline__ void add_rows(
    float* acc_q, float* sq_q, int ib, int i0, int i1, int step, int P,
    int j0, int K, const float* mb, const float* d_s, float s,
    const float (&cr)[W][KT > 0 ? KT : 1], const float* lam_c,
    float (&va)[R][W], float (&vs)[R][W]) {
#pragma unroll
  for (int x = 0; x < R; ++x) {
    const int i = ib + x * step;
    if (i < i1) {
      const float* mrow = mb + (i - i0) * K;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float dot;
        if constexpr (KT > 0) {
          dot = mrow[0] * cr[w][0];
#pragma unroll
          for (int k = 1; k < KT; ++k) dot = fmaf(mrow[k], cr[w][k], dot);
        } else {
          const float* lc = lam_c + static_cast<long long>(j0 + w) * K;
          dot = mrow[0] * __ldg(lc);
          for (int k = 1; k < K; ++k) dot = fmaf(mrow[k], __ldg(lc + k), dot);
        }
        float b = __fmul_rn(dot, s);
        if (i == j0 + w) b = __fadd_rn(b, d_s[i - i0]);
        va[x][w] = __fadd_rn(va[x][w], b);
        if constexpr (SQ) vs[x][w] = __fadd_rn(vs[x][w], __fmul_rn(b, b));
      }
      const long long at = static_cast<long long>(i) * P + j0;
      store_cols<W>(acc_q + at, va[x]);
      if constexpr (SQ) store_cols<W>(sq_q + at, vs[x]);
    }
  }
}

// KT: K fixed at compile time (1..16), or 0 for the run-time K.
template <int KT, int W, bool SQ>
__global__ void __launch_bounds__(kThreads, 2)
combine_kernel(const Args a) {
  static_assert(KT > 0 || W == 1, "the run-time-K kernel walks one column");
  constexpr int kRows = rows_in_flight<KT, W, SQ>();
  extern __shared__ float smem[];
  const int K = KT > 0 ? KT : a.K;
  const int P = a.P;
  const int t = threadIdx.x, T = blockDim.x;
  const int u0 = t % a.unit_threads, rg = t / a.unit_threads;
  const int rstep = a.row_groups * kRows;
  float* m_s = smem;                    // (slab, K): M
  float* d_s = m_s + a.slab * K;        // (slab,): the diagonal terms
  float* l_s = d_s + a.slab;            // (slab, K): Lam_r (fixed K)
  float* h_s = l_s + a.slab * K;        // (K, K): H_rc (fixed K)
  for (long long it = blockIdx.x; it < a.items; it += gridDim.x) {
    const long long q = it / a.slabs;
    const int i0 = static_cast<int>(it - q * a.slabs) * a.slab;
    const int i1 = min(i0 + a.slab, P);
    const long long r = a.rows[q], c = a.cols[q];
    const float* lam_r = a.lam + r * P * K;
    const float* lam_c = a.lam + c * P * K;
    // the first unit's Lam_c rows, in flight while the slab is staged
    float cr[W][KT > 0 ? KT : 1];
    if constexpr (KT > 0) {
      if (u0 < a.units) {
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int k = 0; k < KT; ++k) cr[w][k] = lam_c[(u0 * W + w) * KT + k];
      }
    }
    const float d = r == c ? 1.0f : 0.0f;
    for (int il = t; il < i1 - i0; il += T)
      d_s[il] = __fmul_rn(d, __fdiv_rn(1.0f, a.ps[r * P + i0 + il]));
    const float* mb = m_s;              // the slab's M rows
    if constexpr (KT > 0) {
      // Lam_r's slab rows and H_rc into shared memory in one round of
      // loads, then each thread forms whole rows of M from them
      const float* src = lam_r + static_cast<long long>(i0) * KT;
      for (int e = t; e < (i1 - i0) * KT; e += T) l_s[e] = src[e];
      if (a.h != nullptr)
        for (int e = t; e < KT * KT; e += T) {
          const int l = e / KT, k = e - l * KT;
          h_s[e] = a.h[r * a.hs0 + c * a.hs1 + l * a.hs2 + k * a.hs3];
        }
      __syncthreads();
      if (a.h != nullptr) {
        for (int il = t; il < i1 - i0; il += T) {
          float lr[KT];
#pragma unroll
          for (int l = 0; l < KT; ++l) lr[l] = l_s[il * KT + l];
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            float v = lr[0] * h_s[k];
#pragma unroll
            for (int l = 1; l < KT; ++l) v = fmaf(lr[l], h_s[l * KT + k], v);
            m_s[il * KT + k] = v;
          }
        }
        __syncthreads();
      } else {
        mb = l_s;                       // the plain rule: M = Lam_r
      }
    } else {
      for (int e = t; e < (i1 - i0) * K; e += T) {
        const int il = e / K, k = e - il * K;
        const float* lr = lam_r + static_cast<long long>(i0 + il) * K;
        float v;
        if (a.h != nullptr) {
          const float* hk = a.h + r * a.hs0 + c * a.hs1 + k * a.hs3;
          v = lr[0] * hk[0];
          for (int l = 1; l < K; ++l) v = fmaf(lr[l], hk[l * a.hs2], v);
        } else {
          v = lr[k];
        }
        m_s[e] = v;
      }
      __syncthreads();
    }
    const float s = (a.h != nullptr || r == c) ? 1.0f : a.rho;

    float* acc_q = a.acc + q * P * P;
    float* sq_q = SQ ? a.sq + q * P * P : nullptr;
    for (int u = u0; u < a.units; u += a.unit_threads) {
      const int j0 = u * W;
      if constexpr (KT > 0) {
        if (u != u0) {
#pragma unroll
          for (int w = 0; w < W; ++w)
#pragma unroll
            for (int k = 0; k < KT; ++k) cr[w][k] = lam_c[(j0 + w) * KT + k];
        }
      }
      // two register buffers of kRows rows: the next batch's loads are in
      // flight while this batch is formed and stored
      float va[kRows][W], vs[kRows][W], vb[kRows][W], vt[kRows][W];
      int ib = i0 + rg;
      load_rows<W, SQ, kRows>(acc_q, sq_q, ib, i1, a.row_groups, P, j0, va,
                              vs);
      while (ib < i1) {
        const int ib2 = ib + rstep;
        load_rows<W, SQ, kRows>(acc_q, sq_q, ib2, i1, a.row_groups, P, j0,
                                vb, vt);
        add_rows<KT, W, SQ, kRows>(acc_q, sq_q, ib, i0, i1, a.row_groups, P,
                                   j0, K, mb, d_s, s, cr, lam_c, va, vs);
        if (ib2 >= i1) break;
        const int ib3 = ib2 + rstep;
        load_rows<W, SQ, kRows>(acc_q, sq_q, ib3, i1, a.row_groups, P, j0,
                                va, vs);
        add_rows<KT, W, SQ, kRows>(acc_q, sq_q, ib2, i0, i1, a.row_groups,
                                   P, j0, K, mb, d_s, s, cr, lam_c, vb, vt);
        ib = ib3;
      }
    }
    __syncthreads();    // the next item rewrites the shared slab
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <int KT, int W, bool SQ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t floats = KT > 0
      ? static_cast<size_t>(a.slab) * (2 * a.K + 1) + a.K * a.K
      : static_cast<size_t>(a.slab) * (a.K + 1);
  const long long grid = a.items < 0x7fffffffLL ? a.items : 0x7fffffffLL;
  combine_kernel<KT, W, SQ><<<static_cast<unsigned int>(grid),
                              a.unit_threads * a.row_groups,
                              floats * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_k(const Args& a, bool vec, cudaStream_t stream) {
  if (a.sq != nullptr)
    return vec ? launch<KT, 4, true>(a, stream)
               : launch<KT, 1, true>(a, stream);
  return vec ? launch<KT, 4, false>(a, stream)
             : launch<KT, 1, false>(a, stream);
}

}  // namespace

// n panels of P x P: acc[q] (and sq[q], sq may be null) += the panel of
// pair (rows[q], cols[q]); h null is the plain rule with rho.  n, P or K
// below 1, or K above what a slab's shared memory holds (K > 12,286), is
// cudaErrorInvalidValue.
extern "C" int dcfm_combine_panels(void* acc, void* sq, const void* lam,
                                   const void* ps, const void* h,
                                   long long hs0, long long hs1,
                                   long long hs2, long long hs3,
                                   const void* rows, const void* cols,
                                   long long n, int P, int K, float rho,
                                   void* stream) {
  if (n <= 0 || P <= 0 || K <= 0 || kSmemFloats / (K + 1) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.acc = static_cast<float*>(acc);
  a.sq = static_cast<float*>(sq);
  a.lam = static_cast<const float*>(lam);
  a.ps = static_cast<const float*>(ps);
  a.h = static_cast<const float*>(h);
  a.hs0 = hs0; a.hs1 = hs1; a.hs2 = hs2; a.hs3 = hs3;
  a.rows = static_cast<const long long*>(rows);
  a.cols = static_cast<const long long*>(cols);
  a.P = P;
  a.K = K;
  a.rho = rho;
  // a slab's rows: M and the diagonal terms, and for K <= 16 Lam_r's rows
  // and H_rc staged beside them
  const int fit = K <= 16 ? (kSmemFloats - K * K) / (2 * K + 1)
                          : kSmemFloats / (K + 1);
  a.slab = P < fit ? P : fit;
  a.slabs = (P + a.slab - 1) / a.slab;
  a.items = n * a.slabs;
  const bool vec = K <= 16 && P % 4 == 0 && aligned16(acc) &&
                   (sq == nullptr || aligned16(sq));
  a.units = vec ? P / 4 : P;
  a.unit_threads = a.units < kThreads ? a.units : kThreads;
  a.row_groups = kThreads / a.unit_threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
#define DCFM_CASE(KV) \
    case KV: return static_cast<int>(launch_k<KV>(a, vec, st));
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
    DCFM_CASE(5) DCFM_CASE(6) DCFM_CASE(7) DCFM_CASE(8)
    DCFM_CASE(9) DCFM_CASE(10) DCFM_CASE(11) DCFM_CASE(12)
    DCFM_CASE(13) DCFM_CASE(14) DCFM_CASE(15) DCFM_CASE(16)
#undef DCFM_CASE
    default: break;
  }
  return static_cast<int>(a.sq != nullptr ? launch<0, 1, true>(a, st)
                                          : launch<0, 1, false>(a, st));
}
