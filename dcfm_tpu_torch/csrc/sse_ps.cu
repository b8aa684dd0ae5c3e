// K5: fused Gram SSE + residual-precision rate for the psi stage.
//
// Replaces dcfm_tpu/ops/sse_gamma.py::_sse_ps_kernel (body _lane_sse_ps).
// For each of B features (the caller flattens (g, P) into B) with loading
// row Lam_j, M_j = (Lam E)_j, EYt_j = ((eta'Y)')_j (all (B, K) row-major
// float32), Y_j'Y_j and a unit-rate Gamma draw g_j:
//
//   quad = Lam_j . M_j,  dot2 = Lam_j . EYt_j
//   sse  = max(yty - 2 dot2 + quad, 0)
//   ps   = g / (bs + sse / 2)
//
// The clamp keeps NaN (x < 0 ? 0 : x, not fmaxf, which would hide a
// poisoned chain from the health counter).
//
// Bound: device-memory bytes.  At full width (B = 10,048, K = 8) a call
// reads 3 * B * K + 2 * B floats and writes 2 * B: 1.13 MB, about 0.34 us
// at 3.35 TB/s, against 4K + 5 operations per feature.  The pass is one
// memory round trip, so what the design buys is memory-level parallelism:
// K is a template parameter for 1..16 (sse_ps_fixed), so all 3K operands
// of a feature, and its yty and g, are loaded before any arithmetic, with
// float4 loads when K % 4 == 0 and the three (B, K) operands are 16-byte
// aligned.  One thread per feature sums both products in increasing k,
// exactly as _lane_sse_ps does.  (Splitting a feature over K / 4 lanes, one
// float4 per operand per lane and the partial sums combined by
// __shfl_xor_sync, makes every warp's loads contiguous but measured no
// faster, and changes the order of the sums.)  Features past the end are
// masked, not padded.  K > 16, which the Gram path of the fit reaches, takes
// the run-time-k kernel sse_ps_any (scalar loads, a loop over k).  A launch
// of this size cannot go much below an empty launch plus one memory round
// trip: floor_pass_kernel below is the same traffic with nothing to compute,
// and the smoke test times it beside this kernel.  Tensor cores and TMA do
// not apply: 4K + 5 operations on rows of 32 bytes.  Every launch uses no
// shared memory, allocates nothing and does not synchronise, so it can be
// captured in a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void finish(float y, float gv, float quad,
                                       float dot2, float bs, float* ps,
                                       float* sse) {
  float s = y - 2.0f * dot2 + quad;
  s = s < 0.0f ? 0.0f : s;
  *ps = gv / (bs + 0.5f * s);
  *sse = s;
}

template <int K, bool VEC, int T>
__global__ void __launch_bounds__(T)
sse_ps_fixed(const float* __restrict__ lam, const float* __restrict__ m,
             const float* __restrict__ eyt, const float* __restrict__ yty,
             const float* __restrict__ g, float* __restrict__ ps,
             float* __restrict__ sse, long long n, float bs) {
  static_assert(!VEC || K % 4 == 0, "float4 loads need K % 4 == 0");
  const long long r = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (r >= n) return;
  const long long at = r * K;
  float l[K], mv[K], e[K];
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(lam + at + j);
      const float4 b = *reinterpret_cast<const float4*>(m + at + j);
      const float4 c = *reinterpret_cast<const float4*>(eyt + at + j);
      l[j] = a.x; l[j + 1] = a.y; l[j + 2] = a.z; l[j + 3] = a.w;
      mv[j] = b.x; mv[j + 1] = b.y; mv[j + 2] = b.z; mv[j + 3] = b.w;
      e[j] = c.x; e[j + 1] = c.y; e[j + 2] = c.z; e[j + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      l[j] = lam[at + j];
      mv[j] = m[at + j];
      e[j] = eyt[at + j];
    }
  }
  const float y = yty[r], gv = g[r];

  float quad = l[0] * mv[0];
  float dot2 = l[0] * e[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    quad = quad + l[j] * mv[j];
    dot2 = dot2 + l[j] * e[j];
  }
  finish(y, gv, quad, dot2, bs, ps + r, sse + r);
}

template <int T>
__global__ void __launch_bounds__(T)
sse_ps_any(const float* __restrict__ lam, const float* __restrict__ m,
           const float* __restrict__ eyt, const float* __restrict__ yty,
           const float* __restrict__ g, float* __restrict__ ps,
           float* __restrict__ sse, long long n, int k, float bs) {
  const long long r = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (r >= n) return;
  const float* l = lam + r * k;
  const float* mr = m + r * k;
  const float* er = eyt + r * k;
  float quad = l[0] * mr[0];
  float dot2 = l[0] * er[0];
  for (int j = 1; j < k; ++j) {
    quad = quad + l[j] * mr[j];
    dot2 = dot2 + l[j] * er[j];
  }
  finish(yty[r], g[r], quad, dot2, bs, ps + r, sse + r);
}

// threads per block, every route: 79 blocks at the full-width batch.  64
// threads (157 blocks, more than the card's 132 SMs) measured the same,
// 256 and 512 slower.
constexpr int kBlock = 128;
// the most features one launch takes: the grid's 2^31 - 1 blocks
constexpr long long kMaxFeatures = 0x7fffffffLL * kBlock;

inline bool aligned16(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<std::uintptr_t>(a) |
           reinterpret_cast<std::uintptr_t>(b) |
           reinterpret_cast<std::uintptr_t>(c)) & 15) == 0;
}

template <int K>
cudaError_t launch_fixed(const float* lam, const float* m, const float* eyt,
                         const float* yty, const float* g, float* ps,
                         float* sse, unsigned int blocks, long long n,
                         float bs, cudaStream_t stream) {
  if (K % 4 == 0 && aligned16(lam, m, eyt))
    sse_ps_fixed<K, K % 4 == 0, kBlock>
        <<<blocks, kBlock, 0, stream>>>(lam, m, eyt, yty, g, ps, sse, n, bs);
  else
    sse_ps_fixed<K, false, kBlock>
        <<<blocks, kBlock, 0, stream>>>(lam, m, eyt, yty, g, ps, sse, n, bs);
  return cudaGetLastError();
}

// ---- the card's floor for a launch of this size --------------------------
// Not ports of anything: an empty kernel, and a streaming pass with K5's
// traffic and K5's grid (one thread per feature), every load a float4 and
// every warp's loads contiguous.  Timed beside K5 by the smoke test; the
// fit never calls them.

__global__ void floor_empty_kernel() {}

template <int PER, int T>
__global__ void __launch_bounds__(T)
floor_pass_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  const float4* __restrict__ c, const float* __restrict__ yty,
                  const float* __restrict__ g, float* __restrict__ ps,
                  float* __restrict__ sse, long long n) {
  // thread r reads float4 r, r + n, ... of each operand (PER = K / 4 each),
  // all of them before any arithmetic
  const long long r = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (r >= n) return;
  float4 x[PER], y[PER], w[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    x[j] = a[r + j * n];
    y[j] = b[r + j * n];
    w[j] = c[r + j * n];
  }
  float s0 = yty[r], s1 = g[r];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    s0 += x[j].x + y[j].x + w[j].x + x[j].y + y[j].y + w[j].y;
    s1 += x[j].z + y[j].z + w[j].z + x[j].w + y[j].w + w[j].w;
  }
  ps[r] = s0;
  sse[r] = s1;
}

}  // namespace

// B = n features of k loadings each in one launch; n above kMaxFeatures
// (the grid's 2^31 - 1 blocks) is cudaErrorInvalidValue.
extern "C" int dcfm_sse_ps(const void* lam, const void* m, const void* eyt,
                           const void* yty, const void* g, void* ps, void* sse,
                           long long n, int k, float bs, void* stream) {
  const float* lf = static_cast<const float*>(lam);
  const float* mf = static_cast<const float*>(m);
  const float* ef = static_cast<const float*>(eyt);
  const float* yf = static_cast<const float*>(yty);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(ps);
  float* sf = static_cast<float*>(sse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k <= 0 || n > kMaxFeatures)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kBlock - 1) / kBlock);
  switch (k) {
#define DCFM_CASE(KV) \
    case KV: return static_cast<int>(launch_fixed<KV>(lf, mf, ef, yf, gf, pf, sf, blocks, n, bs, st));
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
    DCFM_CASE(5) DCFM_CASE(6) DCFM_CASE(7) DCFM_CASE(8)
    DCFM_CASE(9) DCFM_CASE(10) DCFM_CASE(11) DCFM_CASE(12)
    DCFM_CASE(13) DCFM_CASE(14) DCFM_CASE(15) DCFM_CASE(16)
#undef DCFM_CASE
    default: break;
  }
  sse_ps_any<kBlock><<<blocks, kBlock, 0, st>>>(lf, mf, ef, yf, gf, pf, sf,
                                                n, k, bs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dcfm_floor_empty(void* stream) {
  floor_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// K5's operands and outputs (k = 4, 8, 12 or 16, the three (n, k) operands
// 16-byte aligned, else cudaErrorInvalidValue); what it writes means nothing.
extern "C" int dcfm_floor_pass(const void* lam, const void* m,
                               const void* eyt, const void* yty,
                               const void* g, void* ps, void* sse,
                               long long n, int k, void* stream) {
  if (n <= 0 || k <= 0 || k % 4 || k > 16 || !aligned16(lam, m, eyt) ||
      n > kMaxFeatures)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kBlock - 1) / kBlock);
  const float4* a = static_cast<const float4*>(lam);
  const float4* b = static_cast<const float4*>(m);
  const float4* c = static_cast<const float4*>(eyt);
  const float* y = static_cast<const float*>(yty);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(ps);
  float* sf = static_cast<float*>(sse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k / 4) {
#define DCFM_CASE(PER) \
    case PER: floor_pass_kernel<PER, kBlock><<<blocks, kBlock, 0, st>>>(a, b, c, y, gf, pf, sf, n); break;
    DCFM_CASE(1) DCFM_CASE(2) DCFM_CASE(3) DCFM_CASE(4)
#undef DCFM_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
