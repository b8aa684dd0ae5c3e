// K5: fused Gram SSE + residual-precision rate for the psi stage.
//
// Replaces dcfm_tpu/ops/sse_gamma.py::_sse_ps_kernel (body _lane_sse_ps).
// For each of B features (the caller flattens (g, P) into B) with loading
// row Lam_j, M_j = (Lam E)_j, EYt_j = ((eta'Y)')_j (all (B, K) row-major
// float32), Y_j'Y_j and a unit-rate Gamma draw g_j:
//
//   quad = Lam_j . M_j,  dot2 = Lam_j . EYt_j   (accumulated in increasing k)
//   sse  = max(yty - 2 dot2 + quad, 0)
//   ps   = g / (bs + sse / 2)
//
// The clamp keeps NaN (x < 0 ? 0 : x, not fmaxf, which would hide a
// poisoned chain from the health counter).
//
// Bound: device-memory bytes.  At full width (B = 10,048, K = 8) a call
// reads 3 * B * K + 2 * B floats and writes 2 * B: 1.1 MB, about 0.34 us
// at 3.35 TB/s, against 4K + 5 operations per feature.  One thread per
// feature holds both dot products in registers; the three (B, K) operands
// are read once, each thread walking its own contiguous row (the rows of
// a warp share their cache lines, so every byte fetched is used), and
// nothing is written but the two outputs.  As for K1, a launch costs more
// than the bytes at this size; CUDA graphs are the later remedy.

#include <cuda_runtime.h>

namespace {

__global__ void sse_ps_kernel(const float* __restrict__ lam,
                              const float* __restrict__ m,
                              const float* __restrict__ eyt,
                              const float* __restrict__ yty,
                              const float* __restrict__ g,
                              float* __restrict__ ps,
                              float* __restrict__ sse, long long n, int k,
                              float bs) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
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
  float s = yty[r] - 2.0f * dot2 + quad;
  s = s < 0.0f ? 0.0f : s;
  ps[r] = g[r] / (bs + 0.5f * s);
  sse[r] = s;
}

}  // namespace

extern "C" int dcfm_sse_ps(const void* lam, const void* m, const void* eyt,
                           const void* yty, const void* g, void* ps, void* sse,
                           long long n, int k, float bs, void* stream) {
  constexpr int T = 128;   // 79 blocks at the full-width batch
  if (n <= 0 || k <= 0 || n > 0x7fffffffLL * T)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + T - 1) / T;
  sse_ps_kernel<<<static_cast<unsigned int>(blocks), T, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lam), static_cast<const float*>(m),
      static_cast<const float*>(eyt), static_cast<const float*>(yty),
      static_cast<const float*>(g), static_cast<float*>(ps),
      static_cast<float*>(sse), n, k, bs);
  return static_cast<int>(cudaGetLastError());
}
