// K4 and K3: the batched K x K solves of the mixed-precision sweep.
//
// Replace dcfm_tpu/ops/batched_solve.py::_chol_solve_sample_kernel (K4,
// the bf16 sweep's Lambda update: x_j = Q_j^{-1} b_j + L_j^{-T} z_j) and
// ::_cho_solve_kernel (K3, the plain solve x_j = Q_j^{-1} b_j), for B
// independent SPD precisions Q_j (K x K, K <= 16, row-major (B, K, K)
// float32) and (B, K) right-hand sides.  Both keep those TPU kernels'
// division by L_jj everywhere, the backward solves included (K1 multiplies
// by the reciprocal there).  Q itself is float32 under the bf16 sweep:
// only the products that form it ran in bf16.
//
// Bound: device-memory bytes, as for K1.  At full width (B = 10,048,
// K = 8) K4 moves B (K^2 + 3K) * 4 B = 3.54 MB (1.056 us at 3.35 TB/s),
// K3 B (K^2 + 2K) * 4 B = 3.22 MB (0.96 us), against ~4 MFLOP.
//
// Both run K1's design (chol_group.cuh, whose note says what it does about
// the bound): one group of W >= K lanes per system, rows of Q loaded
// straight into registers with float4 loads, the recurrence in registers
// and warp shuffles, with DIV_BWD set.  K3 is the same instantiation
// without SAMPLE: the y chain, the z loads and the final sum drop out.
// Tensor cores and TMA do not apply, as for K1.

#include "chol_group.cuh"

extern "C" int dcfm_chol_solve_sample(const void* q, const void* b,
                                      const void* z, void* out, long long n,
                                      int k, void* stream) {
  return dcfm::dispatch_chol_group<true, true>(q, b, z, out, n, k, stream);
}

extern "C" int dcfm_cho_solve(const void* q, const void* b, void* out,
                              long long n, int k, void* stream) {
  return dcfm::dispatch_chol_group<true, false>(q, b, nullptr, out, n, k,
                                                stream);
}
