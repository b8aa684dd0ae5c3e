// K4 and K3: the batched K x K solves of the mixed-precision sweep.
//
// Replace dcfm_tpu/ops/batched_solve.py::_chol_solve_sample_kernel (K4,
// the bf16 sweep's Lambda update: x_j = Q_j^{-1} b_j + L_j^{-T} z_j) and
// ::_cho_solve_kernel (K3, the plain solve x_j = Q_j^{-1} b_j), for B
// independent SPD precisions Q_j (K x K, K <= 16, row-major (B, K, K)
// float32) and (B, K) right-hand sides.  Both run chol_recurrence.cuh's
// recurrence with those TPU kernels' order: division by L_jj everywhere,
// the backward solves included (K1 multiplies by the reciprocal there).
// Q itself is float32 under the bf16 sweep: only the products that form
// it ran in bf16.
//
// Bound: device-memory bytes, as for K1.  At full width (B = 10,048,
// K = 8) K4 moves B (K^2 + 3K) * 4 B = 3.54 MB (1.06 us at 3.35 TB/s),
// K3 B (K^2 + 2K) * 4 B = 3.22 MB (0.96 us), against ~4 MFLOP.  The design
// is K1's: one launch over all shards' rows, one thread per system, Q
// staged through shared memory in one coalesced sweep, the factor formed
// in place in the staged tile.

#include "chol_recurrence.cuh"

extern "C" int dcfm_chol_solve_sample(const void* q, const void* b,
                                      const void* z, void* out, long long n,
                                      int k, void* stream) {
  return dcfm::dispatch_solve<true, true>(q, b, z, out, n, k, stream);
}

extern "C" int dcfm_cho_solve(const void* q, const void* b, void* out,
                              long long n, int k, void* stream) {
  return dcfm::dispatch_solve<true, false>(q, b, nullptr, out, n, k, stream);
}
