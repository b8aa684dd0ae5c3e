// K1: batched small-K factor-solve-sample for the Lambda update.
//
// Replaces dcfm_tpu/ops/pallas_gaussian.py::_chol_sample_kernel.  For B
// independent SPD precisions Q_j (K x K, K <= 16, row-major (B, K, K)
// float32) with linear terms b_j and standard normals z_j (both (B, K)),
// it returns x_j = Q_j^{-1} b_j + L_j^{-T} z_j, L_j the lower Cholesky
// factor of Q_j (Rue 2001): L v = b, L' m = v, L' y = z, x = m + y.
// The recurrence is chol_recurrence.cuh's, with the TPU kernel's
// multiplication by 1/L_jj in the two backward solves.
//
// Bound: device-memory bytes.  At the full-width Lambda update (B = 10,048
// rows, K = 8) one call moves 10,048 * (64 + 3 * 8) * 4 B = 3.5 MB - about
// 1 us at 3.35 TB/s - against ~4 MFLOP, so launch overhead (several us)
// dominates, not arithmetic.  What the design does about it: one launch
// per sweep over ALL shards' rows (the caller flattens (g, P) into B), one
// thread per system so the K-deep recurrence runs in registers and shared
// memory and nothing but the inputs and the output touches device memory,
// and Q staged through shared memory by the whole block in one coalesced
// sweep.  Launch overhead itself is left to a later change (CUDA graphs).

#include "chol_recurrence.cuh"

extern "C" int dcfm_chol_sample(const void* q, const void* b, const void* z,
                                void* out, long long n, int k, void* stream) {
  return dcfm::dispatch_solve<false, true>(q, b, z, out, n, k, stream);
}

extern "C" const char* dcfm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
