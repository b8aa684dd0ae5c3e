// K1: batched small-K factor-solve-sample for the Lambda update.
//
// Replaces dcfm_tpu/ops/pallas_gaussian.py::_chol_sample_kernel.  For B
// independent SPD precisions Q_j (K x K, K <= 16, row-major (B, K, K)
// float32) with linear terms b_j and standard normals z_j (both (B, K)),
// it returns x_j = Q_j^{-1} b_j + L_j^{-T} z_j, L_j the lower Cholesky
// factor of Q_j (Rue 2001): L v = b, L' m = v, L' y = z, x = m + y, with
// the TPU kernel's multiplication by 1/L_jj in the two backward solves.
//
// Bound: device-memory bytes.  At the full-width Lambda update (B = 10,048
// rows, K = 8) one call moves 10,048 * (64 + 3 * 8) * 4 B = 3.54 MB, 1.056
// us at 3.35 TB/s, against ~4 MFLOP.  What the design does about it
// (chol_group.cuh): one launch per sweep over ALL shards' rows (the caller
// flattens (g, P) into B); one group of W >= K lanes per system, so the
// fit's batch runs 80,384 threads (about 19 warps per SM) that keep loads
// and the recurrence's latency in flight; each lane loads its row of Q
// straight into registers with float4 loads (the four systems of a warp
// read 1 KB of contiguous memory), and the recurrence runs in registers
// and warp shuffles, O(K) dependent steps per solve instead of a serial
// O(K^3) chain through shared memory.  Nothing but the inputs and the
// output touches device memory.  Tensor cores and TMA do not apply: each
// system is a K <= 16 serial recurrence with no product to put on wgmma,
// and a coalesced 1 KB-per-warp load gains nothing from a TMA descriptor.
// Launch overhead itself is left to a later change (CUDA graphs).

#include "chol_group.cuh"

extern "C" int dcfm_chol_sample(const void* q, const void* b, const void* z,
                                void* out, long long n, int k, void* stream) {
  return dcfm::dispatch_chol_group<false, true>(q, b, z, out, n, k, stream);
}

extern "C" const char* dcfm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
