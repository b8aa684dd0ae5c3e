// Native host-side "conquer" assembler: the port's copy of
// dcfm_tpu/native/assemble.cpp, entry for entry the same arithmetic.
//
// The fetch hands back the g(g+1)/2 upper-triangle block panels of the
// posterior-mean covariance; the host unpacks them into the dense matrix,
// undoes the feature permutation, undoes the per-column standardization and
// re-inserts the zero columns.  NumPy needs four O(p^2) memory-bound passes
// for that (mirror, transpose-stitch, scale, gather/scatter); this does it
// in one.
//
// Loop order is the whole design.  A scatter that walks the panels writes
// each entry to its final position AND its transposed mirror; under the
// feature permutation the mirror store strides across the entire
// (p_out, p_out) output, so nearly every 4-byte write misses cache and TLB.
// Here the loops run OUTPUT-ROW-major instead: for each source shard r and
// local row i, the full output row is produced in one visit by walking all
// g panels that touch shard r (pair (min(r,c), max(r,c)) is recomputed from
// the canonical upper-triangle order, so no mirror store is ever needed).
// Writes stay inside one ~4*p_out-byte row and the g panels touched repeat
// across the P rows of shard r, so the read working set (~g*P*P elements)
// stays in the caches.
//
// Shapes/contracts (all row-major, validated by the caller in
// dcfm_tpu_torch/native/__init__.py):
//   upper:  (n_pairs, P, P), pair k holds block (r_k, c_k) with r_k <= c_k
//           in np.triu_indices order (k = r*g - r(r-1)/2 + (c-r)), which
//           is the device's packed accumulator layout
//           (models/state.packed_pair_indices) with the padding trimmed by
//           runtime/fetch.fetch_prep.
//   scale:  (g*P,) float32 per-shard-coordinate de-standardization scales
//           (all ones when destandardize is off).
//   map:    (g*P,) int64: shard coordinate -> output row/col, -1 = dropped
//           (padding columns).
//   out:    (p_out, p_out) float32, pre-zeroed by the caller.
//
// Exact symmetry by construction: entry (i, j) and its mirror (j, i) read
// the same panel element (or, on diagonal blocks, the commutative sum
// blk[ij] + blk[ji]) and multiply by the commutative product
// scale_i * scale_j in an association-identical order, so the two IEEE
// results are bit-equal without a symmetrization pass.

#include <cstdint>

namespace {

// T = float (full-precision panels, panel_scale == nullptr) or int8_t
// (max-abs quantized panels, one float32 scale per panel - see
// runtime/fetch.cast_for_link; dequantization entry * panel_scale/127 folds
// into the same pass, so the quantized fetch never needs a host-side
// dequant sweep).
template <typename T>
void assemble_rowmajor(const T* upper, const float* panel_scale,
                       int64_t n_pairs, int64_t P, int64_t g,
                       const float* scale, const int64_t* map, float* out,
                       int64_t p_out) {
  const int64_t PP = P * P;
  (void)n_pairs;
  for (int64_t r = 0; r < g; ++r) {
    const int64_t br = r * P;
    for (int64_t i = 0; i < P; ++i) {
      const int64_t mi = map[br + i];
      if (mi < 0) continue;
      const float si = scale[br + i];
      float* out_row = out + mi * p_out;
      for (int64_t c = 0; c < g; ++c) {
        const int64_t a = r < c ? r : c;
        const int64_t b = r < c ? c : r;
        const int64_t k = a * g - a * (a - 1) / 2 + (b - a);
        const T* blk = upper + k * PP;
        const float ps =
            panel_scale ? panel_scale[k] / 127.0f : 1.0f;
        const int64_t bc = c * P;
        if (c == r) {
          // diagonal block: average with the transpose so float-level
          // accumulation asymmetry cannot leak into the output
          for (int64_t j = 0; j < P; ++j) {
            const int64_t mj = map[bc + j];
            if (mj < 0) continue;
            const float v = 0.5f * (static_cast<float>(blk[i * P + j]) +
                                    static_cast<float>(blk[j * P + i]));
            out_row[mj] = v * ps * (si * scale[bc + j]);
          }
        } else if (c > r) {
          // we are the panel's row side: contiguous panel-row read
          const T* row = blk + i * P;
          for (int64_t j = 0; j < P; ++j) {
            const int64_t mj = map[bc + j];
            if (mj < 0) continue;
            out_row[mj] = static_cast<float>(row[j]) * ps *
                          (si * scale[bc + j]);
          }
        } else {
          // we are the panel's column side: strided read, panel-resident
          for (int64_t j = 0; j < P; ++j) {
            const int64_t mj = map[bc + j];
            if (mj < 0) continue;
            out_row[mj] = static_cast<float>(blk[j * P + i]) * ps *
                          (si * scale[bc + j]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

void assemble_covariance_rowmajor(const float* upper, int64_t n_pairs,
                                  int64_t P, int64_t g, const float* scale,
                                  const int64_t* map, float* out,
                                  int64_t p_out) {
  assemble_rowmajor<float>(upper, nullptr, n_pairs, P, g, scale, map, out,
                           p_out);
}

// int8 variant: Sigma is assembled STRAIGHT from the quantized panels - the
// float32 upper panels never materialize on the quant8 fetch path
// (FitResult.upper_panels dequantizes lazily on first access).
void assemble_covariance_q8_rowmajor(const int8_t* upper,
                                     const float* panel_scale,
                                     int64_t n_pairs, int64_t P, int64_t g,
                                     const float* scale, const int64_t* map,
                                     float* out, int64_t p_out) {
  assemble_rowmajor<int8_t>(upper, panel_scale, n_pairs, P, g, scale, map,
                            out, p_out);
}

}  // extern "C"
