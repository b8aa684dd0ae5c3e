"""Combine layer ("conquer"): host-side stitching of the packed panels.

The port's copy of the NumPy assembly of ``dcfm_tpu/utils/estimate.py``.
The chain hands back the packed upper-triangle panels of the
posterior-mean block grid, (g(g+1)/2, P, P) in ``np.triu_indices`` order;
this module unpacks them, stitches the (p_used, p_used) matrix and maps it
to the caller's coordinates.  The native one-pass assembler of the JAX
package is not ported: this is its NumPy fallback, entry for entry.
"""

from __future__ import annotations

import numpy as np

from dcfm_tpu_torch.utils.preprocess import PreprocessResult, restore_covariance


def upper_pair_indices(g: int) -> tuple[np.ndarray, np.ndarray]:
    """Row/col shard indices of the g(g+1)/2 upper-triangle block pairs,
    in the canonical triu order the packed accumulator uses."""
    r, c = np.triu_indices(g)
    return r.astype(np.int32), c.astype(np.int32)


def g_from_pairs(n_pairs: int) -> int:
    """g such that g(g+1)/2 == n_pairs."""
    g = int(round((np.sqrt(8 * n_pairs + 1) - 1) / 2))
    if g * (g + 1) // 2 != n_pairs:
        raise ValueError(f"{n_pairs} is not a triangular panel count")
    return g


def full_blocks_from_upper(upper: np.ndarray, g: int) -> np.ndarray:
    """(g(g+1)/2, P, P) upper panels -> (g, g, P, P) block grid; the
    diagonal blocks are symmetrized so the grid is exactly symmetric."""
    n_pairs, P, _ = upper.shape
    r, c = upper_pair_indices(g)
    blocks = np.empty((g, g, P, P), upper.dtype)  # dcfm: ignore[DCFM1501] - the dense Sigma the port's fit returns
    blocks[r, c] = upper
    blocks[c, r] = np.transpose(upper, (0, 2, 1))
    diag = np.arange(g)
    bd = blocks[diag, diag]
    blocks[diag, diag] = 0.5 * (bd + np.transpose(bd, (0, 2, 1)))
    return blocks


def stitch_blocks(sigma_blocks: np.ndarray, *,
                  symmetrize: bool = True) -> np.ndarray:
    """(g, g, P, P) block grid -> (g*P, g*P) dense covariance."""
    g, g2, P, _ = sigma_blocks.shape
    if g != g2:
        raise ValueError(f"expected square block grid, got {sigma_blocks.shape}")
    S = np.ascontiguousarray(
        np.transpose(sigma_blocks, (0, 2, 1, 3))).reshape(g * P, g * P)
    return 0.5 * (S + S.T) if symmetrize else S


def assemble_from_upper(
    upper: np.ndarray,
    pre: PreprocessResult,
    *,
    destandardize: bool = True,
    reinsert_zero_cols: bool = False,
) -> np.ndarray:
    """Upper block panels -> covariance in caller coordinates."""
    n_pairs, P, _ = upper.shape
    g = g_from_pairs(n_pairs)
    if g * P != pre.p_used:
        raise ValueError(f"{n_pairs} pairs of {P}x{P} blocks != p_used "
                         f"{pre.p_used}")
    return restore_covariance(
        stitch_blocks(full_blocks_from_upper(upper, g), symmetrize=False),
        pre, destandardize=destandardize,
        reinsert_zero_cols=reinsert_zero_cols)
