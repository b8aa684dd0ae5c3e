"""Combine layer ("conquer"): host-side stitching of the packed panels.

The port's copy of ``dcfm_tpu/utils/estimate.py``.  The fetch hands back
the packed upper-triangle panels of the posterior-mean block grid,
(g(g+1)/2, P, P) in ``np.triu_indices`` order, float32 or int8 with one
scale per panel (runtime/fetch.py); this module turns them into the
covariance in the caller's coordinates.  The native one-pass assembler
(dcfm_tpu_torch/native) is the fast path; the NumPy path beside it
computes every entry in the native order - the diagonal blocks averaged
with their transpose, the panel's dequantization scale, then one multiply
by the product of the two column scales, ``v * ps * (s_row * s_col)`` - so
Sigma is the same bits with or without the native library.  Stored draws
(``RunConfig.store_draws``) give per-draw covariance entries
(:func:`draw_covariance_entries`), the JAX package's rule for them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dcfm_tpu_torch import native
from dcfm_tpu_torch.utils.preprocess import PreprocessResult, restore_covariance


def upper_pair_indices(g: int) -> tuple[np.ndarray, np.ndarray]:
    """Row/col shard indices of the g(g+1)/2 upper-triangle block pairs,
    in the canonical triu order the packed accumulator uses."""
    r, c = np.triu_indices(g)
    return r.astype(np.int32), c.astype(np.int32)


def g_from_pairs(n_pairs: int) -> int:
    """g such that g(g+1)/2 == n_pairs."""
    return native.g_from_pairs(n_pairs)


def full_blocks_from_upper(upper: np.ndarray, g: int) -> np.ndarray:
    """(g(g+1)/2, P, P) upper panels -> (g, g, P, P) block grid; the
    diagonal blocks are symmetrized so the grid is exactly symmetric."""
    n_pairs, P, _ = upper.shape
    r, c = upper_pair_indices(g)
    blocks = np.empty((g, g, P, P), upper.dtype)  # dcfm: ignore[DCFM1501] - the dense unpacking seam; callers gate on materialize_sigma
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


def assembly_maps(
    pre: PreprocessResult,
    g: int,
    P: int,
    *,
    destandardize: bool = True,
    reinsert_zero_cols: bool = False,
) -> tuple[np.ndarray, np.ndarray, int]:
    """(col_scale, out_map, p_out) for one-pass native assembly:
    ``col_scale`` is the per-shard-coordinate de-standardization factor,
    ``out_map`` sends each shard coordinate to its output row/col (-1 =
    dropped padding), and ``p_out`` is the output dimension."""
    p_used = pre.p_used
    p_kept = p_used - pre.n_pad
    if g * P != p_used:
        raise ValueError(f"g={g} blocks of width {P} != p_used {p_used}")
    scale = (pre.col_scale.reshape(-1).astype(np.float32) if destandardize
             else np.ones(p_used, np.float32))
    out_map = np.full(p_used, -1, np.int64)
    dest = (pre.kept_cols if reinsert_zero_cols
            else np.arange(p_kept, dtype=np.int64))
    out_map[pre.inv_perm[:p_kept]] = dest
    p_out = pre.p_original if reinsert_zero_cols else p_kept
    return scale, out_map, p_out


def assemble_numpy(
    panels: np.ndarray,
    panel_scale: Optional[np.ndarray],
    pre: PreprocessResult,
    *,
    destandardize: bool = True,
    reinsert_zero_cols: bool = False,
) -> np.ndarray:
    """The NumPy path of the assembly, entry for entry the native one:
    float32 ``panels`` with ``panel_scale=None``, or int8 panels with one
    float32 scale per panel (the diagonal blocks are averaged in the int8
    values, then scaled, as the native q8 pass does)."""
    n_pairs, P, _ = panels.shape
    g = g_from_pairs(n_pairs)
    if g * P != pre.p_used:
        raise ValueError(f"{n_pairs} pairs of {P}x{P} blocks != p_used "
                         f"{pre.p_used}")
    blocks = full_blocks_from_upper(panels.astype(np.float32, copy=False), g)
    if panel_scale is not None:
        ps = np.asarray(panel_scale, np.float32) / np.float32(127.0)
        r, c = upper_pair_indices(g)
        grid = np.empty((g, g), np.float32)  # dcfm: ignore[DCFM1501] - one scale per shard pair, g x g
        grid[r, c] = grid[c, r] = ps
        blocks *= grid[:, :, None, None]
    return restore_covariance(stitch_blocks(blocks, symmetrize=False), pre,
                              destandardize=destandardize,
                              reinsert_zero_cols=reinsert_zero_cols)


def assemble_from_upper(
    upper: np.ndarray,
    pre: PreprocessResult,
    *,
    destandardize: bool = True,
    reinsert_zero_cols: bool = False,
) -> np.ndarray:
    """Float32 upper block panels -> covariance in caller coordinates: the
    native one-pass assembler, else the NumPy path (the same bits)."""
    n_pairs, P, _ = upper.shape
    scale, out_map, p_out = assembly_maps(
        pre, g_from_pairs(n_pairs), P, destandardize=destandardize,
        reinsert_zero_cols=reinsert_zero_cols)
    out = native.assemble_covariance(upper, scale, out_map, p_out)
    if out is not None:
        return out
    return assemble_numpy(upper, None, pre, destandardize=destandardize,
                          reinsert_zero_cols=reinsert_zero_cols)


def dequantize_panels(q_panels: np.ndarray,
                      panel_scale: np.ndarray) -> np.ndarray:
    """int8 max-abs-quantized panels -> float32 (the inverse of
    runtime/fetch.cast_for_link): entry * panel_scale/127, one scale per
    panel.  The single home for the host-side dequant convention."""
    return q_panels.astype(np.float32) * (
        np.asarray(panel_scale, np.float32)[:, None, None] / 127.0)


def assemble_from_q8(
    q_panels: np.ndarray,
    panel_scale: np.ndarray,
    pre: PreprocessResult,
    *,
    destandardize: bool = True,
    reinsert_zero_cols: bool = False,
) -> np.ndarray:
    """Covariance STRAIGHT from int8-quantized panels: the native pass
    folds the dequantization in, so the float32 panels never materialize;
    without the native library the NumPy path computes the same bits."""
    if not native.available():
        return assemble_numpy(q_panels, panel_scale, pre,
                              destandardize=destandardize,
                              reinsert_zero_cols=reinsert_zero_cols)
    n_pairs, P, _ = q_panels.shape
    scale, out_map, p_out = assembly_maps(
        pre, g_from_pairs(n_pairs), P, destandardize=destandardize,
        reinsert_zero_cols=reinsert_zero_cols)
    out = np.zeros((p_out, p_out), np.float32)  # dcfm: ignore[DCFM1501] - q8 assembly output; callers gate on materialize_sigma
    native.assemble_q8(q_panels, panel_scale, scale, out_map, out)
    return out


def _pool_chain_axis(draws: dict) -> dict:
    """(C, S, ...) chain-major draw buffers -> (C*S, ...) pooled draws
    (chains are independent equal-weight posterior samples); draws
    without a chain axis pass through."""
    Lam = np.asarray(draws["Lambda"])
    if Lam.ndim == 4:
        return draws
    return {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
            for k, v in draws.items()}


def draw_covariance_entries(draws: dict, rows: np.ndarray, cols: np.ndarray,
                            *, rho: Optional[float] = None) -> np.ndarray:
    """Per-draw covariance entries, (S, m), in SHARD coordinates (rows and
    cols index the g * P shard columns).

    ``draws`` is FitResult.draws (a chain axis is pooled).  With the
    cross-moments ``H`` (estimator="scaled") each draw's entry is the
    scaled rule's Lam_i' H_rc Lam_j (+ 1/ps_i on the diagonal), so the
    draw mean reproduces the accumulated mean; without ``H`` the plain
    rule, which needs ``rho``."""
    draws = _pool_chain_axis(draws)
    Lam, ps = draws["Lambda"], draws["ps"]          # (S, g, P, K), (S, g, P)
    P = Lam.shape[2]
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    r_s, r_l = np.divmod(rows, P)
    c_s, c_l = np.divmod(cols, P)
    lam_r = Lam[:, r_s, r_l, :]                     # (S, m, K)
    lam_c = Lam[:, c_s, c_l, :]
    H = draws.get("H")
    if H is not None:
        Hrc = H[:, r_s, c_s]                        # (S, m, K, K)
        vals = np.einsum("smk,smkj,smj->sm", lam_r, Hrc, lam_c)
    else:
        if rho is None:
            raise ValueError(
                "draws carry no factor cross-moments H (estimator='plain'); "
                "pass rho for the plain combine rule")
        scale = np.where(r_s == c_s, 1.0, rho)
        vals = scale[None, :] * np.einsum("smk,smk->sm", lam_r, lam_c)
    diag = rows == cols
    if diag.any():
        vals[:, diag] += 1.0 / ps[:, r_s[diag], r_l[diag]]
    return vals
