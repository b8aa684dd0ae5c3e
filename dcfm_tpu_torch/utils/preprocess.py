"""Host-side data layer: filter, shard, standardize (dense inputs only).

The port's copy of the dense path of ``dcfm_tpu/utils/preprocess.py``:
zero-column removal, padding to a multiple of g with N(0, 1) dummy
columns, a random feature permutation, the (g, n, P) shard-major layout
and per-shard column standardization - with the same random stream and
the same operation order, so the shard data is bitwise the JAX package's
for the same (Y, g, seed), NaN payloads included.  NaN marks a missing
entry: the column statistics come from the observed entries, and NaN
flows through the permutation, the padding and the standardization to the
device, where the sweep imputes it (models/conditionals.impute_missing_y);
:func:`restore_data_matrix` maps a shard-layout data matrix back to the
caller's coordinates.  Everything here is NumPy on the host; it runs once
per fit.  The sparse / out-of-core ingest is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PreprocessResult:
    """Sharded data plus everything needed to invert the preprocessing."""

    data: np.ndarray            # (g, n, P) float32 shard-major
    perm: np.ndarray            # (p_used,) shard column j = kept[perm[j]]
    inv_perm: np.ndarray        # (p_used,) inverse of perm
    col_mean: np.ndarray        # (g, P)
    col_scale: np.ndarray       # (g, P)
    kept_cols: np.ndarray       # (p_kept,) indices into the caller's columns
    zero_cols: np.ndarray       # dropped all-zero columns
    n_pad: int                  # dummy padding columns appended
    p_original: int             # caller's p
    n_missing: int = 0          # NaN entries in the kept data (0: complete)

    @property
    def num_shards(self) -> int:
        return self.data.shape[0]

    @property
    def shard_size(self) -> int:
        return self.data.shape[2]

    @property
    def p_used(self) -> int:
        """Columns actually modeled (kept real columns + padding)."""
        return self.num_shards * self.shard_size


def preprocess(
    Y: np.ndarray,
    num_shards: int,
    *,
    permute: bool = True,
    standardize: bool = True,
    pad_to_shards: bool = True,
    seed: int = 0,
) -> PreprocessResult:
    """Filter zero columns, (optionally) permute, pad, shard, standardize.

    Returns shard-major float32 data of shape (g, n, P)."""
    dtype = np.float32
    Y = np.asarray(Y)
    if Y.ndim != 2:
        raise ValueError(f"Y must be (n, p), got shape {Y.shape}")
    n, p = Y.shape
    nan_mask = np.isnan(Y)
    n_missing = int(nan_mask.sum())
    if np.isinf(Y).any():
        raise ValueError(
            "Y contains infinite entries (NaN marks a missing value and is "
            "imputed; inf is unrepresentable data and must be cleaned)")
    if n_missing:
        obs = n - nan_mask.sum(axis=0)
        too_few = obs < (2 if standardize else 1)
        if too_few.any():
            raise ValueError(
                f"columns {np.flatnonzero(too_few).tolist()[:10]} have "
                f"fewer than {2 if standardize else 1} observed entries - "
                "nothing to standardize or anchor imputation on; drop "
                "them first")

    # zero-column filter (NaN != 0, so a column of NaNs and zeros is kept)
    nonzero = np.any(Y != 0, axis=0)
    kept_cols = np.flatnonzero(nonzero)
    zero_cols = np.flatnonzero(~nonzero)
    Yk = Y[:, kept_cols].astype(dtype)
    p_kept = Yk.shape[1]
    if p_kept == 0:
        raise ValueError("all columns of Y are zero")

    rng = np.random.default_rng(seed)

    # pad to a multiple of g: the pad draw comes BEFORE the permutation on
    # the same generator, as in the JAX package
    g = num_shards
    rem = p_kept % g
    n_pad = 0
    if rem != 0:
        if not pad_to_shards:
            raise ValueError(f"p={p_kept} not divisible by g={g}")
        n_pad = g - rem
        pad = rng.standard_normal((n, n_pad)).astype(dtype)
        Yk = np.concatenate([Yk, pad], axis=1)
    p_used = p_kept + n_pad
    P = p_used // g

    perm = rng.permutation(p_used) if permute else np.arange(p_used)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(p_used)

    data = np.ascontiguousarray(
        Yk[:, perm].reshape(n, g, P).transpose(1, 0, 2))

    if standardize:
        # with missing entries, from the observed values only
        if n_missing:
            col_mean = np.nanmean(data, axis=1)
            col_var = np.nanvar(data, axis=1, ddof=1)
        else:
            col_mean = data.mean(axis=1)
            col_var = data.var(axis=1, ddof=1)
        col_scale = np.sqrt(np.maximum(col_var, 1e-12))
        data = (data - col_mean[:, None, :]) / col_scale[:, None, :]
    else:
        col_mean = np.zeros((g, P), dtype)
        col_scale = np.ones((g, P), dtype)

    return PreprocessResult(
        data=data.astype(dtype),
        perm=perm,
        inv_perm=inv_perm,
        col_mean=col_mean.astype(dtype),
        col_scale=col_scale.astype(dtype),
        kept_cols=kept_cols,
        zero_cols=zero_cols,
        n_pad=n_pad,
        p_original=p,
        n_missing=n_missing,
    )


def restore_data_matrix(data_shard: np.ndarray, pre: PreprocessResult, *,
                        destandardize: bool = True) -> np.ndarray:
    """(g, n, P) shard-major data-space matrix -> (n, p_original) caller
    coordinates: de-standardize, undo the shard layout and the permutation,
    drop the padding columns, zero-fill the dropped all-zero columns (the
    row-space inverse of :func:`preprocess`)."""
    g, n, P = data_shard.shape
    if (g, P) != (pre.num_shards, pre.shard_size):
        raise ValueError(
            f"expected ({pre.num_shards}, n, {pre.shard_size}), got "
            f"{data_shard.shape}")
    arr = data_shard
    if destandardize:
        arr = (arr * pre.col_scale[:, None, :]
               + pre.col_mean[:, None, :])
    arr = np.ascontiguousarray(
        np.transpose(arr, (1, 0, 2))).reshape(n, pre.p_used)
    arr = arr[:, pre.inv_perm]          # permuted -> kept (+ padding) order
    p_kept = pre.p_used - pre.n_pad
    out = np.zeros((n, pre.p_original), arr.dtype)
    out[:, pre.kept_cols] = arr[:, :p_kept]
    return out


def caller_to_shard_index(pre: PreprocessResult, idx) -> np.ndarray:
    """Caller-coordinate column indices -> shard-coordinate positions.

    Shard position j models caller column ``kept_cols[perm[j]]``, so caller
    column c (at position q of kept_cols) sits at shard position
    ``inv_perm[q]``; shard j // P, row j % P of that shard's panels.
    Dropped all-zero columns map to -1 (they have no shard coordinate;
    their covariance entries are identically 0).
    """
    idx = np.asarray(idx, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= pre.p_original):
        raise IndexError(
            f"column index out of range [0, {pre.p_original})")
    pos = np.searchsorted(pre.kept_cols, idx)
    out = np.full(idx.shape, -1, np.int64)
    ok = pos < pre.kept_cols.size
    ok &= pre.kept_cols[np.minimum(pos, pre.kept_cols.size - 1)] == idx
    out[ok] = pre.inv_perm[pos[ok]]
    return out


def restore_covariance(
    Sigma_shard: np.ndarray,
    pre: PreprocessResult,
    *,
    destandardize: bool = True,
    reinsert_zero_cols: bool = False,
) -> np.ndarray:
    """Map a (p_used, p_used) covariance in shard coordinates back to the
    caller's: drop the padding, undo the permutation and the
    standardization; with ``reinsert_zero_cols`` the output is
    (p_original, p_original) with zero rows/cols at dropped columns."""
    p_used = pre.p_used
    if Sigma_shard.shape != (p_used, p_used):
        raise ValueError(
            f"expected ({p_used}, {p_used}), got {Sigma_shard.shape}")
    p_kept = p_used - pre.n_pad
    if destandardize:
        # the native assembler's per-entry order: the two column scales
        # combine first, then one multiply (v * (s_row * s_col))
        s = pre.col_scale.reshape(-1)
        S = Sigma_shard * (s[:, None] * s[None, :])
    else:
        S = Sigma_shard
    gidx = pre.inv_perm[:p_kept]
    if reinsert_zero_cols:
        full = np.zeros((pre.p_original, pre.p_original), S.dtype)  # dcfm: ignore[DCFM1501] - the dense caller-coordinate Sigma itself
        full[np.ix_(pre.kept_cols, pre.kept_cols)] = S[np.ix_(gidx, gidx)]
        return full
    return S[np.ix_(gidx, gidx)]
