"""Host-side data layer: filter, shard, standardize.

The port's copy of ``dcfm_tpu/utils/preprocess.py``: zero-column removal,
padding to a multiple of g with N(0, 1) dummy columns, a random feature
permutation, the (g, n, P) shard-major layout and per-shard column
standardization - with the same random stream and the same operation
order, so the shard data is bitwise the JAX package's for the same (Y, g,
seed), NaN payloads included.  NaN marks a missing entry: the column
statistics come from the observed entries, and NaN flows through the
permutation, the padding and the standardization to the device, where the
sweep imputes it (models/conditionals.impute_missing_y);
:func:`restore_data_matrix` maps a shard-layout data matrix back to the
caller's coordinates.

Sparse inputs (:class:`SparseMatrix` CSR/CSC, or any scipy.sparse matrix,
duck-typed by ``tocsc``) and out-of-core dense ones (``np.memmap``) take
the streaming path: the same checks and random draws from one pass over
the stored values, a :class:`LazyShardData` in place of the dense (g, n,
P) array whose blocks are bitwise the dense pipeline's on the densified
input, and host memory bounded by a block of shards, never O(n p).  The
dense restores refuse a lazy result (:class:`LazyMaterializationError`)
unless forced.  Everything here is NumPy on the host; it runs once per
fit.
"""

from __future__ import annotations

import dataclasses
import mmap
import os

import numpy as np



class LazyMaterializationError(RuntimeError):
    """An operation would densify a lazily-ingested (sparse/out-of-core) fit.

    Raised instead of silently allocating an O(p^2) or O(n*p) host array
    when the preprocessing ran in streaming mode (CSR/CSC or memmap input).
    Set ``FitConfig.materialize_sigma="always"`` (or pass ``force=True`` to
    the restore helpers) when the dense result is genuinely wanted and fits
    in host memory.
    """


@dataclasses.dataclass
class SparseMatrix:
    """Dependency-free compressed-sparse matrix: the scipy CSR/CSC triple.

    ``indptr``/``indices``/``data`` follow the standard CSR (``format="csr"``,
    row-compressed) or CSC (``format="csc"``, column-compressed) layout with
    no duplicate entries.  ``shape`` is the logical (n, p).  Stored NaN marks
    a missing OBSERVATION (imputed on device, like dense NaN); entries absent
    from the structure are exact zeros, and explicitly stored zeros behave
    exactly like dense zeros (a column of only stored zeros is dropped).
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple
    format: str = "csr"

    def __post_init__(self):
        if self.format not in ("csr", "csc"):
            raise ValueError(f"format must be 'csr' or 'csc', got "
                             f"{self.format!r}")
        self.indptr = np.asarray(self.indptr, np.int64)
        self.indices = np.asarray(self.indices, np.int64)
        self.data = np.asarray(self.data)
        n, p = self.shape
        n_major = n if self.format == "csr" else p
        if self.indptr.shape != (n_major + 1,):
            raise ValueError(
                f"indptr must have shape ({n_major + 1},) for a "
                f"{self.format} matrix of shape {tuple(self.shape)}, got "
                f"{self.indptr.shape}")
        if self.indices.shape != self.data.shape:
            raise ValueError("indices and data must have equal length")


def _csr_to_csc(indptr, indices, data, shape):
    """(indptr, indices, data) row-compressed -> column-compressed.

    Stable argsort over the column ids keeps rows ascending within each
    column, matching scipy's canonical CSC ordering.
    """
    n, p = shape
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    counts = np.bincount(indices, minlength=p)
    out_indptr = np.zeros(p + 1, np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    return out_indptr, rows[order], data[order]


class _CscSource:
    """Column source over CSC storage: streaming scan + multi-column gather.

    Never densifies more than the requested column block; the gather is a
    single vectorized scatter (no per-column Python loop), so ingesting
    p ~ 10^6 columns costs O(nnz) work and O(n * block) peak memory.
    """

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.vals = np.asarray(data)
        self.n, self.p = shape

    def scan(self):
        """One pass over stored values -> (nonzero_mask, nan_per_col,
        has_inf, n_missing), the exact quantities the dense path derives
        from full-matrix reductions."""
        vals = self.vals
        has_inf = bool(np.isinf(vals).any())
        nan = np.isnan(vals)
        lens = np.diff(self.indptr)
        colid = np.repeat(np.arange(self.p, dtype=np.int64), lens)
        nan_per_col = np.bincount(colid[nan], minlength=self.p)
        nonzero = np.zeros(self.p, bool)
        # NaN != 0 is True, matching the dense zero-column filter: a column
        # holding only missing markers is kept (imputation anchors).
        nonzero[colid[vals != 0]] = True
        return nonzero, nan_per_col, has_inf, int(nan.sum())

    def gather(self, cols, dtype):
        """Densify the requested columns into an (n, len(cols)) block."""
        cols = np.asarray(cols, np.int64)
        m = cols.size
        out = np.zeros((self.n, m), dtype)
        starts = self.indptr[cols]
        lens = self.indptr[cols + 1] - starts
        total = int(lens.sum())
        if total:
            cum = np.cumsum(lens) - lens
            pos = np.repeat(starts - cum, lens) + np.arange(total)
            loc = np.repeat(np.arange(m, dtype=np.int64), lens)
            out[self.indices[pos], loc] = self.vals[pos].astype(
                dtype, copy=False)
        return out


class _DenseSource:
    """Column source over out-of-core dense storage (np.memmap Y).

    Both passes walk blocks of whole rows of about 4 MB - the scan summing
    its per-column counts and flags block by block, the gather copying the
    requested columns of each block.  A read-only memmap of a file, as
    ``np.load(path, mmap_mode="r")`` gives, is read block by block with
    positioned reads into one buffer, so no page of the file is mapped
    into the process and the host holds a block, not the file, whatever
    the OS keeps resident of a mapping: at BASELINE config 5's width (a
    100 MB file) a whole ingest stays below half of the dense (g, n, P)
    tensor.  Any other memmap (a view, a writable or copy-on-write
    mapping) is read through its mapping.  The JAX package scans blocks
    of 64 MB of columns through the mapping; the scan's results are exact
    counts and flags and the gather a copy, so neither choice changes a
    bit.
    """

    _BLOCK_ELEMS = 1 << 20      # ~4 MB of float32 rows per block

    def __init__(self, Y):
        self.Y = Y
        self.n, self.p = Y.shape
        self._rows = max(1, self._BLOCK_ELEMS // max(self.p, 1))
        # the original read-only memmap of a file (not a view): row lo
        # starts at byte offset + lo * row_bytes of the file
        self._file = (Y.filename if isinstance(Y.base, mmap.mmap)
                      and getattr(Y, "mode", None) == "r"
                      and Y.flags.c_contiguous and Y.filename else None)

    def _blocks(self):
        """(lo, rows [lo, lo + block) as an ndarray) over the matrix."""
        if self._file is None:
            for lo in range(0, self.n, self._rows):
                yield lo, np.asarray(self.Y[lo:lo + self._rows])
            return
        row_bytes = self.p * self.Y.dtype.itemsize
        buf = np.empty((self._rows, self.p), self.Y.dtype)
        with open(self._file, "rb", buffering=0) as f:
            for lo in range(0, self.n, self._rows):
                k = min(self._rows, self.n - lo)
                view = memoryview(buf[:k]).cast("B")
                got, pos = 0, self.Y.offset + lo * row_bytes
                while got < view.nbytes:
                    r = os.preadv(f.fileno(), [view[got:]], pos + got)
                    if r <= 0:
                        raise OSError(f"{self._file}: short read at byte "
                                      f"{pos + got}")
                    got += r
                yield lo, buf[:k]

    def scan(self):
        nonzero = np.zeros(self.p, bool)
        nan_per_col = np.zeros(self.p, np.int64)
        has_inf = False
        for _, blk in self._blocks():
            nanb = np.isnan(blk)
            nan_per_col += nanb.sum(axis=0)
            has_inf = has_inf or bool(np.isinf(blk).any())
            nonzero |= np.any(blk != 0, axis=0)
        return nonzero, nan_per_col, has_inf, int(nan_per_col.sum())

    def gather(self, cols, dtype):
        out = np.empty((self.n, len(cols)), dtype)
        for lo, blk in self._blocks():
            out[lo:lo + blk.shape[0]] = blk[:, cols]
        return out


def is_streaming_input(Y) -> bool:
    """True when ``Y`` takes the streaming (lazy) ingestion path: a
    :class:`SparseMatrix`, a scipy.sparse matrix, or an ``np.memmap``.
    Cheap predicate (no conversion) for callers like api.fit that must
    decide whether to densify ``Y`` before preprocess."""
    return (isinstance(Y, (SparseMatrix, np.memmap))
            or (hasattr(Y, "tocsc") and hasattr(Y, "shape")))


def _as_column_source(Y):
    """Streaming column source for sparse / out-of-core inputs, else None."""
    if isinstance(Y, SparseMatrix):
        if Y.format == "csc":
            return _CscSource(Y.indptr, Y.indices, Y.data, Y.shape)
        indptr, indices, data = _csr_to_csc(
            Y.indptr, Y.indices, Y.data, Y.shape)
        return _CscSource(indptr, indices, data, Y.shape)
    if hasattr(Y, "tocsc") and hasattr(Y, "shape"):    # scipy.sparse duck
        C = Y.tocsc()
        C.sum_duplicates()
        return _CscSource(C.indptr, C.indices, C.data, tuple(Y.shape))
    if isinstance(Y, np.memmap):
        return _DenseSource(Y)
    return None


class LazyShardData:
    """Lazily materialized (g, n, P) shard-major data.

    Stands in for ``PreprocessResult.data`` on the streaming path: exposes
    ``.shape``/``.dtype`` like an ndarray, and materializes dense blocks of
    shards on demand (:meth:`block`, :meth:`chunk`) - bitwise-equal to the
    slices of the dense pipeline's array on the same (densified) input.  A
    block of shards is one gather of all its columns from the source.
    There is deliberately no ``__array__``: anything that would densify the
    whole (g, n, P) tensor must call :meth:`materialize` explicitly.
    """

    ndim = 3
    # the shards one pass (the stats, the fingerprint, the upload) holds at
    # once: about 4 MB of float32
    _CHUNK_ELEMS = 1 << 20

    def __init__(self, source, *, perm, kept_cols, pad, g, n, P, dtype,
                 standardize):
        self._source = source
        self._perm = np.asarray(perm)
        self._kept_cols = np.asarray(kept_cols)
        self._pad = pad                       # (n, n_pad) or None
        self._g, self._n, self._P = g, n, P
        self._dtype = np.dtype(dtype)
        self._standardize = standardize
        # filled by the stats pass in _preprocess_streaming
        self.col_mean = None                  # (g, P)
        self.col_scale = None                 # (g, P)

    @property
    def shape(self):
        return (self._g, self._n, self._P)

    @property
    def dtype(self):
        return self._dtype

    @property
    def shards_per_chunk(self) -> int:
        """Shards per block of a streaming pass over the data."""
        return max(1, self._CHUNK_ELEMS // max(self._n * self._P, 1))

    def _raw_chunk(self, lo: int, hi: int) -> np.ndarray:
        """Shards [lo, hi) BEFORE standardization: gather + pad, cast to
        dtype, as a C-contiguous (hi - lo, n, P) array."""
        P = self._P
        src = self._perm[lo * P:hi * P]
        p_kept = self._kept_cols.size
        out = np.empty((hi - lo, self._n, P), self._dtype)
        rows = out.transpose(1, 0, 2)          # (n, shards, P) view
        real = np.flatnonzero(src < p_kept)
        if real.size:
            rows[:, real // P, real % P] = self._source.gather(
                self._kept_cols[src[real]], self._dtype)
        padded = np.flatnonzero(src >= p_kept)
        if padded.size:
            rows[:, padded // P, padded % P] = self._pad[
                :, src[padded] - p_kept]
        return out

    def chunk(self, lo: int, hi: int) -> np.ndarray:
        """Dense (hi-lo, n, P) block of shards [lo, hi)."""
        if not 0 <= lo <= hi <= self._g:
            raise IndexError(f"shards [{lo}, {hi}) out of range "
                             f"[0, {self._g})")
        out = self._raw_chunk(lo, hi)
        if self._standardize:
            # the dense pipeline's (x - mean) / scale, element for element
            np.subtract(out, self.col_mean[lo:hi, None, :], out=out)
            np.divide(out, self.col_scale[lo:hi, None, :], out=out)
        return out

    def block(self, s: int) -> np.ndarray:
        """Dense (n, P) block of shard ``s`` - bitwise-equal to
        ``preprocess(densify(Y), ...).data[s]``."""
        if not 0 <= s < self._g:
            raise IndexError(f"shard index {s} out of range [0, {self._g})")
        return self.chunk(s, s + 1)[0]

    def materialize(self) -> np.ndarray:
        """Full dense (g, n, P) array - O(n * p) host memory, explicit."""
        return self.chunk(0, self._g)


@dataclasses.dataclass
class PreprocessResult:
    """Sharded data plus everything needed to invert the preprocessing."""

    data: np.ndarray            # (g, n, P) float32 shard-major, or a
                                # LazyShardData (streaming ingest)
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

    @property
    def is_lazy(self) -> bool:
        """True when ``data`` is a :class:`LazyShardData` (streaming
        ingestion): per-shard blocks materialize on demand and dense
        O(p^2)/O(n*p) restores refuse unless forced."""
        return not isinstance(self.data, np.ndarray)


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

    Returns shard-major float32 data of shape (g, n, P).  Sparse (scipy
    CSR/CSC or :class:`SparseMatrix`) and out-of-core dense (``np.memmap``)
    inputs take the streaming path: the same semantics in one pass over
    column blocks, a :class:`LazyShardData` in place of the dense array."""
    dtype = np.float32
    source = _as_column_source(Y)
    if source is not None:
        return _preprocess_streaming(
            source, num_shards, permute=permute, standardize=standardize,
            pad_to_shards=pad_to_shards, seed=seed, dtype=dtype)
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


def _preprocess_streaming(
    source,
    num_shards: int,
    *,
    permute: bool,
    standardize: bool,
    pad_to_shards: bool,
    seed: int,
    dtype,
) -> PreprocessResult:
    """Streaming twin of the dense :func:`preprocess` body.

    Mirrors the dense op order exactly - NaN/inf checks, zero-column
    filter, the SAME rng consumption order (pad draw before permutation),
    and per-column stats with the same reduction order - so every derived
    quantity (perm, stats, per-shard blocks) is bitwise-equal to the dense
    path on the densified input, while peak host memory stays bounded by
    a block of shards (``LazyShardData.shards_per_chunk``).
    """
    n, p = source.n, source.p
    nonzero, nan_per_col, has_inf, n_missing = source.scan()
    if has_inf:
        raise ValueError(
            "Y contains infinite entries (NaN marks a missing value and is "
            "imputed; inf is unrepresentable data and must be cleaned)")
    if n_missing:
        obs = n - nan_per_col
        too_few = obs < (2 if standardize else 1)
        if too_few.any():
            raise ValueError(
                f"columns {np.flatnonzero(too_few).tolist()[:10]} have "
                f"fewer than {2 if standardize else 1} observed entries - "
                "nothing to standardize or anchor imputation on; drop "
                "them first")

    kept_cols = np.flatnonzero(nonzero)
    zero_cols = np.flatnonzero(~nonzero)
    p_kept = kept_cols.size
    if p_kept == 0:
        raise ValueError("all columns of Y are zero")

    rng = np.random.default_rng(seed)

    g = num_shards
    rem = p_kept % g
    n_pad = 0
    pad = None
    if rem != 0:
        if not pad_to_shards:
            raise ValueError(f"p={p_kept} not divisible by g={g}")
        n_pad = g - rem
        pad = rng.standard_normal((n, n_pad)).astype(dtype)
    p_used = p_kept + n_pad
    P = p_used // g

    perm = rng.permutation(p_used) if permute else np.arange(p_used)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(p_used)

    lazy = LazyShardData(
        source, perm=perm, kept_cols=kept_cols, pad=pad, g=g, n=n, P=P,
        dtype=dtype, standardize=standardize)

    # one streaming stats pass: each shard's (n, P) reductions are bitwise
    # the dense array's axis=1 reductions (the same summation order per
    # column), so the stats match the dense path exactly
    if standardize:
        col_mean = np.empty((g, P), np.dtype(dtype))
        col_scale = np.empty((g, P), np.dtype(dtype))
        step = lazy.shards_per_chunk
        for lo in range(0, g, step):
            raw = lazy._raw_chunk(lo, min(lo + step, g))
            for s, blk in enumerate(raw, start=lo):
                if n_missing:
                    m = np.nanmean(blk, axis=0)
                    v = np.nanvar(blk, axis=0, ddof=1)
                else:
                    m = blk.mean(axis=0)
                    v = blk.var(axis=0, ddof=1)
                col_mean[s] = m
                col_scale[s] = np.sqrt(np.maximum(v, 1e-12))
            del raw
    else:
        col_mean = np.zeros((g, P), dtype)
        col_scale = np.ones((g, P), dtype)
    lazy.col_mean = col_mean
    lazy.col_scale = col_scale

    return PreprocessResult(
        data=lazy,
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
                        destandardize: bool = True,
                        force: bool = False) -> np.ndarray:
    """(g, n, P) shard-major data-space matrix -> (n, p_original) caller
    coordinates: de-standardize, undo the shard layout and the permutation,
    drop the padding columns, zero-fill the dropped all-zero columns (the
    row-space inverse of :func:`preprocess`).  Refuses a lazily-ingested
    ``pre`` unless ``force``."""
    if pre.is_lazy and not force:
        raise LazyMaterializationError(
            f"refusing to allocate a dense ({data_shard.shape[1]}, "
            f"{pre.p_original}) matrix for a lazily-ingested "
            "(sparse/out-of-core) fit; set "
            "FitConfig.materialize_sigma='always' or pass force=True if "
            "the dense restore is genuinely wanted")
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
    force: bool = False,
) -> np.ndarray:
    """Map a (p_used, p_used) covariance in shard coordinates back to the
    caller's: drop the padding, undo the permutation and the
    standardization; with ``reinsert_zero_cols`` the output is
    (p_original, p_original) with zero rows/cols at dropped columns.
    Refuses a lazily-ingested ``pre`` unless ``force``."""
    if pre.is_lazy and not force:
        raise LazyMaterializationError(
            f"refusing to allocate a dense ({pre.p_original}, "
            f"{pre.p_original})-scale covariance for a lazily-ingested "
            "(sparse/out-of-core) fit; query packed panels via "
            "FitResult.sigma_block / the serve artifact instead, or set "
            "FitConfig.materialize_sigma='always' (force=True here) if the "
            "dense matrix is genuinely wanted")
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
