"""Precision-form Gaussian samplers: factor once, solve many.

The port of ``dcfm_tpu/ops/gaussian.py``.  Sampling rule (Rue 2001): to
draw from N(Q^{-1} b, Q^{-1}) with Q = L L', solve L v = b, L' m = v for
the mean, then L' y = z with z ~ N(0, I), and return m + y.  The standard
normals z are arguments: the caller draws them from its noise provider.

* :func:`sample_mvn_precision_shared` - one K x K precision shared by
  many rows (the Z and X updates), batched over any leading dims:
  ``torch.linalg`` Cholesky and triangular solves, as XLA's library calls
  served the JAX package.
* ``chol_unrolled`` / ``fwd_solve_unrolled`` / ``bwd_solve_unrolled`` -
  the statically unrolled elementwise recurrence over a batch of
  per-row K x K systems; the plain PyTorch versions of the factor-solve
  kernels (ops/chol_sample.py, ops/batched_solve.py, ops/lam_update.py)
  are built from it.
* :func:`sample_mvn_precision_linalg` - the per-row sampler through
  ``torch.linalg`` for K above the kernel's bound.
"""

from __future__ import annotations

import torch


def cholesky(Q: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (Q + Q') / 2, as ``lax.linalg.cholesky``
    symmetrizes its input (under bf16 products L'(L ps) is asymmetric at
    2^-8, so reading one triangle would factor another matrix); a matrix
    that is not positive definite gives NaN (as XLA's factorization does)
    instead of raising, so the chain's health counter sees it and the card
    never synchronizes on a check."""
    L, info = torch.linalg.cholesky_ex((Q + Q.transpose(-1, -2)) / 2)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _tri_solve(L: torch.Tensor, b: torch.Tensor, *, trans: bool):
    """Solve L x = b (trans=False) or L' x = b (trans=True); b is (..., K, m)."""
    A = L.transpose(-1, -2) if trans else L
    return torch.linalg.solve_triangular(A, b, upper=trans)


def sample_mvn_precision_shared(Zn: torch.Tensor, Q: torch.Tensor,
                                B: torch.Tensor) -> torch.Tensor:
    """Rows x_i ~ N(Q^{-1} b_i, Q^{-1}) for a shared precision.

    Q: (..., K, K) SPD; B: (..., n, K); Zn: (..., n, K) standard normals.
    Returns (..., n, K)."""
    L = cholesky(Q)
    V = _tri_solve(L, B.transpose(-1, -2), trans=False)         # (..., K, n)
    M = _tri_solve(L, V, trans=True)
    Yn = _tri_solve(L, Zn.transpose(-1, -2), trans=True)
    return (M + Yn).transpose(-1, -2)


def chol_unrolled(Q: torch.Tensor) -> list:
    """Cholesky of (B, K, K) SPD matrices as K unrolled steps of batched
    elementwise ops; returns columns [(B, K-j) for j in 0..K-1], column j
    holding rows j..K-1 of L."""
    return chol_unrolled_columns(lambda j: Q[:, j:, j], Q.shape[-1])


def chol_unrolled_columns(column, K: int) -> list:
    """:func:`chol_unrolled` with the precision given column by column:
    ``column(j)`` is the (B, K-j) slab of rows j..K-1 of column j of Q, so
    a caller can form Q on the fly (the fused Lambda update)."""
    cols = []
    for j in range(K):
        s = column(j)
        for t in range(j):
            ct = cols[t]
            s = s - ct[:, j - t:] * ct[:, j - t, None]
        d = torch.sqrt(s[:, :1])
        cols.append(torch.cat([d, s[:, 1:] / d], dim=1))
    return cols


def fwd_solve_unrolled(cols: list, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b for unrolled-column L; b, y are (B, K)."""
    K = b.shape[-1]
    ys = []
    for j in range(K):
        acc = b[:, j]
        for t in range(j):
            acc = acc - cols[t][:, j - t] * ys[t]
        ys.append(acc / cols[j][:, 0])
    return torch.stack(ys, dim=-1)


def bwd_solve_unrolled(cols: list, b: torch.Tensor, *,
                       recip: bool = False) -> torch.Tensor:
    """Solve L' x = b for unrolled-column L; b, x are (B, K).  Each step
    divides by L_jj, or with ``recip`` multiplies by 1/L_jj (the order of
    the Pallas kernels in ``dcfm_tpu/ops/pallas_gaussian.py``)."""
    K = b.shape[-1]
    xs = [None] * K
    for j in reversed(range(K)):
        acc = b[:, j]
        for i in range(j + 1, K):
            acc = acc - cols[j][:, i - j] * xs[i]
        d = cols[j][:, 0]
        xs[j] = acc * (1.0 / d) if recip else acc / d
    return torch.stack(xs, dim=-1)


def sample_mvn_precision_linalg(Q: torch.Tensor, B: torch.Tensor,
                                Zn: torch.Tensor) -> torch.Tensor:
    """x_j = Q_j^{-1} b_j + L_j^{-T} z_j for per-row (B, K, K) precisions,
    through torch.linalg (any K)."""
    L = cholesky(Q)
    V = _tri_solve(L, B[..., None], trans=False)
    M = _tri_solve(L, V, trans=True)
    Yn = _tri_solve(L, Zn[..., None], trans=True)
    return (M + Yn)[..., 0]
