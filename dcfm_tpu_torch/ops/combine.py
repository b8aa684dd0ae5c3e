"""The combine: one saved draw's packed covariance panels added into the
posterior-mean accumulator (and, under ``posterior_sd``, their squares
into the second moment's) in place.

Replaces no TPU kernel: the JAX package forms a draw's panels with an XLA
einsum (``dcfm_tpu/models/conditionals.py::covariance_panels``) and adds
them in the same jit.  On a CUDA tensor :func:`combine_panels` launches the
hand-written kernel ``dcfm_tpu_torch/csrc/combine_panels.cu``, which forms
each panel in registers and adds it into the accumulator in one pass over
its bytes, with no (Q, P, P) temporary; on a CPU tensor it runs
:func:`combine_panels_plain`, :func:`form_panels` (the float32
``covariance_panels``) plus the adds.  The plain version with
``mm=mm_bf16`` is also the bfloat16 combine, which keeps its GEMMs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dcfm_tpu_torch.ops import cuda_lib


def form_panels(Lam_all: torch.Tensor, ps_all: torch.Tensor, rho: float,
                rows: torch.Tensor, cols: torch.Tensor,
                H_grid: Optional[torch.Tensor] = None,
                mm: Callable = torch.matmul) -> torch.Tensor:
    """The (Q, P, P) panels of pairs (rows[q], cols[q]): Lam_r H_rc Lam_c'
    with ``H_grid``'s (G, G, K, K) cross-moments (the scaled estimator),
    else rho Lam_r Lam_c' off the diagonal and Lam_r Lam_r' on it; the
    diagonal pairs add diag(1/ps_r).  ``mm`` multiplies (``torch.matmul``,
    or the bf16 combine's ``mm_bf16``)."""
    Lam_r = Lam_all[rows]                                       # (Q, P, K)
    Lam_c = Lam_all[cols]
    diag = rows == cols                                         # (Q,)
    if H_grid is not None:
        H = H_grid[rows, cols]                                  # (Q, K, K)
        blocks = mm(mm(Lam_r, H), Lam_c.transpose(-1, -2))
    else:
        blocks = mm(Lam_r, Lam_c.transpose(-1, -2))
        scale = torch.where(diag, torch.ones((), dtype=blocks.dtype,
                                             device=blocks.device),
                            torch.full((), rho, dtype=blocks.dtype,
                                       device=blocks.device))
        blocks = blocks * scale[:, None, None]
    # residual variances on the diagonal pairs, added in place: a second
    # (Q, P, P) temporary would double the combine's footprint
    inv_ps_r = 1.0 / ps_all[rows]                               # (Q, P)
    blocks.diagonal(dim1=-2, dim2=-1).add_(
        diag.to(blocks.dtype)[:, None] * inv_ps_r)
    return blocks


def combine_panels_plain(acc: torch.Tensor, sq: Optional[torch.Tensor],
                         Lam_all: torch.Tensor, ps_all: torch.Tensor,
                         rows: torch.Tensor, cols: torch.Tensor, rho: float,
                         H_grid: Optional[torch.Tensor] = None,
                         mm: Callable = torch.matmul) -> None:
    """The plain PyTorch version: ``acc += panels`` and, with ``sq``,
    ``sq += panels * panels`` - the square rounded on its own (an in-place
    multiply, no second temporary), then the add: two kernels, so no
    compiler contracts them into an FMA, as the JAX package's
    ``acc_sq + blocks * blocks``.  ``mm`` as in :func:`form_panels`."""
    blocks = form_panels(Lam_all, ps_all, rho, rows, cols, H_grid, mm)
    acc.add_(blocks)
    if sq is not None:
        sq.add_(blocks.mul_(blocks))


def _check(acc, sq, Lam_all, ps_all, rows, cols, H_grid) -> None:
    if Lam_all.dim() != 3:
        raise ValueError(
            f"Lam_all must be (G, P, K), got {tuple(Lam_all.shape)}")
    G, P, K = Lam_all.shape
    if K < 1 or P < 1:
        raise ValueError("P and K must be >= 1")
    if rows.dim() != 1:
        raise ValueError(f"rows must be (Q,), got {tuple(rows.shape)}")
    Q = rows.shape[0]
    shapes = [("acc", acc, (Q, P, P)), ("ps_all", ps_all, (G, P)),
              ("cols", cols, (Q,))]
    if sq is not None:
        shapes.append(("sq", sq, (Q, P, P)))
    if H_grid is not None:
        shapes.append(("H_grid", H_grid, (G, G, K, K)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t, dtype in (("acc", acc, torch.float32),
                           ("sq", sq, torch.float32),
                           ("Lam_all", Lam_all, torch.float32),
                           ("ps_all", ps_all, torch.float32),
                           ("H_grid", H_grid, torch.float32),
                           ("rows", rows, torch.int64),
                           ("cols", cols, torch.int64)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != acc.device:
            raise ValueError(f"{name} on {t.device}, acc on {acc.device}")
        # H_grid is read through its strides (cross_moments returns a
        # permuted view); every other operand is walked as laid out
        if name != "H_grid" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def combine_panels(acc: torch.Tensor, sq: Optional[torch.Tensor],
                   Lam_all: torch.Tensor, ps_all: torch.Tensor,
                   rows: torch.Tensor, cols: torch.Tensor, *, rho: float,
                   H_grid: Optional[torch.Tensor] = None) -> None:
    """Add the panels of pairs (rows[q], cols[q]) into ``acc[q]`` (and
    their squares into ``sq[q]``) in place: ``acc`` (Q, P, P) float32,
    ``Lam_all`` (G, P, K), ``ps_all`` (G, P), ``rows`` / ``cols`` (Q,)
    int64 shard indices, ``H_grid`` (G, G, K, K) or None for the plain
    rule with ``rho``.  See the module doc."""
    _check(acc, sq, Lam_all, ps_all, rows, cols, H_grid)
    if acc.device.type == "cpu":
        combine_panels_plain(acc, sq, Lam_all, ps_all, rows, cols, rho,
                             H_grid)
        return
    if acc.device.type != "cuda":
        raise ValueError(
            f"combine_panels runs on cpu or cuda, not {acc.device}")
    if not rows.shape[0]:
        return
    _, P, K = Lam_all.shape
    hs = H_grid.stride() if H_grid is not None else (0, 0, 0, 0)
    cuda_lib.launch(
        "combine_panels", "dcfm_combine_panels", acc.device,
        acc.data_ptr(), None if sq is None else sq.data_ptr(),
        Lam_all.data_ptr(), ps_all.data_ptr(),
        None if H_grid is None else H_grid.data_ptr(), *hs,
        rows.data_ptr(), cols.data_ptr(), rows.shape[0], P, K, float(rho))
