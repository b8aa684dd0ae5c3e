"""K2: the fused Lambda update (``ModelConfig.lambda_kernel="pallas-fused"``).

Per shard g and loading row j: Q_j = diag(plam_j) + ps_j E_g and
b_j = ps_j ey_j are formed inside the kernel, row by row in the registers
of one lane group per loading row, then x_j = Q_j^{-1} b_j + L_j^{-T} z_j
is drawn with the lane-group recurrence K1 runs (``csrc/chol_group.cuh``),
so the (G, P, K, K) precision tensor never exists.  Replaces
``dcfm_tpu/ops/pallas_gaussian.py::_lam_rows_kernel`` (wrapper
``lam_update_pallas``).  On a CUDA tensor the wrapper launches the
hand-written kernel ``dcfm_tpu_torch/csrc/lam_rows.cu``; on a CPU tensor
it runs :func:`lam_update_plain`, which follows the TPU kernel op for op:
the diagonal ps_j E_jj + plam_j, b = ps_j ey_j, multiplication by 1/L_jj
in the backward solves.
"""

from __future__ import annotations

import torch

from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.ops.chol_sample import MAX_K
from dcfm_tpu_torch.ops.gaussian import (
    bwd_solve_unrolled, chol_unrolled_columns, fwd_solve_unrolled)


def lam_update_plain(E, plam, ps, EYt, Zn) -> torch.Tensor:
    """The plain PyTorch version; shapes as :func:`lam_update`."""
    G, P, K = plam.shape

    def column(j):                      # rows j..K-1 of Q's column j
        s = (ps[..., None] * E[:, None, j:, j]).reshape(G * P, K - j)
        return torch.cat([s[:, :1] + plam[..., j].reshape(G * P, 1),
                          s[:, 1:]], dim=1)

    cols = chol_unrolled_columns(column, K)
    v = fwd_solve_unrolled(cols, (ps[..., None] * EYt).reshape(G * P, K))
    x = (bwd_solve_unrolled(cols, v, recip=True)
         + bwd_solve_unrolled(cols, Zn.reshape(G * P, K), recip=True))
    return x.reshape(G, P, K)


def _check(E, plam, ps, EYt, Zn) -> None:
    if plam.dim() != 3:
        raise ValueError(f"plam must be (G, P, K), got {tuple(plam.shape)}")
    G, P, K = plam.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside the kernel's range 1..{MAX_K}")
    for name, t, shape in (("E", E, (G, K, K)), ("ps", ps, (G, P)),
                           ("EYt", EYt, (G, P, K)), ("Zn", Zn, (G, P, K))):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("E", E), ("plam", plam), ("ps", ps), ("EYt", EYt),
                    ("Zn", Zn)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != plam.device:
            raise ValueError(f"{name} on {t.device}, plam on {plam.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if plam.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lam_update runs on cpu or cuda, not {plam.device}")


def lam_update(E: torch.Tensor, plam: torch.Tensor, ps: torch.Tensor,
               EYt: torch.Tensor, Zn: torch.Tensor) -> torch.Tensor:
    """(G, P, K) sampled loading rows from E (G, K, K), plam (G, P, K),
    ps (G, P), EYt (G, P, K) (eta'Y transposed, without the ps factor) and
    standard normals Zn (G, P, K); see module doc."""
    _check(E, plam, ps, EYt, Zn)
    if plam.device.type == "cpu":
        return lam_update_plain(E, plam, ps, EYt, Zn)
    G, P, K = plam.shape
    out = torch.empty_like(plam)
    if G * P:
        cuda_lib.launch("lam_update", "dcfm_lam_rows", plam.device,
                        E.data_ptr(), plam.data_ptr(), ps.data_ptr(),
                        EYt.data_ptr(), Zn.data_ptr(), out.data_ptr(),
                        G, P, K)
    return out
