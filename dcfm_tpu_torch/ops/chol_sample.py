"""K1: the Lambda update's batched factor-solve-sample.

x_j = Q_j^{-1} b_j + L_j^{-T} z_j for B independent SPD K x K precisions
(K <= 16).  Replaces ``dcfm_tpu/ops/pallas_gaussian.py::_chol_sample_kernel``
(wrapper ``chol_sample_batched_pallas``).  On a CUDA tensor the wrapper
launches the hand-written kernel ``dcfm_tpu_torch/csrc/chol_sample.cu``
(which says what bounds it and what its design does about that); on a CPU
tensor it runs :func:`chol_sample_plain`, the unrolled PyTorch recurrence.
"""

from __future__ import annotations

import torch

from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.ops.gaussian import (
    bwd_solve_unrolled, chol_unrolled, fwd_solve_unrolled)

MAX_K = 16


def chol_sample_plain(Q: torch.Tensor, b: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, in the TPU kernel's order: unrolled
    Cholesky, forward solve, two backward solves multiplying by 1/L_jj."""
    cols = chol_unrolled(Q)
    v = fwd_solve_unrolled(cols, b)
    return (bwd_solve_unrolled(cols, v, recip=True)
            + bwd_solve_unrolled(cols, z, recip=True))


def check_systems(Q: torch.Tensor, **vecs: torch.Tensor) -> None:
    """What the batched K x K kernels take: Q (B, K, K) with 1 <= K <= 16
    and each named vector (B, K); float32, contiguous, on Q's device.

    Input that passes is accepted by one combined test (the wrappers run
    once per sweep); anything else goes through the detailed checks below,
    which raise with the message that names the fault."""
    f32, shape = torch.float32, Q.shape
    if len(shape) == 3 and Q.dtype is f32 and Q.is_contiguous():
        B, K, K2 = shape
        device = Q.device
        ok = K == K2 and 1 <= K <= MAX_K and device.type in ("cpu", "cuda")
        for t in vecs.values():
            ok = (ok and t.dtype is f32 and t.is_contiguous()
                  and t.shape == (B, K) and t.device == device)
        if ok:
            return
    _explain_systems(Q, vecs)


def _explain_systems(Q: torch.Tensor, vecs: dict) -> None:
    if Q.dim() != 3 or Q.shape[1] != Q.shape[2]:
        raise ValueError(f"Q must be (B, K, K), got {tuple(Q.shape)}")
    B, K = Q.shape[0], Q.shape[2]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} outside the kernel's range 1..{MAX_K}")
    for name, t in vecs.items():
        if tuple(t.shape) != (B, K):
            raise ValueError(
                f"{name} must be ({B}, {K}), got {tuple(t.shape)}")
    for name, t in (("Q", Q), *vecs.items()):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != Q.device:
            raise ValueError(f"{name} on {t.device}, Q on {Q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cpu or cuda, not {Q.device}")


def chol_sample(Q: torch.Tensor, b: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """(B, K) draws x_j = Q_j^{-1} b_j + L_j^{-T} z_j; see module doc."""
    check_systems(Q, b=b, z=z)
    if Q.device.type == "cpu":
        return chol_sample_plain(Q, b, z)
    out = torch.empty_like(b)
    if Q.shape[0]:
        cuda_lib.launch("chol_sample", "dcfm_chol_sample", Q.device,
                        Q.data_ptr(), b.data_ptr(), z.data_ptr(),
                        out.data_ptr(), Q.shape[0], Q.shape[2])
    return out
