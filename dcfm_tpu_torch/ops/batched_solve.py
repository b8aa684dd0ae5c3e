"""K4 and K3: batched K x K Cholesky solves, one launch for a whole batch.

The port of ``dcfm_tpu/ops/batched_solve.py``:

* :func:`chol_solve_sample_batched` (K4) - x_j = Q_j^{-1} b_j +
  L_j^{-T} z_j for a flattened (B, K, K) batch, the mixed-precision
  sweep's Lambda update (``ModelConfig.compute_dtype="bf16"``).  Replaces
  ``_chol_solve_sample_kernel``.
* :func:`cho_solve_batched` (K3) - the plain solve x_j = Q_j^{-1} b_j.
  Replaces ``_cho_solve_kernel``; no fit path runs it (nor in the JAX
  package).  It divides by L_jj as K4 does and runs the same lane-group
  kernel (``csrc/chol_group.cuh``) without the noise chain.
* :func:`cho_solve_shared` - one shared precision and an (n, K) right-hand
  block, through ``torch.linalg``.

For K <= 16 the device decides the route, as in ops/chol_sample.py: a
CUDA tensor launches the hand-written kernel in
``dcfm_tpu_torch/csrc/batched_solve.cu``, a CPU tensor runs the plain
PyTorch version, which repeats the JAX recurrence op for op (division by
L_jj in both backward solves, where K1 multiplies by the reciprocal).
K > 16 goes through ``torch.linalg`` on either device, as the JAX
package's "lax" branch does.  Every route factors in float32.
"""

from __future__ import annotations

import torch

from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.ops.chol_sample import MAX_K, check_systems
from dcfm_tpu_torch.ops.gaussian import (
    bwd_solve_unrolled, cholesky, chol_unrolled, fwd_solve_unrolled,
    sample_mvn_precision_linalg)


def chol_solve_sample_plain(Q: torch.Tensor, b: torch.Tensor,
                            z: torch.Tensor) -> torch.Tensor:
    """K4's plain version (``_chol_solve_sample_kernel``'s order)."""
    cols = chol_unrolled(Q)
    v = fwd_solve_unrolled(cols, b)
    return bwd_solve_unrolled(cols, v) + bwd_solve_unrolled(cols, z)


def cho_solve_plain(Q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3's plain version (``_cho_solve_kernel``'s order)."""
    cols = chol_unrolled(Q)
    return bwd_solve_unrolled(cols, fwd_solve_unrolled(cols, b))


def chol_solve_sample_batched(Q: torch.Tensor, b: torch.Tensor,
                              z: torch.Tensor) -> torch.Tensor:
    """(B, K) draws x_j = Q_j^{-1} b_j + L_j^{-T} z_j; see module doc."""
    if Q.dim() == 3 and Q.shape[-1] > MAX_K:
        return sample_mvn_precision_linalg(Q, b, z)
    check_systems(Q, b=b, z=z)
    if Q.device.type == "cpu":
        return chol_solve_sample_plain(Q, b, z)
    out = torch.empty_like(b)
    if Q.shape[0]:
        cuda_lib.launch("chol_solve_sample", "dcfm_chol_solve_sample",
                        Q.device, Q.data_ptr(), b.data_ptr(), z.data_ptr(),
                        out.data_ptr(), Q.shape[0], Q.shape[2])
    return out


def cho_solve_batched(Q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, K) solutions x_j = Q_j^{-1} b_j; see module doc."""
    if Q.dim() == 3 and Q.shape[-1] > MAX_K:
        return torch.cholesky_solve(b[..., None], cholesky(Q))[..., 0]
    check_systems(Q, b=b)
    if Q.device.type == "cpu":
        return cho_solve_plain(Q, b)
    out = torch.empty_like(b)
    if Q.shape[0]:
        cuda_lib.launch("cho_solve", "dcfm_cho_solve", Q.device,
                        Q.data_ptr(), b.data_ptr(), out.data_ptr(),
                        Q.shape[0], Q.shape[2])
    return out


def cho_solve_shared(Q: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = (Q^{-1} B')' for one shared SPD precision Q (K, K) and an (n, K)
    right-hand block: factor once, solve the whole panel."""
    return torch.cholesky_solve(B.transpose(-1, -2),
                                cholesky(Q)).transpose(-1, -2)
