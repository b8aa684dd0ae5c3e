"""K5: fused Gram SSE + residual-precision rate for the psi stage.

For each feature j: sse_j = max(yty_j - 2 Lam_j.EYt_j + Lam_j.M_j, 0) and
ps_j = g_j / (bs + sse_j / 2), over the whole flattened (g * P,) feature
batch.  Replaces ``dcfm_tpu/ops/sse_gamma.py::_sse_ps_kernel`` (wrapper
``gram_sse_ps``).  On a CUDA tensor the wrapper launches the hand-written
kernel ``dcfm_tpu_torch/csrc/sse_ps.cu``; on a CPU tensor it runs
:func:`sse_ps_plain`, the row-major PyTorch expression (the JAX package's
``impl="plain"``).  The unit-Gamma draws g_j come in as an argument, drawn
by the caller from its noise provider.
"""

from __future__ import annotations

import torch

from dcfm_tpu_torch.ops import cuda_lib


def sse_ps_plain(Lam, M, EYt, yty, gunit, bs: float):
    """The plain PyTorch version; returns (ps, sse)."""
    quad = torch.sum(Lam * M, dim=-1)
    dot2 = torch.sum(Lam * EYt, dim=-1)
    sse = torch.clamp(yty - 2.0 * dot2 + quad, min=0.0)
    return gunit / (bs + 0.5 * sse), sse


def _check(Lam, M, EYt, yty, gunit) -> None:
    if Lam.dim() != 2:
        raise ValueError(f"Lam must be (B, K), got {tuple(Lam.shape)}")
    B, K = Lam.shape
    if K < 1:
        raise ValueError("K must be >= 1")
    for name, t, shape in (("M", M, (B, K)), ("EYt", EYt, (B, K)),
                           ("yty", yty, (B,)), ("gunit", gunit, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("Lam", Lam), ("M", M), ("EYt", EYt), ("yty", yty),
                    ("gunit", gunit)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != Lam.device:
            raise ValueError(f"{name} on {t.device}, Lam on {Lam.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sse_ps(Lam: torch.Tensor, M: torch.Tensor, EYt: torch.Tensor,
           yty: torch.Tensor, gunit: torch.Tensor, *, bs: float):
    """(ps, sse), each (B,); see module doc."""
    _check(Lam, M, EYt, yty, gunit)
    if Lam.device.type == "cpu":
        return sse_ps_plain(Lam, M, EYt, yty, gunit, bs)
    if Lam.device.type != "cuda":
        raise ValueError(f"sse_ps runs on cpu or cuda, not {Lam.device}")
    ps = torch.empty_like(yty)
    sse = torch.empty_like(yty)
    if Lam.shape[0]:
        cuda_lib.launch(
            "sse_ps", "dcfm_sse_ps", Lam.device, Lam.data_ptr(), M.data_ptr(),
            EYt.data_ptr(), yty.data_ptr(), gunit.data_ptr(), ps.data_ptr(),
            sse.data_ptr(), Lam.shape[0], Lam.shape[1], float(bs))
    return ps, sse
