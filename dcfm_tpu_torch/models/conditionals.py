"""The Gibbs sweep: Z, X, Lambda, the prior and psi in turn.

The port of ``dcfm_tpu/models/conditionals.py`` for one device, the MGP
prior and float32.  The shard axis is an explicit leading batch dimension
(the JAX package vmaps over it), so the X update's cross-shard sums are
plain sums over axis 0.  Every draw comes from ``draws`` (noise.py) at
the JAX package's site ids, and every kernel's noise is drawn outside the
kernel, as the JAX package's Pallas path does.

On a CUDA tensor the Lambda update (K <= 16) runs the hand-written
factor-solve-sample kernel (ops/chol_sample.py) and the Gram psi stage
the fused SSE/rate kernel (ops/sse_gamma.py); on a CPU tensor both run
their plain PyTorch versions.

Matmul precision: the sweep's float32 products must run in full float32
(the JAX sweep runs them at "high"/"highest" on purpose - under
single-pass reduced precision its Geweke test measured a prior bias).
``api.fit`` refuses to run with TF32 matmuls enabled.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.models.state import SamplerState
from dcfm_tpu_torch.noise import SITE_LAM, SITE_PS, SITE_X, SITE_Z
from dcfm_tpu_torch.ops.chol_sample import MAX_K, chol_sample
from dcfm_tpu_torch.ops.gamma import gamma_rate, gamma_unit_static
from dcfm_tpu_torch.ops.gaussian import (
    sample_mvn_precision_linalg, sample_mvn_precision_shared)
from dcfm_tpu_torch.ops.sse_gamma import sse_ps


def resolve_sse_mode(mode: str, *, n: int, K: int) -> str:
    """"auto" picks "gram" when n >= K per shard (the Gram moments are then
    full rank and cheaper than the (n, P) residual), else "resid"."""
    if mode == "auto":
        return "gram" if n >= K else "resid"
    return mode


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def gibbs_sweep(draws, Y: torch.Tensor, state: SamplerState,
                cfg: ModelConfig, prior) -> tuple[SamplerState, torch.Tensor]:
    """One Gibbs iteration over all G shards.

    Y: (G, n, P) standardized shard data.  Returns ``(state, sse)`` with
    sse the (G, P) per-feature residual sum of squares the psi stage
    formed (the chain trace reads it)."""
    G, n, P = Y.shape
    K = state.Lambda.shape[-1]
    rho = cfg.rho
    sq_r, sq_1mr = math.sqrt(rho), math.sqrt(1.0 - rho)
    jit_eps = float(cfg.ridge_jitter)
    eye = torch.eye(K, dtype=Y.dtype, device=Y.device)
    sse_gram = resolve_sse_mode(cfg.sse_mode, n=n, K=K) == "gram"
    Lam, ps = state.Lambda, state.ps

    # precision-weighted loadings and their K x K moment, shared by the
    # Z and X updates (both read the incoming Lambda and ps)
    W = Lam * ps[..., None]                                     # (G, P, K)
    LtW = _t(Lam) @ W                                           # (G, K, K)

    # ---- Z_m | rest ------------------------------------------------------
    Qz = eye + (1.0 - rho) * LtW
    if jit_eps:
        Qz = Qz + jit_eps * eye
    R = Y - sq_r * (state.X @ _t(Lam))                          # (G, n, P)
    Bz = sq_1mr * (R @ W)                                       # (G, n, K)
    Z = sample_mvn_precision_shared(draws.normal(SITE_Z, (G, n, K)), Qz, Bz)

    # ---- X | rest: the one cross-shard update ----------------------------
    R = Y - sq_1mr * (Z @ _t(Lam))
    S1 = torch.sum(LtW, dim=0)                                  # (K, K)
    S2 = torch.sum(R @ W, dim=0)                                # (n, K)
    Qx = cfg.x_prior_precision * eye + rho * S1
    if jit_eps:
        Qx = Qx + jit_eps * eye
    X = sample_mvn_precision_shared(draws.normal(SITE_X, (n, K)), Qx,
                                    sq_r * S2)

    eta = sq_r * X[None] + sq_1mr * Z                           # (G, n, K)

    # ---- Lambda | rest: G * P independent K x K systems ------------------
    plam = prior.row_precision(state.prior)                     # (G, P, K)
    if jit_eps:
        plam = plam + jit_eps
    E = _t(eta) @ eta                                           # (G, K, K)
    EY = _t(eta) @ Y                                            # (G, K, P)
    Q = torch.diag_embed(plam) + ps[..., None, None] * E[:, None]
    B = ps[..., None] * _t(EY)                                  # (G, P, K)
    Zn = draws.normal(SITE_LAM, (G, P, K))
    if K <= MAX_K:
        Lam = chol_sample(Q.reshape(G * P, K, K), B.reshape(G * P, K),
                          Zn.reshape(G * P, K)).reshape(G, P, K)
    else:
        Lam = sample_mvn_precision_linalg(Q, B, Zn)

    # ---- shrinkage prior ---------------------------------------------------
    prior_state = prior.update(draws, state.prior, Lam)

    # ---- residual precisions ps | rest -----------------------------------
    if sse_gram:
        # SSE_j = Y_j'Y_j - 2 Lam_j'(EY)_j + Lam_j' E Lam_j on the Lambda
        # stage's moments; the rejection-free Exp-sum Gamma draw
        yty = torch.sum(Y * Y, dim=1)                           # (G, P)
        M = Lam @ E                                             # (G, P, K)
        gunit = gamma_unit_static(draws, SITE_PS, cfg.as_ + 0.5 * n, (G, P),
                                  device=Y.device)
        ps, sse = sse_ps(Lam.reshape(G * P, K), M.reshape(G * P, K),
                         _t(EY).reshape(G * P, K), yty.reshape(G * P),
                         gunit.reshape(G * P), bs=float(cfg.bs))
        ps, sse = ps.reshape(G, P), sse.reshape(G, P)
    else:
        resid = Y - eta @ _t(Lam)                               # (G, n, P)
        sse = torch.sum(resid * resid, dim=1)                   # (G, P)
        ps = gamma_rate(draws, SITE_PS, cfg.as_ + 0.5 * n,
                        cfg.bs + 0.5 * sse)

    return SamplerState(Lambda=Lam, Z=Z, X=X, ps=ps, prior=prior_state), sse


def covariance_panels(Lam_all: torch.Tensor, ps_all: torch.Tensor,
                      rho: float, pair_rows: torch.Tensor,
                      pair_cols: torch.Tensor, *,
                      eta_all: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-draw packed upper-triangle covariance panels (Q, P, P), panel q
    the block (pair_rows[q], pair_cols[q]).

    Scaled estimator (``eta_all`` given): Lam_r H_rc Lam_c' with the
    draw's factor cross-moments H_rc = eta_r' eta_c / n.  Plain rule
    (``eta_all`` None): rho Lam_r Lam_c' off the diagonal, Lam_r Lam_r' on
    it.  Diagonal pairs add diag(1/ps_r)."""
    Lam_r = Lam_all[pair_rows]                                  # (Q, P, K)
    Lam_c = Lam_all[pair_cols]
    diag = pair_rows == pair_cols                               # (Q,)
    if eta_all is not None:
        n = eta_all.shape[1]
        H_grid = torch.einsum("rnk,cnj->rckj", eta_all, eta_all) / n
        H = H_grid[pair_rows, pair_cols]                        # (Q, K, K)
        blocks = (Lam_r @ H) @ _t(Lam_c)
    else:
        blocks = Lam_r @ _t(Lam_c)
        scale = torch.where(diag, torch.ones((), dtype=blocks.dtype,
                                             device=blocks.device),
                            torch.full((), rho, dtype=blocks.dtype,
                                       device=blocks.device))
        blocks = blocks * scale[:, None, None]
    # residual variances on the diagonal pairs, added in place: a second
    # (Q, P, P) temporary would double the combine's footprint
    inv_ps_r = 1.0 / ps_all[pair_rows]                          # (Q, P)
    blocks.diagonal(dim1=-2, dim2=-1).add_(
        diag.to(blocks.dtype)[:, None] * inv_ps_r)
    return blocks
