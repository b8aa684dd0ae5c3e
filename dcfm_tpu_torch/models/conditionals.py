"""The Gibbs sweep: Z, X, Lambda, the prior and psi in turn.

The port of ``dcfm_tpu/models/conditionals.py`` for one device, every
prior (models/priors.py) and the column mask of adaptive rank truncation
(``SamplerState.active``).  The shard axis is an explicit leading batch
dimension (the JAX package vmaps over it), so the X update's cross-shard
sums are plain sums over axis 0.  Every draw comes from ``draws`` (noise.py) at
the JAX package's site ids, and every kernel's noise is drawn outside the
kernel, as the JAX package's Pallas path does.

The Lambda update (K <= 16) takes one of three hand-written kernels,
chosen in the JAX package's order: the fused update K2 for
``lambda_kernel="pallas-fused"`` (ops/lam_update.py), the factor-solve-
sample K1 for "pallas" (ops/chol_sample.py), K4 under
``compute_dtype="bf16"`` otherwise (ops/batched_solve.py), else K1.  The
Gram psi stage runs the fused SSE/rate kernel K5 (ops/sse_gamma.py).  On a
CPU tensor every kernel runs its plain PyTorch version.

Matmul precision: the sweep's float32 products must run in full float32
(the JAX sweep runs them at "high"/"highest" on purpose - under
single-pass reduced precision its Geweke test measured a prior bias).
``api.fit`` refuses to run with TF32 matmuls enabled.  Under
``compute_dtype="bf16"`` the large products that the JAX package routes
through its ``mm`` (the Z and X products, E and EY of the Lambda update)
take bfloat16 inputs with float32 accumulation and output
(:func:`mm_bf16`); every K x K precision, Cholesky and state stays float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.models.state import SamplerState
from dcfm_tpu_torch.noise import (
    SITE_IMPUTE, SITE_LAM, SITE_PS, SITE_X, SITE_Z)
from dcfm_tpu_torch.ops.batched_solve import chol_solve_sample_batched
from dcfm_tpu_torch.ops.chol_sample import MAX_K, chol_sample
from dcfm_tpu_torch.ops.gamma import gamma_rate, gamma_unit_static
from dcfm_tpu_torch.ops.gaussian import (
    sample_mvn_precision_linalg, sample_mvn_precision_shared)
from dcfm_tpu_torch.ops.lam_update import lam_update
from dcfm_tpu_torch.ops.sse_gamma import sse_ps


def scope(name: str):
    """A ``torch.profiler`` range named as the JAX package's named scope
    (z_update, x_update, lambda_update, prior_update, ps_update, combine,
    health_trace, impute_missing) while a profiler records
    (``BackendConfig.profile_dir``); nothing otherwise.  A host-side
    marker: it launches nothing, so a CUDA graph captured through it is
    the graph captured without it, and a replay shows none of it."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def resolve_sse_mode(mode: str, *, n: int, K: int) -> str:
    """"auto" picks "gram" when n >= K per shard (the Gram moments are then
    full rank and cheaper than the (n, P) residual), else "resid"."""
    if mode == "auto":
        return "gram" if n >= K else "resid"
    return mode


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (broadcast over leading dims) on bfloat16-rounded inputs,
    accumulated and returned in float32: the JAX package's
    ``matmul(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)``.
    On the card, cuBLAS's bf16 GEMM with a float32 output (the mm.dtype /
    bmm.dtype overloads; a plain bf16 matmul would round its output to
    bf16).  The CPU has no such overload: there the rounded inputs are
    multiplied in float32, exactly as products of two bf16 values are exact
    in float32, so only the summation order differs."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.device.type != "cuda":
        return a16.float() @ b16.float()
    if a.dim() == 2 and b.dim() == 2:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a16.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b16.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(
        *batch, a.shape[-2], b.shape[-1])


def impute_missing_y(draws, Y: torch.Tensor, state: SamplerState,
                     rho: float, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The data-augmentation site: Y completed by drawing its missing
    entries (NaN, or ``mask`` where given: ``isnan(Y)`` formed once) from
    their conditional given the incoming state, N((eta Lam')_ij, 1/ps_j),
    with eta = sqrt(rho) X + sqrt(1 - rho) Z.  Run before the sweep, which
    then reads the completed matrix in every conditional.

    Full float32 under every ``compute_dtype``: the JAX package runs it
    at matmul precision "highest", never through its bf16 ``mm``.  The
    normals are site 7's, one (n, P) block per shard."""
    G, n, P = Y.shape
    if mask is None:
        mask = torch.isnan(Y)
    eta = (math.sqrt(rho) * state.X[None]
           + math.sqrt(1.0 - rho) * state.Z)                    # (G, n, K)
    mu = eta @ _t(state.Lambda)                                 # (G, n, P)
    mu += draws.normal(SITE_IMPUTE, (G, n, P)) / torch.sqrt(
        state.ps[:, None, :])
    return torch.where(mask, mu, Y)


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
    mm = mm_bf16 if cfg.compute_dtype == "bf16" else torch.matmul
    Lam, ps = state.Lambda, state.ps

    # precision-weighted loadings and their K x K moment, shared by the
    # Z and X updates (both read the incoming Lambda and ps)
    with scope("z_update"):
        W = Lam * ps[..., None]                                     # (G, P, K)
        LtW = mm(_t(Lam), W)                                        # (G, K, K)

        # ---- Z_m | rest -----------------------------------------------------
        Qz = eye + (1.0 - rho) * LtW
        if jit_eps:
            Qz = Qz + jit_eps * eye
        R = Y - sq_r * mm(state.X, _t(Lam))                         # (G, n, P)
        Bz = sq_1mr * mm(R, W)                                      # (G, n, K)
        Z = sample_mvn_precision_shared(draws.normal(SITE_Z, (G, n, K)),
                                        Qz, Bz)

    # ---- X | rest: the one cross-shard update ----------------------------
    with scope("x_update"):
        R = Y - sq_1mr * mm(Z, _t(Lam))
        S1 = torch.sum(LtW, dim=0)                                  # (K, K)
        S2 = torch.sum(mm(R, W), dim=0)                             # (n, K)
        Qx = cfg.x_prior_precision * eye + rho * S1
        if jit_eps:
            Qx = Qx + jit_eps * eye
        X = sample_mvn_precision_shared(draws.normal(SITE_X, (n, K)), Qx,
                                        sq_r * S2)

        eta = sq_r * X[None] + sq_1mr * Z                           # (G, n, K)

    # ---- Lambda | rest: G * P independent K x K systems ------------------
    with scope("lambda_update"):
        plam = prior.row_precision(state.prior)                     # (G, P, K)
        if jit_eps:
            plam = plam + jit_eps
        fused = cfg.lambda_kernel == "pallas-fused"
        # under adaptive rank truncation the inactive columns are conditioned
        # at Lambda_h = 0: masking eta's inactive columns before E and EY makes
        # the precision block-diagonal between active and inactive
        # coordinates, so the active ones are drawn from exactly their
        # conditional; the inactive ones are zeroed after the solve.  The
        # masked moments serve the Gram SSE too (every masked entry meets a
        # zero loading there)
        active = state.active
        eta_lam = eta if active is None else eta * active[:, None, :]
        # the JAX fused path forms the moments with float32 einsums even under
        # bf16, except in Gram mode, where it reuses these mm moments
        mm_e = torch.matmul if fused and not sse_gram else mm
        E = mm_e(_t(eta_lam), eta_lam)                              # (G, K, K)
        EY = mm_e(_t(eta_lam), Y)                                   # (G, K, P)
        EYt = _t(EY).contiguous()                                   # (G, P, K)
        Zn = draws.normal(SITE_LAM, (G, P, K))
        if fused:
            Lam = lam_update(E, plam, ps, EYt, Zn)
        else:
            Q = torch.diag_embed(plam) + ps[..., None, None] * E[:, None]
            B = ps[..., None] * EYt                                 # (G, P, K)
            if cfg.compute_dtype == "bf16" and cfg.lambda_kernel != "pallas":
                Lam = chol_solve_sample_batched(
                    Q.reshape(G * P, K, K), B.reshape(G * P, K),
                    Zn.reshape(G * P, K)).reshape(G, P, K)
            elif K <= MAX_K:
                Lam = chol_sample(Q.reshape(G * P, K, K), B.reshape(G * P, K),
                                  Zn.reshape(G * P, K)).reshape(G, P, K)
            else:
                Lam = sample_mvn_precision_linalg(Q, B, Zn)
        if active is not None:
            Lam = Lam * active[:, None, :]

    # ---- shrinkage prior ---------------------------------------------------
    with scope("prior_update"):
        prior_state = prior.update(draws, state.prior, Lam, active)

    # ---- residual precisions ps | rest -----------------------------------
    with scope("ps_update"):
        if sse_gram:
            # SSE_j = Y_j'Y_j - 2 Lam_j'(EY)_j + Lam_j' E Lam_j on the Lambda
            # stage's moments; the rejection-free Exp-sum Gamma draw
            yty = torch.sum(Y * Y, dim=1)                           # (G, P)
            M = Lam @ E                                             # (G, P, K)
            gunit = gamma_unit_static(draws, SITE_PS, cfg.as_ + 0.5 * n,
                                      (G, P), device=Y.device)
            ps, sse = sse_ps(Lam.reshape(G * P, K), M.reshape(G * P, K),
                             EYt.reshape(G * P, K), yty.reshape(G * P),
                             gunit.reshape(G * P), bs=float(cfg.bs))
            ps, sse = ps.reshape(G, P), sse.reshape(G, P)
        else:
            resid = Y - eta @ _t(Lam)                               # (G, n, P)
            sse = torch.sum(resid * resid, dim=1)                   # (G, P)
            ps = gamma_rate(draws, SITE_PS, cfg.as_ + 0.5 * n,
                            cfg.bs + 0.5 * sse)

    return SamplerState(Lambda=Lam, Z=Z, X=X, ps=ps, prior=prior_state,
                        active=active), sse


def cross_moments(eta: torch.Tensor) -> torch.Tensor:
    """(G, G, K, K) factor cross-moments H_rc = eta_r' eta_c / n of one
    draw's (G, n, K) factors, in float32 (the scaled combine's H, and the
    draw ring's)."""
    return torch.einsum("rnk,cnj->rckj", eta, eta) / eta.shape[1]


def covariance_panels(Lam_all: torch.Tensor, ps_all: torch.Tensor,
                      rho: float, pair_rows: torch.Tensor,
                      pair_cols: torch.Tensor, *,
                      eta_all: Optional[torch.Tensor] = None,
                      compute_dtype: Optional[torch.dtype] = None,
                      H_grid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Per-draw packed upper-triangle covariance panels (Q, P, P), panel q
    the block (pair_rows[q], pair_cols[q]).

    Scaled estimator (``eta_all`` given): Lam_r H_rc Lam_c' with the
    draw's factor cross-moments H_rc = eta_r' eta_c / n (``H_grid``, when
    the caller formed them: :func:`cross_moments` of ``eta_all``).  Plain rule
    (``eta_all`` None): rho Lam_r Lam_c' off the diagonal, Lam_r Lam_r' on
    it.  Diagonal pairs add diag(1/ps_r).

    ``compute_dtype=torch.bfloat16`` runs the block products on bf16
    inputs with float32 accumulation and output (:func:`mm_bf16`); as in
    the JAX package, H is formed in float32 and the intermediate Lam_r H is
    rounded to bf16 again before the second product.  None is float32."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(
            f"compute_dtype must be None or torch.bfloat16, got "
            f"{compute_dtype}")
    mm = torch.matmul if compute_dtype is None else mm_bf16
    Lam_r = Lam_all[pair_rows]                                  # (Q, P, K)
    Lam_c = Lam_all[pair_cols]
    diag = pair_rows == pair_cols                               # (Q,)
    if eta_all is not None:
        if H_grid is None:
            H_grid = cross_moments(eta_all)
        H = H_grid[pair_rows, pair_cols]                        # (Q, K, K)
        blocks = mm(mm(Lam_r, H), _t(Lam_c))
    else:
        blocks = mm(Lam_r, _t(Lam_c))
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
