"""Chain driver: a Python loop over Gibbs sweeps with on-device
accumulation of the packed posterior-mean covariance panels.

The port of ``init_chain`` / ``run_chunk`` in ``dcfm_tpu/models/sampler.py``
(where a ``lax.scan`` runs the loop).  Every draw of iteration ``it`` comes
from ``noise.sweep(chain, it)``, keyed on the chain's global index and the
global iteration, so splitting a run into chunks never changes the chain.
Nothing in the loop reads a device value on the host: the save cadence is
host arithmetic, and health and trace stay on the device until the chunk
ends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.models.conditionals import covariance_panels, gibbs_sweep
from dcfm_tpu_torch.models.state import (
    SamplerState, init_state, num_padded_pairs, packed_pair_indices)

# per-iteration chain summaries, in the JAX package's order: mean signal
# variance, mean residual variance, their sum, average log-likelihood
TRACE_SUMMARIES = ("signal_var_mean", "resid_var_mean", "sigma_diag_mean",
                   "avg_loglik")


@dataclasses.dataclass
class ChainCarry:
    state: SamplerState
    sigma_acc: torch.Tensor   # (Q, P, P) packed running SUM of the upper
                              # Sigma panels over saved draws (divided by
                              # num_saved_draws at fetch)
    iteration: int            # global Gibbs iterations done
    health: torch.Tensor      # (G, 4) running [max |log tau|, min ps,
                              # max ps, #iterations with non-finite state]


class ChainStats(NamedTuple):
    """Numerical-health diagnostics over every iteration seen."""
    tau_log_max: float
    ps_min: float
    ps_max: float
    # (iteration, shard) pairs whose post-sweep state held a non-finite
    # value (a failed K x K Cholesky propagates NaN); 0 on a healthy chain
    nonfinite_count: float
    # non-finite entries of the accumulator at chunk end
    acc_nonfinite: float


def num_saved_draws(iteration: int, burnin: int, thin: int) -> int:
    """Saved draws after ``iteration`` global iterations."""
    return max(0, int(iteration) - burnin) // thin


def _health_now(state: SamplerState, prior) -> torch.Tensor:
    shrink_log = prior.health(state.prior)                      # (G,)
    ok = (torch.isfinite(state.Lambda).all(dim=2).all(dim=1)
          & torch.isfinite(state.ps).all(dim=1)
          & torch.isfinite(state.X).all()
          & torch.isfinite(shrink_log))
    bad = (~ok).to(state.ps.dtype)
    return torch.stack([shrink_log, state.ps.amin(dim=-1),
                        state.ps.amax(dim=-1), bad], dim=-1)


def _health_update(running: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.maximum(running[:, 0], now[:, 0]),
                        torch.minimum(running[:, 1], now[:, 1]),
                        torch.maximum(running[:, 2], now[:, 2]),
                        running[:, 3] + now[:, 3]], dim=-1)


def _trace_now(state: SamplerState, sse: torch.Tensor,
               rho: float) -> torch.Tensor:
    """(4,) summaries of one sweep's output, from the (G, P) SSE the psi
    stage already formed (no data-sized contraction)."""
    G, P = state.ps.shape
    n = state.X.shape[0]
    p_total = G * P
    eta = math.sqrt(rho) * state.X[None] + math.sqrt(1.0 - rho) * state.Z
    E = torch.einsum("gnk,gnj->gkj", eta, eta) / n
    M = torch.einsum("gpk,gkj->gpj", state.Lambda, E)
    sig_j = torch.sum(M * state.Lambda, dim=-1)                 # (G, P)
    loglik = 0.5 * torch.sum(
        n * (torch.log(state.ps) - math.log(2.0 * math.pi))
        - state.ps * sse, dim=-1)                               # (G,)
    signal, rvar, ll = torch.sum(torch.stack(
        [torch.sum(sig_j, dim=-1), torch.sum(1.0 / state.ps, dim=1),
         loglik], dim=-1), dim=0)
    return torch.stack([signal / p_total, rvar / p_total,
                        (signal + rvar) / p_total, ll / (p_total * n)])


def init_chain(draws, Y: torch.Tensor, cfg: ModelConfig, prior) -> ChainCarry:
    """Initial state, a zero packed accumulator and a fresh health panel."""
    G, n, P = Y.shape
    state = init_state(draws, prior, G=G, n=n, P=P,
                       K=cfg.factors_per_shard, as_=cfg.as_, bs=cfg.bs,
                       device=Y.device)
    acc = torch.zeros((num_padded_pairs(G), P, P), dtype=torch.float32,
                      device=Y.device)
    health = torch.tensor([0.0, math.inf, 0.0, 0.0], dtype=torch.float32,
                          device=Y.device).expand(G, 4).clone()
    return ChainCarry(state=state, sigma_acc=acc, iteration=0, health=health)


def run_chunk(noise, chain: int, Y: torch.Tensor, carry: ChainCarry,
              cfg: ModelConfig, prior, *, num_iters: int, burnin: int,
              thin: int) -> tuple[ChainCarry, ChainStats, torch.Tensor]:
    """Run ``num_iters`` Gibbs iterations of chain ``chain`` from ``carry``.

    On every thin-th post-burn-in iteration the packed Sigma panels of the
    draw are ADDED to the accumulator (raw sums; the caller divides by
    :func:`num_saved_draws`).  Returns (carry, stats, trace) with trace
    (num_iters, 4) on the device."""
    G = Y.shape[0]
    rows, cols = packed_pair_indices(G)
    rows = torch.as_tensor(rows, dtype=torch.long, device=Y.device)
    cols = torch.as_tensor(cols, dtype=torch.long, device=Y.device)
    state, acc, health = carry.state, carry.sigma_acc, carry.health
    sq_r, sq_1mr = math.sqrt(cfg.rho), math.sqrt(1.0 - cfg.rho)
    # the combine's input dtype: the combine_dtype knob, or the sweep-wide
    # bf16 policy; the accumulator stays float32 either way
    c_dtype = (torch.bfloat16 if (cfg.combine_dtype == "bfloat16"
                                  or cfg.compute_dtype == "bf16") else None)
    traces = []
    it = carry.iteration
    for _ in range(num_iters):
        state, sse = gibbs_sweep(noise.sweep(chain, it), Y, state, cfg,
                                 prior)
        it += 1                                   # 1-based, like the JAX chain
        if it > burnin and (it - burnin) % thin == 0:
            eta = (sq_r * state.X[None] + sq_1mr * state.Z
                   if cfg.estimator == "scaled" else None)
            acc += covariance_panels(state.Lambda, state.ps, cfg.rho, rows,
                                     cols, eta_all=eta, compute_dtype=c_dtype)
        health = _health_update(health, _health_now(state, prior))
        traces.append(_trace_now(state, sse, cfg.rho))
    h = health.cpu()
    stats = ChainStats(
        tau_log_max=float(h[:, 0].max()), ps_min=float(h[:, 1].min()),
        ps_max=float(h[:, 2].max()), nonfinite_count=float(h[:, 3].sum()),
        acc_nonfinite=float((~torch.isfinite(acc)).sum()))
    trace = (torch.stack(traces) if traces else
             torch.zeros((0, len(TRACE_SUMMARIES)), device=Y.device))
    return ChainCarry(state, acc, it, health), stats, trace
