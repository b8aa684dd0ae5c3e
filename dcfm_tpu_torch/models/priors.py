"""Shrinkage priors on the loadings: MGP, horseshoe and Dirichlet-Laplace.

The port of ``dcfm_tpu/models/priors.py``.  A prior is a set of functions
over the prior state of ALL shards at once - the shard axis is an
explicit leading batch dimension where the JAX package vmaps:

    init(draws, G, P, K)               -> prior state, leaves (G, ...)
    update(draws, state, Lam, active)  -> the same, given Lambda (G, P, K)
    row_precision(state)               -> (G, P, K) loading-row precision
    health(state)                      -> (G,) |log global scale| watch

``active`` is the (G, K) 0/1 column mask of adaptive rank truncation
(models/adapt.py), or None when adaptation is off: deactivated columns'
loadings are conditioned at 0, so they drop out of the sufficient
statistics, and column-counting shapes count only active columns.  Where
such a shape is a Gamma's, the update draws a candidate table
(``Draws.gamma_candidates``: one standard Gamma per possible count) and
picks the realised count's entry on the device, so its draws stay
independent of the chain state (noise.py).  With ``active`` None every
update draws exactly what it drew before adaptation existed.

Every draw is taken from ``draws`` at ``SITE_PRIOR``, addressed by the
JAX package's key path (noise.py ``part``).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.noise import SITE_PRIOR, sub_part
from dcfm_tpu_torch.ops.gamma import (
    gamma_rate, gamma_rate_half_integer, inverse_gamma_rate)
from dcfm_tpu_torch.ops.gig import gig, inverse_gaussian


class Prior(NamedTuple):
    name: str
    init: Callable[..., Any]
    update: Callable[..., Any]
    row_precision: Callable[[Any], torch.Tensor]
    health: Callable[[Any], torch.Tensor]


def _pick(table: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``table[..., count]`` elementwise: the candidate draw at the
    realised (integer-valued float) count."""
    return torch.gather(table, -1, count.long().unsqueeze(-1)).squeeze(-1)


# --------------------------------------------------------------------------
# MGP: multiplicative gamma process (the reference's prior)
# --------------------------------------------------------------------------

def _mgp_tauh(delta: torch.Tensor) -> torch.Tensor:
    """tau_h = prod_{l<=h} delta_l over the last axis, via logs."""
    return torch.exp(torch.cumsum(torch.log(delta), dim=-1))


def make_mgp(cfg: ModelConfig) -> Prior:
    c = cfg.mgp

    def init(draws, G: int, P: int, K: int, *, device=None):
        # psi_jh ~ Gamma(df/2, df/2); delta_1 ~ Gamma(ad1, bd1),
        # delta_h ~ Gamma(ad2, bd2) - rate convention
        psijh = gamma_rate(draws, SITE_PRIOR, c.df / 2, c.df / 2,
                           sample_shape=(G, P, K), device=device)
        d1 = gamma_rate(draws, SITE_PRIOR, c.ad1, c.bd1,
                        sample_shape=(G, 1), device=device)
        if K > 1:
            dh = gamma_rate(draws, SITE_PRIOR, c.ad2, c.bd2,
                            sample_shape=(G, K - 1), device=device)
            delta = torch.cat([d1, dh], dim=1)
        else:
            delta = d1
        return {"psijh": psijh, "delta": delta}

    def update(draws, state, Lam: torch.Tensor, active=None):
        G, P, K = Lam.shape
        dev = Lam.device
        psijh, delta = state["psijh"], state["delta"]
        tauh = _mgp_tauh(delta)                                  # (G, K)
        lam2 = Lam * Lam

        # psi_jh | rest ~ Gamma(df/2 + a_h/2, df/2 + tau_h lam_jh^2 / 2):
        # a deactivated column carries no loading observation and redraws
        # from the prior Gamma(df/2, df/2)
        psi_rate = c.df / 2 + 0.5 * tauh[:, None, :] * lam2
        if float(c.df).is_integer() and c.df <= 7:
            if active is None:
                twice = torch.full(lam2.shape, int(c.df) + 1,
                                   dtype=torch.int32, device=dev)
            else:
                twice = int(c.df) + active[:, None, :].expand(
                    G, P, K).to(torch.int32)
            psijh = gamma_rate_half_integer(
                draws, SITE_PRIOR, twice, psi_rate,
                max_twice=int(c.df) + 1, part=0)
        elif active is None:
            psijh = gamma_rate(draws, SITE_PRIOR, c.df / 2 + 0.5, psi_rate,
                               part=0)
        else:
            # shape df/2 + active/2: candidates at active = 0 and 1
            alphas = (c.df / 2 + 0.5 * torch.arange(
                2, dtype=torch.float32, device=dev)).expand(
                    G, P, K, 2).contiguous()
            g = _pick(draws.gamma_candidates(SITE_PRIOR, alphas, part=0),
                      active[:, None, :].expand(G, P, K))
            psijh = g / psi_rate

        # delta_h | rest, sequential in h with tau recomputed after each
        # update; all K standard gammas drawn up front (only the RATE
        # depends on the recursion).  The shapes count the active columns
        # l >= h (all K - h without adaptation)
        s = torch.sum(psijh * lam2, dim=1)                       # (G, K)
        hs = torch.arange(K, device=dev)
        rates0 = torch.where(hs == 0, c.bd1, c.bd2).to(torch.float32)
        if active is None:
            n_ge = torch.arange(K, 0, -1, device=dev, dtype=torch.float32)
            shapes = torch.where(hs == 0, c.ad1 + 0.5 * P * n_ge[0],
                                 c.ad2 + 0.5 * P * n_ge)
            g_std = draws.standard_gamma(
                SITE_PRIOR, shapes.expand(G, K).contiguous(), part=1)
        else:
            n_ge = torch.flip(torch.cumsum(torch.flip(active, [-1]), -1),
                              [-1])                              # (G, K)
            counts = torch.arange(K + 1, device=dev, dtype=torch.float32)
            base = torch.where(hs == 0, c.ad1, c.ad2).to(torch.float32)
            alphas = (base[:, None] + 0.5 * P * counts).expand(
                G, K, K + 1).contiguous()                  # (G, K, K + 1)
            g_std = _pick(draws.gamma_candidates(SITE_PRIOR, alphas,
                                                 part=1), n_ge)
        delta = delta.clone()
        for h in range(K):
            tau_minus = _mgp_tauh(delta) / delta[:, h:h + 1]
            mask = (hs >= h).to(lam2.dtype)
            rate = rates0[h] + 0.5 * torch.sum(mask * tau_minus * s, dim=-1)
            delta[:, h] = g_std[:, h] / rate
        return {"psijh": psijh, "delta": delta}

    def row_precision(state):
        return state["psijh"] * _mgp_tauh(state["delta"])[:, None, :]

    def health(state):
        return torch.amax(torch.abs(torch.cumsum(torch.log(state["delta"]),
                                                 dim=-1)), dim=-1)

    return Prior("mgp", init, update, row_precision, health)


# --------------------------------------------------------------------------
# Horseshoe (Makalic & Schmidt 2016 auxiliary parameterization)
# --------------------------------------------------------------------------
# lam_jh ~ N(0, lam2_jh tau2); sqrt(lam2) ~ C+(0, 1); sqrt(tau2) ~ C+(0, s),
# with auxiliaries nu_jh and xi every conditional inverse-gamma.  The
# state clamps keep a deactivated column's free-running (lam2, nu) pair
# inside float32 (the JAX package found lam2 underflowing to 0 and the
# tau2 rate turning 0/0), and the row precision is bounded so the Lambda
# update's Cholesky stays well-scaled.
_HS_TINY, _HS_HUGE = 1e-30, 1e30
_HS_MAX_PRECISION = 1e12


def make_horseshoe(cfg: ModelConfig) -> Prior:
    s2 = cfg.horseshoe.global_scale ** 2

    def init(draws, G: int, P: int, K: int, *, device=None):
        # draws nothing
        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=device)
        return {"lam2": ones(G, P, K), "nu": ones(G, P, K),
                "tau2": ones(G), "xi": ones(G)}

    def update(draws, state, Lam: torch.Tensor, active=None):
        G, P, K = Lam.shape
        lam_sq = Lam * Lam
        tau2 = state["tau2"]
        lam2 = torch.clamp(inverse_gamma_rate(
            draws, SITE_PRIOR, 1.0,
            1.0 / state["nu"] + 0.5 * lam_sq / tau2[:, None, None],
            part=((4, 0),)), _HS_TINY, _HS_HUGE)
        nu = torch.clamp(inverse_gamma_rate(
            draws, SITE_PRIOR, 1.0, 1.0 + 1.0 / lam2, part=((4, 1),)),
            _HS_TINY, _HS_HUGE)
        # tau2's shape counts the loadings that exist: P per active column
        # (deactivated columns' lam_sq is 0 by masking, so the rate needs
        # no correction - lam2 is clamped above 0)
        rate = 1.0 / state["xi"] + 0.5 * torch.sum(lam_sq / lam2,
                                                   dim=(1, 2))
        if active is None:
            tau2 = inverse_gamma_rate(draws, SITE_PRIOR,
                                      0.5 * (P * float(K) + 1), rate,
                                      part=((4, 2),))
        else:
            counts = torch.arange(K + 1, device=Lam.device,
                                  dtype=torch.float32)
            alphas = (0.5 * (P * counts + 1)).expand(G, K + 1).contiguous()
            g = _pick(draws.gamma_candidates(SITE_PRIOR, alphas,
                                             part=((4, 2),)),
                      torch.sum(active, dim=-1))
            tau2 = 1.0 / (g / rate)
        tau2 = torch.clamp(tau2, _HS_TINY, _HS_HUGE)
        xi = torch.clamp(inverse_gamma_rate(
            draws, SITE_PRIOR, 1.0, 1.0 / s2 + 1.0 / tau2, part=((4, 3),)),
            _HS_TINY, _HS_HUGE)
        return {"lam2": lam2, "nu": nu, "tau2": tau2, "xi": xi}

    def row_precision(state):
        return 1.0 / torch.clamp(state["lam2"] * state["tau2"][:, None, None],
                                 1.0 / _HS_MAX_PRECISION, _HS_MAX_PRECISION)

    def health(state):
        return torch.abs(torch.log(state["tau2"]))

    return Prior("horseshoe", init, update, row_precision, health)


# --------------------------------------------------------------------------
# Dirichlet-Laplace (Bhattacharya, Pati, Pillai & Dunson 2015), row-wise
# --------------------------------------------------------------------------
# Per loading row j (theta = Lambda_j.):
#   theta_h ~ N(0, psi_jh phi_jh^2 tau_j^2),  psi_jh ~ Exp(1/2),
#   phi_j. ~ Dirichlet(a, ..., a),  tau_j ~ Gamma(K a, 1/2);
#   1/psi_jh | . ~ iGauss(phi_jh tau_j / |theta_h|, 1),
#   tau_j | . ~ GIG(K(a - 1), 1, 2 sum_h |theta_h| / phi_jh),
#   phi_j. | . = T / sum(T),  T_h ~ GIG(a - 1, 1, 2 |theta_h|).
# The row precision is clamped at _DL_MAX_PRECISION (deep enough that the
# clamp binds rarely: the JAX package's Geweke test measured a bias at
# 1e8 and none at 1e12).
_DL_MAX_PRECISION = 1e12
_DL_EPS = 1e-8


def make_dl(cfg: ModelConfig) -> Prior:
    a = cfg.dl.a
    k_psi, k_tau, k_phi = ((3, 0),), ((3, 1),), ((3, 2),)

    def init(draws, G: int, P: int, K: int, *, device=None):
        # the init key splits as (psi, phi, tau), the update's as
        # (psi, tau, phi)
        psi = 2.0 * draws.exponential(SITE_PRIOR, (G, P, K),
                                      part=((3, 0),))          # Exp(1/2)
        d = gamma_rate(draws, SITE_PRIOR, a, 1.0, sample_shape=(G, P, K),
                       part=((3, 1),), device=device)         # Dirichlet(a)
        phi = d / torch.sum(d, dim=-1, keepdim=True)
        tau = gamma_rate(draws, SITE_PRIOR, K * a, 0.5, sample_shape=(G, P),
                         part=((3, 2),), device=device)
        return {"psi": psi, "phi": phi, "tau": tau}

    def update(draws, state, Lam: torch.Tensor, active=None):
        # UPDATE ORDER IS LOAD-BEARING (partially collapsed Gibbs): phi |
        # theta marginalizes psi and tau, tau | phi, theta marginalizes
        # psi - so phi first, then tau given the new phi, then psi given
        # both (the JAX package's Geweke test catches the paper's order at
        # z ~ 13).  Under adaptation the row vector is the active
        # coordinates only: tau's GIG order counts them, its rate and
        # phi's normalization sum over them, and deactivated coordinates'
        # psi and phi redraw from the prior.
        G, P, K = Lam.shape
        absL = torch.clamp_min(torch.abs(Lam), _DL_EPS)
        T = gig(draws, SITE_PRIOR, a - 1.0, 1.0, 2.0 * absL, part=k_phi)
        if active is None:
            phi = T / torch.sum(T, dim=-1, keepdim=True)
            phi = torch.clamp_min(phi, _DL_EPS)
            tau = gig(draws, SITE_PRIOR, K * (a - 1.0), 1.0,
                      2.0 * torch.sum(absL / phi, dim=-1), part=k_tau)
            mu = phi * tau[..., None] / absL
            psi = 1.0 / inverse_gaussian(draws, SITE_PRIOR, mu, 1.0,
                                         part=k_psi)
            return {"psi": psi, "phi": phi, "tau": tau}

        act = active[:, None, :]                               # (G, 1, K)
        n_act = torch.sum(active, dim=-1, keepdim=True)        # (G, 1)
        d_prior = gamma_rate(draws, SITE_PRIOR, a, 1.0,
                             sample_shape=(G, P, K),
                             part=sub_part(k_phi, ("fold", 1)),
                             device=Lam.device)
        T = torch.where(act > 0, act * T, d_prior)
        # active coordinates normalize over the active sum (the truncated
        # Dirichlet), inactive ones over the inactive sum (a prior draw)
        sum_act = torch.sum(act * T, dim=-1, keepdim=True)
        sum_inact = torch.sum((1.0 - act) * T, dim=-1, keepdim=True)
        phi = torch.where(act > 0, T / torch.clamp_min(sum_act, _DL_EPS),
                          T / torch.clamp_min(sum_inact, _DL_EPS))
        phi = torch.clamp_min(phi, _DL_EPS)
        tau = gig(draws, SITE_PRIOR, n_act * (a - 1.0), 1.0,
                  2.0 * torch.sum(act * absL / phi, dim=-1), part=k_tau)
        mu = phi * tau[..., None] / absL
        psi_cond = 1.0 / inverse_gaussian(draws, SITE_PRIOR, mu, 1.0,
                                          part=k_psi)
        # the prior draw of deactivated coordinates: Exp(1/2) = 2 Exp(1)
        psi_prior = 2.0 * draws.exponential(
            SITE_PRIOR, (G, P, K), part=sub_part(k_psi, ("fold", 1)))
        psi = torch.where(act > 0, psi_cond, psi_prior)
        return {"psi": psi, "phi": phi, "tau": tau}

    def row_precision(state):
        v = (state["psi"] * torch.square(state["phi"])
             * torch.square(state["tau"])[..., None])
        return 1.0 / torch.clamp_min(v, 1.0 / _DL_MAX_PRECISION)

    def health(state):
        return torch.amax(torch.abs(torch.log(state["tau"])), dim=-1)

    return Prior("dl", init, update, row_precision, health)


def make_prior(cfg: ModelConfig) -> Prior:
    if cfg.prior == "mgp":
        return make_mgp(cfg)
    if cfg.prior == "horseshoe":
        return make_horseshoe(cfg)
    if cfg.prior == "dl":
        return make_dl(cfg)
    raise ValueError(f"unknown prior {cfg.prior!r}")
