"""The plain reference of a fit under the Dirichlet-Laplace prior
(Bhattacharya, Pati, Pillai and Dunson, "Dirichlet-Laplace priors for
optimal shrinkage", JASA 110, 2015, doi:10.1080/01621459.2014.960967),
put row-wise on the loadings: the chain of :mod:`fitref.gibbs` with DL's
conditionals as its ``Prior`` record.

Per loading row of a shard, theta = (theta_1, ..., theta_K):

    theta_h ~ N(0, psi_h phi_h^2 tau^2),   psi_h ~ Exp(rate 1/2),
    phi ~ Dirichlet(a, ..., a),            tau ~ Gamma(K a, rate 1/2),

and the paper's conditionals, with GIG(p, a, b) the density proportional
to x^(p - 1) exp(-(a x + b / x) / 2):

    phi = T / sum(T),  T_h | theta ~ GIG(a - 1, 1, 2 |theta_h|),
    tau | phi, theta ~ GIG(K (a - 1), 1, 2 sum_h |theta_h| / phi_h),
    1 / psi_h | phi, tau, theta ~ iGauss(phi_h tau / |theta_h|, 1).

The first marginalizes psi and tau, the second psi, so a sweep draws
them in that order - phi, then tau given the new phi, then psi given
both - which makes the blocked sampler a partially collapsed Gibbs
sampler of the right posterior; the paper lists psi first, which with
these collapsed conditionals is not.

Departures from the paper, each the program's own:

* the GIG is Devroye's (2014) rejection sampler run for at most 64
  rounds, whose uniforms U, V, W are all drawn before the first round;
  the loop stops once every element has accepted, and an element no
  round accepts takes the peak of Devroye's log-density (X = 0 there),
  mapped back to GIG(p, a, b);
* V is a U(0, 1) variate plus 1e-30, and the GIG's a and b are floored at
  1e-12;
* |theta_h| is floored at 1e-8, phi_h too (after the normalization), and
  a row's prior precision 1 / (psi_h phi_h^2 tau^2) is capped at 1e12;
* the inverse Gaussian is Michael, Schucany and Haas's transform of one
  normal and one uniform, its smaller root written without cancellation,
  x = mu 4 w / (w + sqrt(w (w + 4)))^2 for w = mu nu^2 clipped to
  [1e-20, 1e18], and the other root mu^2 / x with x floored at 1e-30.

The variates are drawn at the prior's site in the program's order and
shapes (fitref/streams.py), so the two chains consume the same ones: at
the initial state Exp(1) for psi, the Dirichlet's Gammas, tau's Gamma; in
each sweep the U, V, W of T's rounds, each (G, 64, P, K), those of tau's,
each (G, 64, P), then the inverse Gaussian's normals and uniforms, each
(G, P, K).  Adaptive rank truncation is not written out and is refused.
"""

from __future__ import annotations

import math

import torch

from fitref import gibbs
from fitref.streams import SITE_PRIOR, ChainStreams

ROUNDS = 64
_EPS, _MAX_PRECISION = 1e-8, 1e12


# -- Devroye's GIG sampler as an early-exit loop ------------------------------

def _psi(x, alpha, lam):
    """Devroye's log-density of log(X / m): -alpha (cosh x - 1) - lam
    (e^x - 1 - x)."""
    return -alpha * (torch.cosh(x) - 1.0) - lam * (torch.expm1(x) - x)


def _dpsi(x, alpha, lam):
    return -alpha * torch.sinh(x) - lam * torch.expm1(x)


def gig(st: ChainStreams, p: float, a, b: torch.Tensor,
        rounds: int = ROUNDS) -> torch.Tensor:
    """GIG(p, a, b) draws shaped like ``b`` (C, G, ...), p and a scalars.
    X ~ GIG(p, a, b) is sqrt(b / a) W with W ~ GIG(p, w, w), w =
    sqrt(a b), and 1 / W ~ GIG(-p, w, w); Devroye draws GIG(|p|, w, w)
    as m e^X, m = |p| / w + sqrt(1 + (|p| / w)^2), X from the density
    e^psi(x) by rejection under a three-piece hat."""
    a = torch.clamp_min(torch.full_like(b, float(a)), 1e-12)
    b = torch.clamp_min(b, 1e-12)
    lam = abs(float(p))
    omega = torch.sqrt(a * b)
    alpha = torch.sqrt(omega * omega + lam * lam) - lam
    one = torch.ones_like(alpha)

    # the hat's inner interval [-s, t]
    x_t = -_psi(one, alpha, lam)
    t = torch.where(x_t > 2.0, torch.sqrt(2.0 / (alpha + lam)),
                    torch.where(x_t < 0.5,
                                torch.log(4.0 / (alpha + 2.0 * lam)), one))
    x_s = -_psi(-one, alpha, lam)
    inv = 1.0 / alpha
    s = torch.where(
        x_s > 2.0, torch.sqrt(4.0 / (alpha * math.cosh(1.0) + lam)),
        torch.where(x_s < 0.5,
                    torch.minimum(
                        torch.full_like(alpha, 1.0 / max(lam, 1e-30)),
                        torch.log1p(inv + torch.sqrt(inv * inv
                                                     + 2.0 * inv))),
                    one))
    eta, zeta = -_psi(t, alpha, lam), -_dpsi(t, alpha, lam)
    theta, xi = -_psi(-s, alpha, lam), _dpsi(-s, alpha, lam)
    p_, r_ = 1.0 / xi, 1.0 / zeta
    t_, s_ = t - r_ * eta, s - p_ * theta
    q = t_ + s_
    total = p_ + q + r_

    # every round's uniforms first, the round axis after the shard axis
    shape = tuple(b.shape[1:2]) + (rounds,) + tuple(b.shape[2:])
    U, V, W = (st.uniform(SITE_PRIOR, shape) for _ in range(3))
    V = V + 1e-30
    x = torch.zeros_like(alpha)
    done = torch.zeros(alpha.shape, dtype=torch.bool, device=alpha.device)
    for k in range(rounds):
        u, v, w = U[:, :, k], V[:, :, k], W[:, :, k]
        cand = torch.where(
            u < q / total, -s_ + q * v,
            torch.where(u < (q + r_) / total, t_ - r_ * torch.log(v),
                        -s_ + p_ * torch.log(v)))
        hat = torch.where(
            (cand >= -s_) & (cand <= t_), torch.ones_like(cand),
            torch.where(cand > t_, torch.exp(-eta - zeta * (cand - t)),
                        torch.exp(-theta + xi * (cand + s))))
        ok = w * hat <= torch.exp(_psi(cand, alpha, lam))
        x = torch.where(ok & ~done, cand, x)
        done = done | ok
        if bool(done.all()):
            break
    ratio = lam / omega
    y = torch.exp(x) * (ratio + torch.sqrt(1.0 + ratio * ratio))
    if p < 0:
        y = 1.0 / y
    return y * torch.sqrt(b / a)


def inverse_gaussian(st: ChainStreams, mu: torch.Tensor,
                     lam: float = 1.0) -> torch.Tensor:
    """iGauss(mu, lam) draws (mean mu, variance mu^3 / lam), shaped like
    ``mu`` (C, G, ...): Michael, Schucany and Haas's smaller root x of
    lam (x - mu)^2 = mu^2 x nu^2, kept with probability mu / (mu + x),
    else mu^2 / x."""
    shape = tuple(mu.shape[1:])
    nu = st.normal(SITE_PRIOR, shape)
    w = torch.clamp(mu * (nu * nu), 1e-20, 1e18)
    d = w + torch.sqrt(w * (w + 4.0 * lam))
    x = mu * (4.0 * lam * w) / (d * d)
    u = st.uniform(SITE_PRIOR, shape)
    return torch.where(u <= mu / (mu + x), x,
                       mu * mu / torch.clamp_min(x, 1e-30))


# -- the prior -----------------------------------------------------------------

def _a(model: dict) -> float:
    return float(model["dl"]["a"])


def _init(model: dict, st: ChainStreams, G: int, P: int, K: int) -> dict:
    a = _a(model)
    psi = 2.0 * st.exponential(SITE_PRIOR, (G, P, K))            # Exp(1/2)
    d = gibbs.gamma_static(st, SITE_PRIOR, a, (G, P, K))
    phi = d / torch.sum(d, dim=-1, keepdim=True)                 # Dirichlet
    tau = gibbs.gamma_static(st, SITE_PRIOR, K * a, (G, P)) / 0.5
    return {"psi": psi, "phi": phi, "tau": tau}


def _update(model: dict, st: ChainStreams, pr: dict, Lam: torch.Tensor,
            active) -> dict:
    a, K = _a(model), Lam.shape[-1]
    absL = torch.clamp_min(torch.abs(Lam), _EPS)
    T = gig(st, a - 1.0, 1.0, 2.0 * absL)
    phi = torch.clamp_min(T / torch.sum(T, dim=-1, keepdim=True), _EPS)
    tau = gig(st, K * (a - 1.0), 1.0, 2.0 * torch.sum(absL / phi, dim=-1))
    psi = 1.0 / inverse_gaussian(st, phi * tau[..., None] / absL)
    return {"psi": psi, "phi": phi, "tau": tau}


def _row_precision(model: dict, pr: dict) -> torch.Tensor:
    v = pr["psi"] * pr["phi"] ** 2 * (pr["tau"] ** 2)[..., None]
    return 1.0 / torch.clamp_min(v, 1.0 / _MAX_PRECISION)


DL = gibbs.Prior(_init, _update, _row_precision)


def posterior_mean(Y, model: dict, schedule: dict, seed: int, chains: int,
                   device, *, dtype=torch.float32):
    """The fit's posterior-mean panels under the DL prior, with
    :func:`fitref.gibbs.posterior_mean`'s meaning; a model with another
    prior, or with adaptive rank truncation, is refused by name."""
    if model["prior"] != "dl":
        raise NotImplementedError(f"prior {model['prior']!r}: this is the "
                                  "DL reference")
    if model.get("rank_adapt"):
        raise NotImplementedError("the DL reference has no rank_adapt")
    return gibbs.posterior_mean(Y, model, schedule, seed, chains, device,
                                dtype=dtype, prior=DL)
