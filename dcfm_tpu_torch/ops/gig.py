"""Inverse-Gaussian and generalized-inverse-Gaussian samplers.

The port of ``dcfm_tpu/ops/gig.py``, the Dirichlet-Laplace prior's
conditionals.  Each takes its raw unit variates from a ``Draws`` object
(noise.py) and transforms them exactly as the JAX package transforms its
own, so fed the same variates both return the same draws.

* :func:`inverse_gaussian`: the Michael-Schucany-Haas transform of one
  standard normal and one uniform per draw, with the cancellation-free
  root ``x = mu * 4 lam w / (w + sqrt(w (w + 4 lam)))^2``, ``w = mu nu^2``.
* :func:`gig`: Devroye's (2014) rejection sampler for GIG(p, a, b),
  density ~ x^(p-1) exp(-(a x + b/x)/2).  The JAX package runs a masked
  rejection loop of at most ``max_rounds`` rounds that stops once every
  element has accepted; here every round is drawn up front (three
  uniforms per element and round, noise ``("rounds", R)`` parts), every
  candidate and acceptance is computed at once along a round axis, and
  each element takes the candidate of its first accepting round (zero
  where no round accepts, as the loop leaves it).  That is the loop's
  value element for element - the loop only stops after each element's
  first accept - and it has a fixed shape, so it runs inside a CUDA
  graph with no wait on a device flag.  Plain PyTorch: the JAX module
  has no Pallas kernel.
"""

from __future__ import annotations

import torch

from dcfm_tpu_torch.noise import sub_part

# rounds of the GIG rejection sampler (the JAX package's max_rounds)
MAX_ROUNDS = 64


def inverse_gaussian(draws, site: int, mu: torch.Tensor, lam=1.0, *,
                     part=None) -> torch.Tensor:
    """iGauss(mu, lam) draws (mean mu, variance mu^3 / lam), shaped like
    ``mu``: the normal from child 0 of ``part``'s key, the uniform from
    child 1."""
    shape = tuple(mu.shape)
    nu = draws.normal(site, shape, part=sub_part(part, 0))
    # mu * chi^2_1, clipped so w (w + 4 lam) neither under- nor overflows
    w = torch.clamp(mu * (nu * nu), 1e-20, 1e18)
    d = w + torch.sqrt(w * (w + 4.0 * lam))
    x = mu * (4.0 * lam * w) / (d * d)
    u = draws.uniform(site, shape, part=sub_part(part, 1))
    return torch.where(u <= mu / (mu + x), x,
                       mu * mu / torch.clamp_min(x, 1e-30))


def _psi(x, alpha, lam):
    return -alpha * (torch.cosh(x) - 1.0) - lam * (torch.expm1(x) - x)


def _dpsi(x, alpha, lam):
    return -alpha * torch.sinh(x) - lam * torch.expm1(x)


def gig(draws, site: int, p, a, b, *, part=None,
        max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """GIG(p, a, b) draws, broadcasting p, a and b elementwise (``b`` a
    tensor whose leading axis is the shard axis).  Negative orders go through
    X ~ GIG(p, a, b) <=> 1/X ~ GIG(-p, b, a); a and b are clamped at
    1e-12.  Round r's uniforms U, V, W are children 0, 1, 2 of the
    three-way split of the round's key; V takes the JAX package's
    ``minval=1e-30``."""
    dev = b.device
    # scalars built on the device (torch.full), never copied from the
    # host: a host-to-device copy cannot be captured into a CUDA graph
    p, a, b = (x.to(torch.float32) if isinstance(x, torch.Tensor)
               else torch.full((), float(x), dtype=torch.float32,
                               device=dev) for x in (p, a, b))
    shape = torch.broadcast_shapes(p.shape, a.shape, b.shape)
    p = torch.broadcast_to(p, shape)
    a = torch.clamp_min(torch.broadcast_to(a, shape), 1e-12)
    b = torch.clamp_min(torch.broadcast_to(b, shape), 1e-12)

    lam = torch.abs(p)
    swap = p < 0
    omega = torch.sqrt(a * b)
    alpha = torch.sqrt(omega * omega + lam * lam) - lam      # >= 0
    one = torch.ones_like(alpha)

    # Devroye's setup: t > 0 and s > 0 with psi(t), psi(-s) ~ -1
    x_t = -_psi(one, alpha, lam)
    t = torch.where(
        x_t > 2.0, torch.sqrt(2.0 / (alpha + lam)),
        torch.where(x_t < 0.5, torch.log(4.0 / (alpha + 2.0 * lam)), one))
    x_s = -_psi(-one, alpha, lam)
    inv_alpha = 1.0 / alpha
    s_small = torch.minimum(
        1.0 / torch.clamp_min(lam, 1e-30),
        torch.log1p(inv_alpha + torch.sqrt(inv_alpha * inv_alpha
                                           + 2.0 * inv_alpha)))
    s = torch.where(
        x_s > 2.0, torch.sqrt(4.0 / (alpha * torch.cosh(one) + lam)),
        torch.where(x_s < 0.5, s_small, one))

    eta = -_psi(t, alpha, lam)
    zeta = -_dpsi(t, alpha, lam)
    theta = -_psi(-s, alpha, lam)
    xi = _dpsi(-s, alpha, lam)
    pp = 1.0 / xi
    r = 1.0 / zeta
    td = t - r * eta
    sd = s - pp * theta
    q = td + sd
    denom = pp + q + r

    # every round at once: the round axis follows the shard axis
    rshape = (shape[0], max_rounds) + tuple(shape[1:])
    U, V, W = (draws.uniform(site, rshape, part=sub_part(
        part, ("rounds", max_rounds), (3, j))) for j in range(3))
    V = torch.clamp_min(V + 1e-30, 1e-30)       # minval=1e-30, maxval=1

    def per_round(x):
        return x.unsqueeze(1)

    alpha_r, lam_r = per_round(alpha), per_round(lam)
    q_r, r_r, pp_r = per_round(q), per_round(r), per_round(pp)
    sd_r, td_r, denom_r = per_round(sd), per_round(td), per_round(denom)
    logV = torch.log(V)
    cand = torch.where(
        U < q_r / denom_r, -sd_r + q_r * V,
        torch.where(U < (q_r + r_r) / denom_r, td_r - r_r * logV,
                    -sd_r + pp_r * logV))
    # the three-piece dominating function chi(cand)
    f1 = torch.exp(-per_round(eta) - per_round(zeta) * (cand - per_round(t)))
    f2 = torch.exp(-per_round(theta) + per_round(xi) * (cand + per_round(s)))
    hat = torch.where((cand >= -sd_r) & (cand <= td_r),
                      torch.ones_like(cand), torch.where(cand > td_r, f1, f2))
    accept = W * hat <= torch.exp(_psi(cand, alpha_r, lam_r))
    # each element's first accepting round; zero where none accepts
    first = torch.argmax(accept.to(torch.uint8), dim=1, keepdim=True)
    u_log = torch.where(accept.any(dim=1),
                        torch.gather(cand, 1, first).squeeze(1),
                        torch.zeros_like(alpha))

    # back from psi-space: y = exp(u) * mode
    ratio = lam / omega
    y = torch.exp(u_log) * (ratio + torch.sqrt(1.0 + ratio * ratio))
    y = torch.where(swap, 1.0 / y, y)
    return y * torch.sqrt(b / a)
