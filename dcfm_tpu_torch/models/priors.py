"""The MGP (multiplicative gamma process) shrinkage prior on the loadings.

The port of ``make_mgp`` in ``dcfm_tpu/models/priors.py``.  A prior is a
set of functions over the prior state of ALL shards at once - the shard
axis is an explicit leading batch dimension where the JAX package vmaps:

    init(draws, G, P, K)       -> {"psijh": (G, P, K), "delta": (G, K)}
    update(draws, state, Lam)  -> the same, given Lambda (G, P, K)
    row_precision(state)       -> (G, P, K) loading-row prior precision
    health(state)              -> (G,) max |log tau_h| (overflow watch)

Every draw is taken from ``draws`` at ``SITE_PRIOR`` (psi normals as part
0, delta gammas as part 1 in the update), in the JAX package's order.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from dcfm_tpu_torch.config import _SCEN, ModelConfig
from dcfm_tpu_torch.noise import SITE_PRIOR
from dcfm_tpu_torch.ops.gamma import gamma_rate, gamma_rate_half_integer


class Prior(NamedTuple):
    name: str
    init: Callable[..., Any]
    update: Callable[..., Any]
    row_precision: Callable[[Any], torch.Tensor]
    health: Callable[[Any], torch.Tensor]


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

    def update(draws, state, Lam: torch.Tensor):
        G, P, K = Lam.shape
        psijh, delta = state["psijh"], state["delta"]
        tauh = _mgp_tauh(delta)                                  # (G, K)
        lam2 = Lam * Lam

        # psi_jh | rest ~ Gamma(df/2 + 1/2, df/2 + tau_h lam_jh^2 / 2)
        psi_rate = c.df / 2 + 0.5 * tauh[:, None, :] * lam2
        if float(c.df).is_integer() and c.df <= 7:
            twice = torch.full(lam2.shape, int(c.df) + 1,
                               dtype=torch.int32, device=Lam.device)
            psijh = gamma_rate_half_integer(
                draws, SITE_PRIOR, twice, psi_rate,
                max_twice=int(c.df) + 1, part=0)
        else:
            psijh = gamma_rate(draws, SITE_PRIOR, c.df / 2 + 0.5, psi_rate,
                               part=0)

        # delta_h | rest, sequential in h with tau recomputed after each
        # update; all K standard gammas drawn up front (only the RATE
        # depends on the recursion)
        s = torch.sum(psijh * lam2, dim=1)                       # (G, K)
        hs = torch.arange(K, device=Lam.device)
        n_ge = torch.arange(K, 0, -1, device=Lam.device,
                            dtype=torch.float32)                 # active l >= h
        shapes = torch.where(hs == 0, c.ad1 + 0.5 * P * n_ge[0],
                             c.ad2 + 0.5 * P * n_ge)
        rates0 = torch.where(hs == 0, c.bd1, c.bd2).to(torch.float32)
        g_std = draws.standard_gamma(
            SITE_PRIOR, shapes.expand(G, K).contiguous(), part=1)  # (G, K)
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


def make_prior(cfg: ModelConfig) -> Prior:
    if cfg.prior != "mgp":
        raise NotImplementedError(
            f"prior={cfg.prior!r} is not ported to dcfm_tpu_torch yet: "
            f"{_SCEN}")
    return make_mgp(cfg)
