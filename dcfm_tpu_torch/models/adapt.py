"""Adaptive rank truncation (Bhattacharya & Dunson 2011, section 3.2).

The port of ``dcfm_tpu/models/adapt.py``.  Columns are never removed:
``SamplerState.active`` is a (G, K) 0/1 mask and a deactivated column is
conditioned at Lambda_h = 0 (models/conditionals.py masks eta before the
Lambda update's moments, models/priors.py counts only active columns).
At burn-in iteration t, with probability p(t) = exp(a0 + a1 t) - one coin
for all shards - each shard drops its redundant columns (at least
``prop`` of their |loadings| below ``eps``), never below ``min_active``,
or, with none redundant, restores its first dropped column.  After
burn-in the mask is frozen.

Inside a CUDA graph nothing here may be a constant of the capture: the
iteration ``it`` is a device tensor the chain driver writes before every
trip (models/sampler.ChainRunner), and the coin is a uniform drawn at
``SITE_ADAPT`` outside the graph like every other variate (noise.py).
The decision, the drop and the growth are computed on the device every
sweep, a no-op when the coin says no.
"""

from __future__ import annotations

import dataclasses

import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.models.state import SamplerState
from dcfm_tpu_torch.noise import SITE_ADAPT


def adapt_rank(draws, state: SamplerState, it: torch.Tensor, burnin: int,
               cfg: ModelConfig) -> SamplerState:
    """One adaptation step after a sweep; the identity when the
    Bernoulli(p(t)) coin says no, when ``it > burnin``, or when
    ``state.active`` is None (no draw is taken then).

    ``it``: the 1-based global iteration as a float32 device scalar;
    ``state``: the sweep's output (Lambda already masked)."""
    active = state.active
    if active is None:
        return state
    ac = cfg.adapt
    dtype = state.Lambda.dtype
    K = active.shape[-1]

    u = draws.uniform(SITE_ADAPT, ())
    p_t = torch.exp(ac.a0 + ac.a1 * it)
    do = (u < p_t) & (it <= burnin)

    # a column is redundant when >= prop of its |loadings| are below eps;
    # inactive columns (all zero) are excluded so only live ones drop
    small = (torch.abs(state.Lambda) < ac.eps).to(dtype)        # (G, P, K)
    prop_small = torch.mean(small, dim=1)                       # (G, K)
    is_active = active > 0
    redundant = (prop_small >= ac.prop) & is_active
    num_red = torch.sum(redundant, dim=-1)                      # (G,)
    num_act = torch.sum(is_active, dim=-1)

    # drop every redundant column, but never below min_active
    can_drop = (num_act - num_red) >= ac.min_active
    dropped = torch.where(can_drop[:, None],
                          active * (1.0 - redundant.to(dtype)), active)
    # with none redundant, reactivate the first inactive column (it
    # re-enters at Lambda_h = 0, resampled from its conditional next sweep)
    has_inactive = num_act < K
    first_inactive = torch.argmax((~is_active).to(torch.uint8), dim=-1)
    one_hot = (torch.arange(K, device=active.device)
               == first_inactive[:, None]).to(dtype)
    grown = torch.clamp(
        active + one_hot * has_inactive[:, None].to(dtype), 0.0, 1.0)

    new_active = torch.where((num_red > 0)[:, None], dropped, grown)
    new_active = torch.where(do, new_active, active)
    return dataclasses.replace(
        state, active=new_active,
        Lambda=state.Lambda * new_active[:, None, :])


def effective_ranks(state: SamplerState) -> torch.Tensor:
    """(G,) active columns per shard (K with adaptation off)."""
    if state.active is None:
        G, _, K = state.Lambda.shape
        return torch.full((G,), float(K), dtype=torch.float32,
                          device=state.Lambda.device)
    return torch.sum((state.active > 0).to(torch.float32), dim=-1)
