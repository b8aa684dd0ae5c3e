"""Carry a sampler state across packages as numpy arrays.

The JAX package's ``SamplerState`` leaves (``Lambda``, ``Z``, ``X``,
``ps``, ``prior`` - any prior's dict of leaves: MGP ``psijh, delta``,
horseshoe ``lam2, nu, tau2, xi``, DL ``phi, psi, tau`` - and, under rank
adaptation, ``active``), handed over as numpy arrays, map one to one onto
the port's state and back, so both packages can start a sweep or a chain
from the same state.  The rest of a chain's carry crosses the same way: a
JAX ``DrawBuffers`` (``Lambda``, ``ps``, ``X`` and, under the scaled
estimator, ``H``) maps onto the port's draw ring, and ``y_imp_acc`` is one
array.
"""

from __future__ import annotations

import numpy as np
import torch

from dcfm_tpu_torch.models.sampler import DrawBuffers
from dcfm_tpu_torch.models.state import SamplerState

_LEAVES = ("Lambda", "Z", "X", "ps")


def state_from_numpy(d: dict, device) -> SamplerState:
    """``{"Lambda", "Z", "X", "ps", "prior": {...}, "active": (G, K) or
    None}`` of numpy arrays (``active`` may be absent) -> a float32
    :class:`SamplerState` on ``device``."""
    def put(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    active = d.get("active")
    return SamplerState(**{k: put(d[k]) for k in _LEAVES},
                        prior={k: put(v) for k, v in d["prior"].items()},
                        active=None if active is None else put(active))


def state_to_numpy(state: SamplerState) -> dict:
    """The inverse of :func:`state_from_numpy` (``active`` None without
    adaptation)."""
    def get(t):
        return t.detach().cpu().numpy()
    out = {k: get(getattr(state, k)) for k in _LEAVES}
    out["prior"] = {k: get(v) for k, v in state.prior.items()}
    out["active"] = None if state.active is None else get(state.active)
    return out


def draws_from_numpy(d: dict, device) -> DrawBuffers:
    """``{"Lambda", "ps", "X", "H" (absent or None under the plain
    estimator)}`` of numpy arrays -> a float32 :class:`DrawBuffers` on
    ``device``."""
    def put(a):
        return (None if a is None
                else torch.as_tensor(np.array(a, np.float32), device=device))
    return DrawBuffers(*(put(d.get(k)) for k in DrawBuffers._fields))


def draws_to_numpy(draws: DrawBuffers) -> dict:
    """The inverse of :func:`draws_from_numpy` (``H`` None without it)."""
    return {k: None if t is None else t.detach().cpu().numpy()
            for k, t in zip(DrawBuffers._fields, draws)}
