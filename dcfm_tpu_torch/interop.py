"""Carry a sampler state across packages as numpy arrays.

The JAX package's ``SamplerState`` leaves (``Lambda``, ``Z``, ``X``,
``ps`` and ``prior = {"psijh", "delta"}``), handed over as numpy arrays,
map one to one onto the port's state and back, so both packages can start
a sweep or a chain from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from dcfm_tpu_torch.models.state import SamplerState

_LEAVES = ("Lambda", "Z", "X", "ps")
_PRIOR = ("psijh", "delta")


def state_from_numpy(d: dict, device) -> SamplerState:
    """``{"Lambda", "Z", "X", "ps", "prior": {"psijh", "delta"}}`` of numpy
    arrays -> a float32 :class:`SamplerState` on ``device``."""
    def put(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return SamplerState(**{k: put(d[k]) for k in _LEAVES},
                        prior={k: put(d["prior"][k]) for k in _PRIOR})


def state_to_numpy(state: SamplerState) -> dict:
    """The inverse of :func:`state_from_numpy`."""
    def get(t):
        return t.detach().cpu().numpy()
    out = {k: get(getattr(state, k)) for k in _LEAVES}
    out["prior"] = {k: get(state.prior[k]) for k in _PRIOR}
    return out
