"""Sampler state and the packed-panel index map.

The port of ``dcfm_tpu/models/state.py``.  The state is a dataclass of
tensors; every per-shard leaf carries an explicit leading shard axis G
(the JAX package's vmapped ``Gl``), and ``X`` is the one leaf shared by
all shards.  eta and the prior row precision are derived quantities,
recomputed where needed, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dcfm_tpu_torch.noise import SITE_PS, SITE_X, SITE_Z
from dcfm_tpu_torch.ops.gamma import gamma_rate


def num_upper_pairs(g: int) -> int:
    """g(g+1)/2: blocks in the upper triangle (incl. diagonal) of the
    g x g covariance block grid."""
    return g * (g + 1) // 2


def num_padded_pairs(g: int) -> int:
    """The packed-panel axis length: g(g+1)/2 rounded up to a multiple of
    g (the JAX package's mesh-portable layout; padding slots duplicate
    pair (0, 0) and are dropped at fetch)."""
    n = num_upper_pairs(g)
    return n + (-n) % g


def packed_pair_indices(g: int) -> tuple[np.ndarray, np.ndarray]:
    """``(rows, cols)``, each ``(num_padded_pairs(g),)`` int32: packed
    panel q is block (rows[q], cols[q]), in ``np.triu_indices`` order,
    padding entries aliasing pair (0, 0)."""
    r, c = np.triu_indices(g)
    pad = num_padded_pairs(g) - r.size
    if pad:
        r = np.concatenate([r, np.zeros(pad, r.dtype)])
        c = np.concatenate([c, np.zeros(pad, c.dtype)])
    return r.astype(np.int32), c.astype(np.int32)


@dataclasses.dataclass
class SamplerState:
    Lambda: torch.Tensor   # (G, P, K) factor loadings
    Z: torch.Tensor        # (G, n, K) shard-specific factors
    X: torch.Tensor        # (n, K) factors shared by all shards
    ps: torch.Tensor       # (G, P) residual precisions
    prior: dict            # {"psijh": (G, P, K), "delta": (G, K)}


def init_state(draws, prior, *, G: int, n: int, P: int, K: int, as_: float,
               bs: float, device) -> SamplerState:
    """Draw the initial state: Lambda = 0, Z and X standard normal,
    ps ~ Gamma(as_, bs), the prior from its own init."""
    X = draws.normal(SITE_X, (n, K))
    ps = gamma_rate(draws, SITE_PS, as_, bs, sample_shape=(G, P),
                    device=device)
    Z = draws.normal(SITE_Z, (G, n, K))
    return SamplerState(
        Lambda=torch.zeros((G, P, K), dtype=torch.float32, device=device),
        Z=Z, X=X, ps=ps, prior=prior.init(draws, G, P, K, device=device))
