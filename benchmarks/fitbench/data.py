"""A cell's data from its seed: Y = F L' + noise * eps, drawn on the
device in three calls of one seeded ``torch.Generator``, then copied to
the host once (the program's entry takes a host array)."""

from __future__ import annotations

import numpy as np
import torch


def data_seed(seed: int) -> int:
    """A 64-bit generator seed for the cell's data, mixed from ``seed``."""
    lo, hi = np.random.SeedSequence([int(seed), 0xDA7A]).generate_state(
        2, np.uint32)
    return int(lo) | (int(hi) << 32)


def make_data(recipe: dict, seed: int, device) -> np.ndarray:
    """(n, p) float32 data of a factor model of rank ``k_true`` with
    loadings L ~ N(0, 1/k_true), factors F ~ N(0, 1) and noise sd
    ``noise``: Sigma = L L' + noise^2 I."""
    n, p, k = int(recipe["n"]), int(recipe["p"]), int(recipe["k_true"])
    gen = torch.Generator(device=device)
    gen.manual_seed(data_seed(seed))
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    L = torch.randn((p, k), **kw) / float(np.sqrt(k))
    F = torch.randn((n, k), **kw)
    Y = torch.randn((n, p), **kw).mul_(float(recipe["noise"]))
    Y.addmm_(F, L.T)
    return Y.cpu().numpy()


def run_seed(seed: int, index: int) -> int:
    """The run seed of the window's fit ``index``: distinct for every
    (seed, index) with index < 4096."""
    return int(seed) * 4096 + int(index)
