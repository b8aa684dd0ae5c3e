"""The variate streams of a fit, drawn from its seed.

The program's documented draw recipe, written out again so that the
reference can redraw every variate itself: one ``torch.Generator`` per
(seed, chain, phase, iteration, site), seeded with the 64-bit word
``numpy.random.SeedSequence(words).generate_state(2, uint32)`` (low word
first), phase 0 for a chain's initial state and 1 for a sweep.  A site's
variates come from its generator in the order the model draws them.
Sites: 1 the shard factors Z, 2 the shared factors X, 3 the loadings,
4 the shrinkage prior, 5 the residual precisions, 6 the rank-adaptation
coin.

Plain PyTorch and NumPy only: nothing here reads the program.
"""

from __future__ import annotations

import numpy as np
import torch

SITE_Z, SITE_X, SITE_LAM, SITE_PRIOR, SITE_PS, SITE_ADAPT = 1, 2, 3, 4, 5, 6
_INIT, _SWEEP = 0, 1


def stream_seed(*words: int) -> int:
    lo, hi = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


class Streams:
    """The generators of one (chain, phase, iteration), one per site,
    made on first use.  Variates are drawn in float32, as the recipe
    draws them, and handed out in ``dtype``."""

    def __init__(self, words: tuple, device, dtype=torch.float32):
        self.words, self.device, self.dtype = words, device, dtype
        self._gens = {}

    @classmethod
    def init(cls, seed: int, chain: int, device,
             dtype=torch.float32) -> "Streams":
        return cls((int(seed), int(chain), _INIT), device, dtype)

    @classmethod
    def sweep(cls, seed: int, chain: int, iteration: int, device,
              dtype=torch.float32) -> "Streams":
        """The draws of the sweep that makes 1-based iteration
        ``iteration + 1``."""
        return cls((int(seed), int(chain), _SWEEP, int(iteration)), device,
                   dtype)

    def gen(self, site: int) -> torch.Generator:
        g = self._gens.get(site)
        if g is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(stream_seed(*self.words, site))
            self._gens[site] = g
        return g

    def normal(self, site: int, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen(site),
                           device=self.device,
                           dtype=torch.float32).to(self.dtype)

    def exponential(self, site: int, shape) -> torch.Tensor:
        out = torch.empty(tuple(shape), device=self.device,
                          dtype=torch.float32)
        return out.exponential_(generator=self.gen(site)).to(self.dtype)

    def uniform(self, site: int, shape) -> torch.Tensor:
        out = torch.empty(tuple(shape), device=self.device,
                          dtype=torch.float32)
        return out.uniform_(generator=self.gen(site)).to(self.dtype)

    def standard_gamma(self, site: int, alpha: torch.Tensor) -> torch.Tensor:
        """Standard-Gamma variates at the float32 shapes ``alpha``."""
        return torch._standard_gamma(alpha.float().contiguous(),
                                     generator=self.gen(site)).to(self.dtype)


class ChainStreams:
    """The draws of every chain at one (phase, iteration), each chain's
    from its own generators, stacked on a leading chain axis."""

    def __init__(self, per_chain: list):
        self.per_chain = per_chain
        self.chains = len(per_chain)
        self.device, self.dtype = per_chain[0].device, per_chain[0].dtype

    @classmethod
    def init(cls, seed: int, chains: int, device,
             dtype=torch.float32) -> "ChainStreams":
        return cls([Streams.init(seed, c, device, dtype)
                    for c in range(chains)])

    @classmethod
    def sweep(cls, seed: int, chains: int, iteration: int, device,
              dtype=torch.float32) -> "ChainStreams":
        return cls([Streams.sweep(seed, c, iteration, device, dtype)
                    for c in range(chains)])

    def normal(self, site: int, shape) -> torch.Tensor:
        return torch.stack([s.normal(site, shape) for s in self.per_chain])

    def exponential(self, site: int, shape) -> torch.Tensor:
        return torch.stack([s.exponential(site, shape)
                            for s in self.per_chain])

    def uniform(self, site: int, shape) -> torch.Tensor:
        return torch.stack([s.uniform(site, shape) for s in self.per_chain])

    def standard_gamma(self, site: int, alpha: torch.Tensor) -> torch.Tensor:
        return torch.stack([s.standard_gamma(site, alpha)
                            for s in self.per_chain])
