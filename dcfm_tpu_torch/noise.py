"""The noise seam: every random draw of the chain goes through one provider.

A provider hands out RAW unit variates - standard normals, Exp(1) terms
and standard-Gamma draws - and the samplers transform them themselves.
That keeps the sampling math in the port, and lets a test swap the
provider for one that replays the JAX package's own draws, so that one
sweep of each package can be compared leaf by leaf from the same state.

Draws are addressed by ``site`` (the JAX package's site ids 1-5, one per
conditional, ``dcfm_tpu/models/conditionals.py``) and ``part`` (which
child of the site's key split a JAX draw uses: the MGP prior update draws
its psi normals from part 0 and its delta gammas from part 1; the Gram psi
stage its Exp(1) terms from part 0 and its half normal from part 1).  A
draw whose leading axis is the shard axis is per-shard at every site but
``SITE_X`` (X is shared by all shards).

:class:`TorchNoise`, the default provider, seeds one ``torch.Generator``
on the data's device per (seed, chain, global iteration, site) and takes
that site's parts from it in order.  Keying on the GLOBAL iteration is
what keeps host-level chunking from changing the chain.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

# site ids, as in dcfm_tpu/models/conditionals.py
SITE_Z, SITE_X, SITE_LAM, SITE_PRIOR, SITE_PS = 1, 2, 3, 4, 5

_INIT, _SWEEP = 0, 1


class Draws(Protocol):
    """The draws of one chain at one iteration (or at its init)."""

    def normal(self, site: int, shape, *, part=None) -> torch.Tensor: ...

    def exponential(self, site: int, shape, *, part=None) -> torch.Tensor: ...

    def standard_gamma(self, site: int, alpha: torch.Tensor, *,
                       part=None) -> torch.Tensor: ...


class NoiseProvider(Protocol):
    def init(self, chain: int) -> Draws: ...

    def sweep(self, chain: int, iteration: int) -> Draws: ...


def stream_seed(*words: int) -> int:
    """A 64-bit generator seed mixed from non-negative integers."""
    lo, hi = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return int(lo) | (int(hi) << 32)


class _SiteStreams:
    """One generator per site, created on first use, on ``device``."""

    def __init__(self, words: tuple, device: torch.device):
        self._words = words
        self._device = device
        self._gens: dict = {}

    def _gen(self, site: int) -> torch.Generator:
        gen = self._gens.get(site)
        if gen is None:
            gen = torch.Generator(device=self._device)
            gen.manual_seed(stream_seed(*self._words, site))
            self._gens[site] = gen
        return gen

    def normal(self, site, shape, *, part=None):
        return torch.randn(tuple(shape), generator=self._gen(site),
                           device=self._device, dtype=torch.float32)

    def exponential(self, site, shape, *, part=None):
        out = torch.empty(tuple(shape), device=self._device,
                          dtype=torch.float32)
        return out.exponential_(generator=self._gen(site))

    def standard_gamma(self, site, alpha, *, part=None):
        return torch._standard_gamma(alpha, generator=self._gen(site))


class TorchNoise:
    """Default provider: Philox streams keyed on (seed, chain, global
    iteration, site) on ``device`` (an init has its own key space)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def init(self, chain: int) -> Draws:
        return _SiteStreams((self.seed, int(chain), _INIT), self.device)

    def sweep(self, chain: int, iteration: int) -> Draws:
        return _SiteStreams((self.seed, int(chain), _SWEEP, int(iteration)),
                            self.device)
