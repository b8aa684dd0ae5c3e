"""The noise seam: every random draw of the chain goes through one provider.

A provider hands out RAW unit variates - standard normals, Exp(1) terms,
U(0, 1) uniforms and standard-Gamma draws - and the samplers transform
them themselves.  That keeps the sampling math in the port, and lets a
test swap the provider for one that replays the JAX package's own draws,
so that one sweep of each package can be compared leaf by leaf from the
same state.

Draws are addressed by ``site`` (the JAX package's site ids: 1-5, one per
conditional, ``dcfm_tpu/models/conditionals.py``, 6 for the rank
adaptation's coin, ``dcfm_tpu/models/adapt.py``, and 7 for the missing-data
imputation's normals, drawn only when imputation is on) and ``part``, the path
from the site's per-shard key to the key a JAX draw uses.  ``part`` is
None (the key itself), an int i (child i of a two-way split: the MGP
prior update draws its psi normals from part 0 and its delta gammas from
part 1), or a tuple of steps applied in order: an int i (child i of a
two-way split), ``(n, i)`` (child i of an n-way split), ``("fold", d)``
(the key folded with d) and ``("rounds", R)``, which gives the draw an
axis of R rejection rounds after the shard axis, round r taking the key
the JAX package's rejection loop splits off in its r-th trip (``k, sub =
split(k)``, r + 1 times).  A draw whose leading axis is the shard axis is
per-shard at every site but the :data:`SHARED_SITES` (X, and the
adaptation coin, are shared by all shards).

:class:`TorchNoise`, the default provider, seeds one ``torch.Generator``
on the data's device per (seed, chain, global iteration, site) and takes
that site's parts from it in order (it reads no ``part``).  Keying on the
GLOBAL iteration is what keeps host-level chunking from changing the
chain.

Draws a CUDA graph can consume.  Every variate a sweep draws is
independent of the chain state, so the chain driver takes the random
numbers out of the graph: :class:`RecordingDraws` records the sweep's
ordered calls (its draw *recipe*) once, during one eager sweep;
:func:`draw_into` draws a later iteration's recipe from the unchanged
:class:`TorchNoise` streams into static tensors before a replay; and
:class:`BufferedDraws` hands those tensors to the sweep inside the graph in
the recorded order, refusing any call that departs from the recipe.  Two
kinds of site would break that rule, and each has its state-independent
form:

* a Gamma whose shape follows the chain state (under rank adaptation the
  MGP delta shapes count the active columns, the horseshoe's tau2 shape
  too) draws a *candidate table* (:meth:`Draws.gamma_candidates`): one
  standard Gamma for every shape the site can take, a constant of the
  config, from which the sampler picks the realised count's entry on the
  device - an exact Gamma draw at the realised shape;
* a rejection loop (the GIG sampler, ops/gig.py) draws all of its rounds'
  uniforms up front (a ``("rounds", R)`` part) and takes each element's
  first accepted round, which is the value the early-exit loop returns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol

import numpy as np
import torch

# site ids, as in dcfm_tpu/models/conditionals.py and models/adapt.py
SITE_Z, SITE_X, SITE_LAM, SITE_PRIOR, SITE_PS = 1, 2, 3, 4, 5
SITE_ADAPT = 6
SITE_IMPUTE = 7
# the sites whose draws are shared by all shards (no shard axis)
SHARED_SITES = (SITE_X, SITE_ADAPT)

_INIT, _SWEEP = 0, 1


class Draws(Protocol):
    """The draws of one chain at one iteration (or at its init).  A
    provider that takes ``out`` writes the variates into it and returns
    it (:func:`draw_into` needs that; the sweep never passes it)."""

    def normal(self, site: int, shape, *, part=None,
               out=None) -> torch.Tensor: ...

    def exponential(self, site: int, shape, *, part=None,
                    out=None) -> torch.Tensor: ...

    def uniform(self, site: int, shape, *, part=None,
                out=None) -> torch.Tensor: ...

    def standard_gamma(self, site: int, alpha: torch.Tensor, *,
                       part=None, out=None) -> torch.Tensor: ...

    def gamma_candidates(self, site: int, alphas: torch.Tensor, *,
                         part=None, out=None) -> torch.Tensor:
        """Independent standard-Gamma draws at every candidate shape
        ``alphas[..., c]``; replaying the JAX package, entry c is the
        variate its ``jax.random.gamma(key, alphas[..., c])`` gives."""
        ...


class NoiseProvider(Protocol):
    def init(self, chain: int, lineage: int = 0) -> Draws: ...

    def sweep(self, chain: int, iteration: int) -> Draws: ...


def sub_part(part, *steps) -> tuple:
    """The path ``part`` extended by ``steps`` (module docstring)."""
    if part is None:
        return tuple(steps)
    head = part if isinstance(part, tuple) else (part,)
    return head + tuple(steps)


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

    # ``out`` gives the same variates as a fresh tensor: each fill depends
    # only on the generator's state and the element count
    def normal(self, site, shape, *, part=None, out=None):
        if out is not None:
            return torch.randn(tuple(shape), generator=self._gen(site),
                               out=out)
        return torch.randn(tuple(shape), generator=self._gen(site),
                           device=self._device, dtype=torch.float32)

    def exponential(self, site, shape, *, part=None, out=None):
        if out is None:
            out = torch.empty(tuple(shape), device=self._device,
                              dtype=torch.float32)
        return out.exponential_(generator=self._gen(site))

    def uniform(self, site, shape, *, part=None, out=None):
        if out is None:
            out = torch.empty(tuple(shape), device=self._device,
                              dtype=torch.float32)
        return out.uniform_(generator=self._gen(site))

    def standard_gamma(self, site, alpha, *, part=None, out=None):
        g = torch._standard_gamma(alpha, generator=self._gen(site))
        return g if out is None else out.copy_(g)

    # every candidate is an independent draw at its own shape
    gamma_candidates = standard_gamma


def warm_lineage(relineage: int) -> tuple:
    """The sweep lineage of a warm start (``WarmStart.relineage``): a
    leading 0, which no rewind lineage has (rewind counts start at 1), so
    a warm chain never replays the draws of its donor, of a plain run of
    the same seed, or of a rewound one; successive relineage values give
    disjoint streams.  The init streams are not lineaged."""
    return (0, int(relineage))


class TorchNoise:
    """Default provider: Philox streams keyed on (seed, chain, global
    iteration, site) on ``device`` (an init has its own key space).

    ``lineage`` re-lineages the sweeps' streams: the divergence sentinel's
    rewind appends its rewind count (runtime/pipeline), so a retried
    trajectory never replays the draws that diverged - the port of the JAX
    package's ``fold_in(key_chain, rewinds)``.  The empty lineage keys the
    streams exactly as before it existed.  ``init(chain, lineage)`` with a
    lineage > 0 is an elastic birth's initial state (the JAX package's
    ``fold_in(k_init, elastic_lineage)``): never the state any chain of
    another lineage started from.  A warm start's chains run on
    :func:`warm_lineage` (the JAX package's ``fold_in(k_chain,
    relineage)``), extended by the sentinel's rewinds."""

    def __init__(self, seed: int, device, lineage: tuple = ()):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.lineage = tuple(int(w) for w in lineage)

    def init(self, chain: int, lineage: int = 0) -> Draws:
        words = (self.seed, int(chain), _INIT) + ((int(lineage),)
                                                  if lineage else ())
        return _SiteStreams(words, self.device)

    def sweep(self, chain: int, iteration: int) -> Draws:
        return _SiteStreams((self.seed, int(chain), _SWEEP, int(iteration),
                             *self.lineage), self.device)


class DrawCall(NamedTuple):
    """One call of a sweep on its provider."""
    site: int
    part: object                   # None, an int or a tuple path
    kind: str                      # a Draws method's name
    shape: tuple
    alpha: Optional[torch.Tensor]  # a Gamma's shape parameters


class RecordingDraws:
    """Takes every draw from ``draws`` and appends the call to ``recipe``."""

    def __init__(self, draws: Draws, recipe: list):
        self._draws, self._recipe = draws, recipe

    def normal(self, site, shape, *, part=None):
        self._recipe.append(DrawCall(site, part, "normal", tuple(shape), None))
        return self._draws.normal(site, shape, part=part)

    def exponential(self, site, shape, *, part=None):
        self._recipe.append(
            DrawCall(site, part, "exponential", tuple(shape), None))
        return self._draws.exponential(site, shape, part=part)

    def uniform(self, site, shape, *, part=None):
        self._recipe.append(
            DrawCall(site, part, "uniform", tuple(shape), None))
        return self._draws.uniform(site, shape, part=part)

    def standard_gamma(self, site, alpha, *, part=None):
        self._recipe.append(DrawCall(site, part, "standard_gamma",
                                     tuple(alpha.shape), alpha.clone()))
        return self._draws.standard_gamma(site, alpha, part=part)

    def gamma_candidates(self, site, alphas, *, part=None):
        self._recipe.append(DrawCall(site, part, "gamma_candidates",
                                     tuple(alphas.shape), alphas.clone()))
        return self._draws.gamma_candidates(site, alphas, part=part)


def draw_into(draws: Draws, recipe: list, slots: list) -> None:
    """Draw one iteration's ``recipe`` from ``draws`` into ``slots`` (one
    tensor per call, of the call's shape), in the recorded order: the
    variates the sweep would have drawn itself."""
    for call, out in zip(recipe, slots, strict=True):
        if call.alpha is not None:
            getattr(draws, call.kind)(call.site, call.alpha, part=call.part,
                                      out=out)
        else:
            getattr(draws, call.kind)(call.site, call.shape, part=call.part,
                                      out=out)


class BufferedDraws:
    """Hands out ``slots[i]`` for the sweep's i-th call, after checking the
    call against ``recipe[i]`` (site, part, kind, shape; on every call made
    outside a capture, also a Gamma's alpha by value, so an alpha that
    came to depend on the chain state is refused by name).
    :meth:`finish` checks that the sweep made every recorded call."""

    def __init__(self, recipe: list, slots: list):
        self._recipe, self._slots, self._i = recipe, slots, 0

    def _next(self, site, part, kind, shape, alpha=None) -> torch.Tensor:
        i = self._i
        want = (self._recipe[i][:4] if i < len(self._recipe)
                else "no further draw")
        if want != (site, part, kind, tuple(shape)):
            raise RuntimeError(
                f"draw {i} of the sweep is {kind} at site {site} part {part} "
                f"shape {tuple(shape)}, but the recorded recipe has {want}")
        if alpha is not None and not (
                alpha.is_cuda and torch.cuda.is_current_stream_capturing()):
            if not torch.equal(alpha, self._recipe[i].alpha):
                raise ValueError(
                    f"draw {i} of the sweep ({kind} at site {site} "
                    f"part {part}) has an alpha that differs from the "
                    "recorded one: it depends on the chain state, and a "
                    "pre-drawn variate cannot follow it")
        self._i += 1
        return self._slots[i]

    def normal(self, site, shape, *, part=None):
        return self._next(site, part, "normal", shape)

    def exponential(self, site, shape, *, part=None):
        return self._next(site, part, "exponential", shape)

    def uniform(self, site, shape, *, part=None):
        return self._next(site, part, "uniform", shape)

    def standard_gamma(self, site, alpha, *, part=None):
        return self._next(site, part, "standard_gamma", alpha.shape, alpha)

    def gamma_candidates(self, site, alphas, *, part=None):
        return self._next(site, part, "gamma_candidates", alphas.shape,
                          alphas)

    def finish(self) -> None:
        if self._i != len(self._recipe):
            raise RuntimeError(
                f"the sweep made {self._i} draws, the recorded recipe has "
                f"{len(self._recipe)}")


class ShardSliceNoise:
    """A mesh rank's provider (parallel/shard.py): the draws of ``base``
    over all ``total`` shards, of which the rank keeps its block ``[offset,
    offset + local)``.

    A per-shard site (every site but :data:`SHARED_SITES`) draws the
    GLOBAL shape - the shard axis leads every such draw - and keeps the
    rank's rows, so rank r holds exactly the slice of what the one-device
    chain draws at that (chain, iteration, site, part), in every provider
    (:class:`TorchNoise` draws a site's parts from one generator in call
    order, so a local shape would draw another stream).  A Gamma's
    per-shard shapes are constants of the config expanded over the shard
    axis, so the global shapes are the local ones tiled.  The recipe of a
    trip (:class:`RecordingDraws`) records the calls the sweep makes, with
    local shapes, and :func:`draw_into` replays them through this provider,
    so a pre-drawn slot holds the rank's slice too.  Each rank draws every
    shard's variates: its cost grows with g, not with g / N.  ``base``'s
    lineages carry through: a warm start's re-lineaged sweeps and an
    elastic birth's ``init(chain, lineage)`` slice the one-device draws of
    the same lineage."""

    def __init__(self, base, offset: int, local: int, total: int):
        self.base = base
        self.offset, self.local, self.total = int(offset), int(local), int(
            total)

    def init(self, chain: int, lineage: int = 0) -> Draws:
        d = self.base.init(chain, lineage) if lineage else self.base.init(
            chain)
        return _SliceDraws(d, self)

    def sweep(self, chain: int, iteration: int) -> Draws:
        return _SliceDraws(self.base.sweep(chain, iteration), self)


class _SliceDraws:
    def __init__(self, draws: Draws, sl: ShardSliceNoise):
        self._draws, self._sl = draws, sl

    def _global(self, site: int, shape: tuple):
        if site in SHARED_SITES:
            return None
        if not shape or shape[0] != self._sl.local:
            raise ValueError(
                f"a per-shard draw at site {site} has shape {shape}, whose "
                f"leading axis is not the rank's {self._sl.local} shards")
        return (self._sl.total,) + shape[1:]

    def _keep(self, full: torch.Tensor, out) -> torch.Tensor:
        block = full[self._sl.offset:self._sl.offset + self._sl.local]
        return block if out is None else out.copy_(block)

    def _plain(self, kind, site, shape, part, out):
        fn = getattr(self._draws, kind)
        gshape = self._global(site, tuple(shape))
        if gshape is None:
            return (fn(site, shape, part=part) if out is None
                    else fn(site, shape, part=part, out=out))
        return self._keep(fn(site, gshape, part=part), out)

    def _gamma(self, kind, site, alpha, part, out):
        fn = getattr(self._draws, kind)
        if self._global(site, tuple(alpha.shape)) is None:
            return (fn(site, alpha, part=part) if out is None
                    else fn(site, alpha, part=part, out=out))
        reps = (self._sl.total // self._sl.local,) + (1,) * (alpha.dim() - 1)
        return self._keep(fn(site, alpha.repeat(reps), part=part), out)

    def normal(self, site, shape, *, part=None, out=None):
        return self._plain("normal", site, shape, part, out)

    def exponential(self, site, shape, *, part=None, out=None):
        return self._plain("exponential", site, shape, part, out)

    def uniform(self, site, shape, *, part=None, out=None):
        return self._plain("uniform", site, shape, part, out)

    def standard_gamma(self, site, alpha, *, part=None, out=None):
        return self._gamma("standard_gamma", site, alpha, part, out)

    def gamma_candidates(self, site, alphas, *, part=None, out=None):
        return self._gamma("gamma_candidates", site, alphas, part, out)
