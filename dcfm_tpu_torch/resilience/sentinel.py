"""Divergence sentinel: stop a blown-up chain from writing garbage draws.

The port of ``dcfm_tpu/resilience/sentinel.py``.  A NaN/Inf in the sampler
state (a failed K x K Cholesky under extreme shrinkage) propagates into
every later draw and, silently, into the covariance accumulator.  The
sweep already reduces a per-iteration all-finite check into the carried
health panel, and the runner counts the accumulator's non-finite entries
at every chunk end (``ChainStats.nonfinite_count`` / ``acc_nonfinite``,
read on the host at the boundary).  This module is the host-side policy
over those counts: it adds no device work, so a healthy chain is bitwise
unaffected by the sentinel's mode.

Policy (``FitConfig.sentinel``), on detection at a chunk boundary:

* ``rewind`` - reload the last good (CRC-verified) checkpoint, fold the
  rewind count into the chains' streams (``noise.TorchNoise``'s lineage:
  the retry must not walk back into the same blow-up) and escalate
  ``ModelConfig.ridge_jitter`` 10x per rewind.  Not bitwise an undiverged
  run; resume after a crash is.
* ``abort`` - raise :class:`ChainDivergedError` at the boundary.

The sentinel trips on an increase of the cumulative non-finite counter
over the run's starting value (a resumed carry may hold historical
counts), or on any non-finite accumulator entry.
"""

from __future__ import annotations

import numpy as np


class ChainDivergedError(RuntimeError):
    """The chain produced NaN/Inf and the sentinel's policy (or rewind
    budget) forbids continuing.  Carries the global ``iteration`` of the
    boundary where the divergence was detected and the number of
    ``rewinds`` already spent."""

    def __init__(self, message: str, *, iteration: int = -1,
                 rewinds: int = 0):
        super().__init__(message)
        self.iteration = iteration
        self.rewinds = rewinds


def _scalar(x) -> float:
    return float(np.asarray(x).sum())


class DivergenceSentinel:
    """Per-fit sentinel state: trip detection and the rewind budget.

    ``baseline_nonfinite`` is the cumulative non-finite count the carries
    already held when this fit started (nonzero after resuming a run that
    diverged before: only new divergence trips)."""

    def __init__(self, mode: str, *, max_rewinds: int = 3,
                 baseline_nonfinite: float = 0.0,
                 base_jitter: float = 0.0):
        if mode not in ("abort", "rewind"):
            raise ValueError(f"sentinel mode must be 'abort' or 'rewind', "
                             f"got {mode!r}")
        self.mode = mode
        self.max_rewinds = int(max_rewinds)
        self.rewinds = 0
        self._baseline = float(baseline_nonfinite)
        self._base_jitter = float(base_jitter)

    def tripped(self, stats) -> bool:
        """Host-side check of one boundary's ChainStats (already on the
        host: no extra device sync)."""
        if _scalar(stats.nonfinite_count) > self._baseline:
            return True
        acc_bad = getattr(stats, "acc_nonfinite", None)
        return acc_bad is not None and _scalar(acc_bad) > 0

    def record_rewind(self, iteration: int) -> None:
        """Spend one rewind; raises when the budget is exhausted."""
        self.rewinds += 1
        if self.rewinds > self.max_rewinds:
            raise ChainDivergedError(
                f"chain diverged at iteration {iteration} and the rewind "
                f"budget ({self.max_rewinds}) is exhausted - every retry "
                "re-diverged despite the stream re-lineage and the ridge "
                "escalation; the data/config are numerically pathological "
                "(see FitConfig.sentinel_max_rewinds)",
                iteration=iteration, rewinds=self.rewinds)

    def escalated_jitter(self) -> float:
        """Ridge jitter for the next attempt, 10x per rewind: a configured
        base escalates to 10x base on the first rewind (the chain just
        diverged under the base); an unconfigured (0.0) base starts at the
        1e-6 floor."""
        if self._base_jitter > 0:
            return float(self._base_jitter * (10.0 ** self.rewinds))
        return float(1e-6 * (10.0 ** (self.rewinds - 1)))
