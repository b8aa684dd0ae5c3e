"""Resume gates: where a fit's chains start, and where a rewind goes.

The port of the single-process part of ``dcfm_tpu/runtime/resume.py``:

* :func:`resume_state` - ``resume=True`` demands a compatible checkpoint
  (``FileNotFoundError`` / ``ValueError("refusing to resume: ...")``),
  ``resume="auto"`` falls back to a fresh start; compatibility is checked
  before the payload loads; a finished file resumes as a no-op; a light
  file restarts the accumulator window at its iteration (a finished light
  file is refused: there is nothing to report), and the ``.full`` sidecar
  of ``checkpoint_full_every`` wins whenever it keeps more saved draws; a
  full file whose only mismatch is the chain count is adopted elastically
  when ``FitConfig.elastic`` allows (:func:`_try_elastic`);
* :func:`rewind_source` - the divergence sentinel's rewind target: the
  newest compatible, CRC-clean retained generation.

Both return host leaves (``utils/checkpoint.load_checkpoint``'s), which
the chunk loop (runtime/pipeline.py) copies into the chains' carries, and
leave in ``ResumeContext.elastic`` the elastic bookkeeping the run must
thread into its divisor and its saves.  Still refused: multi-process
``.procK-of-N`` sets (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Optional

from dcfm_tpu_torch.config import _OUTER, FitConfig
from dcfm_tpu_torch.models.sampler import num_saved_draws
from dcfm_tpu_torch.utils.checkpoint import (
    checkpoint_compatible, config_from_checkpoint_meta, elastic_meta,
    load_checkpoint, load_checkpoint_elastic, read_checkpoint_meta,
    retained_checkpoints)


@dataclasses.dataclass
class ElasticResume:
    """One elastic adoption's bookkeeping, or the carried-over state of a
    file saved after one: what the resumed run threads into its fetch
    divisor (runtime/fetch.accumulator_window) and every later save (the
    v7 meta fields), so the pooled Sigma stays exact across further kills,
    rewinds and adoptions.  The JAX package's ``ElasticResume``."""

    from_chains: int
    to_chains: int
    kept: int
    dropped: int
    birthed: int
    fold_draws: int
    chain_acc_starts: tuple
    elastic_lineage: int
    from_topology: Optional[dict] = None
    to_topology: Optional[dict] = None


@dataclasses.dataclass
class ResumeContext:
    """What the gates need of a fit: the config, the data fingerprint the
    checkpoint must match, the carry template
    (``utils/checkpoint.carry_template``) and ``birth(chain, lineage)``,
    an elastic grow's initial leaves of a new chain (no chain axis).

    ``elastic`` is an OUT field: the resumed file's elastic bookkeeping (a
    fresh adoption, or a file saved after one), else None."""

    cfg: FitConfig
    fingerprint: Optional[str]
    template: dict
    birth: Optional[Callable[[int, int], dict]] = None
    elastic: Optional[ElasticResume] = None


def run_topology(cfg: FitConfig) -> dict:
    """The topology a port run writes and adopts onto: one device, one
    process."""
    return {"num_chains": int(cfg.run.num_chains), "num_devices": 1,
            "num_processes": 1}


def _elastic_carryover(meta: dict, cfg: FitConfig) -> Optional[ElasticResume]:
    """The elastic state a same-chain-count resume of a v7 file keeps
    threading: non-uniform window starts, folded draws, or a birth lineage
    (which must never rewind, or a later grow could replay a birth's
    initial state); None for the uniform case."""
    C = int(cfg.run.num_chains)
    starts, fold, lineage = elastic_meta(meta, C)
    if not fold and len(set(starts)) <= 1 and not lineage:
        return None
    return ElasticResume(
        from_chains=C, to_chains=C, kept=C, dropped=0, birthed=0,
        fold_draws=int(fold), chain_acc_starts=tuple(starts),
        elastic_lineage=int(lineage), from_topology=meta.get("topology"),
        to_topology=run_topology(cfg))


def _light_carryover(meta: dict, cfg: FitConfig,
                     it: int) -> Optional[ElasticResume]:
    """A light resume restarts a uniform window at ``it``, but keeps the
    file's birth lineage."""
    lineage = int(meta.get("elastic_lineage", 0))
    if not lineage:
        return None
    C = int(cfg.run.num_chains)
    return ElasticResume(
        from_chains=C, to_chains=C, kept=C, dropped=0, birthed=0,
        fold_draws=0, chain_acc_starts=(it,) * C, elastic_lineage=lineage,
        from_topology=meta.get("topology"), to_topology=run_topology(cfg))


def refuse_multiprocess_sets(path: str) -> None:
    """Refuse ``path``'s ``.procK-of-N`` sets by name (resume and export
    read single-process files only)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    if not os.path.isdir(d):
        return
    pat = re.compile(re.escape(os.path.basename(path))
                     + r"\.proc\d+-of-\d+$")
    found = sorted(f for f in os.listdir(d) if pat.match(f))
    if found:
        raise NotImplementedError(
            f"multi-process checkpoint sets ({found[0]}, ...) are not "
            f"ported to dcfm_tpu_torch yet: {_OUTER}")


def _try_elastic(ctx: ResumeContext, meta: dict):
    """Elastic adoption of a file whose only mismatch is the chain count,
    as ``(leaves, done, acc_start)`` with ``ctx.elastic`` set; None when
    ``FitConfig.elastic`` is False or more than the chain count differs.
    A refused adoption (a light donor, a store_draws donor) raises its
    ValueError.

    A grow births the new chains on ``elastic_lineage + 1`` (the file's
    lineage bumped: a chain born after a second adoption never starts
    from a previous birth's state); the lineage is bumped on a shrink
    too, as the JAX package does."""
    cfg, run = ctx.cfg, ctx.cfg.run
    if cfg.elastic is False:
        return None
    if checkpoint_compatible(meta, cfg, ctx.fingerprint,
                             ignore_chains=True) is not None:
        return None
    donor_chains = int(config_from_checkpoint_meta(meta).run.num_chains)
    if donor_chains == run.num_chains:
        return None
    lineage = elastic_meta(meta, donor_chains)[2] + 1
    births = None
    if run.num_chains > donor_chains:
        births = [ctx.birth(c, lineage)
                  for c in range(donor_chains, run.num_chains)]
    leaves, meta, info = load_checkpoint_elastic(
        cfg.checkpoint_path, ctx.template, run.num_chains, births=births)
    starts = info["chain_acc_starts"]
    ctx.elastic = ElasticResume(
        from_chains=info["from_chains"], to_chains=info["to_chains"],
        kept=info["kept"], dropped=info["dropped"],
        birthed=info["birthed"], fold_draws=info["fold_draws"],
        chain_acc_starts=tuple(starts), elastic_lineage=lineage,
        from_topology=info["from_topology"], to_topology=run_topology(cfg))
    it = int(meta["iteration"])
    return leaves, it, min(starts) if starts else it


def _try_full_sidecar(ctx: ResumeContext, light_kept: int):
    """The ``.full`` sidecar (checkpoint_full_every) as ``(leaves, done,
    acc_start)`` iff it is full, compatible, loads clean and keeps MORE
    saved draws than ``light_kept`` (the light restart window); None
    otherwise."""
    cfg, run = ctx.cfg, ctx.cfg.run
    side = cfg.checkpoint_path + ".full"
    if not os.path.exists(side):
        return None
    try:
        smeta = read_checkpoint_meta(side)
        if (smeta.get("state_only")
                or checkpoint_compatible(smeta, cfg, ctx.fingerprint)
                is not None):
            return None
        s_acc0 = int(smeta.get("acc_start", 0))
        s_kept = (num_saved_draws(run.total_iters, run.burnin, run.thin)
                  - num_saved_draws(s_acc0, run.burnin, run.thin))
        if s_kept <= light_kept:
            return None
        leaves, smeta = load_checkpoint(side, ctx.template)
    except (OSError, ValueError, KeyError):
        return None          # not usable: the light resume stands
    ctx.elastic = _elastic_carryover(smeta, cfg)
    return leaves, int(smeta["iteration"]), s_acc0


def _load(ctx: ResumeContext, meta: dict):
    """The compatible plain file's ``(leaves, done, acc_start)``."""
    cfg, run = ctx.cfg, ctx.cfg.run
    leaves, meta = load_checkpoint(cfg.checkpoint_path, ctx.template)
    it = int(meta["iteration"])
    if not meta.get("state_only"):
        ctx.elastic = _elastic_carryover(meta, cfg)
        return leaves, it, int(meta.get("acc_start", 0))
    # light file: accumulation restarts here, keeping only the restarted
    # window's draws - unless the sidecar keeps more (including the
    # window = 0 case, where a light resume would report Sigma = 0)
    window = (num_saved_draws(run.total_iters, run.burnin, run.thin)
              - num_saved_draws(it, run.burnin, run.thin))
    side = _try_full_sidecar(ctx, max(window, 0))
    if side is not None:
        return side
    if window <= 0:
        raise ValueError(
            f"resuming a state-only (light) checkpoint at iteration {it}: "
            "no further draws would be saved and its covariance "
            "accumulators were not stored, so there is nothing to report "
            "- extend run.mcmc to continue the chain, or use "
            "checkpoint_mode='full' / checkpoint_full_every for "
            "recoverable accumulators")
    ctx.elastic = _light_carryover(meta, cfg, it)
    return leaves, it, it


def resume_state(ctx: ResumeContext):
    """``(leaves or None, done, acc_start)``: None means a fresh start at
    iteration 0."""
    cfg = ctx.cfg
    ctx.elastic = None
    if not cfg.resume:
        return None, 0, 0
    auto = cfg.resume == "auto"
    path = cfg.checkpoint_path
    refuse_multiprocess_sets(path)
    if not os.path.exists(path):
        if not auto:
            raise FileNotFoundError(f"resume=True but no checkpoint at {path}")
        return None, 0, 0
    try:
        meta = read_checkpoint_meta(path)
        reason = checkpoint_compatible(meta, cfg, ctx.fingerprint)
    except (OSError, ValueError, KeyError):
        # unreadable, an old format: in auto mode one more reason to
        # start fresh
        if not auto:
            raise
        return None, 0, 0
    if reason is not None:
        try:
            adopted = _try_elastic(ctx, meta)
        except (OSError, ValueError, KeyError) as e:
            ctx.elastic = None
            if not auto:
                raise ValueError(f"refusing to resume: {reason} (elastic "
                                 f"adoption refused: {e})") from e
            return None, 0, 0
        if adopted is not None:
            return adopted
        if not auto:
            raise ValueError(f"refusing to resume: {reason}")
        return None, 0, 0
    try:
        return _load(ctx, meta)
    except (OSError, ValueError, KeyError):
        # a corrupt leaf behind a healthy meta (CheckpointCorruptError is
        # a ValueError), a finished light file
        if not auto:
            raise
        ctx.elastic = None
        return None, 0, 0


def rewind_source(ctx: ResumeContext):
    """The newest compatible, CRC-clean generation among the retained
    ones (checkpoint_keep_last) as ``(leaves, iteration, acc_start)``, or
    None; ``ctx.elastic`` becomes that file's bookkeeping."""
    cfg = ctx.cfg
    for p in retained_checkpoints(cfg.checkpoint_path):
        try:
            meta = read_checkpoint_meta(p)
            if checkpoint_compatible(meta, cfg, ctx.fingerprint):
                continue
            leaves, meta = load_checkpoint(p, ctx.template)
        except (OSError, ValueError, KeyError):
            continue        # a corrupt or unreadable generation: the next
        it = int(meta["iteration"])
        if meta.get("state_only"):
            ctx.elastic = _light_carryover(meta, cfg, it)
            return leaves, it, it
        ctx.elastic = _elastic_carryover(meta, cfg)
        return leaves, it, int(meta.get("acc_start", 0))
    return None
