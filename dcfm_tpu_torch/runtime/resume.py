"""Resume gates: where a fit's chains start, and where a rewind goes.

The port of the single-process part of ``dcfm_tpu/runtime/resume.py``:

* :func:`resume_state` - ``resume=True`` demands a compatible checkpoint
  (``FileNotFoundError`` / ``ValueError("refusing to resume: ...")``),
  ``resume="auto"`` falls back to a fresh start; compatibility is checked
  before the payload loads; a finished file resumes as a no-op; a light
  file restarts the accumulator window at its iteration (a finished light
  file is refused: there is nothing to report), and the ``.full`` sidecar
  of ``checkpoint_full_every`` wins whenever it keeps more saved draws;
* :func:`rewind_source` - the divergence sentinel's rewind target: the
  newest compatible, CRC-clean retained generation.

Both return host leaves (``utils/checkpoint.load_checkpoint``'s), which
the chunk loop (runtime/pipeline.py) copies into the chains' carries.
Still refused: adopting a file written at another chain count (the JAX
package's elastic resume, ROADMAP Queue A item 3) and multi-process
``.procK-of-N`` sets (item 7).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

from dcfm_tpu_torch.config import _CKPT, _OUTER, FitConfig
from dcfm_tpu_torch.models.sampler import num_saved_draws
from dcfm_tpu_torch.utils.checkpoint import (
    checkpoint_compatible, elastic_meta, load_checkpoint,
    read_checkpoint_meta, retained_checkpoints)


@dataclasses.dataclass
class ResumeContext:
    """What the gates need of a fit: the config, the data fingerprint the
    checkpoint must match and the carry template
    (``utils/checkpoint.carry_template``).

    ``window`` is an OUT field: the resumed file's v7 accumulator
    bookkeeping ``(chain_acc_starts, fold_draws)`` when it is not the
    uniform window (a file written after an elastic adoption), else None.
    The fetch divisor and every later full save thread it."""

    cfg: FitConfig
    fingerprint: Optional[str]
    template: dict
    window: Optional[tuple] = None


def _window_carryover(meta: dict, num_chains: int) -> Optional[tuple]:
    starts, fold, _ = elastic_meta(meta, num_chains)
    acc0 = int(meta.get("acc_start", 0))
    if fold or any(a != acc0 for a in starts):
        return tuple(starts), fold
    return None


def _refuse_multiprocess_sets(path: str) -> None:
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


def _refuse_elastic(meta: dict, ctx: ResumeContext) -> None:
    """A file whose only mismatch is the chain count: the JAX package
    adopts it when ``elastic`` allows; the port refuses by name."""
    cfg = ctx.cfg
    if cfg.elastic is False:
        return
    if checkpoint_compatible(meta, cfg, ctx.fingerprint,
                             ignore_chains=True) is None:
        raise NotImplementedError(
            "adopting a checkpoint written at num_chains="
            f"{meta['config']['run']['num_chains']} onto num_chains="
            f"{cfg.run.num_chains} (elastic resume) is not ported to "
            f"dcfm_tpu_torch yet: {_CKPT}; set FitConfig.elastic=False to "
            "refuse the file as incompatible instead")


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
    ctx.window = _window_carryover(smeta, run.num_chains)
    return leaves, int(smeta["iteration"]), s_acc0


def _load(ctx: ResumeContext, meta: dict):
    """The compatible plain file's ``(leaves, done, acc_start)``."""
    cfg, run = ctx.cfg, ctx.cfg.run
    leaves, meta = load_checkpoint(cfg.checkpoint_path, ctx.template)
    it = int(meta["iteration"])
    if not meta.get("state_only"):
        ctx.window = _window_carryover(meta, run.num_chains)
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
    return leaves, it, it


def resume_state(ctx: ResumeContext):
    """``(leaves or None, done, acc_start)``: None means a fresh start at
    iteration 0."""
    cfg = ctx.cfg
    ctx.window = None
    if not cfg.resume:
        return None, 0, 0
    auto = cfg.resume == "auto"
    path = cfg.checkpoint_path
    _refuse_multiprocess_sets(path)
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
        _refuse_elastic(meta, ctx)
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
        ctx.window = None
        return None, 0, 0


def rewind_source(ctx: ResumeContext):
    """The newest compatible, CRC-clean generation among the retained
    ones (checkpoint_keep_last) as ``(leaves, iteration, acc_start)``, or
    None."""
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
            ctx.window = None
            return leaves, it, it
        ctx.window = _window_carryover(meta, cfg.run.num_chains)
        return leaves, it, int(meta.get("acc_start", 0))
    return None
