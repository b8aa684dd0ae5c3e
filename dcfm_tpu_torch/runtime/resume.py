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
  when ``FitConfig.elastic`` allows (:func:`_try_elastic`); a fresh start
  under ``FitConfig.warm_start`` seeds the chains' state from another
  run's checkpoint (:func:`_try_warm_start`), strictly below resume: a
  relaunched warm refit resumes its own file and never re-grafts;
* :func:`rewind_source` - the divergence sentinel's rewind target: the
  newest compatible, CRC-clean retained generation.

Both return host leaves (``utils/checkpoint.load_checkpoint``'s), which
the chunk loop (runtime/pipeline.py) copies into the chains' carries, and
leave in ``ResumeContext.elastic`` the elastic bookkeeping the run must
thread into its divisor and its saves (and in ``ResumeContext.warm`` the
grafted state of a warm start).  Every decision is a flight-recorder event
(obs/recorder.py), as in the JAX package: ``resume_decision`` (fresh,
resume, light, sidecar, elastic), ``elastic_resume`` (elastic, refused)
and ``warm_start`` (warm, or cold with the reason).  On the shard mesh
every rank runs the gates (``ResumeContext.mesh``).  Still refused:
multi-process ``.procK-of-N`` sets (ROADMAP Queue A item 7,
:func:`refuse_multiprocess_sets`).

Fault seams (resilience/faults.py ``kill_event``): the elastic window's
``elastic_gate`` / ``elastic_fold`` / ``elastic_fold_post`` where the JAX
package's one-process resume has them, and the resume windows that the
JAX package opens around the collectives of its pod resume, at the same
places of the one-process resume here, each pair around the step that
stands in for the JAX collective: ``resume_gate`` / ``resume_gate_post``
around the decision on a loaded file (a full file's bookkeeping adopted,
or a light restart), ``sidecar_gate`` after the ``.full`` sidecar's
eligibility, ``sidecar_load`` before its load, ``sidecar_commit`` /
``sidecar_commit_post`` around the adoption of its bookkeeping (both
fire on a failed load too, as the JAX vote does, with nothing
committed).  A kill anywhere in them leaves the files as they were: the
gates only read.  ``supervise --no-elastic`` (DCFM_NO_ELASTIC=1) vetoes
the elastic adoption of ``elastic="auto"`` (:func:`_elastic_allowed`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from dcfm_tpu_torch.config import _OUTER, FitConfig
from dcfm_tpu_torch.models.sampler import num_saved_draws
from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.parallel.shard import leaf_block
from dcfm_tpu_torch.resilience.faults import fault_event
from dcfm_tpu_torch.utils.checkpoint import (
    _chain_tensors, _open, _read_leaf, checkpoint_compatible,
    config_from_checkpoint_meta, elastic_meta, load_checkpoint,
    load_checkpoint_elastic, read_checkpoint_meta, retained_checkpoints,
    state_leaf_names)


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
    (``utils/checkpoint.carry_template``), ``birth(chain, lineage)``, an
    elastic grow's initial leaves of a new chain (no chain axis), and
    ``fresh()``, the chains' initial carries on the fit's device (the
    same carries on every call: a warm start grafts into them).

    ``mesh`` is the shard mesh's rank (parallel/shard.RankMesh) when the
    fit runs on one: every rank runs the gates on the same files, so they
    decide alike, and a warm start's graft is the rank's block of the
    global graft, decided once for the mesh.

    ``elastic`` and ``warm`` are OUT fields: the resumed file's elastic
    bookkeeping (a fresh adoption, or a file saved after one), else None;
    the grafted state leaves of a warm start (``{leaf: host array}``, the
    chain-axis convention of the chains ``fresh()`` returns), which the
    caller writes into ``fresh()``'s carries, else None."""

    cfg: FitConfig
    fingerprint: Optional[str]
    template: dict
    birth: Optional[Callable[[int, int], dict]] = None
    fresh: Optional[Callable[[], list]] = None
    mesh: Optional[object] = None
    elastic: Optional[ElasticResume] = None
    warm: Optional[dict] = None


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
    read single-process files only): ``api.fit`` calls it before any work
    when it resumes, and ``serve/artifact.export_from_checkpoint``."""
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


def _elastic_allowed(cfg: FitConfig) -> bool:
    """May this run adopt a chain-count-mismatched checkpoint?  True,
    or "auto" without the supervisor's DCFM_NO_ELASTIC=1 veto."""
    el = getattr(cfg, "elastic", "auto")
    if el is True:
        return True
    return el == "auto" and os.environ.get("DCFM_NO_ELASTIC") != "1"


def _try_elastic(ctx: ResumeContext, meta: dict):
    """Elastic adoption of a file whose only mismatch is the chain count,
    as ``(leaves, done, acc_start)`` with ``ctx.elastic`` set; None when
    :func:`_elastic_allowed` says no (``FitConfig.elastic`` False, or
    "auto" under ``supervise --no-elastic``'s DCFM_NO_ELASTIC=1) or more
    than the chain count differs.
    A refused adoption (a light donor, a store_draws donor) raises its
    ValueError.

    A grow births the new chains on ``elastic_lineage + 1`` (the file's
    lineage bumped: a chain born after a second adoption never starts
    from a previous birth's state); the lineage is bumped on a shrink
    too, as the JAX package does."""
    cfg, run = ctx.cfg, ctx.cfg.run
    if not _elastic_allowed(cfg):
        return None
    if checkpoint_compatible(meta, cfg, ctx.fingerprint,
                             ignore_chains=True) is not None:
        return None
    donor_chains = int(config_from_checkpoint_meta(meta).run.num_chains)
    if donor_chains == run.num_chains:
        return None
    # the crash seams: before the adoption commits to anything, between
    # the births and the donor's fold, after the fold
    fault_event("elastic_gate")
    lineage = elastic_meta(meta, donor_chains)[2] + 1
    births = None
    if run.num_chains > donor_chains:
        births = [ctx.birth(c, lineage)
                  for c in range(donor_chains, run.num_chains)]
    fault_event("elastic_fold")
    leaves, meta, info = load_checkpoint_elastic(
        cfg.checkpoint_path, ctx.template, run.num_chains, births=births)
    fault_event("elastic_fold_post")
    starts = info["chain_acc_starts"]
    ctx.elastic = ElasticResume(
        from_chains=info["from_chains"], to_chains=info["to_chains"],
        kept=info["kept"], dropped=info["dropped"],
        birthed=info["birthed"], fold_draws=info["fold_draws"],
        chain_acc_starts=tuple(starts), elastic_lineage=lineage,
        from_topology=info["from_topology"], to_topology=run_topology(cfg))
    it = int(meta["iteration"])
    acc0 = min(starts) if starts else it
    record("elastic_resume", decision="elastic",
           from_chains=info["from_chains"], to_chains=info["to_chains"],
           kept=info["kept"], dropped=info["dropped"],
           birthed=info["birthed"], fold_draws=info["fold_draws"],
           elastic_lineage=lineage, iteration=it, acc_start=acc0,
           from_topology=info["from_topology"],
           to_topology=run_topology(cfg))
    record("resume_decision", decision="elastic", iteration=it,
           acc_start=acc0)
    return leaves, it, acc0


def _try_full_sidecar(ctx: ResumeContext, light_kept: int):
    """The ``.full`` sidecar (checkpoint_full_every) as ``(leaves, done,
    acc_start)`` iff it is full, compatible, loads clean and keeps MORE
    saved draws than ``light_kept`` (the light restart window); None
    otherwise."""
    cfg = ctx.cfg
    side = cfg.checkpoint_path + ".full"
    s_acc0 = _sidecar_eligible(ctx, side, light_kept)
    fault_event("sidecar_gate")
    if s_acc0 is None:
        return None
    fault_event("sidecar_load")
    try:
        leaves, smeta = load_checkpoint(side, ctx.template)
    except (OSError, ValueError, KeyError):
        leaves = None        # not usable: the light resume stands
    # the commit (the sidecar's bookkeeping adopted) between the pair; a
    # failed load commits nothing and keeps the light resume
    fault_event("sidecar_commit")
    if leaves is not None:
        ctx.elastic = _elastic_carryover(smeta, cfg)
    fault_event("sidecar_commit_post")
    if leaves is None:
        return None
    return leaves, int(smeta["iteration"]), s_acc0


def _sidecar_eligible(ctx: ResumeContext, side: str,
                      light_kept: int) -> Optional[int]:
    """The sidecar's accumulation start iff it exists, is full and
    compatible and keeps more saved draws than ``light_kept``; else
    None."""
    cfg, run = ctx.cfg, ctx.cfg.run
    if not os.path.exists(side):
        return None
    try:
        smeta = read_checkpoint_meta(side)
        if (smeta.get("state_only")
                or checkpoint_compatible(smeta, cfg, ctx.fingerprint)
                is not None):
            return None
    except (OSError, ValueError, KeyError):
        return None
    s_acc0 = int(smeta.get("acc_start", 0))
    s_kept = (num_saved_draws(run.total_iters, run.burnin, run.thin)
              - num_saved_draws(s_acc0, run.burnin, run.thin))
    return s_acc0 if s_kept > light_kept else None


def _load(ctx: ResumeContext, meta: dict):
    """The compatible plain file's ``(leaves, done, acc_start)``."""
    cfg, run = ctx.cfg, ctx.cfg.run
    leaves, meta = load_checkpoint(cfg.checkpoint_path, ctx.template)
    # the decision (a full file's bookkeeping adopted, or a light file's
    # restart) between the pair
    fault_event("resume_gate")
    it = int(meta["iteration"])
    light = bool(meta.get("state_only"))
    if not light:
        ctx.elastic = _elastic_carryover(meta, cfg)
    fault_event("resume_gate_post")
    if not light:
        acc0 = int(meta.get("acc_start", 0))
        record("resume_decision", decision="resume", kind="plain",
               iteration=it, acc_start=acc0)
        return leaves, it, acc0
    # light file: accumulation restarts here, keeping only the restarted
    # window's draws - unless the sidecar keeps more (including the
    # window = 0 case, where a light resume would report Sigma = 0)
    window = (num_saved_draws(run.total_iters, run.burnin, run.thin)
              - num_saved_draws(it, run.burnin, run.thin))
    side = _try_full_sidecar(ctx, max(window, 0))
    if side is not None:
        record("resume_decision", decision="sidecar", iteration=side[1],
               acc_start=side[2])
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
    record("resume_decision", decision="light", kind="plain", iteration=it,
           acc_start=it)
    return leaves, it, it


def _warm_incompatible(meta: dict, cfg: FitConfig) -> Optional[str]:
    """Why the donor checkpoint cannot seed this run's chains, or None
    (the JAX package's rule and reasons).

    Looser than :func:`checkpoint_compatible`: a warm start is a new run
    whose data grew, so seed, schedule, fingerprint and the random
    streams (``meta["rng"]``) may all differ.  What must hold is the graft
    geometry: the chain axis present in both or in neither, and the same
    model up to ``num_shards`` (the field that grows with a new shard)."""
    if int(meta["version"]) not in (6, 7, 8):
        return (f"donor checkpoint is format v{meta['version']}, "
                "warm start requires v6/v7/v8")
    old = config_from_checkpoint_meta(meta)
    if old.run.num_chains != cfg.run.num_chains and (
            old.run.num_chains == 1 or cfg.run.num_chains == 1):
        return (f"donor ran {old.run.num_chains} chains, this run "
                f"{cfg.run.num_chains} - the chain axis appears/"
                "disappears at num_chains=1, no graft geometry")
    if dataclasses.replace(old.model,
                           num_shards=cfg.model.num_shards) != cfg.model:
        return ("donor model config differs beyond num_shards - the "
                "state pytrees are not graft-compatible")
    return None


def graft_block(old: np.ndarray, block: np.ndarray, origin: tuple,
                shape: tuple) -> np.ndarray:
    """One donor state leaf ``old`` grafted into a fresh leaf of ``shape``
    (the JAX package's rule), as its block at ``origin``: ``block`` is
    that block of the fresh leaf.  The donor takes the fresh leaf's origin
    block - all of it when the shapes are equal - and the fresh init stays
    in the grown region (appended rows grow n, new shards grow G); a
    shrunk or reshaped leaf raises (the caller's cold fallback).  The
    shard mesh grafts each rank's block this way (parallel/shard.
    leaf_block), so the blocks of every rank make up the one-device
    graft."""
    dtype = np.dtype(block.dtype)
    if (old.ndim != len(shape)
            or any(o > f for o, f in zip(old.shape, shape))):
        raise ValueError(
            f"donor state leaf {old.shape} does not embed in fresh "
            f"{tuple(shape)} - data shrank or layout changed")
    if old.shape == tuple(block.shape) and not any(origin):
        return np.asarray(old, dtype=dtype)  # dcfm: ignore[DCFM801] - donor npz bytes already on the host, not a device fetch
    out = np.array(block, dtype=dtype)  # dcfm: ignore[DCFM801] - the fresh leaf is a host array (host_state), not a device fetch
    src, dst = [], []
    for o, lo, b in zip(old.shape, origin, out.shape):
        hi = min(lo + b, o)
        if hi <= lo:
            return out              # the donor does not reach this block
        src.append(slice(lo, hi))
        dst.append(slice(0, hi - lo))
    out[tuple(dst)] = old[tuple(src)].astype(dtype)
    return out


def _graft_state_leaf(old: np.ndarray, fresh: np.ndarray) -> np.ndarray:
    """One donor state leaf grafted into its whole fresh-init counterpart
    (:func:`graft_block` on one device)."""
    return graft_block(old, fresh, (0,) * np.ndim(fresh), np.shape(fresh))


def host_state(carries: list, names: tuple) -> dict:
    """The chains' state leaves ``names`` as host arrays, with the
    chain-axis convention (a leading chain axis for more than one
    chain)."""
    per = [_chain_tensors(c, True) for c in carries]
    return {k: (np.stack([p[k].cpu().numpy() for p in per])
                if len(per) > 1 else per[0][k].cpu().numpy())
            for k in names}


def graft_into(carries: list, leaves: dict) -> None:
    """Write host state leaves (the chain-axis convention) into the
    chains' own carries, in place: before the chain's first trip, so every
    capture reads them from the device."""
    for c, carry in enumerate(carries):
        tensors = _chain_tensors(carry, True)
        for k, a in leaves.items():
            tensors[k].copy_(torch.from_numpy(np.ascontiguousarray(
                a[c] if len(carries) > 1 else a)))


def _warm_graft(ctx: ResumeContext) -> tuple:
    """The graft of the donor checkpoint (``FitConfig.warm_start``) into
    the fresh chains' state: ``(grafted leaves or None, the warm_start
    event's fields)``.  Never raises: any failure is a cold start.

    Only the state grafts - accumulators, iteration and health start
    fresh (a new run over new data).  The state leaves are the first
    leaves of a full and of a light file alike, each CRC-checked before
    it is grafted.  A donor with more chains seeds from its first rows; a
    donor with fewer leaves the extra chains on their fresh init (the
    origin-block graft).  Lambda's (P, K) must agree (per-shard width and
    rank never graft); n and G may grow.  On the shard mesh each rank
    grafts its block of every global leaf (:func:`graft_block` at
    ``parallel/shard.leaf_block``'s origin), in the global chain and shard
    coordinates of the one-device graft."""
    cfg, ws = ctx.cfg, ctx.cfg.warm_start
    try:
        meta = read_checkpoint_meta(ws.checkpoint)
        reason = _warm_incompatible(meta, cfg)
        if reason is not None:
            return None, {"decision": "cold", "reason": reason}
        names = state_leaf_names(cfg.model)
        fresh = host_state(ctx.fresh(), names)
        blocks = {k: (fresh[k], (0,) * fresh[k].ndim, fresh[k].shape)
                  if ctx.mesh is None
                  else leaf_block(ctx.mesh.layout, k, fresh[k])
                  for k in names}
        donor_chains = config_from_checkpoint_meta(meta).run.num_chains
        C = cfg.run.num_chains
        chain_slice = C if donor_chains > C else None
        grafted, verbatim = {}, 0
        with _open(ws.checkpoint) as z:
            lam, f_lam = z["leaf_0"], blocks["Lambda"][2]
            if lam.ndim != len(f_lam) or lam.shape[-2:] != f_lam[-2:]:
                return None, {
                    "decision": "cold",
                    "reason": (f"donor Lambda {lam.shape} vs fresh "
                               f"{tuple(f_lam)}: per-shard feature width "
                               "/ rank mismatch")}
            for i, name in enumerate(names):
                arr = _read_leaf(z, meta, f"leaf_{i}", ws.checkpoint)
                if chain_slice is not None:
                    arr = arr[:chain_slice]
                grafted[name] = graft_block(arr, *blocks[name]).reshape(
                    fresh[name].shape)
                verbatim += int(arr.shape == tuple(blocks[name][2]))
        return grafted, {"decision": "warm",
                         "donor_iteration": int(meta["iteration"]),
                         "relineage": ws.relineage, "leaves": len(grafted),
                         "verbatim_leaves": verbatim}
    except Exception as e:
        # a warm start is best-effort by contract: any failure is a
        # recorded cold start
        return None, {"decision": "cold", "reason": f"{type(e).__name__}: {e}"}


def _try_warm_start(ctx: ResumeContext) -> bool:
    """The warm-start seam (``FitConfig.warm_start``): :func:`_warm_graft`
    into ``ctx.warm``, recorded as the ``warm_start`` event; True when it
    grafted.  Never raises: any failure is a recorded cold start (False).
    On the shard mesh the decision is one for every rank - warm only when
    every rank grafted its block, else cold on all of them (one rank's
    cold start would run another chain on its block) - and the event is
    rank 0's record."""
    grafted, event = _warm_graft(ctx)
    if ctx.mesh is not None:
        cold = int(ctx.mesh.total(float(grafted is None)))
        if cold and grafted is not None:
            grafted = None
            event = {"decision": "cold",
                     "reason": (f"{cold} of the mesh's {ctx.mesh.world} "
                                "ranks could not graft the donor")}
    ctx.warm = grafted
    record("warm_start", checkpoint=ctx.cfg.warm_start.checkpoint, **event)
    return grafted is not None


def _fresh(ctx: ResumeContext):
    """A start at iteration 0: warm from ``FitConfig.warm_start`` when the
    donor grafts, else recorded as the fresh decision."""
    ctx.elastic = None
    if ctx.cfg.warm_start is not None and _try_warm_start(ctx):
        return None, 0, 0
    record("resume_decision", decision="fresh", iteration=0, acc_start=0)
    return None, 0, 0


def resume_state(ctx: ResumeContext):
    """``(leaves or None, done, acc_start)``: None means a start at
    iteration 0 (``ctx.warm`` holds the grafted state of a warm one)."""
    cfg = ctx.cfg
    ctx.elastic = ctx.warm = None
    if not cfg.resume:
        return _fresh(ctx)
    auto = cfg.resume == "auto"
    path = cfg.checkpoint_path
    if not os.path.exists(path):
        if not auto:
            raise FileNotFoundError(f"resume=True but no checkpoint at {path}")
        return _fresh(ctx)
    try:
        meta = read_checkpoint_meta(path)
        reason = checkpoint_compatible(meta, cfg, ctx.fingerprint)
    except (OSError, ValueError, KeyError):
        # unreadable, an old format: in auto mode one more reason to
        # start fresh
        if not auto:
            raise
        return _fresh(ctx)
    if reason is not None:
        try:
            adopted = _try_elastic(ctx, meta)
        except (OSError, ValueError, KeyError) as e:
            record("elastic_resume", decision="refused",
                   reason=f"{type(e).__name__}: {e}")
            if not auto:
                raise ValueError(f"refusing to resume: {reason} (elastic "
                                 f"adoption refused: {e})") from e
            return _fresh(ctx)
        if adopted is not None:
            return adopted
        if not auto:
            raise ValueError(f"refusing to resume: {reason}")
        return _fresh(ctx)
    try:
        return _load(ctx, meta)
    except (OSError, ValueError, KeyError):
        # a corrupt leaf behind a healthy meta (CheckpointCorruptError is
        # a ValueError), a finished light file
        if not auto:
            raise
        return _fresh(ctx)


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
