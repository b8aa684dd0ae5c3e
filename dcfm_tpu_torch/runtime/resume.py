"""Resume gates: where a fit's chains start, and where a rewind goes.

The port of ``dcfm_tpu/runtime/resume.py``:

* :func:`resume_state` - one process: discovery picks the most
  progressed source among the plain file and any complete
  ``.procK-of-N`` set (a pod's set is resharded onto this process,
  narrated as a ``pod_elastic`` event: the host-elastic resume);
  ``resume=True`` demands a compatible checkpoint
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
* :func:`resume_state_multiproc` - a pod's rank (parallel/multihost.py):
  the decision is COLLECTIVE and source-signature-exact (a kill can land
  between two processes' saves; resuming mismatched states would
  deadlock the collectives), with the sidecar preference behind two
  unanimity gates, and every rank reads only its own file when the set
  was written at the pod's size;
* :func:`rewind_source` - the divergence sentinel's rewind target: the
  newest compatible, CRC-clean retained generation.

They return host leaves (``utils/checkpoint.load_checkpoint``'s, or a
pod rank's own block of them), which the chunk loop (runtime/pipeline.py)
copies into the chains' carries, and leave in ``ResumeContext.elastic``
the elastic bookkeeping the run must thread into its divisor and its
saves, in ``ResumeContext.pod`` the host-elastic bookkeeping every later
save carries, and in ``ResumeContext.warm`` the grafted state of a warm
start.  Every decision is a flight-recorder event (obs/recorder.py), as
in the JAX package: ``resume_decision`` (fresh, resume, light, sidecar,
elastic; on a pod with ``agree`` or refused with the signatures),
``elastic_resume`` (elastic, refused), ``pod_elastic`` (adopted) and
``warm_start`` (warm, or cold with the reason).  On the shard mesh every
rank runs the gates (``ResumeContext.mesh``).

Fault seams (resilience/faults.py ``kill_event``): the elastic window's
``elastic_gate`` / ``elastic_fold`` / ``elastic_fold_post``; on a pod the
JAX package's resume windows around its collectives - ``resume_gate`` /
``resume_gate_post`` around the signature gather, ``sidecar_gate``
before the sidecar's eligibility gather, ``sidecar_load`` before its
load, ``sidecar_commit`` / ``sidecar_commit_post`` around the load
votes' gather.  The one-process resume opens the same windows at the
same places, each pair around the step that stands in for the
collective: ``resume_gate`` / ``resume_gate_post`` around the decision on
a loaded file, ``sidecar_gate`` after the sidecar's eligibility,
``sidecar_load`` before its load, ``sidecar_commit`` /
``sidecar_commit_post`` around the adoption of its bookkeeping (both
fire on a failed load too, with nothing committed).  A kill anywhere in
them leaves the files as they were: the gates only read.  ``supervise
--no-elastic`` (DCFM_NO_ELASTIC=1) vetoes the elastic adoption of
``elastic="auto"`` (:func:`_elastic_allowed`) and the adoption of a set
written by another number of processes (:func:`_pod_refusal`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from dcfm_tpu_torch.config import FitConfig
from dcfm_tpu_torch.models.sampler import num_saved_draws
from dcfm_tpu_torch.models.state import num_padded_pairs
from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.parallel.multihost import process_count, process_index
from dcfm_tpu_torch.parallel.shard import leaf_block
from dcfm_tpu_torch.resilience.faults import fault_event
from dcfm_tpu_torch.utils.checkpoint import (
    _chain_tensors, _open, _read_leaf, checkpoint_compatible,
    config_from_checkpoint_meta, discover_checkpoint, elastic_meta,
    load_checkpoint, load_checkpoint_elastic, load_checkpoint_multiprocess,
    load_checkpoint_resharded, pod_meta, proc_path, read_checkpoint_meta,
    retained_checkpoints, state_leaf_names)


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

    ``elastic``, ``pod`` and ``warm`` are OUT fields: the resumed file's
    elastic bookkeeping (a fresh adoption, or a file saved after one),
    else None; the host-elastic bookkeeping (meta v8) -
    ``{"from_hosts", "to_hosts", "pod_adoptions"}`` when the source was
    written by another number of processes or carries an adoption count
    every later save must keep, else None; the grafted state leaves of a
    warm start (``{leaf: host array}``, the chain-axis convention of the
    chains ``fresh()`` returns), which the caller writes into
    ``fresh()``'s carries, else None."""

    cfg: FitConfig
    fingerprint: Optional[str]
    template: dict
    birth: Optional[Callable[[int, int], dict]] = None
    fresh: Optional[Callable[[], list]] = None
    mesh: Optional[object] = None
    elastic: Optional[ElasticResume] = None
    warm: Optional[dict] = None
    pod: Optional[dict] = None


def run_topology(cfg: FitConfig) -> dict:
    """The topology a port run adopts onto, for the flight recorder: its
    chains, and its processes (parallel/multihost.process_count: 1
    outside a pod), one device each."""
    n = process_count()
    return {"num_chains": int(cfg.run.num_chains), "num_devices": n,
            "num_processes": n}


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


def _pod_carryover(ctx: ResumeContext, meta: dict) -> None:
    """Thread the v8 host-elastic bookkeeping of a source resumed on this
    run's process count into ``ctx.pod``, a change of the count narrated
    as a ``pod_elastic`` event (the pair panels re-partitioned onto the
    surviving hosts).  The adoption count never rewinds: a resume on the
    writer's count keeps it, a crossing bumps it."""
    now = process_count()
    from_hosts, adoptions = pod_meta(meta)
    if from_hosts != now:
        adoptions += 1
        try:
            pairs = int(num_padded_pairs(int(
                config_from_checkpoint_meta(meta).model.num_shards)))
        except Exception:  # dcfm: ignore[DCFM601] - narration only; the adoption itself needs no pair count
            pairs = -1
        record("pod_elastic", decision="adopted", from_hosts=from_hosts,
               to_hosts=now, pod_adoptions=adoptions, pair_panels=pairs,
               iteration=int(meta.get("iteration", -1)))
    ctx.pod = ({"from_hosts": from_hosts, "to_hosts": now,
                "pod_adoptions": adoptions}
               if (from_hosts != now or adoptions) else None)


def _pod_refusal(meta: dict, cfg: FitConfig) -> Optional[str]:
    """Why a source written by another number of processes cannot be
    adopted here (elastic adoption vetoed), or None (the JAX package's
    text, naming both fixes)."""
    if _elastic_allowed(cfg):
        return None
    from_hosts, _ = pod_meta(meta)
    now = process_count()
    if from_hosts == now:
        return None
    return (f"checkpoint was written by a {from_hosts}-host pod, run "
            f"has {now} host(s) and elastic adoption is vetoed; drop "
            "--no-elastic (DCFM_NO_ELASTIC=1) to re-partition the pair "
            f"panels onto the surviving hosts, or relaunch with --pod "
            f"{from_hosts} to match the checkpoint")


def _local_set_source(path: str):
    """A pod rank's own ``.procK-of-N`` file as a "local-set" source, for
    per-host local disks where the peers' files are not visible: ``(source,
    this rank's file)``, or ``(None, None)`` without one.  The loader's
    fast path reads only that file; its reshard path refuses the kind, and
    the callers gate on the pod's agreement."""
    n = process_count()
    mine = proc_path(path, process_index(), n)
    if not os.path.exists(mine):
        return None, None
    it = int(read_checkpoint_meta(mine)["iteration"])
    return ("local-set",
            (n, [proc_path(path, i, n) for i in range(n)], it)), mine


def sidecar_esig(elig) -> np.ndarray:
    """A pod's unanimity signature of a sidecar eligibility
    (:func:`_sidecar_eligibility`'s ``(source, iteration, acc_start)`` or
    None): ``[iteration, kind, writer count, acc_start]`` as int64, all -1
    when ineligible.  ``acc_start`` keeps two hosts whose sidecars agree
    on the rest but started their windows apart from dividing by
    different draw counts."""
    if elig is None:
        return np.asarray([-1, -1, -1, -1], np.int64)
    source, it, acc0 = elig
    return np.asarray(
        [it, 0 if source[0] == "plain" else 1,
         -1 if source[0] == "plain" else source[1][0], acc0], np.int64)


def _elastic_allowed(cfg: FitConfig) -> bool:
    """May this run adopt a chain-count-mismatched checkpoint?  True,
    or "auto" without the supervisor's DCFM_NO_ELASTIC=1 veto."""
    el = getattr(cfg, "elastic", "auto")
    if el is True:
        return True
    return el == "auto" and os.environ.get("DCFM_NO_ELASTIC") != "1"


def _try_elastic(ctx: ResumeContext, meta: dict, source=("plain", None)):
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
    too, as the JAX package does.  ``source`` (discover_checkpoint's) may
    be a ``.procK-of-N`` set donor."""
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
        cfg.checkpoint_path, ctx.template, run.num_chains, births=births,
        paths=None if source[0] == "plain" else source[1][1])
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
    _pod_carryover(ctx, meta)
    return leaves, it, acc0


def _try_full_sidecar(ctx: ResumeContext, light_kept: int):
    """The ``.full`` sidecar (checkpoint_full_every) as ``(leaves, done,
    acc_start)`` iff :func:`_sidecar_eligibility` says it wins and it
    loads clean; None otherwise."""
    cfg = ctx.cfg
    elig = _sidecar_eligibility(ctx, light_kept)
    fault_event("sidecar_gate")
    if elig is None:
        return None
    source, _, s_acc0 = elig
    fault_event("sidecar_load")
    try:
        leaves, smeta = (
            load_checkpoint(cfg.checkpoint_path + ".full", ctx.template)
            if source[0] == "plain"
            else load_checkpoint_resharded(source[1][1], ctx.template))
    except (OSError, ValueError, KeyError):
        leaves = None        # not usable: the light resume stands
    # the commit (the sidecar's bookkeeping adopted) between the pair; a
    # failed load commits nothing and keeps the light resume
    fault_event("sidecar_commit")
    if leaves is not None:
        ctx.elastic = _elastic_carryover(smeta, cfg)
        _pod_carryover(ctx, smeta)
    fault_event("sidecar_commit_post")
    if leaves is None:
        return None
    return leaves, int(smeta["iteration"]), s_acc0


def _sidecar_eligibility(ctx: ResumeContext, light_kept: int, *,
                         multiproc: bool = False):
    """The one home of the "does the ``.full`` sidecar beat the light
    resume" rule: the sidecar - a plain file or a ``.procK-of-N`` set at
    ``checkpoint_path + ".full"``, on a pod (``multiproc``) falling back
    to the rank's own set file - as ``(source, iteration, acc_start)`` iff
    it is full, compatible and keeps MORE saved draws than
    ``light_kept`` (the light restart window); None otherwise, never
    raising."""
    cfg, run = ctx.cfg, ctx.cfg.run
    side = cfg.checkpoint_path + ".full"
    try:
        source = discover_checkpoint(side, prefer_plain=not multiproc)
        meta_path = None
        if source is not None:
            meta_path = side if source[0] == "plain" else source[1][1][0]
        elif multiproc:
            source, meta_path = _local_set_source(side)
        if source is None:
            return None
        smeta = read_checkpoint_meta(meta_path)
        if (smeta.get("state_only")
                or checkpoint_compatible(smeta, cfg, ctx.fingerprint)
                is not None):
            return None
        s_acc0 = int(smeta.get("acc_start", 0))
        s_kept = (num_saved_draws(run.total_iters, run.burnin, run.thin)
                  - num_saved_draws(s_acc0, run.burnin, run.thin))
        if s_kept <= light_kept:
            return None
        return source, int(smeta["iteration"]), s_acc0
    except Exception:  # dcfm: ignore[DCFM601] - eligibility probe: any failure = sidecar not usable
        return None


def _load(ctx: ResumeContext, meta: dict, source=("plain", None)):
    """The compatible source's ``(leaves, done, acc_start)``: the plain
    file, or a complete set assembled onto this process."""
    cfg, run = ctx.cfg, ctx.cfg.run
    kind = source[0]
    leaves, meta = (load_checkpoint(cfg.checkpoint_path, ctx.template)
                    if kind == "plain"
                    else load_checkpoint_resharded(source[1][1],
                                                   ctx.template))
    # the decision (a full file's bookkeeping adopted, or a light file's
    # restart) between the pair
    fault_event("resume_gate")
    it = int(meta["iteration"])
    light = bool(meta.get("state_only"))
    if not light:
        ctx.elastic = _elastic_carryover(meta, cfg)
        _pod_carryover(ctx, meta)
    fault_event("resume_gate_post")
    if not light:
        acc0 = int(meta.get("acc_start", 0))
        record("resume_decision", decision="resume", kind=kind,
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
    record("resume_decision", decision="light", kind=kind, iteration=it,
           acc_start=it)
    _pod_carryover(ctx, meta)
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
    return {k: (np.stack([p[k].cpu().numpy() for p in per])  # dcfm-torch: ignore[DCFM801] - once per resume, off the chunk path
                if len(per) > 1 else per[0][k].cpu().numpy())  # dcfm-torch: ignore[DCFM801] - once per resume, off the chunk path
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
    ctx.elastic = ctx.pod = None
    if ctx.cfg.warm_start is not None and _try_warm_start(ctx):
        return None, 0, 0
    record("resume_decision", decision="fresh", iteration=0, acc_start=0)
    return None, 0, 0


def resume_state(ctx: ResumeContext):
    """``(leaves or None, done, acc_start)``: None means a start at
    iteration 0 (``ctx.warm`` holds the grafted state of a warm one).  The
    source is the most progressed of the plain file and any complete
    ``.procK-of-N`` set (``utils/checkpoint.discover_checkpoint``; a tie
    goes to the plain file): a set written by a pod resumes here
    resharded, narrated as a ``pod_elastic`` event."""
    cfg = ctx.cfg
    ctx.elastic = ctx.warm = ctx.pod = None
    if not cfg.resume:
        return _fresh(ctx)
    auto = cfg.resume == "auto"
    path = cfg.checkpoint_path
    try:
        source = discover_checkpoint(path, prefer_plain=True)
    except (OSError, ValueError, KeyError):
        # nothing readable (a torn file, an old format): in auto mode one
        # more reason to start fresh
        if not auto:
            raise
        return _fresh(ctx)
    if source is None:
        if not auto:
            raise FileNotFoundError(f"resume=True but no checkpoint at "
                                    f"{path} (or any .procK-of-N set)")
        return _fresh(ctx)
    try:
        meta = read_checkpoint_meta(path if source[0] == "plain"
                                    else source[1][1][0])
        reason = checkpoint_compatible(meta, cfg, ctx.fingerprint)
        if reason is None:
            # the host-topology veto (--no-elastic): a source of another
            # process count may only be adopted elastically
            reason = _pod_refusal(meta, cfg)
    except (OSError, ValueError, KeyError):
        if not auto:
            raise
        return _fresh(ctx)
    if reason is not None:
        try:
            adopted = _try_elastic(ctx, meta, source)
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
        return _load(ctx, meta, source)
    except (OSError, ValueError, KeyError):
        # a corrupt leaf behind a healthy meta (CheckpointCorruptError is
        # a ValueError), a finished light file
        if not auto:
            raise
        return _fresh(ctx)


def resume_state_multiproc(ctx: ResumeContext):
    """A pod rank's resume (``ctx.mesh``, a pod's parallel/shard.RankMesh):
    ``(this rank's leaves or None, done, acc_start)``, the JAX package's
    collective, source-signature-exact decision.

    Each rank discovers its source (a complete set, the plain file, or on
    per-host disks its own file), checks it and loads its block
    (utils/checkpoint.load_checkpoint_multiprocess: its own file when the
    set was written at the pod's size), then every rank's signature
    ``[iteration, kind, writer count, state_only]`` is gathered and the
    pod resumes only when all agree - a kill between two processes' saves
    leaves files a chunk apart, and mixed states would deadlock the
    collectives.  No rank raises before the gather (a raise there would
    leave its peers waiting in it until the timeout): a strict-mode
    failure surfaces after it, on every rank alike.  A light agreement
    prefers the ``.full`` sidecar behind two more unanimity gates (every
    rank saw the same eligible sidecar; every rank loaded it).  No
    elastic adoption of another chain count and no warm start run here
    (a warm start is recorded cold), as in the JAX package."""
    cfg, run, mesh = ctx.cfg, ctx.cfg.run, ctx.mesh
    auto = cfg.resume == "auto"
    path = cfg.checkpoint_path
    ctx.elastic = ctx.warm = ctx.pod = None
    loaded, failure, source = None, None, None
    if cfg.resume:
        meta_path = None
        try:
            source = discover_checkpoint(path, prefer_plain=False)
            if source is not None:
                meta_path = (path if source[0] == "plain"
                             else source[1][1][0])
        except Exception as e:
            source, failure = None, f"checkpoint unreadable: {e}"
        if source is None:
            # per-host local disks: discovery needs the whole set, the
            # fast path only this rank's own file
            try:
                source, lpath = _local_set_source(path)
                if source is not None:
                    meta_path, failure = lpath, None
            except Exception as e:
                failure = failure or f"checkpoint unreadable: {e}"
        if source is not None:
            try:
                meta = read_checkpoint_meta(meta_path)
                reason = checkpoint_compatible(meta, cfg, ctx.fingerprint)
                if reason is None:
                    reason = _pod_refusal(meta, cfg)
                if reason is not None:
                    failure = f"refusing to resume: {reason}"
                else:
                    loaded = load_checkpoint_multiprocess(
                        path, ctx.template, layout=mesh.layout,
                        source=source)
            except Exception as e:
                failure = f"checkpoint unreadable: {e}"
        elif failure is None:
            failure = f"no checkpoint at {path} (or any .procK-of-N set)"
    my_iter = int(loaded[1]["iteration"]) if loaded is not None else -1
    kind_code = -1 if loaded is None else (0 if source[0] == "plain" else 1)
    src_count = (-1 if loaded is None or source[0] == "plain"
                 else source[1][0])
    # light-vs-full belongs to the signature: a light agreement runs the
    # sidecar's extra gathers, which every rank must enter alike
    so_code = (-1 if loaded is None
               else int(bool(loaded[1].get("state_only"))))
    my_sig = np.asarray([my_iter, kind_code, src_count, so_code], np.int64)
    fault_event("resume_gate")
    all_sigs = mesh.gather_ints(my_sig)
    fault_event("resume_gate_post")
    agree = my_iter >= 0 and bool(np.all(all_sigs == my_sig[None, :]))
    if agree:
        meta = loaded[1]
        if meta.get("state_only"):
            window = (num_saved_draws(run.total_iters, run.burnin, run.thin)
                      - num_saved_draws(my_iter, run.burnin, run.thin))
            # gate 1: every rank saw the same, more-draw-keeping sidecar
            elig = _sidecar_eligibility(ctx, max(window, 0), multiproc=True)
            e_sig = sidecar_esig(elig)
            fault_event("sidecar_gate")
            all_e = mesh.gather_ints(e_sig)
            if e_sig[0] >= 0 and bool(np.all(all_e == e_sig[None, :])):
                fault_event("sidecar_load")
                s_loaded = None
                try:
                    s_loaded = load_checkpoint_multiprocess(
                        path + ".full", ctx.template, layout=mesh.layout,
                        source=elig[0])
                except Exception:  # dcfm: ignore[DCFM601] - a failed load votes no at gate 2
                    s_loaded = None
                # gate 2: every rank loaded it, or none commits
                fault_event("sidecar_commit")
                all_ok = mesh.gather_ints([int(s_loaded is not None)])
                fault_event("sidecar_commit_post")
                if bool(np.all(all_ok == 1)):
                    smeta = s_loaded[1]
                    ctx.elastic = _elastic_carryover(smeta, cfg)
                    _pod_carryover(ctx, smeta)
                    s_it = int(smeta["iteration"])
                    s_acc0 = int(smeta.get("acc_start", 0))
                    record("resume_decision", decision="sidecar",
                           agree=True, iteration=s_it, acc_start=s_acc0)
                    return s_loaded[0], s_it, s_acc0
            if window > 0:
                _pod_carryover(ctx, meta)
                record("resume_decision", decision="light", agree=True,
                       iteration=my_iter, acc_start=my_iter)
                return loaded[0], my_iter, my_iter
            # every rank agreed on the source, so every rank raises alike
            if not auto:
                raise ValueError(
                    "resuming a state-only (light) checkpoint at "
                    f"iteration {my_iter}: no further draws would be "
                    "saved and its covariance accumulators were not "
                    "stored - extend run.mcmc, or use "
                    "checkpoint_full_every so a .full sidecar exists")
        else:
            ctx.elastic = _elastic_carryover(meta, cfg)
            _pod_carryover(ctx, meta)
            acc0 = int(meta.get("acc_start", 0))
            record("resume_decision", decision="resume", agree=True,
                   kind="plain" if kind_code == 0 else "set",
                   iteration=my_iter, acc_start=acc0)
            return loaded[0], my_iter, acc0
    if cfg.resume and not auto and not agree:
        record("resume_decision", decision="refused", iteration=my_iter,
               signatures=all_sigs.tolist())  # dcfm-torch: ignore[DCFM801] - a numpy array (gather_ints returns host ints), not a device fetch
        raise ValueError(
            failure or "resume=True but the per-process checkpoints "
            "disagree on the resume source "
            f"({all_sigs.tolist()} as [iteration, kind, count, "  # dcfm-torch: ignore[DCFM801] - a numpy array, not a device fetch
            "state_only] rows) - a crash between two processes' saves, "
            "or mixed stale files; delete the files or use "
            "resume='auto' to restart fresh")
    ctx.elastic = ctx.pod = None
    if cfg.warm_start is not None:
        record("warm_start", decision="cold",
               reason="multi-process runs never warm-start",
               checkpoint=cfg.warm_start.checkpoint)
    record("resume_decision", decision="fresh", iteration=0, acc_start=0)
    return None, 0, 0


def rewind_source(ctx: ResumeContext):
    """The newest compatible, CRC-clean generation among the retained
    ones (checkpoint_keep_last) as ``(leaves, iteration, acc_start)``, or
    None; ``ctx.elastic`` and ``ctx.pod`` become that file's
    bookkeeping."""
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
        _pod_carryover(ctx, meta)
        if meta.get("state_only"):
            ctx.elastic = _light_carryover(meta, cfg, it)
            return leaves, it, it
        ctx.elastic = _elastic_carryover(meta, cfg)
        return leaves, it, int(meta.get("acc_start", 0))
    return None
