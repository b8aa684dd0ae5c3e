"""One online cycle: detect -> refit -> export -> validate -> promote.

The port of ``dcfm_tpu/online/cycle.py``, over the port's serving plane
(serve/promote.py, serve/delta.py), its warm starts
(``config.WarmStart``) and its supervisor.  The refit runs on the card
unless the runner asks for the CPU: the default runner of
:func:`run_cycle` takes the device from the refit config's ``backend``
("auto": the card), and :func:`default_runner` sets it.

A *cycle* turns one observed data change into one promoted artifact
generation, or into a typed, event-logged refusal that leaves the old
generation serving.  Every stage lands in the flight recorder:

* ``online_detect``  - the manifest changed (kind, shapes, target gen);
* ``online_refit``   - the refit launched (warm or cold, schedule);
* ``online_promote`` - the pointer flipped (generation, data-to-serving
  wall ``cycle_s``);
* ``online_refused`` - a gate said no (stage, reason); the pointer did
  NOT move.

When a generation is already serving, the candidate additionally ships
as a per-panel DELTA against it (serve/delta.py): the streamed
candidate is replaced by the delta's byte-identical materialization
BEFORE the gates run (so CRC and drift validate exactly what a replica
reconstructs), and gate 3 promotes through ``promote_delta`` - emitting
``delta_export`` / ``delta_promote`` events that count panels and bytes
actually shipped.  Any delta-side failure (shape change, missing CRC
tables, torn delta) records ``delta_fallback`` and promotes the full
candidate instead - never a refusal loop.

**Detection** is manifest-based: the watched directory holds one
``Y.npy`` (the current full data matrix) and the cycle compares its
``(n, p, fingerprint)`` against the last promoted manifest.  Rows
appended with columns unchanged -> ``appended_rows`` (warm refit: the
donor state grafts verbatim, new rows initialize fresh); columns grown
-> ``new_shards`` (warm refit: converged shards' state grafts verbatim,
the new shard initializes from the prior); anything else -> ``replaced``
(cold refit - the donor posterior describes different data).

**Validation gates**, all three before the pointer moves:

1. CRC-clean: every panel of the candidate verifies
   (serve/promote.verify_candidate) - a refit killed mid-stream leaves
   an unopenable or CRC-failing candidate, never a served one;
2. bounded drift: the relative Frobenius distance between the candidate
   and the currently served artifact over their common feature block is
   <= ``max_drift`` - a refit that wandered (bad shard of appended
   data, poisoned warm start) must page an operator, not silently
   replace the posterior the fleet answers from;
3. monotonic generation: the promotion writes exactly the generation
   detection targeted (``promote_artifact(expect_generation=...)``) -
   a concurrent promoter or a resumed twin of this cycle cannot
   re-number history.

A refused cycle raises :class:`CycleRefusedError` whose message names
the flight-recorder path (resilience/supervisor.postmortem), the same
triage contract as ``PoisonedRunError``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Optional

import numpy as np

from dcfm_tpu_torch.config import (
    BackendConfig, FitConfig, ModelConfig, RunConfig, WarmStart)
from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.serve.artifact import ArtifactError, PosteriorArtifact
from dcfm_tpu_torch.serve.delta import (
    materialize_delta, write_delta_artifact)
from dcfm_tpu_torch.serve.promote import (
    PointerError, promote_artifact, promote_delta, read_pointer,
    verify_candidate)

DATA_FILE = "Y.npy"


class OnlineError(RuntimeError):
    """Base of the online loop's typed failures.  Messages name the
    flight-recorder path so triage starts from the event trail."""


class CycleRefusedError(OnlineError):
    """A validation gate refused the promotion.  The old artifact keeps
    serving; the refusal is in the flight recorder (``online_refused``)."""


@dataclasses.dataclass(frozen=True)
class CycleSettings:
    """Everything a cycle needs beyond the data itself."""

    root: str                    # promotion root the fleet watches
    workdir: str                 # checkpoints, donor state, obs
    factors_per_shard: int
    rho: float
    shard_width: int             # features per shard (fixed; p grows by it)
    burnin: int                  # cold-start schedule
    mcmc: int
    warm_burnin: int             # shortened burn-in for warm refits
    thin: int = 1
    seed: int = 0
    chunk_size: int = 0
    max_drift: float = 0.5       # rel-Frobenius promotion gate
    supervised: bool = True      # refit under supervise() (crash-only)
    max_retries: int = 3
    prior: str = "mgp"

    def num_shards(self, p: int) -> int:
        # packed panels pad to shard evenly (FitConfig.pad_to_shards
        # default), so a partially filled trailing shard is fine
        return max(1, -(-p // self.shard_width))


@dataclasses.dataclass(frozen=True)
class CyclePlan:
    """One detection, frozen: what changed and what this cycle will do."""

    kind: str                    # initial | appended_rows | new_shards | replaced
    manifest: dict               # {"n", "p", "fingerprint"} of the new data
    num_shards: int
    target_generation: int
    candidate: str               # artifact directory name inside the root
    checkpoint: str              # this refit's own checkpoint path
    warm_from: Optional[str]     # donor checkpoint, None = cold


@dataclasses.dataclass(frozen=True)
class CycleResult:
    """A completed (promoted) cycle."""

    generation: int
    artifact: str                # promoted artifact directory
    checkpoint: str              # this refit's checkpoint (next donor)
    manifest: dict
    warm: bool                   # did the refit graft the donor state?
    refit_s: float
    cycle_s: float               # detect -> pointer flip wall
    drift: Optional[float]       # rel-Frobenius vs the previous artifact
    # delta-promotion stats ({"panels_changed", "panels_total",
    # "bytes_shipped", "full_bytes"}) when this generation shipped as a
    # per-panel delta against the previous one; None = full promotion
    delta: Optional[dict] = None


def read_manifest(data_dir: str) -> dict:
    """``(n, p, fingerprint)`` of the watched directory's data matrix.
    Raises OSError/ValueError when absent or unreadable - the watcher
    treats that as "no data yet", not as an error."""
    from dcfm_tpu_torch.utils.checkpoint import data_fingerprint
    Y = np.load(os.path.join(data_dir, DATA_FILE), mmap_mode="r")
    return {"n": int(Y.shape[0]), "p": int(Y.shape[1]),
            "fingerprint": data_fingerprint(np.asarray(Y))}


def classify(prev: Optional[dict], cur: dict) -> Optional[str]:
    """The detection rule.  None = nothing changed (same fingerprint and
    shape); otherwise one of the four cycle kinds."""
    if prev is None:
        return "initial"
    if (prev["fingerprint"] == cur["fingerprint"]
            and prev["n"] == cur["n"] and prev["p"] == cur["p"]):
        return None
    if cur["p"] > prev["p"]:
        return "new_shards"
    if cur["p"] == prev["p"] and cur["n"] > prev["n"]:
        return "appended_rows"
    # shrunk, or same-shape different bytes: the donor posterior
    # describes data that no longer exists - refit cold
    return "replaced"


def plan_cycle(settings: CycleSettings, prev_manifest: Optional[dict],
               manifest: dict,
               donor_checkpoint: Optional[str]) -> Optional[CyclePlan]:
    """Turn a manifest read into a plan, or None when nothing changed.
    Emits ``online_detect``."""
    kind = classify(prev_manifest, manifest)
    if kind is None:
        return None
    try:
        gen = read_pointer(settings.root).generation + 1
    except PointerError:
        gen = 1
    warm_from = donor_checkpoint if kind in ("appended_rows",
                                             "new_shards") else None
    plan = CyclePlan(
        kind=kind, manifest=dict(manifest),
        num_shards=settings.num_shards(manifest["p"]),
        target_generation=gen, candidate=f"v{gen}",
        checkpoint=os.path.join(settings.workdir, f"gen{gen}.ckpt.npz"),
        warm_from=warm_from)
    record("online_detect", kind=kind, n=manifest["n"], p=manifest["p"],
           fingerprint=manifest["fingerprint"], target_generation=gen,
           warm=warm_from is not None)
    return plan


def _refuse(stage: str, reason: str, plan: CyclePlan,
            obs_dir: Optional[str]):
    from dcfm_tpu_torch.resilience.supervisor import postmortem
    record("online_refused", stage=stage, reason=reason, kind=plan.kind,
           generation=plan.target_generation)
    raise CycleRefusedError(
        f"cycle for generation {plan.target_generation} refused at "
        f"{stage}: {reason}" + postmortem(obs_dir))


def refit_config(settings: CycleSettings, plan: CyclePlan) -> FitConfig:
    """The refit's FitConfig: checkpointed (the supervisor's resume
    substrate AND the next cycle's warm-start donor), streaming its
    artifact straight into the candidate directory, warm-started when
    the plan has a donor.  ``resume="auto"`` so a supervised relaunch
    resumes this refit's own progress - the warm seam sits strictly
    below resume."""
    warm = plan.warm_from is not None
    run = RunConfig(
        burnin=settings.warm_burnin if warm else settings.burnin,
        mcmc=settings.mcmc, thin=settings.thin, seed=settings.seed,
        chunk_size=settings.chunk_size)
    model = ModelConfig(
        num_shards=plan.num_shards,
        factors_per_shard=settings.factors_per_shard,
        rho=settings.rho, prior=settings.prior)
    return FitConfig(
        model=model, run=run,
        # quant8 fetch is the artifact's native layout - required by
        # stream_artifact, and what the fleet serves anyway
        backend=BackendConfig(fetch_dtype="quant8"),
        checkpoint_path=plan.checkpoint, checkpoint_mode="full",
        checkpoint_keep_last=2, resume="auto",
        stream_artifact=os.path.join(settings.root, plan.candidate),
        warm_start=(WarmStart(checkpoint=plan.warm_from,
                              relineage=plan.target_generation)
                    if warm else None))


def default_runner(settings: CycleSettings, backend: str = "auto"):
    """The refit seam of :func:`run_cycle`: the refit on the device
    ``backend`` names (a ``BackendConfig.backend`` value; "auto" keeps
    the refit config's, the card), supervised when the settings say so.

    A supervised refit runs its chain in supervised children and returns
    their report: the cycle reads the streamed candidate, never a
    FitResult, so the daemon does not materialize one - it holds no card
    memory while the next cycle's child fits."""
    def run(Y, cfg):
        if backend != "auto":
            cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
                cfg.backend, backend=backend))
        if settings.supervised:
            from dcfm_tpu_torch.resilience.supervisor import (
                _supervise_children)
            return _supervise_children(Y, cfg,
                                       max_retries=settings.max_retries)
        from dcfm_tpu_torch.api import fit
        return fit(Y, cfg)
    return run


def _rel_frob(A: np.ndarray, B: np.ndarray) -> float:
    denom = float(np.linalg.norm(B))
    return float(np.linalg.norm(A - B)) / max(denom, 1e-30)


def run_cycle(settings: CycleSettings, Y, plan: CyclePlan, *,
              runner: Optional[Callable] = None,
              obs_dir: Optional[str] = None) -> CycleResult:
    """Execute one planned cycle end to end.  Returns the promoted
    :class:`CycleResult` or raises :class:`CycleRefusedError` /
    :class:`OnlineError`; the promotion root is untouched on ANY
    failure path (gates run before the pointer write, and the pointer
    write itself is atomic)."""
    t0 = time.perf_counter()
    cfg = refit_config(settings, plan)
    record("online_refit", kind=plan.kind,
           warm=cfg.warm_start is not None,
           generation=plan.target_generation,
           burnin=cfg.run.burnin, mcmc=cfg.run.mcmc,
           num_shards=cfg.model.num_shards)
    t_fit = time.perf_counter()
    try:
        (runner or default_runner(settings))(np.asarray(Y), cfg)
    except Exception as e:
        # every refit failure becomes the same typed, recorded refusal
        _refuse("refit", f"{type(e).__name__}: {e}", plan, obs_dir)
    refit_s = time.perf_counter() - t_fit

    cand_path = os.path.join(settings.root, plan.candidate)
    # Delta emission: when a generation is already serving, encode the
    # candidate as a per-panel delta against it and REPLACE the streamed
    # candidate with the delta's materialization - byte-identical by
    # contract, so gates 1 and 2 below validate exactly what a replica
    # pulling the delta will reconstruct.  ANY failure here (base
    # missing its CRC tables, shape change across generations, a torn
    # delta) falls back to the full candidate with a recorded
    # ``delta_fallback`` - a delta problem must never refuse a cycle
    # that holds a perfectly good full artifact.
    delta_name = None
    delta_stats = None
    if plan.target_generation > 1:
        try:
            base = PosteriorArtifact.open(
                read_pointer(settings.root).path)
            d = write_delta_artifact(
                cand_path, base,
                os.path.join(settings.root, plan.candidate + ".delta"))
            mat = cand_path + ".mat"
            if os.path.exists(mat):
                shutil.rmtree(mat)
            materialize_delta(base, d, mat)
            # same-directory rename dance: the pointer still names the
            # OLD generation, so every intermediate state is invisible
            # to the fleet and a crash anywhere re-runs the cycle
            orig = cand_path + ".orig"
            if os.path.exists(orig):
                shutil.rmtree(orig)
            os.rename(cand_path, orig)
            os.rename(mat, cand_path)
            shutil.rmtree(orig)
            delta_name = plan.candidate + ".delta"
            delta_stats = {
                "panels_changed": d.panels_changed,
                "panels_total": d.n_pairs * (2 if d.has_sd else 1),
                "bytes_shipped": d.bytes_shipped,
                "full_bytes": d.full_bytes,
            }
        except (ArtifactError, OSError) as e:
            record("delta_fallback",
                   reason=f"{type(e).__name__}: {e}", kind=plan.kind,
                   generation=plan.target_generation)
    # Gate 1 - CRC-clean: a refit killed after its last checkpoint but
    # before the stream finalized leaves a candidate that refuses to
    # open (meta invalidated) or fails a panel CRC.
    try:
        art = verify_candidate(cand_path)
    except (ArtifactError, OSError) as e:
        _refuse("validate", f"candidate failed verification: {e}", plan,
                obs_dir)
    # Gate 2 - bounded drift vs the artifact currently serving, over
    # the common feature block (a new shard only ADDS columns).
    drift = None
    try:
        prev = read_pointer(settings.root)
    except PointerError:
        prev = None
    if prev is not None:
        try:
            S_prev = PosteriorArtifact.open(prev.path).assemble()
            S_new = art.assemble()
        except (ArtifactError, OSError) as e:
            _refuse("validate", f"drift check unreadable: {e}", plan,
                    obs_dir)
        k = min(S_prev.shape[0], S_new.shape[0])
        drift = _rel_frob(S_new[:k, :k], S_prev[:k, :k])
        if drift > settings.max_drift:
            _refuse("validate",
                    f"posterior drift {drift:.4f} exceeds max_drift "
                    f"{settings.max_drift} over the common "
                    f"{k}x{k} block", plan, obs_dir)
    # Gate 3 - monotonic generation, enforced inside the atomic write.
    # A delta generation promotes through promote_delta: the SAME
    # compare-and-swap, plus the delta_promote event that counts what
    # the fleet will actually pull (the candidate was already
    # materialized above, so promote_delta adopts it as-is).
    try:
        if delta_name is not None:
            state = promote_delta(settings.root, delta_name,
                                  verify=False,
                                  expect_generation=plan.target_generation,
                                  candidate=plan.candidate, drift=drift)
        else:
            state = promote_artifact(
                settings.root, plan.candidate, verify=False,
                expect_generation=plan.target_generation)
    except (ArtifactError, OSError) as e:
        _refuse("promote", str(e), plan, obs_dir)
    cycle_s = time.perf_counter() - t0
    record("online_promote", generation=state.generation,
           target=state.target, fingerprint=state.fingerprint,
           kind=plan.kind, warm=cfg.warm_start is not None,
           drift=drift, refit_s=refit_s, cycle_s=cycle_s,
           delta=delta_name is not None)
    return CycleResult(
        generation=state.generation, artifact=cand_path,
        checkpoint=plan.checkpoint, manifest=plan.manifest,
        warm=cfg.warm_start is not None, refit_s=refit_s,
        cycle_s=cycle_s, drift=drift, delta=delta_stats)
