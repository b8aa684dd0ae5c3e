"""Atomic artifact promotion: the ``CURRENT`` pointer a fleet watches.

The port's copy of ``dcfm_tpu/serve/promote.py``: the same pointer file,
generations and audit links, so either package's promoter publishes to
either package's fleet.

A *promotion root* is a directory of versioned artifact directories
plus one small pointer file, ``CURRENT``, naming the live one::

    root/
      CURRENT           {"target": "v2", "generation": 2, "fingerprint": ..}
      CURRENT.gen1      hardlinked audit trail of every pointer that served
      CURRENT.gen2
      v1/               a full posterior artifact (meta.json, *_q8.bin, ...)
      v2/

``PosteriorServer`` opens a promotion root instead of a bare artifact
directory and then WATCHES the pointer (a cheap ``os.stat`` probe per
request batch, or immediately on SIGHUP): when the pointer changes, the
worker opens the new artifact, verifies every panel CRC, and swaps its
engine atomically - in-flight requests finish on the old engine, new
requests see the new generation, and the response header
``X-DCFM-Artifact-Generation`` is monotonically non-decreasing.

Write discipline is the checkpoint writer's promotion discipline applied to a
pointer file: the new pointer is written to a temp name, fsynced, and
``os.replace``d over ``CURRENT`` (every observable state is either the
old pointer or the new one, never a torn half), then hardlinked to
``CURRENT.gen<N>`` so the promotion history survives later promotions.
The generation counter lives IN the pointer and increments per
promotion, which is what makes the fleet-wide generation well-defined
without any worker-to-worker coordination.

Candidates are verified BEFORE the pointer moves (``verify=True``
default: full per-panel CRC sweep via ``verify_panel``), and every
worker independently re-verifies at swap time - a torn or bit-flipped
candidate is refused with a typed ``serve_swap_refused`` event while
the old artifact keeps serving.  ``verify=False`` skips the promoter-
side check (the chaos harness uses it to model a buggy promoter racing
a partial copy; the worker-side refusal is the test subject).

Fault seams (``resilience/faults.py``): pointer writes count under
target ``"pointer"`` (``io_error`` / ``io_delay`` / ``torn_write``
apply), and ``promote_pointer`` / ``promote_pointer_post`` bracket the
atomic rename so a ``kill_event`` can land on either side of the flip.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.resilience.faults import fault_event, fault_plan
from dcfm_tpu_torch.serve.artifact import ArtifactError, PosteriorArtifact

POINTER_FILE = "CURRENT"


class PointerError(ArtifactError):
    """Missing, torn, or malformed ``CURRENT`` pointer."""


@dataclasses.dataclass(frozen=True)
class PointerState:
    """One consistent read of the promotion pointer."""
    target: str          # artifact directory name, relative to the root
    generation: int      # monotonic promotion counter
    fingerprint: str     # artifact_fingerprint recorded at promotion
    path: str            # resolved artifact directory
    stat: tuple          # (mtime_ns, size, ino) of the pointer file


def is_pointer_root(path: str) -> bool:
    """True when ``path`` is a promotion root (has a ``CURRENT`` file)."""
    return os.path.isfile(os.path.join(path, POINTER_FILE))


def pointer_stat(root: str) -> tuple:
    """(mtime_ns, size, ino) of the pointer - the cheap change probe a
    worker runs per request batch.  Raises OSError when absent."""
    st = os.stat(os.path.join(root, POINTER_FILE))
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def read_pointer(root: str) -> PointerState:
    """Parse ``CURRENT``.  Raises :class:`PointerError` when the pointer
    is missing or torn (a worker treats that as a refused swap and keeps
    serving what it has)."""
    ppath = os.path.join(root, POINTER_FILE)
    try:
        st = os.stat(ppath)
        with open(ppath, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError as e:
        raise PointerError(
            f"{root}: no readable {POINTER_FILE} pointer ({e})") from e
    try:
        spec = json.loads(raw)
        target = str(spec["target"])
        generation = int(spec["generation"])
        fingerprint = str(spec["fingerprint"])
    except (ValueError, KeyError, TypeError) as e:
        raise PointerError(
            f"{root}/{POINTER_FILE} is torn or malformed ({e!r}) - "
            "refusing the swap; the old artifact keeps serving") from e
    return PointerState(target, generation, fingerprint,
                        os.path.join(root, target),
                        (st.st_mtime_ns, st.st_size, st.st_ino))


def verify_candidate(path: str) -> PosteriorArtifact:
    """Open a candidate artifact and CRC-verify EVERY panel.

    Promotion is rare and swap-time verification reads the candidate's
    bytes exactly once (which also pre-warms the page cache the fleet
    shares), so the full sweep is cheap where it runs and priceless
    where it catches: a torn copy fails ``open`` on file sizes, a
    bit-flip fails its panel CRC - either way the typed
    :class:`~dcfm_tpu_torch.serve.artifact.ArtifactError` refuses the swap
    BEFORE any request is answered from bad bytes.  Artifacts without
    recorded CRCs (sparse synthetics) verify vacuously, and their
    ``weak-`` fingerprint says so."""
    art = PosteriorArtifact.open(path)
    for kind in (("mean", "sd") if art.has_sd else ("mean",)):
        panels, _ = art.panels(kind)
        for pair in range(panels.shape[0]):
            art.verify_panel(kind, pair)
    return art


def promote_artifact(root: str, candidate: str, *,
                     verify: bool = True,
                     expect_generation: Optional[int] = None
                     ) -> PointerState:
    """Atomically point ``root/CURRENT`` at ``candidate`` (a directory
    name inside the root, or a path to one).  Returns the new
    :class:`PointerState`; the generation is the previous pointer's + 1
    (1 for a fresh root).

    ``verify=True`` (default) runs :func:`verify_candidate` first and
    raises instead of promoting a corrupt candidate.  ``verify=False``
    writes the pointer regardless - the chaos harness's buggy-promoter
    model; every serving worker still refuses independently.

    ``expect_generation`` is the online loop's monotonicity gate: the
    promotion proceeds only if the generation it WOULD write equals
    this value.  A cycle computes its target generation at detect time;
    if another promoter (or a crashed-and-resumed twin of this cycle)
    moved the pointer meanwhile, writing would re-number history - the
    typed :class:`ArtifactError` makes the cycle re-detect instead."""
    name = (os.path.relpath(candidate, root) if os.path.isabs(candidate)
            else candidate)
    cand_path = os.path.join(root, name)
    if not os.path.isdir(cand_path):
        raise ArtifactError(
            f"promotion candidate {cand_path} is not a directory")
    fingerprint = "unverified"
    if verify:
        fingerprint = verify_candidate(cand_path).fingerprint
    else:
        try:
            fingerprint = PosteriorArtifact.open(cand_path).fingerprint
        except (ArtifactError, OSError):
            pass    # torn candidate, promoted on purpose by the chaos drill
    try:
        generation = read_pointer(root).generation + 1
    except PointerError:
        generation = 1
    if expect_generation is not None and generation != expect_generation:
        raise ArtifactError(
            f"{root}: promotion would write generation {generation}, "
            f"caller expected {expect_generation} - the pointer moved "
            "since this cycle detected; refusing to re-number history")
    ppath = os.path.join(root, POINTER_FILE)
    plan = fault_plan()
    count = plan.on_write("pointer", ppath) if plan is not None else 0
    tmp = ppath + ".promote.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"target": name, "generation": generation,
                   "fingerprint": fingerprint}, f)
        f.flush()
        os.fsync(f.fileno())
    # a kill HERE leaves the old pointer fully intact (plus a stale tmp)
    fault_event("promote_pointer")
    os.replace(tmp, ppath)
    # a kill HERE: the pointer already flipped; only the audit link is lost
    fault_event("promote_pointer_post")
    if plan is not None:
        plan.after_replace("pointer", ppath, count)
    try:
        # the checkpoints' hardlink discipline: the generation that
        # served is linked aside, never rewritten - the promotion history
        # for post-mortems
        os.link(ppath, f"{ppath}.gen{generation}")
    except OSError:
        pass    # audit link is best-effort (exists / no-hardlink fs)
    record("artifact_promote", target=name, generation=generation,
           fingerprint=fingerprint, verified=bool(verify))
    st = os.stat(ppath)
    return PointerState(name, generation, fingerprint, cand_path,
                        (st.st_mtime_ns, st.st_size, st.st_ino))


def promote_delta(root: str, delta: str, *,
                  verify: bool = True,
                  expect_generation: Optional[int] = None,
                  candidate: Optional[str] = None,
                  drift: Optional[float] = None) -> PointerState:
    """Materialize a delta against the artifact ``CURRENT`` names, then
    promote the reconstruction through the SAME compare-and-swap as
    :func:`promote_artifact` (verification, monotonic generation, atomic
    pointer write - a refusal at any stage keeps the old artifact
    serving).

    ``delta`` is a delta directory (name inside the root, or a path);
    ``candidate`` overrides the materialization target directory name
    (default: the candidate name recorded in the delta, falling back to
    ``v<generation>``).  ``drift`` is recorded into the
    ``delta_promote`` event when the caller (the online loop) measured
    it.

    The materialization is idempotent across retries: a target that
    already holds the finished candidate (fingerprint matches) is
    adopted as-is; a torn or foreign target is rebuilt from base +
    delta.  A crash mid-materialization therefore needs no cleanup -
    the retry re-materializes and promotes.

    Raises :class:`PointerError` when the root has no serving base and
    :class:`~dcfm_tpu_torch.serve.delta.DeltaBaseMismatchError` when the
    serving artifact is not the delta's base - both are the caller's
    cue to fall back to a full promotion (this function never has the
    full candidate to fall back to itself)."""
    from dcfm_tpu_torch.serve.delta import DeltaArtifact, materialize_delta
    dpath = delta if os.path.isabs(delta) else os.path.join(root, delta)
    d = DeltaArtifact.open(dpath)
    ptr = read_pointer(root)            # PointerError -> no base, fall back
    base = PosteriorArtifact.open(ptr.path)
    name = candidate or d.candidate_name or f"v{ptr.generation + 1}"
    cand_path = os.path.join(root, name)
    adopted = False
    if os.path.isdir(cand_path):
        try:
            adopted = (PosteriorArtifact.open(cand_path).fingerprint
                       == d.candidate_fingerprint)
        except (ArtifactError, OSError):
            adopted = False             # torn prior attempt: rebuild it
    if not adopted:
        if os.path.exists(cand_path):
            shutil.rmtree(cand_path)
        materialize_delta(base, d, cand_path)
    state = promote_artifact(root, name, verify=verify,
                             expect_generation=expect_generation)
    record("delta_promote", target=name, generation=state.generation,
           fingerprint=state.fingerprint,
           base_fingerprint=d.base_fingerprint,
           panels_changed=d.panels_changed,
           panels_total=d.n_pairs * (2 if d.has_sd else 1),
           bytes_shipped=d.bytes_shipped, full_bytes=d.full_bytes,
           drift=drift, materialized=not adopted)
    return state
