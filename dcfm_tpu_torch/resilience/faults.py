"""Deterministic fault injection: replay exact failure sequences on purpose.

The port's copy of ``dcfm_tpu/resilience/faults.py``: the same plans, env
gates and seeded spec streams, recording through the port's
``obs/recorder.py``.  The port's serving plane fires the serve-side
faults as the JAX package does (targets ``artifact``, ``panel``,
``pointer`` and ``delta``; the :data:`SERVE_EVENTS`).  The fit has no
fault seams yet (the chunk loop, resume and checkpoint writer: ROADMAP
Queue A item 7 (e)), so a plan with faults that could only fire inside a
fit is refused by ``api.fit`` at its start (:func:`refuse_fit_faults`),
never silently ignored.

Crash-recovery code that is only ever exercised by real crashes is
untested code.  This module turns the failure modes the resilience layer
claims to survive into *scheduled, reproducible events*, driven by the
``DCFM_FAULT_PLAN`` environment variable so a chaos test (or a manual
drill) states exactly which fault fires when - and a failing run can be
replayed bit-for-bit.

``DCFM_FAULT_PLAN`` holds either the JSON plan itself or ``@/path/to/
plan.json``.  Schema::

    {"faults": [
      {"op": "kill",        "at_iteration": 16, "when": "post_save"},
      {"op": "kill_event",  "event": "sidecar_gate", "at_occurrence": 1},
      {"op": "poison_state","at_iteration": 16},
      {"op": "torn_write",  "target": "checkpoint", "at_write": 2,
                            "keep_fraction": 0.5},
      {"op": "bit_flip",    "target": "checkpoint", "at_write": 2,
                            "leaf": "leaf_3"},
      {"op": "io_error",    "target": "checkpoint", "at_write": 1},
      {"op": "io_delay",    "target": "artifact",   "at_write": 1,
                            "seconds": 0.25}
    ]}

Every fault additionally accepts two GATES, both optional:

* ``"process": k`` - the fault fires only in the process whose
  ``DCFM_FAULT_PROCESS`` environment variable equals ``k`` (the pod
  supervisor / multihost demo exports one per host).  Absent the env
  var, a process-gated fault never fires - so a shared plan can SIGKILL
  exactly one host of a pod while its peers run it untouched.
* ``"at_launch": n`` - the fault fires only in the n-th (1-based)
  supervised launch (``DCFM_FAULT_LAUNCH``, exported by the
  supervisor before every (re)launch; defaults to 1).  This is what
  lets a crash-point plan kill launch 1 at a boundary, kill launch 2
  inside the RESUME path, and still let launch 3 finish clean.

Ops:

* ``kill`` - SIGKILL this process at the first chunk boundary whose
  global iteration is >= ``at_iteration``.  ``when`` is ``"post_save"``
  (default: the boundary's checkpoint save completes first - the
  supervised-resume drill) or ``"pre_save"`` (the kill lands before the
  save, so the checkpoint never advances past the boundary - the
  poison-iteration drill: every relaunch dies at the same place).
  A fault only fires when the run *started* below ``at_iteration``, so
  a resumed child that already progressed past the kill point does not
  re-die - which is exactly what makes the post-save drill terminate
  and the pre-save drill loop (until the supervisor's poison detector
  aborts it).
* ``kill_event`` - SIGKILL this process at the ``at_occurrence``-th
  (1-based, default 1) firing of a NAMED code-path event.  Events are
  emitted by :func:`fault_event` calls threaded through the multi-host
  resume path (runtime/resume.resume_state_multiproc): ``resume_gate`` /
  ``resume_gate_post`` bracket the source-signature allgather,
  ``sidecar_gate`` precedes the sidecar-eligibility allgather (gate 1),
  ``sidecar_load`` lands between gate 1 passing and the payload load,
  and ``sidecar_commit`` / ``sidecar_commit_post`` bracket the
  payload-success allgather (gate 2).  A kill BETWEEN two collectives
  on one host leaves its peers blocked inside the next one - exactly
  the state the pod supervisor's coordinated stop must reap.
* ``poison_state`` - at the matching boundary the caller (api.fit)
  multiplies the carried sampler state by NaN, simulating an on-device
  divergence; the next chunk's health reduction trips the sentinel.
* ``torn_write`` - the ``at_write``-th write to ``target`` is truncated
  to ``keep_fraction`` of its bytes AFTER the atomic rename, simulating
  a filesystem that acknowledged then lost the tail of the file.
* ``bit_flip`` - flips the lowest bit of the first byte of payload
  entry ``leaf`` (default: the largest entry) on the ``at_write``-th
  write, AFTER integrity checksums are computed - a silent media error
  the CRC verification must catch.
* ``io_error`` / ``io_delay`` - the ``at_write``-th write to ``target``
  raises ``OSError`` / sleeps ``seconds`` first.

Write counters are 1-based and PER-PROCESS (a relaunched child counts
its own writes from zero), which keeps every plan deterministic without
cross-process state.  Targets: ``"checkpoint"`` (``utils/checkpoint``
saves) and ``"artifact"`` (``serve/artifact`` exports); an optional
``"path_re"`` regex narrows a fault to matching paths (e.g. exclude the
``.full`` sidecar).

Randomized crash-point fuzzing: ``DCFM_FAULT_FUZZ=seed:N`` expands the
N-th crash point of a seeded deterministic stream into a concrete plan
(:func:`fuzz_spec`) - the fuzz harness sweeps N while the seed pins the
whole campaign, so any failing point replays exactly.
``DCFM_FAULT_PLAN`` wins when both are set.

Everything is stdlib + numpy; with no plan installed every hook is a
cheap no-op (one truthiness check).
"""

from __future__ import annotations

import json
import os
import random
import re
import signal
import time
from typing import Optional

import numpy as np

from dcfm_tpu_torch.obs.recorder import record, record_sync

ENV_VAR = "DCFM_FAULT_PLAN"
FUZZ_ENV_VAR = "DCFM_FAULT_FUZZ"
PROCESS_ENV_VAR = "DCFM_FAULT_PROCESS"
LAUNCH_ENV_VAR = "DCFM_FAULT_LAUNCH"

_VALID_OPS = {"kill", "kill_event", "poison_state", "torn_write",
              "bit_flip", "io_error", "io_delay"}

# Resume-path events the multi-host fuzz targets (the runtime pipeline
# emits them via fault_event; see the kill_event op above).  The chunk
# loop additionally emits ``stream_submit`` / ``stream_submit_post``
# around each boundary's streamed-fetch dispatch
# (runtime/pipeline.run_chain) - not fuzzed by default, but available
# to plans that want a kill INSIDE the streaming window.
FUZZ_EVENTS = ("resume_gate", "resume_gate_post", "sidecar_gate",
               "sidecar_load", "sidecar_commit", "sidecar_commit_post")

# Elastic-resume events (runtime/resume._try_elastic): ``elastic_gate``
# fires after the adoption decision, ``elastic_fold`` between the fresh
# carry init and the donor load/fold, ``elastic_fold_post`` after the
# fold completed.  The fold only READS the donor checkpoint, so a
# SIGKILL anywhere in the window leaves the old generation intact - the
# relaunch either re-adopts cleanly or refuses typed, never resumes a
# half-folded (mis-divided) accumulator.  ``elastic_fuzz_spec`` sweeps
# kills over these windows; DCFM_FAULT_FUZZ=seed:index:elastic selects
# that stream.
ELASTIC_EVENTS = ("elastic_gate", "elastic_fold", "elastic_fold_post")

# Host-elastic (pod-degrade) events: the cooperative artifact export
# (serve/artifact.write_artifact_cooperative) emits one before each of
# its three barrier phases - a host killed there leaves its peers
# blocked inside the sync, the state the pod supervisor's coordinated
# stop must reap.  ``pod_fuzz_spec`` sweeps kills over these windows
# plus the resume gates and plain boundaries;
# DCFM_FAULT_FUZZ=seed:index:pod selects that stream.
POD_EVENTS = ("coop_export_prepare", "coop_export_panels",
              "coop_export_meta")


class FaultPlanError(ValueError):
    """Malformed DCFM_FAULT_PLAN."""


class FaultPlan:
    """A parsed fault plan plus its per-process trigger state."""

    def __init__(self, spec: dict):
        faults = spec.get("faults")
        if not isinstance(faults, list):
            raise FaultPlanError(
                "fault plan must be {'faults': [...]}, got "
                f"{type(spec).__name__} without a 'faults' list")
        self.faults = []
        for i, f in enumerate(faults):
            op = f.get("op")
            if op not in _VALID_OPS:
                raise FaultPlanError(
                    f"fault #{i}: unknown op {op!r} "
                    f"(expected one of {sorted(_VALID_OPS)})")
            if op in ("kill", "poison_state") and "at_iteration" not in f:
                raise FaultPlanError(f"fault #{i}: {op} needs at_iteration")
            if op == "kill_event" and "event" not in f:
                raise FaultPlanError(f"fault #{i}: kill_event needs event")
            if op in ("torn_write", "bit_flip", "io_error", "io_delay") \
                    and "at_write" not in f:
                raise FaultPlanError(f"fault #{i}: {op} needs at_write")
            self.faults.append(dict(f))
        # 1-based write counters, keyed per target
        self._writes: dict = {}
        # 1-based event-occurrence counters, keyed per event name
        self._events: dict = {}
        self._fired: set = set()

    @staticmethod
    def _gates_open(f: dict) -> bool:
        """Process / launch gates (see module doc).  A process-gated
        fault without DCFM_FAULT_PROCESS in the environment never fires
        - the safe default for a shared pod plan."""
        p = f.get("process")
        if p is not None:
            mine = os.environ.get(PROCESS_ENV_VAR)
            if mine is None or int(mine) != int(p):
                return False
        n = f.get("at_launch")
        if n is not None:
            if int(os.environ.get(LAUNCH_ENV_VAR, "1")) != int(n):
                return False
        return True

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get(ENV_VAR)
        if not raw:
            fuzz = os.environ.get(FUZZ_ENV_VAR)
            if not fuzz:
                return None
            m = re.match(r"^(-?\d+):(\d+)(:elastic|:pod)?$", fuzz.strip())
            if not m:
                raise FaultPlanError(
                    f"{FUZZ_ENV_VAR} must be 'seed:index[:elastic|:pod]',"
                    f" got {fuzz!r}")
            gen = {":elastic": elastic_fuzz_spec,
                   ":pod": pod_fuzz_spec}.get(m.group(3), fuzz_spec)
            return cls(gen(int(m.group(1)), int(m.group(2))))
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as f:
                raw = f.read()
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as e:
            raise FaultPlanError(f"{ENV_VAR} is not valid JSON: {e}") from e
        return cls(spec)

    # -- boundary faults (kill / poison) -------------------------------
    def _boundary_due(self, op: str, phase: str, iteration: int,
                      start_iteration: int):
        for i, f in enumerate(self.faults):
            if f["op"] != op or (i, op) in self._fired:
                continue
            if op == "kill" and f.get("when", "post_save") != phase:
                continue
            if not self._gates_open(f):
                continue
            at = int(f["at_iteration"])
            # only runs that STARTED below the trigger fire it: a resumed
            # child already past the point must not re-die (see module doc)
            if iteration >= at and start_iteration < at:
                self._fired.add((i, op))
                return f
        return None

    def maybe_kill(self, iteration: int, start_iteration: int,
                   phase: str) -> None:
        """SIGKILL this process if a kill fault matches this boundary.
        ``phase`` is "pre_save" or "post_save"."""
        f = self._boundary_due("kill", phase, iteration, start_iteration)
        if f is not None:
            # the log must name the kill that is about to happen: emit +
            # fsync BEFORE the signal (the process never runs another line)
            record_sync("fault", op="kill", when=phase,
                        at_iteration=int(f["at_iteration"]),
                        iteration=iteration)
            os.kill(os.getpid(), signal.SIGKILL)

    def poison_due(self, iteration: int, start_iteration: int) -> bool:
        """True exactly once when a poison_state fault matches."""
        return self._boundary_due(
            "poison_state", "post_save", iteration, start_iteration
        ) is not None

    # -- code-path events (the resume-window crash points) -------------
    def maybe_kill_event(self, event: str) -> None:
        """Count an occurrence of ``event`` and SIGKILL this process if a
        kill_event fault matches it (occurrence counters are per-process
        and per-launch, like the write counters)."""
        count = self._events.get(event, 0) + 1
        self._events[event] = count
        for i, f in enumerate(self.faults):
            if f["op"] != "kill_event" or (i, "kill_event") in self._fired:
                continue
            if f["event"] != event or int(f.get("at_occurrence", 1)) != count:
                continue
            if not self._gates_open(f):
                continue
            self._fired.add((i, "kill_event"))
            record_sync("fault", op="kill_event", event_name=event,
                        occurrence=count)
            os.kill(os.getpid(), signal.SIGKILL)

    # -- write faults --------------------------------------------------
    def _write_faults(self, target: str, path: str, count: int):
        for f in self.faults:
            if f["op"] in ("kill", "kill_event", "poison_state"):
                continue
            if f.get("target", "checkpoint") != target:
                continue
            if int(f["at_write"]) != count:
                continue
            pr = f.get("path_re")
            if pr and not re.search(pr, path):
                continue
            if not self._gates_open(f):
                continue
            yield f

    def on_write(self, target: str, path: str) -> int:
        """Count a write to ``target`` and apply io_error/io_delay faults.
        Returns the (1-based) write ordinal, passed to the later stages
        so all faults of one write agree on the count."""
        count = self._writes.get(target, 0) + 1
        self._writes[target] = count
        for f in self._write_faults(target, path, count):
            if f["op"] == "io_delay":
                record("fault", op="io_delay", target=target,
                       path=os.path.basename(path), write=count,
                       seconds=float(f.get("seconds", 0.1)))
                time.sleep(float(f.get("seconds", 0.1)))
            elif f["op"] == "io_error":
                record_sync("fault", op="io_error", target=target,
                            path=os.path.basename(path), write=count)
                raise OSError(
                    f"injected I/O failure (DCFM_FAULT_PLAN: write "
                    f"#{count} to {target} at {path})")
        return count

    def mutate_payload(self, target: str, path: str, count: int,
                       payload: dict) -> dict:
        """Apply bit_flip faults to a to-be-written payload.  Called
        AFTER integrity checksums were computed, so the flip is exactly
        the silent corruption CRC verification exists to catch."""
        out = payload
        for f in self._write_faults(target, path, count):
            if f["op"] != "bit_flip":
                continue
            if out is payload:
                out = dict(payload)
            leaf = f.get("leaf")
            if leaf is None:
                leaf = max(out, key=lambda k: np.asarray(out[k]).nbytes)
            if leaf not in out:
                raise FaultPlanError(
                    f"bit_flip leaf {leaf!r} not in payload "
                    f"({sorted(out)})")
            arr = np.array(out[leaf], copy=True)
            flat = arr.view(np.uint8).reshape(-1)
            flat[0] ^= 1
            out[leaf] = arr
            record("fault", op="bit_flip", target=target,
                   path=os.path.basename(path), write=count, leaf=leaf)
        return out

    def after_replace(self, target: str, path: str, count: int) -> None:
        """Apply torn_write faults to a file that was just atomically
        renamed into place (simulating a filesystem that lied about
        durability)."""
        for f in self._write_faults(target, path, count):
            if f["op"] != "torn_write":
                continue
            size = os.path.getsize(path)
            keep = int(size * float(f.get("keep_fraction", 0.5)))
            with open(path, "r+b") as fh:
                fh.truncate(keep)
            record("fault", op="torn_write", target=target,
                   path=os.path.basename(path), write=count,
                   kept_bytes=keep, size_bytes=size)


_ACTIVE: Optional[FaultPlan] = None
_LOADED = False


def fault_plan() -> Optional[FaultPlan]:
    """The process-wide fault plan, parsed from ``DCFM_FAULT_PLAN`` on
    first use (None when unset - the production fast path).  Tests may
    swap it with :func:`install` / :func:`clear`."""
    global _ACTIVE, _LOADED
    if not _LOADED:
        _ACTIVE = FaultPlan.from_env()
        _LOADED = True
    return _ACTIVE


def install(spec: Optional[dict]) -> Optional[FaultPlan]:
    """Install a plan in-process (tests); None clears it."""
    global _ACTIVE, _LOADED
    _LOADED = True
    _ACTIVE = FaultPlan(spec) if spec is not None else None
    return _ACTIVE


def clear() -> None:
    """Forget the cached plan (the next :func:`fault_plan` re-reads the
    environment)."""
    global _ACTIVE, _LOADED
    _ACTIVE, _LOADED = None, False


def fault_event(name: str) -> None:
    """Emit a named code-path event into the fault harness (a cheap
    no-op without a plan).  The runtime pipeline threads these through
    the multi-host resume path (collective gate windows - see
    :data:`FUZZ_EVENTS`) and around each chunk boundary's streamed-fetch
    dispatch (``stream_submit`` / ``stream_submit_post``), so kill_event
    faults can land inside either window."""
    plan = fault_plan()
    if plan is not None:
        plan.maybe_kill_event(name)


# ---------------------------------------------------------------------------
# randomized crash-point fuzzing (DCFM_FAULT_FUZZ=seed:N)
# ---------------------------------------------------------------------------

def fuzz_spec(seed: int, index: int, *,
              boundaries=(2, 4, 6, 8),
              max_writes: int = 4,
              nproc: int = 2,
              events=FUZZ_EVENTS) -> dict:
    """The ``index``-th crash point of a seeded deterministic stream, as
    a concrete fault-plan spec.  Same (seed, index, knobs) -> same plan,
    always - a failing fuzz point is replayed by its coordinates alone.

    The defaults describe the 2-process multihost demo workload
    (boundaries every 2 iterations to 8, one checkpoint write per
    boundary per process); harnesses with other schedules pass their
    own.  ``events=()`` drops the resume-window kill points (the
    single-process smoke: there is no collective gate to kill inside).

    Every injected fault is gated to a specific launch (``at_launch``),
    so it models an ENVIRONMENTAL failure - a preemption does not
    re-fire deterministically on the relaunch.  (Without the gate, a
    boundary kill re-arms whenever a later launch legitimately resumes
    from a sidecar BEHIND the kill iteration - the ``start_iteration <
    at`` rule sees a fresh crossing - and the run correctly but
    uninterestingly ends in the poison abort; deterministic-failure
    containment has its own dedicated drills.)

    Four crash-point shapes, chosen per index:

    * a boundary ``kill`` (pre- or post-save) of one random process in
      launch 1;
    * a ``torn_write``/``bit_flip`` of a random checkpoint write
      (sometimes narrowed to the ``.full`` sidecar, sometimes applied
      on every host) followed by a post-save kill at-or-after the
      boundary that wrote it, so the resume must recover OVER the
      corruption;
    * an ``io_error`` on a random save in launch 1 (the child dies on
      the raised save; the relaunch must proceed);
    * a resume-window ``kill_event``: launch 1 dies at a boundary,
      launch 2 is killed inside a random collective-gate event, and
      launch 3 must still finish clean.
    """
    rng = random.Random(f"dcfm-fuzz:{int(seed)}:{int(index)}")
    boundaries = tuple(int(b) for b in boundaries)
    kinds = ["boundary_kill", "write_then_kill", "io_error"]
    if events:
        kinds.append("resume_event_kill")
    kind = rng.choice(kinds)
    faults = []
    if kind == "boundary_kill":
        faults.append({"op": "kill", "at_iteration": rng.choice(boundaries),
                       "when": rng.choice(["pre_save", "post_save"]),
                       "process": rng.randrange(nproc), "at_launch": 1})
    elif kind == "write_then_kill":
        w = rng.randint(1, max_writes)
        f = {"op": rng.choice(["torn_write", "bit_flip"]),
             "target": "checkpoint", "at_write": w, "at_launch": 1}
        if rng.random() < 0.5:
            f["process"] = rng.randrange(nproc)
        if rng.random() < 0.3:
            f["path_re"] = r"\.full"
        faults.append(f)
        # the kill lands at the boundary of write w or later, so the
        # relaunch resumes over (or around) the corrupted generation
        b = rng.choice(boundaries[min(w, len(boundaries)) - 1:])
        faults.append({"op": "kill", "at_iteration": b,
                       "when": "post_save",
                       "process": rng.randrange(nproc), "at_launch": 1})
    elif kind == "io_error":
        f = {"op": "io_error", "target": "checkpoint",
             "at_write": rng.randint(1, max_writes), "at_launch": 1}
        if rng.random() < 0.5:
            f["process"] = rng.randrange(nproc)
        faults.append(f)
    else:
        faults.append({"op": "kill", "when": "post_save",
                       "at_iteration": rng.choice(boundaries[:-1]),
                       "process": rng.randrange(nproc), "at_launch": 1})
        faults.append({"op": "kill_event", "event": rng.choice(list(events)),
                       "at_occurrence": 1, "at_launch": 2,
                       "process": rng.randrange(nproc)})
    return {"faults": faults}


def elastic_fuzz_spec(seed: int, index: int, *,
                      boundaries=(2, 4, 6, 8),
                      events=ELASTIC_EVENTS) -> dict:
    """The ``index``-th crash point of the ELASTIC fuzz stream
    (``DCFM_FAULT_FUZZ=seed:index:elastic``): launch 1 dies at a random
    checkpointing boundary, and launch 2 - which the harness runs on a
    DIFFERENT chain count, so its resume goes through the elastic
    adoption - is usually killed inside a random ``ELASTIC_EVENTS``
    window (sometimes not at all, so clean adoptions are swept too).
    Launch 3 (or 2) must finish with an intact pooled Sigma: the fold
    only reads the donor file, so every kill point leaves a resumable
    generation behind.  Single-process by construction - no process
    gates (the elastic fold is a single-host operation; multi-process
    donors adopt through the set-donor path on one process)."""
    rng = random.Random(f"dcfm-elastic-fuzz:{int(seed)}:{int(index)}")
    boundaries = tuple(int(b) for b in boundaries)
    faults = [{"op": "kill", "when": "post_save",
               "at_iteration": rng.choice(boundaries), "at_launch": 1}]
    if rng.random() < 0.75:
        faults.append({"op": "kill_event",
                       "event": rng.choice(list(events)),
                       "at_occurrence": 1, "at_launch": 2})
    return {"faults": faults}


def pod_fuzz_spec(seed: int, index: int, *,
                  boundaries=(2, 4, 6, 8),
                  nproc: int = 2,
                  events=POD_EVENTS) -> dict:
    """The ``index``-th crash point of the HOST-ELASTIC fuzz stream
    (``DCFM_FAULT_FUZZ=seed:index:pod``): one host of launch 1 is
    killed - at a random checkpointing boundary, inside a random
    multi-host resume-gate window, or inside one of the cooperative
    artifact export's barrier phases (:data:`POD_EVENTS`) - and the
    harness relaunches the pod DEGRADED to the survivors
    (supervisor._pod_capacity), whose resume host-elastically adopts
    the dead topology's ``.procK-of-N`` set.  The degraded launch must
    finish with an intact pooled Sigma and a CRC-clean artifact:
    boundary kills leave a resumable generation, export-window kills
    happen after the chain completed (the relaunch re-runs a no-op
    resume plus a fresh export over the invalidated meta), and resume-
    gate kills leave the old generation untouched.  Kills are gated
    ``at_launch: 1`` for :func:`fuzz_spec`'s reason: the death models
    an environmental host loss, not a deterministic fault."""
    rng = random.Random(f"dcfm-pod-fuzz:{int(seed)}:{int(index)}")
    boundaries = tuple(int(b) for b in boundaries)
    kind = rng.choice(["boundary_kill", "export_kill", "gate_kill"])
    proc = rng.randrange(nproc)
    if kind == "boundary_kill":
        faults = [{"op": "kill", "at_iteration": rng.choice(boundaries),
                   "when": rng.choice(["pre_save", "post_save"]),
                   "process": proc, "at_launch": 1}]
    elif kind == "export_kill":
        faults = [{"op": "kill_event", "event": rng.choice(list(events)),
                   "at_occurrence": 1, "process": proc, "at_launch": 1}]
    else:
        # only the resume-gate pair: the sidecar windows in FUZZ_EVENTS
        # never open under the full checkpoint mode the pod harness
        # runs, and a fault that cannot fire is a wasted fuzz point
        faults = [{"op": "kill_event",
                   "event": rng.choice(["resume_gate",
                                        "resume_gate_post"]),
                   "at_occurrence": 1, "process": proc, "at_launch": 1}]
    return {"faults": faults}


# ---------------------------------------------------------------------------
# serve-side chaos (the serving fleet's seeded fuzz sweep)
# ---------------------------------------------------------------------------

# Events the SERVE path emits via fault_event: every request handler
# fires ``serve_request`` before routing (a kill there is "worker
# SIGKILLed mid-request"), and the hot-swap brackets its pointer
# adoption with ``swap_begin`` / ``swap_commit`` (a kill inside the
# window dies with the swap half-done - the respawned worker must come
# up on whatever the pointer says NOW).  The promoter additionally
# emits ``promote_pointer`` / ``promote_pointer_post`` around the
# atomic rename (serve/promote.py).
SERVE_FUZZ_EVENTS = ("serve_request", "swap_begin", "swap_commit")

# every event the port emits through fault_event (the server, the
# promoter, the delta materializer) and every write target it counts; a
# fault naming anything else could only fire inside a fit
SERVE_EVENTS = SERVE_FUZZ_EVENTS + ("promote_pointer", "promote_pointer_post",
                                    "delta_materialize")
SERVE_TARGETS = ("artifact", "panel", "pointer", "delta")


def fit_faults(plan: Optional[FaultPlan]) -> list:
    """The faults of ``plan`` that only a fit could fire: ``kill`` and
    ``poison_state`` (chunk boundaries), write faults on any target but
    the serving plane's (``checkpoint`` is the default target), and
    ``kill_event`` on any event but :data:`SERVE_EVENTS`."""
    if plan is None:
        return []
    out = []
    for f in plan.faults:
        op = f["op"]
        if op in ("kill", "poison_state"):
            out.append(f)
        elif op == "kill_event":
            if f["event"] not in SERVE_EVENTS:
                out.append(f)
        elif f.get("target", "checkpoint") not in SERVE_TARGETS:
            out.append(f)
    return out


def refuse_fit_faults() -> None:
    """Raise when the installed plan (or ``DCFM_FAULT_PLAN``) holds faults
    only a fit could fire: the port's fit has no fault seams yet, and a
    plan is never silently ignored."""
    bad = fit_faults(fault_plan())
    if bad:
        raise NotImplementedError(
            f"fault plan entries {bad} target the fit (boundary kills, "
            "state poisoning, checkpoint writes, resume-window events), "
            "whose fault seams are not ported to dcfm_tpu_torch yet: "
            "ROADMAP Queue A item 7 (the supervisor and the fit's seams)")


def serve_fuzz_spec(seed: int, index: int, *,
                    workers: int = 2,
                    max_requests: int = 40,
                    io_max: int = 6) -> dict:
    """The ``index``-th serve chaos point of a seeded deterministic
    stream.  Same coordinates -> same spec, so a failing sweep point is
    replayed exactly like :func:`fuzz_spec`'s.

    The ``"faults"`` list is a normal fault plan the fleet exports to
    its workers (:class:`FaultPlan` ignores the extra ``"serve"`` key);
    ``"serve"`` carries DIRECTIVES FOR THE HARNESS itself - whether to
    run a mid-load promotion, whether to corrupt the candidate first
    (``promotion_fault``), and how many slow-loris clients to attach -
    things that happen in the load generator / promoter process, not
    inside a worker.

    Five chaos shapes:

    * ``worker_kill``: SIGKILL one worker at a random mid-load request
      (``kill_event serve_request``) - the supervisor must respawn it
      and no client request may be dropped (SO_REUSEPORT failover);
    * ``swap_kill``: a promotion happens under load and one worker is
      killed inside its swap window (``swap_begin``/``swap_commit``);
    * ``torn_promotion``: the promoted candidate is corrupted first
      (truncated file or flipped byte) - every worker must REFUSE the
      swap and keep serving the old generation;
    * ``io_fault``: ``io_delay`` (or, rarely, ``io_error``) on a random
      panel dequant - requests slow down or fail TYPED, never untyped;
    * ``slow_client``: slow-loris sockets squat on worker connections
      while the real load runs - the per-connection io_timeout must
      keep the fleet draining and serving.

    Kills are gated ``"at_launch": 1`` for the same reason
    :func:`fuzz_spec` gates its kills: the injected death models an
    ENVIRONMENTAL failure, so the respawned worker (launch 2) runs
    clean; without the gate the event counter resets per launch and the
    kill re-fires forever, which correctly but uninterestingly ends in
    the fleet's poison abort (poison containment has its own drill).
    """
    rng = random.Random(f"dcfm-serve-fuzz:{int(seed)}:{int(index)}")
    kind = rng.choice(["worker_kill", "swap_kill", "torn_promotion",
                       "io_fault", "slow_client"])
    faults = []
    serve = {"kind": kind, "promote": False, "promotion_fault": None,
             "slow_clients": 0}
    if kind == "worker_kill":
        faults.append({"op": "kill_event", "event": "serve_request",
                       "at_occurrence": rng.randint(1, max_requests),
                       "process": rng.randrange(workers),
                       "at_launch": 1})
        # half the worker-kill points also promote mid-load: a death
        # and a hot-swap racing is the interesting composition
        serve["promote"] = rng.random() < 0.5
    elif kind == "swap_kill":
        faults.append({"op": "kill_event",
                       "event": rng.choice(["swap_begin", "swap_commit"]),
                       "at_occurrence": 1,
                       "process": rng.randrange(workers),
                       "at_launch": 1})
        serve["promote"] = True
    elif kind == "torn_promotion":
        serve["promote"] = True
        serve["promotion_fault"] = rng.choice(["torn", "bit_flip"])
    elif kind == "io_fault":
        op = "io_error" if rng.random() < 0.25 else "io_delay"
        f = {"op": op, "target": "panel",
             "at_write": rng.randint(1, io_max)}
        if op == "io_delay":
            f["seconds"] = round(rng.uniform(0.05, 0.25), 3)
        if rng.random() < 0.5:
            f["process"] = rng.randrange(workers)
        faults.append(f)
        serve["promote"] = rng.random() < 0.3
    else:
        serve["slow_clients"] = rng.randint(1, 2)
        serve["promote"] = rng.random() < 0.3
    return {"faults": faults, "serve": serve}
