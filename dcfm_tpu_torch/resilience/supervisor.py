"""Run supervisor: crash-only fits that finish anyway.

The port of ``dcfm_tpu/resilience/supervisor.py``.
``supervise()`` (API) and ``dcfm-tpu-torch fit --supervise`` /
``dcfm-tpu-torch supervise`` (CLI) run the fit in a CHILD process and
treat its death - SIGKILL, preemption, OOM, a native crash - as a
scheduling event, not a failure: verify the newest checkpoint's integrity
(falling back to the previous retained one when the CRC says the file is
lying), relaunch with exponential backoff under a max-retry budget, and
resume.  Because every draw is keyed on the global iteration, the
supervised result is BIT-IDENTICAL to an uninterrupted run, however many
times the child died.

Poison-iteration detection is what separates a supervisor from a
crash-loop: when the checkpoint iteration does not advance between two
consecutive child deaths - the same iteration killed the child twice -
the run is deterministically poisoned and relaunching forever would burn
the machine.  The supervisor aborts with a typed :class:`PoisonedRunError`
carrying the offending checkpoint path for offline triage.

The card has one owner at a time: the supervising parent runs no fit and
touches no card while a child runs (the parent-side probes read checkpoint
metadata and CRCs on the host only); ``supervise()`` materializes its
:class:`~dcfm_tpu_torch.api.FitResult` only after the last child exited.
Every launch gets the same launch-gated environment as in the JAX
package: ``DCFM_FAULT_LAUNCH`` (the 1-based attempt), the run's
flight-recorder directory and run id, and no ``DCFM_OBS_ROLE``.

Pod supervision (:func:`supervise_pod`, ``dcfm-tpu-torch supervise --pod
N``): the same crash-only contract for an N-process fit
(parallel/multihost.py).  Three things change at pod scale:

* **Coordinated stop** - a pod's collectives cannot complete with a dead
  peer, so when ANY process dies the survivors are blocked in one, not
  failing: the supervisor reaps them (SIGTERM, a grace period, SIGKILL,
  :func:`_await_pod`) instead of waiting on a hang.
* **Unanimous-generation resume** - each process writes its own
  ``.procK-of-N`` file with its own ``.bakK`` chain, so after a crash the
  newest generation may exist on only some slots or be corrupt on one.
  The relaunch pre-pass (:func:`_ensure_unanimous_checkpoint`) demotes
  corrupt generations per slot, then promotes the newest generation held
  CRC-clean by ALL slots - the only state the collective resume gate
  accepts; with none, the live files are set aside (``.orphan``) so every
  process starts fresh.
* **Elastic degrade** - a relaunch probes the surviving host capacity
  (``DCFM_POD_CAPACITY`` / ``DCFM_POD_CAPACITY_FILE``,
  :func:`_pod_capacity`) and relaunches on fewer processes, whose resume
  adopts the old set host-elastically, unless ``--no-elastic`` vetoes it
  (:class:`PodCapacityError`).

A launch in which nothing dies and nothing progresses is bounded by
``launch_timeout`` (:class:`PodHangError`, never retried)."""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

from dcfm_tpu_torch.obs.recorder import (
    OBS_DIR_ENV_VAR, OBS_ROLE_ENV_VAR, RUN_ID_ENV_VAR, FlightRecorder,
    record, tail_events)
from dcfm_tpu_torch.obs.recorder import install as _obs_install
from dcfm_tpu_torch.obs.recorder import uninstall as _obs_uninstall

# NOTE: dcfm_tpu_torch.utils.checkpoint is imported lazily inside
# functions: it imports resilience.faults (the write seam), so a
# module-level import here would be circular through the package init.
# obs.recorder is stdlib-only, so the parent imports it without torch.

class PoisonedRunError(RuntimeError):
    """The same failure killed the child repeatedly: it is deterministic,
    not environmental - relaunching cannot help.  ``checkpoint_path`` is
    the last good checkpoint of a fit (empty for a serving fleet),
    ``iteration`` its saved position."""

    def __init__(self, message: str, *, checkpoint_path: str = "",
                 iteration: int = -1):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path
        self.iteration = iteration


class RetriesExhaustedError(RuntimeError):
    """The child kept dying (with progress between deaths, so not
    poison) past the retry budget."""


class PodHangError(RuntimeError):
    """No process died, none finished, and the watchdog
    (``launch_timeout``) expired: the launch is hung.  A hang is a BUG,
    so it is raised typed, never retried."""


class PodCapacityError(RuntimeError):
    """Surviving host capacity is below the configured pod size and
    elastic degrade is vetoed (``--no-elastic`` / ``DCFM_NO_ELASTIC=1``):
    relaunching at full N would die again on the missing hosts, so the
    supervisor stops typed.  The message names both ways out."""


@dataclasses.dataclass
class SuperviseReport:
    """What the supervision loop did: evidence for the postmortem."""
    launches: int = 0              # child processes started (1 = no crash)
    deaths: list = dataclasses.field(default_factory=list)
    #                              # (exit_code, checkpoint_iteration) pairs
    corrupt_fallbacks: int = 0     # CRC-demoted checkpoints
    final_iteration: int = -1
    elapsed_s: float = 0.0
    # flight-recorder identity of the run: every launch's events (and
    # supervise()'s materialization fit) share this id in the obs dir
    run_id: str = ""


def _log(msg: str) -> None:
    # the flight recorder's stderr MIRROR: structured telemetry lives in
    # the event log; this line keeps the operator-visible trail
    print(f"[supervise] {msg}", file=sys.stderr, flush=True)  # dcfm: ignore[DCFM901] - the supervisor's documented stderr mirror


def postmortem(obs_dir: Optional[str], launch: Optional[int] = None) -> str:
    """Last-events suffix for typed operational errors: a poison, hang,
    or refused-cycle report names the flight-recorder path and what the
    dying run last did.  ``launch=None`` tails the whole run (the online
    watch daemon's errors aren't launch-scoped)."""
    if not obs_dir:
        return ""
    suffix = f"; flight recorder: {obs_dir}"
    try:
        evs = tail_events(obs_dir, 5, launch=launch)
    except Exception:  # dcfm: ignore[DCFM601] - an unreadable log must not mask the typed error it decorates
        return suffix
    if not evs:
        return suffix
    brief = []
    for e in evs:
        s = str(e.get("event"))
        it = e.get("iteration", e.get("end"))
        if it is not None:
            s += f"@it{it}"
        brief.append(s)
    scope = "run" if launch is None else f"launch {launch}"
    return (f"{suffix} (last {len(evs)} events of {scope}: "
            + ", ".join(brief) + ")")


def _checkpoint_slots(path: str) -> list:
    """The live-file slots the integrity pass walks: the plain path and
    every ``.procK-of-N`` file a pod's process writes (each with its own
    ``.bakK`` chain), those whose live file is gone but whose retained
    generations survive included."""
    slots = [path]
    d = os.path.dirname(os.path.abspath(path)) or "."
    if os.path.isdir(d):
        base = re.escape(os.path.basename(path))
        pat = re.compile(f"^({base}\\.proc\\d+-of-\\d+)(\\.bak\\d+)?$")
        seen = set()
        for f in sorted(os.listdir(d)):
            m = pat.match(f)
            if m and m.group(1) not in seen:
                seen.add(m.group(1))
                slots.append(os.path.join(d, m.group(1)))
    return slots


def _progress_iteration(path: str) -> int:
    """Chain progress at ``path``: the best iteration among the plain file
    and any COMPLETE ``.procK-of-N`` set whose members agree
    (utils/checkpoint.discover_checkpoint), from their metadata alone (the
    parent never touches the card); -1 when nothing is readable."""
    from dcfm_tpu_torch.utils.checkpoint import (
        discover_checkpoint, read_checkpoint_meta)
    try:
        source = discover_checkpoint(path, prefer_plain=True)
        if source is None:
            return -1
        if source[0] == "set":
            return source[1][2]
        return int(read_checkpoint_meta(path)["iteration"])
    except Exception:  # dcfm: ignore[DCFM601] - absent/corrupt/mid-write files are simply not progress
        return -1


def _capacity_probe(checkpoint_path: str, num_processes: int,
                    rec, log: Callable[[str], None]) -> None:
    """The relaunch's capacity probe: the newest readable file's RECORDED
    topology against the capacity this launch runs on (its process
    count; the device count only where ``DCFM_DEVICE_COUNT`` says),
    narrated as an ``elastic_capacity`` event with the posture the
    children's resume will take (elastic, or "disabled" under
    ``--no-elastic``).  The decision stays in the children's resume."""
    from dcfm_tpu_torch.utils.checkpoint import read_checkpoint_meta
    recorded = None
    try:
        recorded = read_checkpoint_meta(checkpoint_path).get("topology")
    except Exception:  # dcfm: ignore[DCFM601] - absent/corrupt/pre-v7 file: nothing to compare against
        pass
    if recorded is None:
        return
    env_dev = os.environ.get("DCFM_DEVICE_COUNT")
    current = {"num_processes": int(num_processes),
               "num_devices": int(env_dev) if env_dev else None}
    degraded = (int(recorded.get("num_processes", 1)) != num_processes
                or (current["num_devices"] is not None
                    and current["num_devices"]
                    != recorded.get("num_devices")))
    posture = ("disabled" if os.environ.get("DCFM_NO_ELASTIC") == "1"
               else "elastic")
    rec.emit("elastic_capacity", recorded_topology=recorded,
             current_topology=current, degraded=degraded, posture=posture)
    if degraded:
        log(f"capacity changed vs checkpoint topology {recorded} -> "
            f"{current}; children "
            + ("will refuse adoption (--no-elastic)"
               if posture == "disabled"
               else "resume elastically on surviving capacity"))


def _pod_capacity(current: int) -> int:
    """The surviving host capacity for the next launch, clamped to ``[1,
    current]`` (a pod only degrades mid-run): ``DCFM_POD_CAPACITY`` (an
    integer) or the number in the file ``DCFM_POD_CAPACITY_FILE`` names
    (whatever tells this launcher how many hosts still answer writes it).
    Absent, empty or unreadable: the current size stands."""
    raw = os.environ.get("DCFM_POD_CAPACITY")
    if not raw:
        f = os.environ.get("DCFM_POD_CAPACITY_FILE")
        if f:
            try:
                with open(f, encoding="utf-8") as fh:
                    raw = fh.read().strip()
            except OSError:
                raw = None
    if not raw:
        return current
    try:
        cap = int(raw)
    except ValueError:
        return current
    return max(1, min(cap, current))


def _proc_families(path: str) -> dict:
    """The COMPLETE ``.procK-of-M`` slot families on disk, live or
    retained: ``{M: [slot paths 0 .. M-1]}`` for every M whose every slot
    has at least one generation (file names only).  A complete family is
    one resumable unit at any pod size, so its slots are promoted
    together, never each to its own newest."""
    from dcfm_tpu_torch.utils.checkpoint import proc_path
    d = os.path.dirname(os.path.abspath(path)) or "."
    out: dict = {}
    if not os.path.isdir(d):
        return out
    base = re.escape(os.path.basename(path))
    pat = re.compile(f"^{base}\\.proc(\\d+)-of-(\\d+)(\\.bak\\d+)?$")
    found: dict = {}
    for f in os.listdir(d):
        m = pat.match(f)
        if m:
            found.setdefault(int(m.group(2)), set()).add(int(m.group(1)))
    for count, idxs in sorted(found.items()):
        if idxs == set(range(count)):
            out[count] = [proc_path(path, i, count) for i in range(count)]
    return out


def _unanimous_iteration(per_slot_holdings) -> int:
    """The newest iteration present in EVERY slot's holdings (an iterable
    of iterations per slot), -1 when none: the one rule behind the
    relaunch pre-pass and the death accounting."""
    common: Optional[set] = None
    for held in per_slot_holdings:
        h = set(held)
        common = h if common is None else (common & h)
        if not common:
            return -1
    return max(common) if common else -1


def _promote_unanimous(slots: list, gens: list, it_star: int,
                       log: Callable[[str], None]) -> None:
    """Install generation ``it_star`` of every slot's clean generations
    ``gens`` into its live slot."""
    for slot, g in zip(slots, gens):
        src = g[it_star]
        if src != slot:
            _promote(src, slot)
            log(f"promoted retained checkpoint {src} -> {slot} "
                f"(iteration {it_star}, unanimous over {len(slots)} "
                "slots)")
            record("checkpoint_promote", src=os.path.basename(src),
                   slot=os.path.basename(slot), iteration=it_star,
                   unanimous=True)


def _ensure_family(fam: list, report: SuperviseReport,
                   log: Callable[[str], None]) -> int:
    """Promote, into every live slot of one ``.procK-of-M`` family, the
    newest generation every slot holds CRC-clean, demoting corrupt ones on
    the way; returns its iteration (-1: none, the family is left as it
    is)."""
    gens = [_clean_generations(s, report, log) for s in fam]
    it_star = _unanimous_iteration(gens)
    if it_star >= 0:
        _promote_unanimous(fam, gens, it_star, log)
    return it_star


def _pod_progress(path: str, num_processes: int) -> int:
    """A pod's resumable progress, for the death accounting: the best of
    :func:`_progress_iteration` and the newest iteration every
    ``.procK-of-N`` slot holds CRC-clean across its retention chain.  A
    kill between two processes' saves leaves mixed live files (no
    agreeing set, so -1 alone), and two such deaths would pass the poison
    rule's same-iteration test while the pod progresses."""
    from dcfm_tpu_torch.utils.checkpoint import proc_path, scan_generations
    per_slot = []
    for i in range(num_processes):
        slot = proc_path(path, i, num_processes)
        per_slot.append({it for _, it, err in scan_generations(slot)
                         if err is None})
    return max(_progress_iteration(path), _unanimous_iteration(per_slot))


def _watchdog_progress(path: str, num_processes: int) -> int:
    """The hang watchdog's liveness score: the SUM of the iterations every
    slot's live file reports (metadata only).  Any one slot's advance
    moves it - a slow process saving while a finished peer's file is
    parked higher is alive - which is all the watchdog needs; -1 when no
    file is readable."""
    from dcfm_tpu_torch.utils.checkpoint import proc_path, read_checkpoint_meta
    candidates = [path] + [proc_path(path, i, num_processes)
                           for i in range(num_processes)]
    score = -1
    for p in candidates:
        try:
            it = int(read_checkpoint_meta(p)["iteration"])
        except Exception:  # dcfm: ignore[DCFM601] - absent/mid-write file is simply not liveness evidence
            continue
        score = it if score < 0 else score + it
    return score


def _demote(p: str, err, report: SuperviseReport,
            log: Callable[[str], None]) -> None:
    log(f"checkpoint {p} unusable ({err}); demoting")
    record("checkpoint_demote", path=os.path.basename(p), error=str(err))
    report.corrupt_fallbacks += 1
    try:
        os.replace(p, p + ".corrupt")
    except OSError:
        pass


def _promote(src: str, slot: str) -> None:
    """Install retained generation ``src`` into the live ``slot`` WITHOUT
    removing it from its ``.bakK`` position (a hard link into place, as
    the keep_last rotation does; a copy on link-less filesystems): the
    cross-slot intersection must still find it there after a second
    failure."""
    tmp = slot + ".promote.tmp"
    try:
        os.link(src, tmp)
    except OSError:
        import shutil
        shutil.copy2(src, tmp)
    os.replace(tmp, slot)


def _clean_generations(slot: str, report: SuperviseReport,
                       log: Callable[[str], None]) -> dict:
    """One slot's retention chain scanned, corrupt generations demoted:
    ``{iteration: path}`` of the clean ones (the newest file wins a
    tie)."""
    from dcfm_tpu_torch.utils.checkpoint import scan_generations
    out: dict = {}
    for p, it, err in scan_generations(slot):
        if err is not None:
            _demote(p, err, report, log)
        else:
            out.setdefault(it, p)
    return out


def _ensure_slot(slot: str, report: SuperviseReport,
                 log: Callable[[str], None]) -> int:
    """Walk ONE slot's retention chain newest-first, demoting every
    CRC-corrupt file to ``<file>.corrupt`` and promoting the first
    verified generation into the live position; returns its iteration
    (-1: nothing survived)."""
    from dcfm_tpu_torch.utils.checkpoint import scan_generations
    for p, it, err in scan_generations(slot):
        if err is not None:
            _demote(p, err, report, log)
            continue
        if p != slot:
            # promote the retained generation into the live slot; the
            # child resumes it exactly as if it were the newest save
            _promote(p, slot)
            log(f"promoted retained checkpoint {p} -> {slot} "
                f"(iteration {it})")
            record("checkpoint_promote", src=os.path.basename(p),
                   slot=os.path.basename(slot), iteration=it)
        return it
    return -1


def _ensure_good_checkpoint(path: str, report: SuperviseReport,
                            log: Callable[[str], None]) -> int:
    """The one-process integrity pre-pass before a (re)launch: every slot
    (the plain path and each ``.procK-of-N`` file) walked by
    :func:`_ensure_slot`, except that the slots of a COMPLETE family (a
    pod's set a one-process relaunch resumes, host-elastically) are
    promoted together to their newest unanimous generation
    (:func:`_ensure_family`).  Returns the resulting progress
    (:func:`_progress_iteration`), -1 when no checkpoint exists yet."""
    families = _proc_families(path)
    in_family = {s for fam in families.values() for s in fam}
    for slot in _checkpoint_slots(path):
        if slot not in in_family:
            _ensure_slot(slot, report, log)
    for fam in families.values():
        _ensure_family(fam, report, log)
    return _progress_iteration(path)


def _ensure_unanimous_checkpoint(path: str, num_processes: int,
                                 report: SuperviseReport,
                                 log: Callable[[str], None]) -> int:
    """The pod's integrity pre-pass: promote, into every
    ``.procK-of-N`` live slot, the newest generation ALL ``num_processes``
    slots hold CRC-clean - the only state the collective resume gate
    accepts (per-slot newest would hand the children a mixed state it
    refuses on every relaunch).  Newer generations are discarded by the
    promotion; with no unanimous generation the live files are set aside
    as ``.orphan`` so every process starts fresh.  Slots outside the
    current size still get the integrity walk (discovery may pick the
    plain file or another size's set, promoted as a unit), and corrupt
    ``.full`` sidecar generations are demoted.  Returns the resulting
    progress (:func:`_progress_iteration`)."""
    from dcfm_tpu_torch.utils.checkpoint import proc_path, scan_generations
    slots = [proc_path(path, i, num_processes)
             for i in range(num_processes)]
    current = set(slots)
    families = _proc_families(path)
    families.pop(num_processes, None)
    in_family = {s for fam in families.values() for s in fam}
    for slot in _checkpoint_slots(path):
        if slot not in current and slot not in in_family:
            _ensure_slot(slot, report, log)
    for fam in families.values():
        _ensure_family(fam, report, log)
    gens = [_clean_generations(s, report, log) for s in slots]
    it_star = _unanimous_iteration(gens)
    if it_star >= 0:
        _promote_unanimous(slots, gens, it_star, log)
    else:
        for slot in slots:
            if os.path.exists(slot):
                log(f"no unanimously-held generation; setting aside "
                    f"{slot}")
                record("checkpoint_orphan", slot=os.path.basename(slot))
                try:
                    os.replace(slot, slot + ".orphan")
                except OSError:
                    pass
    for i in range(num_processes):
        side = proc_path(path + ".full", i, num_processes)
        for p, _, err in scan_generations(side):
            if err is not None:
                _demote(p, err, report, log)
    return _progress_iteration(path)


def _reap(procs: list, grace: float) -> None:
    """SIGTERM every live process, SIGKILL what is still alive after
    ``grace`` seconds, and wait for all of them (no zombie is left)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.perf_counter() + grace
    for p in procs:
        while p.poll() is None and time.perf_counter() < deadline:
            time.sleep(0.02)
        if p.poll() is None:
            p.kill()
        p.wait()


def _await_pod(procs: list, launch_timeout: Optional[float], grace: float,
               log: Callable[[str], None],
               progress_fn: Optional[Callable[[], int]] = None) -> int:
    """Wait for a launch's processes: 0 when ALL exited 0; on the first
    non-zero exit the survivors are REAPED (the coordinated stop: a dead
    peer leaves them blocked in a collective that cannot complete) and
    that exit code is returned.

    Raises :class:`PodHangError` when the launch makes NO OBSERVABLE
    PROGRESS for ``launch_timeout`` seconds (None = wait forever): a clean
    process exit and an advance of ``progress_fn``'s score (polled at a
    coarse cadence; a healthy fit checkpoints at every boundary) reset
    the deadline."""
    deadline = (time.perf_counter() + launch_timeout
                if launch_timeout else None)
    finished = 0
    last_progress = None
    next_probe = 0.0
    try:
        while True:
            codes = [p.poll() for p in procs]
            dead = [c for c in codes if c is not None and c != 0]
            if dead:
                alive = sum(c is None for c in codes)
                if alive:
                    log(f"process died (exit {dead[0]}); coordinated stop "
                        f"of {alive} surviving process(es)")
                _reap(procs, grace)
                return dead[0]
            if all(c == 0 for c in codes):
                return 0
            now = time.perf_counter()
            done_now = sum(c == 0 for c in codes)
            if done_now > finished:
                finished = done_now
                if launch_timeout:
                    deadline = now + launch_timeout
            if (launch_timeout and progress_fn is not None
                    and now >= next_probe):
                next_probe = now + max(1.0, launch_timeout / 10.0)
                try:
                    p_now = progress_fn()
                except Exception:  # dcfm: ignore[DCFM601] - a torn mid-save meta is not a hang verdict; the next probe retries
                    p_now = None
                if p_now is not None and (last_progress is None
                                          or p_now > last_progress):
                    if last_progress is not None:
                        deadline = now + launch_timeout
                    last_progress = p_now
            if deadline is not None and now > deadline:
                _reap(procs, grace)
                raise PodHangError(
                    f"no process finished or died, and the checkpoint "
                    f"iteration did not advance, within the "
                    f"{launch_timeout:.0f}s watchdog - the launch is hung "
                    "(processes blocked in collectives that cannot "
                    "complete); this is a bug, not a scheduling event, and "
                    "is not retried")
            time.sleep(0.05)
    finally:
        # never leak a child, whatever raised above
        if any(p.poll() is None for p in procs):
            _reap(procs, grace)


def _run_supervision(
    spawn: Callable,
    *,
    checkpoint_path: str,
    num_processes: int = 1,
    max_retries: int = 5,
    backoff_base: float = 1.0,
    backoff_max: float = 60.0,
    poison_deaths: int = 2,
    launch_timeout: Optional[float] = None,
    grace: float = 5.0,
    log: Callable[[str], None] = _log,
) -> SuperviseReport:
    """Obs session around the supervision loop: open the run's flight
    recorder (``DCFM_OBS_DIR``, defaulting to ``<checkpoint>.obs`` - the
    SAME directory the children's ``FitConfig.obs="auto"`` resolves to, so
    one run = one directory) and export ``DCFM_OBS_DIR`` / ``DCFM_RUN_ID``
    so every launch of every child records into it.  The previous
    environment is restored on the way out."""
    obs_dir = os.environ.get(OBS_DIR_ENV_VAR) or (checkpoint_path + ".obs")
    rec = FlightRecorder(obs_dir, role="supervisor")
    prev_env = {k: os.environ.get(k)
                for k in (OBS_DIR_ENV_VAR, RUN_ID_ENV_VAR)}
    os.environ[OBS_DIR_ENV_VAR] = obs_dir
    os.environ[RUN_ID_ENV_VAR] = rec.run_id
    _obs_install(rec)
    try:
        return _supervision_loop(
            spawn, checkpoint_path=checkpoint_path,
            num_processes=num_processes, max_retries=max_retries,
            backoff_base=backoff_base, backoff_max=backoff_max,
            poison_deaths=poison_deaths, launch_timeout=launch_timeout,
            grace=grace, log=log, rec=rec, obs_dir=obs_dir)
    finally:
        _obs_uninstall(rec)
        rec.close()
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _supervision_loop(
    spawn: Callable,
    *,
    checkpoint_path: str,
    num_processes: int,
    max_retries: int,
    backoff_base: float,
    backoff_max: float,
    poison_deaths: int,
    launch_timeout: Optional[float],
    grace: float,
    log: Callable[[str], None],
    rec: FlightRecorder,
    obs_dir: str,
) -> SuperviseReport:
    """The one supervision loop of one process and of a pod.
    ``spawn(attempt)`` (1-based) - or ``spawn(attempt, n)``, handed the
    current pod size - starts the attempt's processes and returns their
    ``subprocess.Popen`` handles; integrity pre-pass, capacity probe and
    degrade, death accounting, poison detection, backoff and watchdog are
    here.  Every decision lands in the flight recorder (the typed
    failures quote the dead launch's last events), with ``log`` as the
    stderr mirror."""
    report = SuperviseReport(run_id=rec.run_id)
    t0 = time.perf_counter()
    prev_death_iter: Optional[int] = None
    same_iter_deaths = 0
    # the pod size is loop state: a relaunch that finds fewer surviving
    # hosts degrades the pod for every later attempt
    n_procs = num_processes
    try:
        spawn_takes_n = len(inspect.signature(spawn).parameters) >= 2
    except (TypeError, ValueError):  # builtins / odd callables
        spawn_takes_n = False

    def pre_pass():
        if n_procs > 1:
            return _ensure_unanimous_checkpoint(
                checkpoint_path, n_procs, report, log)
        return _ensure_good_checkpoint(checkpoint_path, report, log)

    while True:
        if num_processes > 1:
            cap = _pod_capacity(n_procs)
            if cap < n_procs:
                if os.environ.get("DCFM_NO_ELASTIC") == "1":
                    rec.emit("pod_degrade", decision="refused",
                             posture="disabled", from_processes=n_procs,
                             to_processes=cap)
                    rec.flush(fsync=True)
                    raise PodCapacityError(
                        f"surviving capacity is {cap} host(s) but the "
                        f"pod is configured for {n_procs} and elastic "
                        "degrade is vetoed (--no-elastic / "
                        "DCFM_NO_ELASTIC=1); drop the veto to relaunch "
                        "degraded on the survivors, or restore "
                        f"{n_procs} host(s) and relaunch"
                        + postmortem(obs_dir, report.launches or None))
                rec.emit("pod_degrade", decision="degraded",
                         posture="elastic", from_processes=n_procs,
                         to_processes=cap)
                rec.flush(fsync=True)
                log(f"pod degraded {n_procs} -> {cap} host(s); "
                    "relaunching on the survivors")
                n_procs = cap
        it_before = pre_pass()
        _capacity_probe(checkpoint_path, n_procs, rec, log)
        report.launches += 1
        rec.emit("supervisor_launch", attempt=report.launches,
                 checkpoint_iteration=it_before, num_processes=n_procs)
        rec.flush(fsync=True)
        log(f"launch #{report.launches} (checkpoint at iteration "
            f"{it_before})")
        procs = (spawn(report.launches, n_procs) if spawn_takes_n
                 else spawn(report.launches))
        if isinstance(procs, subprocess.Popen):
            procs = [procs]
        try:
            rc = _await_pod(
                procs, launch_timeout, grace, log,
                progress_fn=lambda: _watchdog_progress(checkpoint_path,
                                                       n_procs))
        except PodHangError as e:
            report.elapsed_s = time.perf_counter() - t0
            rec.emit("supervisor_hang", launch=report.launches,
                     watchdog_s=launch_timeout)
            rec.flush(fsync=True)
            raise PodHangError(
                str(e) + postmortem(obs_dir, report.launches)) from None
        if rc == 0:
            # leave the live slot VERIFIED on the way out too: the final
            # save itself can be the corrupt one, and a future resume
            # should find the newest CLEAN generation promoted
            report.final_iteration = pre_pass()
            report.elapsed_s = time.perf_counter() - t0
            rec.emit("supervisor_done", launches=report.launches,
                     corrupt_fallbacks=report.corrupt_fallbacks,
                     final_iteration=report.final_iteration,
                     dur_s=report.elapsed_s)
            log(f"child finished after {report.launches} launch(es), "
                f"{report.corrupt_fallbacks} corrupt fallback(s)")
            return report
        it_died = (_pod_progress(checkpoint_path, n_procs) if n_procs > 1
                   else _progress_iteration(checkpoint_path))
        report.deaths.append((rc, it_died))
        rec.emit("supervisor_death", exit=rc, iteration=it_died,
                 launch=report.launches)
        rec.flush(fsync=True)
        log(f"child died (exit {rc}) at checkpoint iteration {it_died}")
        # Poison = the same iteration killed the child ``poison_deaths``
        # times in a row: each counted death shows NO progress over the
        # child's own launch point AND sits at the previous death's
        # iteration.  Both matter - a corruption fallback legitimately
        # moves a launch point BACKWARDS, so two deaths at one iteration
        # with progress in between must keep retrying.
        if it_died <= it_before and it_died == prev_death_iter:
            same_iter_deaths += 1
        else:
            same_iter_deaths = 1
        if same_iter_deaths >= poison_deaths:
            report.elapsed_s = time.perf_counter() - t0
            rec.emit("supervisor_poisoned", iteration=it_died,
                     deaths=same_iter_deaths, exit=rc)
            rec.flush(fsync=True)
            raise PoisonedRunError(
                f"iteration {it_died} killed the child {same_iter_deaths} "
                f"times in a row (exit {rc}) - the failure "
                "is deterministic, not environmental; inspect the run at "
                f"the offending checkpoint: {checkpoint_path}"
                + postmortem(obs_dir, report.launches),
                checkpoint_path=checkpoint_path, iteration=it_died)
        prev_death_iter = it_died
        retries = report.launches  # deaths so far == launches (none exited 0)
        if retries > max_retries:
            report.elapsed_s = time.perf_counter() - t0
            rec.emit("supervisor_retries_exhausted", retries=retries,
                     exit=rc, iteration=it_died)
            rec.flush(fsync=True)
            raise RetriesExhaustedError(
                f"child died {retries} times (retry budget {max_retries}); "
                f"last exit {rc} at iteration {it_died}"
                + postmortem(obs_dir, report.launches))
        # FULL jitter under the exponential cap: supervisors relaunching
        # after one shared event do not return in lockstep; the drawn
        # delay is recorded beside its cap
        cap = min(backoff_max, backoff_base * (2.0 ** (retries - 1)))
        delay = random.uniform(0.0, cap)
        rec.emit("supervisor_backoff", seconds=round(delay, 4),
                 cap=round(cap, 4), next_attempt=report.launches + 1)
        log(f"backing off {delay:.2f}s (cap {cap:.2f}s) before relaunch")
        time.sleep(delay)


def supervise_command(
    argv: list,
    *,
    checkpoint_path: str,
    max_retries: int = 5,
    backoff_base: float = 1.0,
    backoff_max: float = 60.0,
    poison_deaths: int = 2,
    launch_timeout: Optional[float] = None,
    env: Optional[dict] = None,
    log: Callable[[str], None] = _log,
) -> SuperviseReport:
    """Run ``argv`` as a child process until it exits 0, resuming it
    through crashes.  The core both CLI modes and :func:`supervise` build
    on.

    Contract for ``argv``: it must checkpoint to ``checkpoint_path`` and
    resume from it when relaunched unchanged (``dcfm-tpu-torch fit
    --checkpoint ... --resume`` and the internal ``_child`` runner both
    do).

    Raises :class:`PoisonedRunError` when ``poison_deaths`` consecutive
    deaths show the same checkpoint iteration with no progress,
    :class:`RetriesExhaustedError` past ``max_retries`` relaunches after a
    death, and :class:`PodHangError` when a launch makes no observable
    progress within ``launch_timeout`` seconds (None disables the
    watchdog).  CAVEAT: two RANDOM preemptions inside one save window
    mimic poison; raise ``poison_deaths`` where that is routine.

    Every launch exports ``DCFM_FAULT_LAUNCH`` (the 1-based attempt) so
    launch-gated faults (resilience/faults.py) stay deterministic across
    relaunches."""
    full_env = dict(os.environ)
    if env:
        full_env.update(env)

    def spawn(attempt: int) -> subprocess.Popen:
        child_env = dict(full_env)
        child_env["DCFM_FAULT_LAUNCH"] = str(attempt)
        # the obs session (one run directory + run id for every launch)
        # is exported by _run_supervision AFTER full_env was snapshotted
        for k in (OBS_DIR_ENV_VAR, RUN_ID_ENV_VAR):
            if k in os.environ:
                child_env[k] = os.environ[k]
        # children ARE launches: never inherit a role override
        child_env.pop(OBS_ROLE_ENV_VAR, None)
        return subprocess.Popen(argv, env=child_env)

    return _run_supervision(
        spawn, checkpoint_path=checkpoint_path, max_retries=max_retries,
        backoff_base=backoff_base, backoff_max=backoff_max,
        poison_deaths=poison_deaths, launch_timeout=launch_timeout, log=log)


def supervise_pod(
    spawn: Callable,
    *,
    checkpoint_path: str,
    num_processes: int,
    max_retries: int = 5,
    backoff_base: float = 1.0,
    backoff_max: float = 60.0,
    poison_deaths: int = 2,
    launch_timeout: Optional[float] = None,
    grace: float = 5.0,
    log: Callable[[str], None] = _log,
) -> SuperviseReport:
    """Run an N-process pod fit until every process exits 0, surviving the
    death of any subset.

    ``spawn(attempt)`` (1-based) starts all ``num_processes`` processes of
    one launch and returns their ``Popen`` handles; it owns each process's
    environment (the coordinator address - a FRESH port per attempt, so a
    relaunch never races the dead coordinator's socket -,
    ``DCFM_PROCESS_ID``, ``DCFM_FAULT_PROCESS`` / ``DCFM_FAULT_LAUNCH``).
    The children checkpoint to ``checkpoint_path`` (``.procK-of-N`` files)
    and resume from it when relaunched.  A two-parameter ``spawn(attempt,
    n)`` is handed the CURRENT pod size: when the capacity probe
    (:func:`_pod_capacity`) reports fewer surviving hosts, the loop
    degrades the pod (a ``pod_degrade`` event; the children adopt the old
    set host-elastically), or raises :class:`PodCapacityError` under
    ``DCFM_NO_ELASTIC=1``.

    On any death the survivors are reaped (:func:`_await_pod`), the slots
    promoted to their newest unanimous generation
    (:func:`_ensure_unanimous_checkpoint`) and the WHOLE pod relaunched -
    processes that had finished re-run as no-op resumes.  Poison
    detection, retry budget, backoff and watchdog are
    :func:`supervise_command`'s."""
    return _run_supervision(
        spawn, checkpoint_path=checkpoint_path,
        num_processes=num_processes, max_retries=max_retries,
        backoff_base=backoff_base, backoff_max=backoff_max,
        poison_deaths=poison_deaths, launch_timeout=launch_timeout,
        grace=grace, log=log)


def _check_supervisable(cfg) -> None:
    if not cfg.checkpoint_path:
        raise ValueError("supervise() requires cfg.checkpoint_path - "
                         "without a checkpoint there is nothing to resume")
    if cfg.checkpoint_mode != "full":
        raise ValueError(
            "supervise() requires checkpoint_mode='full': the parent "
            "materializes the result from the finished checkpoint, which "
            "a state-only (light) final save cannot provide")


def _supervise_children(Y, cfg, *, max_retries: int = 5,
                        backoff_base: float = 1.0, backoff_max: float = 60.0,
                        workdir: Optional[str] = None,
                        log: Callable[[str], None] = _log) -> SuperviseReport:
    """The children's half of :func:`supervise`: the chain runs to its end
    in supervised ``_child`` processes; returns the report.  The data
    matrix and config reach the child through a scratch directory
    (``workdir``; a temp dir by default) - the child re-runs
    preprocessing deterministically from the seed, exactly like any
    resume."""
    import numpy as np

    _check_supervisable(cfg)
    from dcfm_tpu_torch.utils.checkpoint import _config_to_json

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="dcfm-supervise-")
    os.makedirs(workdir, exist_ok=True)
    data_path = os.path.join(workdir, "Y.npy")
    cfg_path = os.path.join(workdir, "cfg.json")
    np.save(data_path, np.asarray(Y))
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(_config_to_json(cfg), f)
    argv = [sys.executable, "-m", "dcfm_tpu_torch.resilience._child",
            cfg_path, data_path]
    try:
        return supervise_command(
            argv, checkpoint_path=cfg.checkpoint_path,
            max_retries=max_retries, backoff_base=backoff_base,
            backoff_max=backoff_max, log=log)
    finally:
        if own_tmp:
            for p in (data_path, cfg_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            try:
                os.rmdir(workdir)
            except OSError:
                pass


def supervise(Y, cfg, *, max_retries: int = 5, backoff_base: float = 1.0,
              backoff_max: float = 60.0, workdir: Optional[str] = None,
              log: Callable[[str], None] = _log):
    """Supervised ``fit(Y, cfg)``: the chain runs in child processes
    (crash-isolated, resumable); the parent returns the completed
    :class:`~dcfm_tpu_torch.api.FitResult` with the supervision telemetry
    in ``supervise_report``.

    Requires ``cfg.checkpoint_path`` (the resume substrate) and
    ``checkpoint_mode="full"`` (the parent materializes the result by a
    no-op resume of the finished checkpoint, which a light save cannot
    serve).  ``checkpoint_keep_last >= 2`` is recommended so a corrupt
    newest checkpoint falls back instead of restarting from zero.  The
    children and the materialization run on the device
    ``cfg.backend.backend`` names (the card unless "torch_cpu")."""
    import numpy as np

    report = _supervise_children(Y, cfg, max_retries=max_retries,
                                 backoff_base=backoff_base,
                                 backoff_max=backoff_max, workdir=workdir,
                                 log=log)
    # The children completed the chain; materialize the FitResult here by
    # a no-op resume (loads the finished checkpoint, runs zero iterations,
    # fetches + assembles), after the last child exited.  It records
    # under its OWN flight-recorder role ("materialize") and under the
    # supervised run's id, so one logical run keeps one id across every
    # launch plus this segment.
    from dcfm_tpu_torch.api import fit
    prev = {k: os.environ.get(k) for k in (OBS_ROLE_ENV_VAR, RUN_ID_ENV_VAR)}
    os.environ[OBS_ROLE_ENV_VAR] = "materialize"
    if report.run_id:
        os.environ[RUN_ID_ENV_VAR] = report.run_id
    try:
        res = fit(np.asarray(Y), dataclasses.replace(cfg, resume=True))
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dataclasses.replace(res, supervise_report=report)


def run_supervised_cli(child_argv: list, *, checkpoint: str,
                       max_retries: int = 5, backoff_base: float = 1.0,
                       backoff_max: float = 60.0,
                       poison_deaths: int = 2,
                       launch_timeout: Optional[float] = None,
                       pod: int = 0, port_base: int = 29900,
                       no_elastic: bool = False) -> int:
    """The ONE home of the CLI supervision protocol, shared by
    ``dcfm-tpu-torch fit --supervise`` and ``dcfm-tpu-torch supervise``:
    run the subcommand ``child_argv`` under :func:`supervise_command` -
    or, with ``pod=N > 1``, N copies of it under :func:`supervise_pod`,
    one per process, meeting through the ``DCFM_COORDINATOR`` /
    ``DCFM_NUM_PROCESSES`` / ``DCFM_PROCESS_ID`` environment the CLI's
    fit honours (parallel/multihost.initialize_from_env), each attempt on
    the fresh coordinator port ``port_base + attempt``.  Prints the JSON
    report (or the typed failure) to stderr; returns the process exit code
    (0 success, 3 poisoned/exhausted/hung/capacity).  ``no_elastic``
    exports DCFM_NO_ELASTIC=1 to every child: its resume then refuses
    (``ValueError("refusing to resume: ...")``) a checkpoint of another
    chain count or process count instead of adopting it."""
    argv = [sys.executable, "-m", "dcfm_tpu_torch.cli"] + list(child_argv)
    if no_elastic:
        # every child inherits the veto: its resume refuses (typed) a
        # checkpoint of another chain count instead of adopting it
        os.environ["DCFM_NO_ELASTIC"] = "1"
    try:
        if pod > 1:
            def spawn(attempt: int, n: int) -> list:
                # n is the CURRENT pod size, which the capacity probe may
                # have degraded below --pod N (the children see the
                # reduced count and adopt the old set host-elastically)
                procs = []
                for i in range(n):
                    env = dict(os.environ)
                    env.pop(OBS_ROLE_ENV_VAR, None)  # children ARE launches
                    env["DCFM_COORDINATOR"] = (
                        f"127.0.0.1:{port_base + attempt}")
                    env["DCFM_NUM_PROCESSES"] = str(n)
                    env["DCFM_PROCESS_ID"] = str(i)
                    env["DCFM_FAULT_PROCESS"] = str(i)
                    env["DCFM_FAULT_LAUNCH"] = str(attempt)
                    procs.append(subprocess.Popen(argv, env=env))
                return procs

            report = supervise_pod(
                spawn, checkpoint_path=checkpoint, num_processes=pod,
                max_retries=max_retries, backoff_base=backoff_base,
                backoff_max=backoff_max, poison_deaths=poison_deaths,
                launch_timeout=launch_timeout)
        else:
            report = supervise_command(
                argv, checkpoint_path=checkpoint, max_retries=max_retries,
                backoff_base=backoff_base, backoff_max=backoff_max,
                poison_deaths=poison_deaths, launch_timeout=launch_timeout)
    except (PoisonedRunError, RetriesExhaustedError, PodHangError,
            PodCapacityError) as e:
        print(json.dumps({  # dcfm: ignore[DCFM901] - the CLI's documented stderr JSON protocol
            "error": type(e).__name__, "message": str(e),
            "checkpoint": getattr(e, "checkpoint_path", None),
            "iteration": getattr(e, "iteration", None),
        }), file=sys.stderr)
        return 3
    print(json.dumps({  # dcfm: ignore[DCFM901] - the CLI's documented stderr JSON protocol
        "supervised": True, "launches": report.launches,
        "deaths": report.deaths,
        "corrupt_fallbacks": report.corrupt_fallbacks,
        "final_iteration": report.final_iteration,
    }), file=sys.stderr)
    return 0


def build_supervise_parser():
    """The parser of ``dcfm-tpu-torch supervise`` (the JAX CLI's flags)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="dcfm-tpu-torch supervise",
        description=supervise_cli.__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path to monitor (default: extracted "
                        "from the child command's --checkpoint)")
    p.add_argument("--max-retries", type=int, default=5)
    p.add_argument("--backoff", type=float, default=1.0,
                   help="base of the exponential relaunch backoff (s)")
    p.add_argument("--backoff-max", type=float, default=60.0)
    p.add_argument("--poison-deaths", type=int, default=2,
                   help="consecutive same-iteration no-progress deaths "
                        "that count as a poisoned run (raise on heavily-"
                        "preempted fleets with long save cadences)")
    p.add_argument("--pod", type=int, default=0, metavar="N",
                   help="run N coordinated processes of the child command "
                        "(one per host of a pod), rendezvousing through "
                        "DCFM_COORDINATOR/NUM_PROCESSES/PROCESS_ID; any "
                        "death relaunches the whole pod from the newest "
                        "checkpoint generation held by every process")
    p.add_argument("--watchdog", type=float, default=0.0, metavar="S",
                   help="hang watchdog: if the child neither finishes "
                        "nor dies, and its checkpoint does not advance, "
                        "within S seconds, kill it and abort with a typed "
                        "PodHangError (0 = disabled)")
    p.add_argument("--port-base", type=int, default=29900,
                   help="pod mode: attempt k's coordinator listens on "
                        "port-base + k (a fresh port per relaunch)")
    p.add_argument("--no-elastic", action="store_true",
                   help="veto elastic adoption: children refuse (typed) "
                        "a checkpoint written on a different chain "
                        "count instead of adopting it (exports "
                        "DCFM_NO_ELASTIC=1)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the dcfm-tpu-torch command to supervise (a "
                        "leading '--' separator is accepted)")
    return p


def supervise_cli(argv: list) -> int:
    """``dcfm-tpu-torch supervise [options] -- <subcommand ...>``: run
    any dcfm-tpu-torch command (typically ``fit ... --checkpoint ...``)
    under the crash supervisor.  ``--checkpoint`` is read from the child
    command when not given explicitly."""
    p = build_supervise_parser()
    args = p.parse_args(argv)
    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no child command given (e.g. `dcfm-tpu-torch supervise "
                "-- fit Y.npy --shards 4 ... --checkpoint ck.npz`)")
    ck = args.checkpoint
    if ck is None:
        for i, tok in enumerate(cmd):
            if tok == "--checkpoint" and i + 1 < len(cmd):
                ck = cmd[i + 1]
            elif tok.startswith("--checkpoint="):
                ck = tok.split("=", 1)[1]
    if not ck:
        p.error("the child command has no --checkpoint (nothing to "
                "resume from); pass one, or --checkpoint to supervise")
    if cmd[0] == "fit" and "--resume" not in cmd:
        cmd.append("--resume")
    return run_supervised_cli(
        cmd, checkpoint=ck, max_retries=args.max_retries,
        backoff_base=args.backoff, backoff_max=args.backoff_max,
        poison_deaths=args.poison_deaths,
        launch_timeout=args.watchdog or None,
        pod=args.pod, port_base=args.port_base, no_elastic=args.no_elastic)
