"""Run supervisor: crash-only fits that finish anyway.

The port of the single-host half of ``dcfm_tpu/resilience/supervisor.py``.
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

The N-process half - ``supervise_pod``, unanimous-generation resume over
``.procK-of-N`` sets, host capacity and elastic degrade (``--pod N``) -
needs the multi-process checkpoint sets the port does not write yet: it
waits for ROADMAP Queue A item 7 (f), and ``--pod N > 1`` is refused by
name.  :class:`PodHangError` (the launch watchdog) and
:class:`PodCapacityError` keep the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
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

_POD = ("needs the multi-process checkpoint sets (.procK-of-N) and is not "
        "ported to dcfm_tpu_torch yet: ROADMAP Queue A item 7 (f)")


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
    elastic degrade is vetoed (the JAX package's pod supervisor; the
    port's waits for ROADMAP Queue A item 7 (f))."""


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


def _progress_iteration(path: str) -> int:
    """Chain progress at ``path``: the live file's iteration from its
    metadata alone (the parent never touches the card; cheap enough for
    the watchdog to poll), -1 when absent, corrupt or mid-write."""
    from dcfm_tpu_torch.utils.checkpoint import read_checkpoint_meta
    try:
        return int(read_checkpoint_meta(path)["iteration"])
    except Exception:  # dcfm: ignore[DCFM601] - absent/corrupt/mid-write file is simply not progress
        return -1


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
    the keep_last rotation does; a copy on link-less filesystems)."""
    tmp = slot + ".promote.tmp"
    try:
        os.link(src, tmp)
    except OSError:
        import shutil
        shutil.copy2(src, tmp)
    os.replace(tmp, slot)


def _ensure_good_checkpoint(path: str, report: SuperviseReport,
                            log: Callable[[str], None]) -> int:
    """Integrity pre-pass before a (re)launch: walk the retention chain
    newest-first, demote every CRC-corrupt file to ``<file>.corrupt``,
    and promote the first verified generation into the live position so
    the child's resume sees only clean bytes.  Returns its iteration, or
    -1 when no checkpoint exists yet (first launch / nothing survived).
    One live slot: the ``.procK-of-N`` slots of the JAX package's pod
    wait for ROADMAP Queue A item 7 (f)."""
    from dcfm_tpu_torch.utils.checkpoint import scan_generations
    for p, it, err in scan_generations(path):
        if err is not None:
            _demote(p, err, report, log)
            continue
        if p != path:
            # promote the retained generation into the live slot; the
            # child resumes it exactly as if it were the newest save
            _promote(p, path)
            log(f"promoted retained checkpoint {p} -> {path} "
                f"(iteration {it})")
            record("checkpoint_promote", src=os.path.basename(p),
                   slot=os.path.basename(path), iteration=it)
        return it
    return -1


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


def _await_child(proc, launch_timeout: Optional[float], grace: float,
                 progress_fn: Optional[Callable[[], int]] = None) -> int:
    """Wait for a launch's process (the JAX package's ``_await_pod`` for
    one process) and return its exit code.

    Raises :class:`PodHangError` when the launch makes NO OBSERVABLE
    PROGRESS for ``launch_timeout`` seconds (None = wait forever): the
    deadline resets when the checkpoint iteration reported by
    ``progress_fn`` advances (polled at a coarse cadence; a healthy fit
    checkpoints at every boundary, so a long chain is never mistaken for
    a hang as long as the watchdog exceeds one boundary-to-boundary
    interval)."""
    deadline = (time.perf_counter() + launch_timeout
                if launch_timeout else None)
    last_progress = None
    next_probe = 0.0
    try:
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc
            now = time.perf_counter()
            if (launch_timeout and progress_fn is not None
                    and now >= next_probe):
                next_probe = now + max(1.0, launch_timeout / 10.0)
                p_now = progress_fn()
                if last_progress is None or p_now > last_progress:
                    if last_progress is not None:
                        deadline = now + launch_timeout
                    last_progress = p_now
            if deadline is not None and now > deadline:
                _reap([proc], grace)
                raise PodHangError(
                    f"no process finished or died, and the checkpoint "
                    f"iteration did not advance, within the "
                    f"{launch_timeout:.0f}s watchdog - the launch is "
                    "hung; this is a bug, not a scheduling event, and is "
                    "not retried")
            time.sleep(0.05)
    finally:
        # never leak a child, whatever raised above
        if proc.poll() is None:
            _reap([proc], grace)


def _run_supervision(
    spawn: Callable[[int], subprocess.Popen],
    *,
    checkpoint_path: str,
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
            max_retries=max_retries, backoff_base=backoff_base,
            backoff_max=backoff_max, poison_deaths=poison_deaths,
            launch_timeout=launch_timeout, grace=grace, log=log, rec=rec,
            obs_dir=obs_dir)
    finally:
        _obs_uninstall(rec)
        rec.close()
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _supervision_loop(
    spawn: Callable[[int], subprocess.Popen],
    *,
    checkpoint_path: str,
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
    """The supervision loop of one process per launch (the JAX package's
    loop with ``num_processes=1``).  ``spawn(attempt)`` (1-based) starts
    the attempt's process and returns its ``subprocess.Popen`` handle;
    integrity pre-pass, death accounting, poison detection, backoff and
    watchdog are here.  Every decision lands in the flight recorder (the
    typed failures quote the dead launch's last events), with ``log`` as
    the stderr mirror."""
    report = SuperviseReport(run_id=rec.run_id)
    t0 = time.perf_counter()
    prev_death_iter: Optional[int] = None
    same_iter_deaths = 0
    while True:
        it_before = _ensure_good_checkpoint(checkpoint_path, report, log)
        report.launches += 1
        rec.emit("supervisor_launch", attempt=report.launches,
                 checkpoint_iteration=it_before, num_processes=1)
        rec.flush(fsync=True)
        log(f"launch #{report.launches} (checkpoint at iteration "
            f"{it_before})")
        proc = spawn(report.launches)
        try:
            rc = _await_child(
                proc, launch_timeout, grace,
                progress_fn=lambda: _progress_iteration(checkpoint_path))
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
            report.final_iteration = _ensure_good_checkpoint(
                checkpoint_path, report, log)
            report.elapsed_s = time.perf_counter() - t0
            rec.emit("supervisor_done", launches=report.launches,
                     corrupt_fallbacks=report.corrupt_fallbacks,
                     final_iteration=report.final_iteration,
                     dur_s=report.elapsed_s)
            log(f"child finished after {report.launches} launch(es), "
                f"{report.corrupt_fallbacks} corrupt fallback(s)")
            return report
        it_died = _progress_iteration(checkpoint_path)
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
                       pod: int = 0, no_elastic: bool = False) -> int:
    """The ONE home of the CLI supervision protocol, shared by
    ``dcfm-tpu-torch fit --supervise`` and ``dcfm-tpu-torch supervise``:
    run the subcommand ``child_argv`` under :func:`supervise_command`.
    Prints the JSON report (or the typed failure) to stderr; returns the
    process exit code (0 success, 3 poisoned/exhausted/hung).  ``pod``
    above 1 is refused (ROADMAP Queue A item 7 (f)).  ``no_elastic``
    exports DCFM_NO_ELASTIC=1 to every child: its resume then refuses
    (``ValueError("refusing to resume: ...")``) a checkpoint of another
    chain count instead of adopting it."""
    if pod > 1:
        raise NotImplementedError(f"supervise --pod {pod} {_POD}")
    argv = [sys.executable, "-m", "dcfm_tpu_torch.cli"] + list(child_argv)
    if no_elastic:
        # every child inherits the veto: its resume refuses (typed) a
        # checkpoint of another chain count instead of adopting it
        os.environ["DCFM_NO_ELASTIC"] = "1"
    try:
        report = supervise_command(
            argv, checkpoint_path=checkpoint, max_retries=max_retries,
            backoff_base=backoff_base, backoff_max=backoff_max,
            poison_deaths=poison_deaths, launch_timeout=launch_timeout)
    except (PoisonedRunError, RetriesExhaustedError, PodHangError) as e:
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
                   help="N coordinated processes of the child command "
                        "(one per host of a pod) - not ported: N > 1 is "
                        "refused (ROADMAP Queue A item 7 (f))")
    p.add_argument("--watchdog", type=float, default=0.0, metavar="S",
                   help="hang watchdog: if the child neither finishes "
                        "nor dies, and its checkpoint does not advance, "
                        "within S seconds, kill it and abort with a typed "
                        "PodHangError (0 = disabled)")
    p.add_argument("--port-base", type=int, default=29900,
                   help="pod mode's coordinator port base (unused: pod "
                        "mode is not ported)")
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
    if args.pod > 1:
        raise SystemExit(f"`supervise --pod {args.pod}` {_POD}")
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
        pod=args.pod, no_elastic=args.no_elastic)
