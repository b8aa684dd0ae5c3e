"""Flight recorder: a crash-safe, append-only JSONL event log per run.

The port's copy of ``dcfm_tpu/obs/recorder.py``: the same environment
variables, file names and event schema, so either package's fits (and a
future supervisor driving either) can record into one run directory and
either package's reader replays it.

One file per (launch, process) - ``events-L<launch>.p<proc>.jsonl`` for
fit processes, ``events-supervisor.jsonl`` for the supervising parent -
inside one run directory, so a supervised pod run's whole story (every
launch of every host plus the supervisor's own decisions) lives in one
place and survives any crash that leaves the filesystem intact.

Crash-safety contract:

* the file is opened append-only and **line-buffered**: every event is
  one complete ``write()`` of one JSON line, so a SIGKILL between
  events never interleaves partial records;
* :meth:`FlightRecorder.flush` with ``fsync=True`` is called at chunk
  boundaries (and before every injected kill), so the log is durable
  up to the last boundary even through a power-cut-shaped failure;
* a **torn final line** (the one write a kill can land inside) is
  tolerated on replay: :func:`read_events` skips unparseable lines and
  counts them instead of raising.

Event schema: every record carries ``event`` (the type), ``t`` (wall
clock, ``time.time()``), ``mono`` (``time.monotonic()``, for in-process
durations), ``run`` (the run id - stable across supervised relaunches
via the ``DCFM_RUN_ID`` environment variable the supervisor exports),
``role`` (``L<launch>.p<proc>`` / ``supervisor``) and ``seq`` (per-file
sequence number), plus event-specific fields.  Events describing
completed work carry ``dur_s``; the span exporter (obs/spans.py) turns
those into Chrome trace slices.

The module-level **active recorder** (:func:`install` / :func:`record`)
is how seams deep in the stack - ``utils/checkpoint._atomic_savez``,
``resilience/faults``, ``runtime/resume`` - emit events without
threading a recorder object through every signature: ``record()`` is a
no-op costing one global read when no recorder is installed, which is
what keeps ``FitConfig.obs="off"`` free.  Installation is a stack, so
a supervisor's recorder and a nested in-process fit's recorder compose.

Everything here is stdlib-only (no numpy, no torch): a supervising
parent must never initialize the card.  Recording is host-side only:
nothing here touches a CUDA stream, event or graph.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import List, Optional

RUN_ID_ENV_VAR = "DCFM_RUN_ID"
OBS_DIR_ENV_VAR = "DCFM_OBS_DIR"
# role override for in-process fits that are NOT a supervised launch
# (e.g. supervise()'s no-op materialization resume): without it they
# would default to L1.p0 and append a second run into the launch-1
# child's event file
OBS_ROLE_ENV_VAR = "DCFM_OBS_ROLE"


class FlightRecorder:
    """Append-only JSONL event writer for one (launch, process) role.

    ``directory`` is the run directory (created if missing); ``role``
    defaults to ``L<launch>.p<process_index>`` with the launch number
    taken from ``DCFM_FAULT_LAUNCH`` (the supervisor exports it, 1
    otherwise) so relaunches never collide on a file."""

    def __init__(self, directory: str, *, run_id: Optional[str] = None,
                 role: Optional[str] = None, process_index: int = 0,
                 launch: Optional[int] = None):
        os.makedirs(directory, exist_ok=True)
        self.directory = os.path.abspath(directory)
        self.run_id = (run_id or os.environ.get(RUN_ID_ENV_VAR)
                       or uuid.uuid4().hex[:12])
        if launch is None:
            try:
                launch = int(os.environ.get("DCFM_FAULT_LAUNCH", "1"))
            except ValueError:
                launch = 1
        self.role = (role or os.environ.get(OBS_ROLE_ENV_VAR)
                     or f"L{launch}.p{int(process_index)}")
        self.path = os.path.join(self.directory,
                                 f"events-{self.role}.jsonl")
        # line-buffered append: one complete write per event, so a kill
        # between events never interleaves partial records
        self._f = open(self.path, "a", buffering=1, encoding="utf-8")
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False

    def emit(self, event: str, **fields) -> None:
        """Append one event (thread-safe: the drain worker and the
        checkpoint writer emit concurrently with the chain thread)."""
        rec = {"event": event, "t": time.time(), "mono": time.monotonic(),
               "run": self.run_id, "role": self.role}
        rec.update(fields)
        try:
            with self._lock:
                if self._closed:
                    return
                rec["seq"] = self._seq
                self._seq += 1
                self._f.write(json.dumps(rec, separators=(",", ":"),
                                         default=str) + "\n")
        except (OSError, ValueError):
            # telemetry is strictly non-invasive: a full disk or a closed
            # descriptor must never alter the run it is describing (the
            # resume gates record() right before committing a decision -
            # an emit failure there must not be mistaken for a gate
            # failure)
            pass

    def flush(self, fsync: bool = False) -> None:
        """Flush (and optionally fsync) the log - called at chunk
        boundaries and before injected kills, so the record is durable
        up to the last boundary."""
        try:
            with self._lock:
                if self._closed:
                    return
                self._f.flush()
                if fsync:
                    os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()


# ---------------------------------------------------------------------------
# the process-active recorder stack
# ---------------------------------------------------------------------------

_STACK: List[FlightRecorder] = []
_STACK_LOCK = threading.Lock()


def install(rec: FlightRecorder) -> FlightRecorder:
    """Push ``rec`` as the process-active recorder (a stack, so a
    supervisor's recorder and an in-process fit's recorder compose)."""
    with _STACK_LOCK:
        _STACK.append(rec)
    return rec


def uninstall(rec: FlightRecorder) -> None:
    """Remove ``rec`` from the active stack (idempotent)."""
    with _STACK_LOCK:
        try:
            _STACK.remove(rec)
        except ValueError:
            pass


def active() -> Optional[FlightRecorder]:
    """The innermost installed recorder, or None (the off fast path)."""
    with _STACK_LOCK:
        return _STACK[-1] if _STACK else None


def record(event: str, **fields) -> None:
    """Emit through the active recorder; a cheap no-op without one -
    which is exactly what keeps obs="off" (and every non-fit process)
    free of recording cost."""
    rec = active()
    if rec is not None:
        rec.emit(event, **fields)


def record_sync(event: str, **fields) -> None:
    """Emit + flush + fsync: for events that must survive the process
    dying IMMEDIATELY after (the fault harness calls this right before
    delivering an injected SIGKILL, so the log names the kill that is
    about to happen)."""
    rec = active()
    if rec is not None:
        rec.emit(event, **fields)
        rec.flush(fsync=True)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def read_events(path: str) -> List[dict]:
    """Parse one events file, tolerating torn lines.

    A SIGKILL (or torn write) can leave the final line incomplete; any
    unparseable line is skipped and counted on the returned list's
    ``.torn_lines`` attribute-free convention: each returned event is a
    dict, and the count of skipped lines is available via
    :func:`read_events_with_stats`."""
    events, _ = read_events_with_stats(path)
    return events


def read_events_with_stats(path: str) -> tuple:
    """-> (events, skipped_line_count).  Never raises on torn content:
    the flight recorder's value is highest exactly when the writer died
    mid-line."""
    events: List[dict] = []
    skipped = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                skipped += 1
    return events, skipped


def event_files(directory: str) -> List[str]:
    """Every ``events-*.jsonl`` in a run directory, sorted by name."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.startswith("events-") and f.endswith(".jsonl"))


def run_events(directory: str) -> List[dict]:
    """All events of a run directory, merged across roles and ordered
    by wall clock (``t``, then per-file ``seq``).  Wall clock is the
    only timebase comparable across processes; ``mono`` stays useful
    for in-process durations."""
    return run_events_with_stats(directory)[0]


def run_events_with_stats(directory: str) -> tuple:
    """-> (merged ordered events, total skipped/torn line count) in ONE
    pass over the files - the events CLI summarizes multi-launch pod
    logs, so the parse should happen once, not once per consumer."""
    out: List[dict] = []
    skipped = 0
    for p in event_files(directory):
        evs, bad = read_events_with_stats(p)
        out.extend(evs)
        skipped += bad
    out.sort(key=lambda e: (e.get("t", 0.0), e.get("seq", 0)))
    return out, skipped


def tail_events(directory: str, n: int = 5,
                launch: Optional[int] = None) -> List[dict]:
    """The last ``n`` events of a run (optionally restricted to the
    fit processes of one launch) - the supervisor's post-mortem quotes
    these in its typed errors, so "the child died" comes with the five
    things the child last did."""
    evs = run_events(directory)
    if launch is not None:
        prefix = f"L{int(launch)}."
        evs = [e for e in evs
               if str(e.get("role", "")).startswith(prefix)]
    return evs[-n:]
