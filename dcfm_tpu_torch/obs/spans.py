"""Span traces from flight-recorder events: Chrome trace-event JSON.

The port's copy of ``dcfm_tpu/obs/spans.py`` (for equal events the trace
and the overlap fraction are equal, value for value).

The flight recorder's events carry wall-clock timestamps and, for
completed work, durations (``dur_s``).  This module turns a run
directory's merged event stream into the Chrome trace-event format that
Perfetto / ``chrome://tracing`` load directly, with one track (pid/tid)
per process and concern:

* the **chain** track holds the chunk slices;
* the **stream-drain** track holds the double-buffered fetch drains -
  loading the trace is how "the drain hides behind compute" stops
  being an assertion and becomes a picture (the drain slices visibly
  overlap the next chunk's slice);
* the **checkpoint** track holds the write-behind saves;
* the supervisor gets its own process row (launches, deaths, backoff).

Everything without a duration (faults, rewinds, resume decisions,
deaths) becomes an instant event on the owning track, so a post-mortem
trace shows exactly where in the timeline the injected kill or the
sentinel trip landed.

Cross-process alignment uses the wall clock (``t``) - the only
timebase comparable across processes; durations come from the emitting
process's own measurement, so slice widths are exact even if wall
clocks drift a little.

:func:`overlap_fraction` is the stream-overlap summary: drain time
hidden behind other work / total drain time.  It prefers the
``fit_done`` event's accounting (exact - the pipeline measures the
exposed join wall directly); absent that it falls back to geometric
overlap of drain slices against chunk slices.
"""

from __future__ import annotations

import json
from typing import List, Optional

# event -> (tid, thread name) inside the owning process's track group
_SPAN_TRACKS = {
    "chunk": (1, "chain"),
    "stream_drain": (2, "stream-drain"),
    "checkpoint_save": (3, "checkpoint-writer"),
    "artifact_write": (3, "checkpoint-writer"),
}
_DEFAULT_TRACK = (4, "events")
_SUPERVISOR_PID = 9999


def _role_pid(role: str) -> int:
    """Stable pid per (launch, process) role: launch-1 procs 0..15 get
    pids 0..15, launch 2 gets 100.., the supervisor its own row."""
    if role == "supervisor":
        return _SUPERVISOR_PID
    if role.startswith("L") and ".p" in role:
        try:
            launch_s, proc_s = role[1:].split(".p", 1)
            return (int(launch_s) - 1) * 100 + int(proc_s)
        except ValueError:
            pass
    return hash(role) % 1000 + 1000


def chrome_trace(events: List[dict]) -> dict:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
    format) from a merged event list (obs.recorder.run_events)."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e.get("t", 0.0) for e in events)
    out = []
    seen_tracks = set()
    for e in events:
        role = str(e.get("role", "?"))
        pid = _role_pid(role)
        name = e.get("event", "?")
        tid, tname = _SPAN_TRACKS.get(name, _DEFAULT_TRACK)
        if (pid, 0) not in seen_tracks:
            seen_tracks.add((pid, 0))
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": f"dcfm {role}"}})
        if (pid, tid) not in seen_tracks:
            seen_tracks.add((pid, tid))
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        args = {k: v for k, v in e.items()
                if k not in ("t", "mono", "seq", "event")}
        dur_s = e.get("dur_s")
        end_us = (e.get("t", t0) - t0) * 1e6
        if isinstance(dur_s, (int, float)) and dur_s >= 0:
            # events record completion; the slice starts dur_s earlier
            out.append({"ph": "X", "name": name, "pid": pid, "tid": tid,
                        "ts": max(0.0, end_us - dur_s * 1e6),
                        "dur": dur_s * 1e6, "args": args})
        else:
            out.append({"ph": "i", "name": name, "pid": pid, "tid": tid,
                        "ts": end_us, "s": "t", "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: List[dict], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(events), f)


def _intervals(events: List[dict], name: str, role: str) -> list:
    out = []
    for e in events:
        if e.get("event") != name or e.get("role") != role:
            continue
        dur = e.get("dur_s")
        if not isinstance(dur, (int, float)) or dur <= 0:
            continue
        end = e.get("t", 0.0)
        out.append((end - dur, end))
    return out


def _overlap(iv: tuple, others: list) -> float:
    s, e = iv
    covered = 0.0
    cursor = s
    for os_, oe in sorted(others):
        if oe <= cursor:
            continue
        if os_ >= e:
            break
        covered += min(e, oe) - max(cursor, os_)
        cursor = max(cursor, min(e, oe))
    return covered


def overlap_fraction(events: List[dict]) -> Optional[float]:
    """Drain time hidden behind compute / total drain time, in [0, 1].

    Prefers the exact accounting recorded in the newest ``fit_done``
    event (``stream.overlap_fraction`` - computed by the pipeline from
    the measured exposed join wall); falls back to geometric overlap of
    ``stream_drain`` slices against the same role's ``chunk`` slices.
    None when the run never streamed."""
    for e in reversed(events):
        if e.get("event") == "fit_done":
            stream = e.get("stream") or {}
            ov = stream.get("overlap_fraction")
            if isinstance(ov, (int, float)):
                return float(ov)
    total = hidden = 0.0
    roles = {e.get("role") for e in events
             if e.get("event") == "stream_drain"}
    for role in roles:
        chunks = _intervals(events, "chunk", role)
        for iv in _intervals(events, "stream_drain", role):
            total += iv[1] - iv[0]
            hidden += _overlap(iv, chunks)
    if total <= 0:
        return None
    return max(0.0, min(1.0, hidden / total))
