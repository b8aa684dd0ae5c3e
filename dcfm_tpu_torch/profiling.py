"""The fit's profiler ranges and the sweep's stage timers.

One helper, :func:`scope`, names the fit's work on a ``torch.profiler``
trace: while a profiler records it opens a ``record_function`` range,
otherwise it costs one flag check and allocates nothing.  The ranges are
host events of the profiler, on the clock of the device activities it
traces beside them, so a reader of the trace can name each of the
device's idle gaps by the range the host was in.  The names:

* the fit's phases (api.py, runtime/pipeline.py, runtime/fetch.py):
  ``api.preprocess``, ``api.upload``, ``api.init``, ``api.chain`` (the
  chunk loop), ``api.fetch`` (the post-hoc fetch, or the streamed
  fetch's join), ``api.assemble``; those timed into
  ``FitResult.phase_seconds`` are timed by :class:`Phase`, so the range
  and the clock cover one extent;
* the chain's steps inside ``api.chain`` (models/sampler.ChainRunner,
  runtime/pipeline.run_chain): ``api.chain.draw`` (a trip's iteration
  tensor and its variates drawn outside the graph), ``api.chain.replay.
  save`` / ``api.chain.replay.plain`` (a graph replay of a trip that
  saves a draw or does not, with its trace-row copy), ``api.chain.eager``
  (a trip run eagerly), ``api.chain.capture``, ``api.chain.boundary``
  (a chunk's end: health, ranks and the accumulator's finiteness read),
  ``api.chain.stream`` (the streamed fetch's submit) and
  ``api.chain.checkpoint``;
* the sweep's stages, the JAX package's named scopes: ``impute_missing``,
  ``z_update``, ``x_update``, ``lambda_update``, ``prior_update``,
  ``ps_update``, then ``adapt_rank``, ``combine`` (a saved draw's) and
  ``health_trace``.

A graph replay shows none of the ranges opened while its trip was
captured.  So while a profiler records, the chain runner captures each
trip twice: as the fit would without a profiler, and as a twin that
carries a :class:`StageClock`, a timing event recorded on the capturing
stream at every stage boundary, which the capture turns into event-record
nodes of the graph.  Each pattern's first trip in a chunk replays the
twin; read after the chunk's end, its events give the device time of
each stage (:class:`StageTally` sums those samples into
``FitResult.graphs``).  Every other replay is the untimed graph, and a
fit with no profiler recording captures no twin: its graphs are the
graphs captured without any of this.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

import torch

# the label of the device time between the sweep's stages: a trip's first
# and last operations, the carry copy-back
OTHER = "other"

_OFF = contextlib.nullcontext()


class _Active(threading.local):
    clock: Optional["StageClock"] = None   # the trip being timed here


_ACTIVE = _Active()


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process."""
    return torch.autograd._profiler_enabled()


def scope(name: str, on: Optional[bool] = None):
    """The profiler's range ``name`` while a profiler records, else a
    shared empty context.  A host-side marker: it launches nothing, so a
    CUDA graph captured through it is the graph captured without it.
    ``on`` is the caller's own :func:`recording` check, made once for
    several ranges.  Without it, inside :meth:`StageClock.timing` (the
    capture of a trip's timed twin) the range also stamps the stage's
    start and end on the device (:meth:`StageClock.stage`)."""
    if on is None:
        clock = _ACTIVE.clock
        if clock is not None:
            return clock.stage(name)
        on = recording()
    return torch.profiler.record_function(name) if on else _OFF


class Phase:
    """A phase of the fit: the range ``name`` (:func:`scope`), and, with
    ``seconds`` (``FitResult.phase_seconds``) and ``key``, its host
    seconds added to ``seconds[key]``.  A ``with`` block, or
    :meth:`start` ... :meth:`stop` around a block too long to indent."""

    def __init__(self, name: str, seconds: Optional[dict] = None,
                 key: Optional[str] = None):
        self._range = scope(name)
        self._seconds, self._key = seconds, key
        self._t = 0.0

    def start(self) -> "Phase":
        self._range.__enter__()
        self._t = time.perf_counter()
        return self

    def stop(self) -> None:
        if self._seconds is not None:
            self._seconds[self._key] = (self._seconds.get(self._key, 0.0)
                                        + time.perf_counter() - self._t)
        self._range.__exit__(None, None, None)

    def __enter__(self) -> "Phase":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def timing_event():
    """A CUDA timing event that a stream capture records as a node of
    the graph (``external``), so every replay records it."""
    return torch.cuda.Event(enable_timing=True, external=True)


class StageClock:
    """The stage boundaries of one captured trip: ``marks`` holds (the
    stage that starts here, its event) in capture order, from the trip's
    first device operation to its last, so the intervals tile the trip.
    ``event`` makes the events (:func:`timing_event`); anything with
    ``record()`` and ``elapsed_time(other)`` in ms will do."""

    def __init__(self, sweeps: int, saves: int,
                 event: Callable = timing_event):
        self.sweeps, self.saves = sweeps, saves
        self._event = event
        self.marks: list = []

    def mark(self, label: Optional[str]) -> None:
        """A boundary on the current stream: ``label`` runs from here to
        the next mark (None: the trip's end)."""
        ev = self._event()
        ev.record()
        self.marks.append((label, ev))

    @contextlib.contextmanager
    def timing(self):
        """The trip inside, from its first device operation to its last:
        the stage ranges it opens on this thread (:func:`scope`) stamp
        their bounds on this clock."""
        before, _ACTIVE.clock = _ACTIVE.clock, self
        try:
            self.mark(OTHER)
            yield
            self.mark(None)
        finally:
            _ACTIVE.clock = before

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(name):
            self.mark(name)
            yield
            self.mark(OTHER)

    def intervals(self) -> dict:
        """Device ms of each label over the last replay: call once the
        replay's work is done (its events are then complete)."""
        out: dict = {}
        for (label, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[label] = out.get(label, 0.0) + a.elapsed_time(b)
        return out


class StageTally:
    """Sampled stage times summed over replays: ``means()`` is the mean
    device ms a sweep of each stage over the sampled replays that ran it,
    the combine's a saved draw; ``samples`` counts the replays read."""

    def __init__(self):
        self.ms: dict = {}
        self.per: dict = {}
        self.samples = 0

    def add(self, clock: StageClock) -> None:
        for label, ms in clock.intervals().items():
            n = clock.saves if label == "combine" else clock.sweeps
            self.ms[label] = self.ms.get(label, 0.0) + ms
            self.per[label] = self.per.get(label, 0) + n
        self.samples += 1

    def merge(self, other: "StageTally") -> None:
        for label, ms in other.ms.items():
            self.ms[label] = self.ms.get(label, 0.0) + ms
            self.per[label] = self.per.get(label, 0) + other.per[label]
        self.samples += other.samples

    def means(self) -> dict:
        return {label: ms / self.per[label] for label, ms in self.ms.items()}
