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
  ``health_trace``; and ``gig``, the GIG sampler (ops/gig.py), a stage
  nested in ``prior_update`` of the Dirichlet-Laplace prior.

A graph replay shows none of the ranges opened while its trip was
captured.  So while a profiler records, the chain runner captures each
trip twice: as the fit would without a profiler, and as a twin that
carries a :class:`StageClock`, a timing event recorded on the capturing
stream at every stage boundary, which the capture turns into event-record
nodes of the graph.  Each pattern's first trip in a chunk replays the
twin; read after the chunk's end, its events give the device time of
each stage (:class:`StageTally` sums those samples into
``FitResult.graphs``).  A stage opened inside another is timed under its
own label and counts into the enclosing stage's time too.  The twin may
also count the GIG sampler's draws and rejection rounds
(:meth:`StageClock.count_gig`), summed on the device and read with its
events.  Every other replay is the untimed graph, and a fit with no
profiler recording captures no twin: its graphs are the graphs captured
without any of this.
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
# the GIG sampler's counters (ops/gig.py; FitResult.graphs["gig"])
GIG_COUNTS = ("draws", "rounds_evaluated", "rounds_needed", "unaccepted")

_OFF = contextlib.nullcontext()


class _Active(threading.local):
    clock: Optional["StageClock"] = None   # the trip being timed here


_ACTIVE = _Active()


def timing_clock() -> Optional["StageClock"]:
    """The clock of the timed twin being captured on this thread, or None
    (every other trip, and every fit with no profiler recording)."""
    return _ACTIVE.clock


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
    A stage opened inside an open one marks its own bounds and, when it
    closes, hands the clock back to the enclosing stage; ``nested`` maps
    such a stage to the stages enclosing it.  ``event`` makes the events
    (:func:`timing_event`); anything with ``record()`` and
    ``elapsed_time(other)`` in ms will do.  The GIG's counters add up on
    ``device`` in a tensor made here, before the capture: a tensor the
    capture made would lie in the graph pool the runner's graphs share,
    where the next replay of another graph writes over it."""

    def __init__(self, sweeps: int, saves: int,
                 event: Callable = timing_event, device=None):
        self.sweeps, self.saves = sweeps, saves
        self._event = event
        self.marks: list = []
        self.nested: dict = {}
        self._open: list = []      # the stages open now, innermost last
        self._gig = torch.zeros((len(GIG_COUNTS),), dtype=torch.int64,
                                device=device)
        self._gig_counted = False  # whether the trip runs the GIG

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
            if self._open:
                self.nested[name] = tuple(self._open)
            self._open.append(name)
            self.mark(name)
            yield
            self._open.pop()
            self.mark(self._open[-1] if self._open else OTHER)

    def count_gig(self, values: torch.Tensor) -> None:
        """One GIG call's counts, in :data:`GIG_COUNTS`' order, added on
        the device, so every call and every replay adds up until
        :meth:`gig_counts` reads them."""
        self._gig.add_(values)
        self._gig_counted = True

    def intervals(self) -> dict:
        """Device ms of each label over the last replay, a nested stage's
        under its own label and under each stage enclosing it: call once
        the replay's work is done (its events are then complete)."""
        out: dict = {}
        for (label, a), (_, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b)
            for key in (label,) + self.nested.get(label, ()):
                out[key] = out.get(key, 0.0) + ms
        return out

    def gig_counts(self) -> dict:
        """The GIG's counts since the last read by name ({} where the trip
        runs no GIG), then zeroed on the current stream: call once the
        replays' work is done."""
        if not self._gig_counted:
            return {}
        counts = dict(zip(GIG_COUNTS, self._gig.tolist()))
        self._gig.zero_()
        return counts


class StageTally:
    """Sampled stage times summed over replays: ``means()`` is the mean
    device ms a sweep of each stage over the sampled replays that ran it,
    the combine's a saved draw; ``samples`` counts the replays read;
    ``gig`` sums the clocks' GIG counts ({} where no GIG ran)."""

    def __init__(self):
        self.ms: dict = {}
        self.per: dict = {}
        self.samples = 0
        self.gig: dict = {}

    def _add_gig(self, counts: dict) -> None:
        for name, v in counts.items():
            self.gig[name] = self.gig.get(name, 0) + v

    def add(self, clock: StageClock) -> None:
        for label, ms in clock.intervals().items():
            n = clock.saves if label == "combine" else clock.sweeps
            self.ms[label] = self.ms.get(label, 0.0) + ms
            self.per[label] = self.per.get(label, 0) + n
        self._add_gig(clock.gig_counts())
        self.samples += 1

    def merge(self, other: "StageTally") -> None:
        for label, ms in other.ms.items():
            self.ms[label] = self.ms.get(label, 0.0) + ms
            self.per[label] = self.per.get(label, 0) + other.per[label]
        self._add_gig(other.gig)
        self.samples += other.samples

    def means(self) -> dict:
        return {label: ms / self.per[label] for label, ms in self.ms.items()}
