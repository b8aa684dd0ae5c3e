"""Microbatcher: coalesce concurrent entry queries by target panel.

The port's copy of ``dcfm_tpu/serve/batcher.py`` over the port's
:class:`~dcfm_tpu_torch.serve.engine.QueryEngine`: one batch is one
device gather per panel and one copy to the host.

Under concurrent load many independent ``/v1/entry`` requests touch the
same int8 panel; dequantizing it once per request wastes the panel
cache's lock and, on a cache miss, the P x P dequant itself.  The
batcher funnels requests through a BOUNDED queue into one worker that
drains whatever has accumulated, hands the whole batch to
``QueryEngine.entries`` (which groups by panel - one dequant serves
every rider), and wakes the callers.

Overload discipline - the part that matters at "millions of users":

* the queue is bounded; a full queue REJECTS the request immediately
  with :class:`Overloaded` (a retry-with-backoff signal the HTTP layer
  maps to 429 + ``Retry-After``) instead of growing without bound or
  block-queueing the accept threads;
* every request carries a deadline; requests that expire while queued
  are dropped with :class:`DeadlineExceeded` (504), not served late -
  serving a request whose client already gave up only digs the
  overload hole deeper;
* a stopped batcher raises :class:`BatcherClosed` - an
  :class:`Overloaded` subtype, because during an artifact hot-swap the
  old batcher drains while the new one takes over, and a request that
  raced the swap should be told "retry" (it will land on the new
  engine), never handed an untyped 500;
* the worker is a NON-daemon thread joined by :meth:`close` (dcfm-lint
  DCFM501/502 discipline: a daemon thread still inside numpy at
  interpreter teardown aborts the process).

Counters live in a :class:`~dcfm_tpu_torch.obs.metrics.MetricsRegistry`,
not ad-hoc ints: pass the server's registry and the counters
survive a hot-swap batcher replacement (get-or-create registration
returns the same ``Counter`` to the successor batcher), so fleet
dashboards see one monotonic series across artifact generations.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

from dcfm_tpu_torch.obs.metrics import MetricsRegistry
from dcfm_tpu_torch.serve.engine import QueryEngine


class Overloaded(RuntimeError):
    """Queue full: explicit backpressure - retry with backoff."""


class BatcherClosed(Overloaded):
    """The batcher stopped (drain or hot-swap) - retry; a successor
    engine is (or will shortly be) serving."""


class DeadlineExceeded(RuntimeError):
    """The request expired before the worker reached it."""


@dataclasses.dataclass
class _Request:
    i: int
    j: int
    destandardize: bool
    deadline: float
    event: threading.Event
    value: Optional[float] = None
    error: Optional[BaseException] = None


class QueryBatcher:
    """Panel-coalescing request funnel over one :class:`QueryEngine`."""

    def __init__(self, engine: QueryEngine, *, max_queue: int = 1024,
                 max_batch: int = 256, default_timeout: float = 2.0,
                 registry: Optional[MetricsRegistry] = None):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.default_timeout = float(default_timeout)
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.registry = MetricsRegistry() if registry is None else registry
        self._requests = self.registry.counter(
            "dcfm_serve_batcher_requests_total",
            "Batcher requests by outcome", labels=("outcome",))
        self._batches = self.registry.counter(
            "dcfm_serve_batcher_batches_total", "Batches drained")
        self.max_batch_seen = 0
        self._worker = threading.Thread(target=self._loop,
                                        name="dcfm-serve-batcher")
        self._worker.start()

    # -- client side ---------------------------------------------------
    def entry(self, i: int, j: int, *, destandardize: bool = True,
              timeout: Optional[float] = None) -> float:
        """Blocking entry query through the batch queue.

        Raises :class:`Overloaded` immediately when the queue is full
        (the caller should retry with backoff), :class:`BatcherClosed`
        when the batcher already stopped (same contract: retry), and
        :class:`DeadlineExceeded` when the request expired before the
        worker reached it.
        """
        if self._stop.is_set():
            raise BatcherClosed("batcher is closed - retry")
        timeout = self.default_timeout if timeout is None else float(timeout)
        req = _Request(i=int(i), j=int(j),
                       destandardize=bool(destandardize),
                       deadline=time.monotonic() + timeout,
                       event=threading.Event())
        self._requests.inc(outcome="submitted")
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._requests.inc(outcome="rejected")
            raise Overloaded(
                f"query queue full ({self._q.maxsize} pending) - retry "
                "with backoff") from None
        # grace past the deadline: the worker drops expired requests
        # itself; this wait only bounds a wedged worker
        if not req.event.wait(timeout + 1.0):
            raise DeadlineExceeded(f"no result within {timeout:.3f}s")
        if req.error is not None:
            raise req.error
        return req.value

    # -- worker side ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline < now:
                    r.error = DeadlineExceeded(
                        "request expired in the batch queue")
                    r.event.set()
                else:
                    live.append(r)
            self._batches.inc()
            if len(batch) > len(live):
                self._requests.inc(len(batch) - len(live), outcome="expired")
            with self._lock:
                self.max_batch_seen = max(self.max_batch_seen, len(batch))
            if not live:
                continue
            try:
                vals = self.engine.entries(
                    [(r.i, r.j, r.destandardize) for r in live])
            except BaseException as e:   # one bad index fails its batch
                for r in live:
                    r.error = e
                    r.event.set()
                continue
            self._requests.inc(len(live), outcome="served")
            for r, v in zip(live, vals):
                r.value = v
                r.event.set()

    def close(self) -> None:
        """Stop accepting, drain the queue, join the worker."""
        self._stop.set()
        self._worker.join()
        # anything still queued after the join was never reached: fail it
        # with the typed retry signal rather than leaving callers blocked
        # until their timeout (during a hot-swap the successor serves it)
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.error = BatcherClosed("batcher closed before serving - retry")
            r.event.set()

    def _count(self, outcome: str) -> int:
        return int(self._requests.value(outcome=outcome))

    def stats(self) -> dict:
        with self._lock:
            max_seen = self.max_batch_seen
        return {
            "submitted": self._count("submitted"),
            "served": self._count("served"),
            "rejected": self._count("rejected"),
            "expired": self._count("expired"),
            "batches": int(self._batches.value()),
            "max_batch_seen": max_seen,
            "queue_depth": self._q.qsize(),
            "queue_capacity": self._q.maxsize,
        }
