"""Stdlib-only JSON HTTP server over the posterior query engine.

The port's copy of ``dcfm_tpu/serve/server.py``: the same routes, status
codes, JSON bodies, generation header and Prometheus families, over the
port's engine on ``device`` (the card unless the caller asks for the
CPU).  The one addition is a ``device`` key in ``/healthz`` and in
:func:`serve_main`'s startup line, naming where the panels live
(``"cpu"``, or ``"cuda:0 (<the card's name>)"``); the ``serve_swap``
flight-recorder event also carries the swap's seconds (``swap_s``).

``ThreadingHTTPServer`` + ``BaseHTTPRequestHandler`` - no framework, no
dependency the container doesn't already have.  Endpoints:

* ``GET /v1/entry?i=..&j=..[&destandardize=0]`` - one covariance entry,
  routed through the microbatcher (concurrent requests touching the
  same panel share one dequant).  429 + ``retry: true`` under
  backpressure, 504 when the request expires in the queue.
* ``GET /v1/block?rows=..&cols=..`` - a sub-block; ``rows``/``cols``
  are comma lists (``0,5,7``) and/or half-open ranges (``10:20``).
* ``GET /v1/interval?i=..&j=..[&alpha=0.05]`` - normal-approximation
  credible interval from the mean and posterior-SD panels.
* ``GET /healthz`` - liveness + mode: ``ok`` when the native assembler
  is loadable, ``degraded`` when it is not (``DCFM_NATIVE_DISABLE=1``
  or no compiler) - no query path uses the assembler, so every query
  keeps working in degraded mode; the flag exists so a fleet can see
  it.  ``draining``
  once shutdown began.  Under a fleet supervisor the payload also
  carries this worker's ``{index, pid}``, the promotion pointer's
  current generation, and the supervisor's fleet-wide liveness table.
* ``GET /metrics`` - per-endpoint latency histograms (p50/p99 + bucket
  counts), panel-cache hit/miss/eviction counters, batcher queue stats,
  hot-swap + load-shed counters, and the served artifact's
  fingerprint + generation tag.
* ``GET /metrics?format=prometheus`` - the same metrics in Prometheus
  text exposition format (0.0.4), rendered from the unified registry
  (``obs/metrics.py``) the latency histograms live on - plus
  the process default registry, so an embedded fit's progress gauges
  ride the same scrape.

Every query response carries the ``X-DCFM-Artifact-Generation`` header.
The generation, engine, batcher, and artifact travel TOGETHER in one
immutable ``_Epoch`` swapped by a single reference assignment: a
request reads the epoch once and answers entirely from it, so the
header always names the artifact that actually produced the bytes, and
per-client generations are monotonically non-decreasing across a
hot-swap (the epoch pointer only moves forward).

Hot-swap: when constructed on a *promotion root* (a directory with a
``CURRENT`` pointer - see ``serve/promote.py``) the server watches the
pointer with a cheap ``os.stat`` probe (time-gated per request, or
forced by SIGHUP), fully CRC-verifies the candidate, and installs a
new epoch; in-flight requests finish on the old engine (the old
batcher drains after the flip), and a torn/corrupt/mismatched
candidate is REFUSED with a typed ``serve_swap_refused`` event while
the old artifact keeps serving.

Tiered load-shedding: under queue or latency pressure (batcher fill
with hysteresis, windowed entry p99 against the deadline budget) the
EXPENSIVE routes - ``/v1/block``, ``/v1/interval`` - shed first with a
typed 503 + jittered ``Retry-After``; ``/v1/entry`` and ``/healthz``
stay up (the batcher's own bounded queue protects entry with 429s).

Slow-client discipline: every connection gets a read AND write socket
timeout (``io_timeout``), so a slow-loris client parks a handler
thread for at most that long instead of forever - ``block_on_close``
joins handler threads at drain, so an unbounded read would otherwise
stall SIGTERM shutdown fleet-wide.

Shutdown discipline (dcfm-lint DCFM503): ``shutdown()`` +
``server_close()`` always run on the exit path - ``run()`` installs
SIGTERM/SIGINT handlers that trigger a graceful drain (stop accepting,
finish in-flight requests, then close the batcher's worker).
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from dcfm_tpu_torch import native
from dcfm_tpu_torch.obs import metrics as obs_metrics
from dcfm_tpu_torch.obs import recorder as obs_recorder
from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.resilience.faults import fault_event
from dcfm_tpu_torch.serve.artifact import (
    MAPS_FILE, ArtifactCorruptError, ArtifactError, PosteriorArtifact)
from dcfm_tpu_torch.serve.batcher import (
    BatcherClosed, DeadlineExceeded, Overloaded, QueryBatcher)
from dcfm_tpu_torch.serve.engine import (
    QueryEngine, device_label, resolve_device)
from dcfm_tpu_torch.serve.promote import (
    PointerError, is_pointer_root, pointer_stat, read_pointer,
    verify_candidate)

MAX_BLOCK_ENTRIES = 1 << 20       # 4 MB of float32 per response, maximum
GENERATION_HEADER = "X-DCFM-Artifact-Generation"
# hot-set pre-warmer (online loop): how many of the previous engine's
# hottest panels are dequantized into a new engine before it serves
PREWARM_LIMIT = 64
HOTSET_SUFFIX = ".hotset.json"


def _hotset_path(artifact_path: str) -> str:
    """The hot-set file lives BESIDE the artifact directory (one per
    generation, e.g. ``root/v2.hotset.json``) - never inside it, where
    an extra file would muddy the finalized, CRC-recorded layout."""
    return artifact_path.rstrip(os.sep) + HOTSET_SUFFIX


def _load_hotset(artifact_path: str) -> list:
    """Persisted hot set -> [(kind, pair), ...]; absent/torn -> []."""
    try:
        with open(_hotset_path(artifact_path), "r", encoding="utf-8") as f:
            return [(str(k), int(p)) for k, p in json.load(f)]
    except (OSError, ValueError, TypeError):
        return []


def _save_hotset(artifact_path: str, keys: list) -> None:
    """Best-effort tmp+replace write (a torn hot set only costs a cold
    cache, never a wrong answer)."""
    path = _hotset_path(artifact_path)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump([[str(k), int(p)] for k, p in keys], f)
        os.replace(tmp, path)
    except OSError:
        pass


class _BadRequest(ValueError):
    pass


_BUCKET_BOUNDS_MS = (0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                     250.0, 1000.0, float("inf"))


class LatencyHistogram:
    """Per-route latency view over the unified metrics registry
    (obs/metrics.Histogram).  The storage moved to the registry - which
    is what Prometheus exposition renders - while this class keeps the
    HISTORICAL JSON ``/metrics`` readout byte-for-byte: same keys, same
    rounding, same bucket-upper-bound percentile rule."""

    def __init__(self, hist: obs_metrics.Histogram, route: str):
        self._hist = hist
        self._route = route

    def record(self, ms: float) -> None:
        self._hist.observe(ms, route=self._route)

    def snapshot(self) -> dict:
        counts, n, sum_ms = self._hist.data(route=self._route)
        if n == 0:
            return {"count": 0}
        return {
            "count": n,
            "mean_ms": round(sum_ms / n, 4),
            "p50_ms": self._hist.percentile(0.50, route=self._route),
            "p99_ms": self._hist.percentile(0.99, route=self._route),
            "buckets_ms": {
                ("inf" if b == float("inf") else str(b)): c
                for b, c in zip(_BUCKET_BOUNDS_MS, counts)},
        }


def _parse_indices(spec: str, p: int) -> list:
    """'0,5,7' and/or half-open ranges '10:20' -> index list."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            lo_s, hi_s = part.split(":", 1)
            lo = int(lo_s) if lo_s else 0
            hi = int(hi_s) if hi_s else p
            if not (0 <= lo <= hi <= p):
                raise _BadRequest(f"range {part!r} out of [0, {p}]")
            out.extend(range(lo, hi))
        else:
            v = int(part)
            if not 0 <= v < p:
                raise _BadRequest(f"index {v} out of [0, {p})")
            out.append(v)
    if not out:
        raise _BadRequest("empty index list")
    return out


class _Epoch:
    """One servable generation: artifact + engine + batcher + tag.

    Immutable after construction and swapped by a single reference
    assignment, so any request that read the epoch once answers
    consistently - the value, the error type, and the generation header
    all come from the same artifact even while a hot-swap lands."""

    __slots__ = ("artifact", "engine", "batcher", "generation")

    def __init__(self, artifact, engine, batcher, generation):
        self.artifact = artifact
        self.engine = engine
        self.batcher = batcher
        self.generation = generation


class _Handler(BaseHTTPRequestHandler):
    server_version = "dcfm-serve/1"
    protocol_version = "HTTP/1.1"
    # fallback socket timeout; setup() overrides it per connection from
    # the server's io_timeout knob
    timeout = 10

    def setup(self):
        # per-connection read AND write timeout: settimeout covers both
        # directions, so neither a slow-loris request (drip-fed header)
        # nor a stuffed client that never drains our response can park
        # this handler thread past the bound - block_on_close joins
        # handler threads at drain, so an unbounded socket op here would
        # stall SIGTERM shutdown fleet-wide
        self.timeout = self.server.io_timeout
        super().setup()

    def log_message(self, fmt, *args):   # latency lives in /metrics
        pass

    def do_GET(self):                    # noqa: N802 (stdlib API name)
        app = self.server.app
        # chaos seam: a kill_event here is "worker SIGKILLed mid-request"
        fault_event("serve_request")
        parts = urlsplit(self.path)
        t0 = time.perf_counter()
        status, payload, headers = app.handle(parts.path,
                                              parse_qs(parts.query))
        app.observe(parts.path, status,
                    (time.perf_counter() - t0) * 1e3)
        if isinstance(payload, str):
            # Prometheus text exposition (format 0.0.4), not JSON
            body = payload.encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            body = json.dumps(payload).encode()
            ctype = "application/json"
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            # generation-tagged responses: which posterior generation
            # answered.  handle() pins it to the epoch that computed the
            # payload; the fallback covers string payloads (Prometheus).
            gen = headers.pop(GENERATION_HEADER, str(app.generation))
            self.send_header(GENERATION_HEADER, gen)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except OSError as e:
            # slow or vanished client (socket timeout / reset while we
            # wrote): drop the CONNECTION, never the handler thread
            app.client_aborted(repr(e))
            self.close_connection = True


class _Httpd(ThreadingHTTPServer):
    # non-daemon handler threads + block_on_close: server_close() joins
    # every in-flight request - the graceful-drain half of DCFM503.
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True
    # the listen backlog (socketserver's default is 5): a burst of new
    # connections past it has its SYNs dropped and retried by the client
    # a second later, which shows up as a 1 s latency tail
    request_queue_size = 128
    app = None
    io_timeout = 10.0
    reuse_port = False

    def server_bind(self):
        if self.reuse_port and hasattr(socket, "SO_REUSEPORT"):
            # fleet mode: N workers bind+listen the same port and the
            # kernel load-balances accepted connections across them
            self.socket.setsockopt(socket.SOL_SOCKET,
                                   socket.SO_REUSEPORT, 1)
        super().server_bind()


class PosteriorServer:
    """The servable unit: artifact -> engine -> batcher -> HTTP."""

    def __init__(self, artifact, *, host: str = "127.0.0.1", port: int = 0,
                 cache_bytes: int = 256 << 20, max_queue: int = 1024,
                 max_batch: int = 256, request_timeout: float = 2.0,
                 io_timeout: float = 10.0, reuse_port: bool = False,
                 swap_poll: float = 0.5, shed_high: float = 0.75,
                 shed_low: float = 0.50, worker_index=None,
                 swap_adopt: str = "auto", device=None):
        if swap_adopt not in ("auto", "off"):
            raise ValueError(
                f"swap_adopt must be 'auto' or 'off', got {swap_adopt!r}")
        # every generation's engine keeps its panels on this device
        self.device = resolve_device(device)
        self.device_label = device_label(self.device)
        # "auto": a hot-swap adopts the old epoch's memmaps (and its
        # dequantized cache) for pairs the CRC tables prove unchanged,
        # so re-warm work scales with changed-and-hot, not p^2.  "off"
        # re-opens every panel from the new artifact - the pre-adoption
        # behavior, kept as an operational escape hatch.
        self._swap_adopt = swap_adopt
        self._cache_bytes = int(cache_bytes)
        self._max_queue = int(max_queue)
        self._max_batch = int(max_batch)
        self._request_timeout = float(request_timeout)
        self.worker_index = worker_index
        # promotion-root mode: the path holds a CURRENT pointer naming
        # the live artifact; the server opens the target and watches the
        # pointer for hot-swaps.  A bare artifact path serves statically.
        self._pointer_root = None
        self._ptr_stat = None
        self._swap_refused_stat = None
        generation = 0
        if isinstance(artifact, str):
            if is_pointer_root(artifact):
                self._pointer_root = artifact
                ptr = read_pointer(artifact)
                generation = ptr.generation
                self._ptr_stat = ptr.stat
                artifact = PosteriorArtifact.open(ptr.path)
            else:
                artifact = PosteriorArtifact.open(artifact)
        # Unified metrics registry (obs/metrics.py): latency
        # histograms, per-status counts, batcher counters, swap/shed
        # counters all live here; cache/batcher snapshots are pull
        # gauges sampled at scrape time.  One registry PER SERVER (two
        # servers in one process never collide); the Prometheus renderer
        # appends the process default registry so an embedded fit's
        # progress gauges ride the same scrape.
        self.metrics = obs_metrics.MetricsRegistry()
        engine = QueryEngine(artifact, cache_bytes=self._cache_bytes,
                             device=self.device)
        # pre-warm from this generation's persisted hot set (written by
        # the worker that served it last): a restarted worker answers
        # its first requests from warm panels instead of dequant misses
        self._prewarmed = engine.prewarm(_load_hotset(artifact.path))
        # bind BEFORE starting the batcher's non-daemon worker: a bind
        # failure (port in use) must raise out of __init__ with no
        # orphaned thread keeping the process alive past the traceback
        self._httpd = _Httpd((host, port), _Handler,
                             bind_and_activate=False)
        self._httpd.app = self
        self._httpd.io_timeout = float(io_timeout)
        self._httpd.reuse_port = bool(reuse_port)
        try:
            self._httpd.server_bind()
            self._httpd.server_activate()
        except BaseException:
            self._httpd.server_close()
            raise
        try:
            batcher = QueryBatcher(engine, max_queue=self._max_queue,
                                   max_batch=self._max_batch,
                                   default_timeout=self._request_timeout,
                                   registry=self.metrics)
        except BaseException:
            self._httpd.server_close()
            raise
        self._epoch = _Epoch(artifact, engine, batcher, generation)
        self.address = self._httpd.server_address[:2]
        self._t0 = time.monotonic()
        self._draining = False
        self._accept_thread = None
        self._close_lock = threading.Lock()
        self._closed = False
        self._hist: dict = {}
        self._hist_lock = threading.Lock()
        # hot-swap state: the non-blocking lock means at most one
        # request pays the probe/verify cost while the rest sail past
        self.swap_poll = float(swap_poll)
        self._swap_lock = threading.Lock()
        self._swap_next_probe = 0.0
        self._swap_sighup = threading.Event()
        # tiered load-shedding state (hysteresis: enter high, exit low)
        self.shed_high = float(shed_high)
        self.shed_low = float(shed_low)
        self._shedding = False
        self._shed_lock = threading.Lock()
        self._shed_prev = ((0,) * len(_BUCKET_BOUNDS_MS), 0)
        self._lat_check_at = 0.0
        self._lat_pressure = False
        self._latency_budget_ms = 0.5 * self._request_timeout * 1e3
        self._retry_base = 0.05
        self._lat_hist = self.metrics.histogram(
            "dcfm_serve_request_latency_ms", _BUCKET_BOUNDS_MS,
            "request latency per route, milliseconds", labels=("route",))
        self._responses = self.metrics.counter(
            "dcfm_serve_responses_total",
            "responses by HTTP status", labels=("status",))
        self._swaps = self.metrics.counter(
            "dcfm_serve_swaps_total", "successful artifact hot-swaps")
        self._swap_refused = self.metrics.counter(
            "dcfm_serve_swap_refused_total",
            "hot-swaps refused (torn/corrupt/mismatched candidate)",
            labels=("reason",))
        self._shed_total = self.metrics.counter(
            "dcfm_serve_shed_total",
            "expensive-route responses shed under pressure",
            labels=("route",))
        self._client_aborts = self.metrics.counter(
            "dcfm_serve_client_aborts_total",
            "connections dropped mid-response (slow/vanished clients)")
        g = self.metrics.gauge
        g("dcfm_serve_uptime_seconds", "seconds since server start"
          ).set_function(lambda: time.monotonic() - self._t0)
        g("dcfm_serve_artifact_generation",
          "generation tag of the served artifact (bumped on hot-swap)"
          ).set_function(lambda: self.generation)
        g("dcfm_serve_shedding",
          "1 while the expensive routes are being shed"
          ).set_function(lambda: float(self._shedding))
        g("dcfm_serve_prewarm_panels",
          "panels pre-dequantized into the serving engine at its "
          "construction or last hot-swap (hot-set pre-warmer)"
          ).set_function(lambda: float(self._prewarmed))
        # one stats() sample is shared by every per-stat series of a
        # scrape (the registry reads series sequentially): without the
        # short-lived memo each exposition would call engine.stats() /
        # batcher.stats() once PER stat, and sibling stats (hits vs
        # misses, submitted vs served) could come from different instants
        def _memo(fn, ttl=0.05):
            state = {"t": -1.0, "v": None}

            def get():
                now = time.monotonic()
                if state["v"] is None or now - state["t"] > ttl:
                    state["v"] = fn()
                    state["t"] = now
                return state["v"]
            return get

        cache_stats = _memo(lambda: self.engine.stats())
        cache_g = g("dcfm_serve_cache", "panel-cache stats",
                    labels=("stat",))
        for stat in ("hits", "misses", "evictions", "panels", "bytes",
                     "budget_bytes"):
            cache_g.set_function(
                lambda s=stat: float(cache_stats().get(s, 0)), stat=stat)
        batch_stats = _memo(lambda: self.batcher.stats())
        batch_g = g("dcfm_serve_batcher", "microbatcher stats",
                    labels=("stat",))
        for stat in ("submitted", "served", "rejected", "expired",
                     "batches", "max_batch_seen", "queue_depth",
                     "queue_capacity"):
            batch_g.set_function(
                lambda s=stat: float(batch_stats().get(s, 0)), stat=stat)

    # the epoch owns the servable quartet; these views always show the
    # CURRENT one (requests in flight hold their own epoch reference)
    @property
    def artifact(self):
        return self._epoch.artifact

    @property
    def engine(self):
        return self._epoch.engine

    @property
    def batcher(self):
        return self._epoch.batcher

    @property
    def generation(self):
        return self._epoch.generation

    _ROUTES = ("/healthz", "/metrics", "/v1/entry", "/v1/block",
               "/v1/interval")
    _EXPENSIVE = ("/v1/block", "/v1/interval")

    # -- observability -------------------------------------------------
    def observe(self, path: str, status: int, ms: float) -> None:
        # known routes get their own histogram; everything else folds
        # into one "other" bucket so a path scanner cannot exhaust the
        # per-route slots and starve a real endpoint of latency data
        key = path if path in self._ROUTES else "other"
        with self._hist_lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = LatencyHistogram(self._lat_hist,
                                                       key)
        # per-status counts live on the registry counter ONLY; the JSON
        # /metrics "statuses" dict is derived from it at read time
        self._responses.inc(status=str(status))
        h.record(ms)

    def client_aborted(self, detail: str) -> None:
        """A connection died mid-response (slow-loris timeout, reset)."""
        self._client_aborts.inc()
        record("serve_client_abort", detail=detail,
               worker=self.worker_index)

    def status_counts(self) -> dict:
        """{status: count} derived from the registry counter - the one
        home of the per-status bookkeeping."""
        return {lab["status"]: int(self._responses.value(**lab))
                for lab, _child in self._responses.series()}

    def _retry_after(self) -> str:
        """Jittered backoff hint: uniformly smeared over [base, 2*base)
        so a synchronized thundering herd of rejected clients does not
        come back as one synchronized wave."""
        return f"{self._retry_base * (1.0 + random.random()):.3f}"

    # -- load shedding -------------------------------------------------
    def _latency_pressure(self) -> bool:
        """Windowed /v1/entry p99 vs. the deadline budget (half the
        request timeout): bucket-count deltas since the last check give
        a p99 over the RECENT window, not the process lifetime, so the
        gate opens and closes with the actual congestion."""
        now = time.monotonic()
        if now < self._lat_check_at:
            return self._lat_pressure
        self._lat_check_at = now + 0.25
        counts, n, _sum = self._lat_hist.data(route="/v1/entry")
        prev_counts, prev_n = self._shed_prev
        self._shed_prev = (counts, n)
        dn = n - prev_n
        if dn < 16:                 # too few samples to judge a p99
            self._lat_pressure = False
            return False
        delta = [c - p for c, p in zip(counts, prev_counts)]
        target, acc, p99 = 0.99 * dn, 0, 0.0
        for b, c in zip(_BUCKET_BOUNDS_MS, delta):
            acc += c
            if acc >= target:
                p99 = _BUCKET_BOUNDS_MS[-2] if b == float("inf") else b
                break
        self._lat_pressure = p99 >= self._latency_budget_ms
        return self._lat_pressure

    def _should_shed(self, route: str) -> bool:
        """Tiered shedding gate, consulted only by the EXPENSIVE routes:
        batcher queue fill (enter >= shed_high, exit <= shed_low -
        hysteresis, no flapping) or sustained entry-latency pressure.
        /v1/entry and /healthz never consult it: cheap traffic and
        liveness stay up while the heavy tiers make room."""
        st = self.batcher.stats()
        fill = st["queue_depth"] / max(1, st["queue_capacity"])
        with self._shed_lock:
            if not self._shedding:
                if fill >= self.shed_high or self._latency_pressure():
                    self._shedding = True
                    record("serve_shed", active=True, route=route,
                           fill=round(fill, 3),
                           worker=self.worker_index)
            else:
                if fill <= self.shed_low and not self._latency_pressure():
                    self._shedding = False
                    record("serve_shed", active=False,
                           fill=round(fill, 3),
                           worker=self.worker_index)
            if self._shedding:
                self._shed_total.inc(route=route)
            return self._shedding

    # -- hot-swap ------------------------------------------------------
    def _maybe_swap(self) -> None:
        """Cheap pointer probe, time-gated (or forced by SIGHUP); at
        most one thread at a time pays the verify/build cost while
        every other request proceeds on the current epoch."""
        if self._pointer_root is None or self._draining:
            return
        now = time.monotonic()
        if now < self._swap_next_probe and not self._swap_sighup.is_set():
            return
        if not self._swap_lock.acquire(blocking=False):
            return                     # another request is mid-swap
        try:
            if self._draining:
                return
            self._swap_sighup.clear()
            self._swap_next_probe = now + self.swap_poll
            try:
                key = pointer_stat(self._pointer_root)
            except OSError:
                return                 # pointer vanished: keep serving
            if key == self._ptr_stat or key == self._swap_refused_stat:
                return
            self._swap(key)
        finally:
            self._swap_lock.release()

    def _swap(self, key) -> None:
        """Verify + install the newly promoted artifact.  Refusal keeps
        the old epoch serving and remembers the refused pointer state so
        the (expensive) verification is not retried per probe."""
        fault_event("swap_begin")
        t0 = time.perf_counter()
        old = self._epoch
        try:
            ptr = read_pointer(self._pointer_root)
            art = verify_candidate(ptr.path)
            if ptr.fingerprint not in ("unverified", art.fingerprint):
                raise ArtifactError(
                    f"candidate fingerprint {art.fingerprint} does not "
                    f"match promoted {ptr.fingerprint} - the artifact "
                    "changed after promotion; refusing the swap")
        except (PointerError, ArtifactError, OSError) as e:
            self._swap_refused_stat = key
            reason = type(e).__name__
            self._swap_refused.inc(reason=reason)
            record("serve_swap_refused", reason=reason, error=str(e),
                   generation=old.generation, worker=self.worker_index)
            return
        generation = max(old.generation, ptr.generation)
        if art.fingerprint == old.artifact.fingerprint:
            # same bytes re-promoted: adopt the generation tag, keep
            # the warm engine and cache
            self._epoch = _Epoch(old.artifact, old.engine, old.batcher,
                                 generation)
            self._ptr_stat = key
            return
        # delta-aware engine build: adopt the old epoch's memmaps (and
        # already-dequantized panels) for every pair the two CRC tables
        # prove unchanged - after a delta promotion only the changed
        # panels' bytes are ever pulled from the new generation
        engine = QueryEngine(
            art, cache_bytes=self._cache_bytes, device=self.device,
            adopt_from=(old.engine if self._swap_adopt == "auto" else None))
        # hot-set pre-warmer: replay the OLD engine's hottest panels
        # into the new engine BEFORE the flip, so a promotion under
        # load does not reset the cache cold (the panel grid only grows
        # across generations; keys past the new grid are skipped).  The
        # set is persisted beside the new artifact so a restarted
        # worker on this generation warms the same way.  Adopted pairs
        # replay for free (seeded straight from the old cache), so the
        # warm-up dequant cost is proportional to changed-and-hot.
        hot = old.engine.hot_panels(PREWARM_LIMIT) or _load_hotset(art.path)
        _save_hotset(art.path, hot)
        self._prewarmed = engine.prewarm(hot)
        batcher = QueryBatcher(engine, max_queue=self._max_queue,
                               max_batch=self._max_batch,
                               default_timeout=self._request_timeout,
                               registry=self.metrics)
        # the flip: one reference assignment installs the new quartet
        self._epoch = _Epoch(art, engine, batcher, generation)
        self._ptr_stat = key
        swap_s = time.perf_counter() - t0
        fault_event("swap_commit")
        self._swaps.inc()
        panels_total = art.n_pairs * (2 if art.has_sd else 1)
        panels_changed = panels_total - engine.panels_adopted
        try:
            maps_bytes = os.path.getsize(os.path.join(art.path, MAPS_FILE))
        except OSError:
            maps_bytes = 0
        record("serve_swap", generation=generation,
               from_generation=old.generation,
               fingerprint=art.fingerprint,
               prewarm_panels=self._prewarmed,
               # re-warm economics of THIS swap: how many pairs kept
               # serving from the old epoch's memmaps, how many panel
               # reads the new generation actually costs
               panels_adopted=engine.panels_adopted,
               panels_changed=panels_changed,
               cache_seeded=engine.cache_seeded,
               bytes_shipped=panels_changed * art.P * art.P + maps_bytes,
               swap_s=round(swap_s, 6), worker=self.worker_index)
        # drain in-flight requests on the OLD engine: close() serves
        # everything already queued before joining the worker, so the
        # swap drops zero requests
        old.batcher.close()

    # -- routing -------------------------------------------------------
    def handle(self, path: str, q: dict) -> tuple:
        """-> (status, json payload, extra headers)."""
        self._maybe_swap()
        ep = self._epoch
        try:
            status, payload, headers = self._dispatch(ep, path, q)
        except BatcherClosed as e:
            # raced a hot-swap: the successor epoch is already
            # installed - retry once there; a second closure means the
            # server itself is draining, which IS a typed 429-retry
            ep = self._epoch
            try:
                status, payload, headers = self._dispatch(ep, path, q)
            except BatcherClosed:
                status, payload, headers = 429, {
                    "error": str(e), "retry": True,
                    "retry_after": float(self._retry_after())}, \
                    {"Retry-After": self._retry_after()}
        headers = dict(headers)
        # pin the generation header to the epoch that produced the
        # payload: a response computed on the old engine mid-swap says
        # so, and per-client generations never decrease
        headers.setdefault(GENERATION_HEADER, str(ep.generation))
        return status, payload, headers

    def _dispatch(self, ep, path: str, q: dict) -> tuple:
        try:
            if path == "/healthz":
                return 200, self._healthz(), {}
            if path == "/metrics":
                if q.get("format", [""])[0] == "prometheus":
                    return 200, self._metrics_prometheus(), {}
                return 200, self._metrics(), {}
            if path in self._EXPENSIVE and self._should_shed(path):
                ra = self._retry_after()
                return 503, {"error": f"overloaded: {path} shed under "
                             "pressure - retry with backoff",
                             "shed": True, "retry": True,
                             "retry_after": float(ra)}, {"Retry-After": ra}
            if path == "/v1/entry":
                return self._entry(ep, q)
            if path == "/v1/block":
                return self._block(ep, q)
            if path == "/v1/interval":
                return self._interval(ep, q)
            return 404, {"error": f"no route {path}"}, {}
        except _BadRequest as e:
            return 400, {"error": str(e)}, {}
        except BatcherClosed:
            raise                      # handle() retries on the successor
        except Overloaded as e:
            ra = self._retry_after()
            return 429, {"error": str(e), "retry": True,
                         "retry_after": float(ra)}, {"Retry-After": ra}
        except DeadlineExceeded as e:
            return 504, {"error": str(e)}, {}
        except ArtifactCorruptError as e:
            # typed 503, never a stack trace: the artifact's bytes are
            # bad (lazy CRC verification caught a corrupt panel) - the
            # request is fine, the REPLICA is not; a client should fail
            # over while this instance gets re-synced/re-exported
            return 503, {"error": str(e), "corrupt_panel": e.panel,
                         "kind": e.kind}, {}
        except (ArtifactError, ValueError, IndexError) as e:
            return 400, {"error": str(e)}, {}
        except OSError as e:
            # an I/O failure reading the memmapped panel (or an injected
            # io_error chaos fault on the dequant path): typed and
            # retryable - another replica, or this one after the cache
            # re-fills, can still answer
            ra = self._retry_after()
            return 503, {"error": repr(e), "retry": True,
                         "retry_after": float(ra)}, {"Retry-After": ra}
        except Exception as e:           # pragma: no cover - last resort
            return 500, {"error": repr(e)}, {}

    def _q_int(self, ep, q, name):
        if name not in q:
            raise _BadRequest(f"missing required parameter {name!r}")
        try:
            v = int(q[name][0])
        except ValueError:
            raise _BadRequest(f"{name}={q[name][0]!r} is not an integer") \
                from None
        if not 0 <= v < ep.artifact.p_original:
            raise _BadRequest(
                f"{name}={v} out of [0, {ep.artifact.p_original})")
        return v

    @staticmethod
    def _q_flag(q, name, default=True):
        if name not in q:
            return default
        return q[name][0] not in ("0", "false", "no")

    def _entry(self, ep, q):
        i, j = self._q_int(ep, q, "i"), self._q_int(ep, q, "j")
        dest = self._q_flag(q, "destandardize")
        value = ep.batcher.entry(i, j, destandardize=dest)
        return 200, {"i": i, "j": j, "value": float(value),
                     "destandardized": dest}, {}

    def _block(self, ep, q):
        p = ep.artifact.p_original
        if "rows" not in q or "cols" not in q:
            raise _BadRequest("block queries need rows= and cols=")
        rows = _parse_indices(q["rows"][0], p)
        cols = _parse_indices(q["cols"][0], p)
        if len(rows) * len(cols) > MAX_BLOCK_ENTRIES:
            return 413, {"error": f"block of {len(rows)}x{len(cols)} "
                         f"exceeds {MAX_BLOCK_ENTRIES} entries; tile the "
                         "request"}, {}
        dest = self._q_flag(q, "destandardize")
        kind = q.get("kind", ["mean"])[0]
        vals = ep.engine.block(rows, cols, kind=kind, destandardize=dest)
        return 200, {"rows": rows, "cols": cols,
                     "values": [[float(v) for v in row] for row in vals],
                     "destandardized": dest, "kind": kind}, {}

    def _interval(self, ep, q):
        i, j = self._q_int(ep, q, "i"), self._q_int(ep, q, "j")
        alpha = float(q.get("alpha", ["0.05"])[0])
        if not 0.0 < alpha < 1.0:
            raise _BadRequest(f"alpha={alpha} must be in (0, 1)")
        dest = self._q_flag(q, "destandardize")
        mean, sd, lo, hi = ep.engine.interval(
            i, j, alpha=alpha, destandardize=dest)
        return 200, {"i": i, "j": j, "alpha": alpha, "mean": mean,
                     "sd": sd, "lo": lo, "hi": hi}, {}

    def _fleet_status(self):
        """The fleet supervisor's liveness table, when one is running:
        it atomically rewrites the JSON file named by DCFM_FLEET_STATUS
        and every worker serves it on /healthz, so ANY replica answers
        for the whole fleet.  mtime-cached; absent/torn reads degrade to
        None (a worker must stay healthy when its supervisor is mid-
        rewrite or gone)."""
        path = os.environ.get("DCFM_FLEET_STATUS")
        if not path:
            return None
        try:
            st = os.stat(path)
            key = (st.st_mtime_ns, st.st_size)
            cached = getattr(self, "_fleet_cache", None)
            if cached is None or cached[0] != key:
                with open(path, "r", encoding="utf-8") as f:
                    self._fleet_cache = (key, json.load(f))
            return self._fleet_cache[1]
        except (OSError, ValueError):
            return None

    def _healthz(self):
        ep = self._epoch
        a = ep.artifact
        with self._shed_lock:
            shedding = self._shedding
        h = {
            "status": ("draining" if self._draining
                       else "ok" if native.available() else "degraded"),
            "native": native.available(),
            "device": self.device_label,
            "p": a.p_original, "g": a.g, "P": a.P, "has_sd": a.has_sd,
            # identity + generation of the served posterior: the pair a
            # fleet checks before/after an artifact hot-swap (a replica
            # still answering under the old fingerprint is stale)
            "artifact_fingerprint": a.fingerprint,
            "artifact_generation": ep.generation,
            "shedding": shedding,
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }
        if self.worker_index is not None:
            h["worker"] = {"index": int(self.worker_index),
                           "pid": os.getpid()}
        if self._pointer_root is not None:
            try:
                h["pointer_generation"] = \
                    read_pointer(self._pointer_root).generation
            except PointerError:
                h["pointer_generation"] = None
        fleet = self._fleet_status()
        if fleet is not None:
            h["fleet"] = fleet
        return h

    def _metrics(self):
        with self._hist_lock:
            hists = {p: h.snapshot() for p, h in self._hist.items()}
        statuses = self.status_counts()
        ep = self._epoch
        with self._shed_lock:
            shedding = self._shedding
        return {
            "latency": hists,
            "statuses": statuses,
            "cache": ep.engine.stats(),
            "batcher": ep.batcher.stats(),
            "artifact": {"fingerprint": ep.artifact.fingerprint,
                         "generation": ep.generation},
            "swap": {
                "swaps": int(self._swaps.value()),
                "refused": sum(
                    int(self._swap_refused.value(**lab))
                    for lab, _c in self._swap_refused.series()),
            },
            "shed": {
                "active": shedding,
                "by_route": {lab["route"]: int(self._shed_total.value(**lab))
                             for lab, _c in self._shed_total.series()},
            },
            "client_aborts": int(self._client_aborts.value()),
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }

    def _metrics_prometheus(self) -> str:
        """Prometheus text exposition: this server's registry first,
        then the process default registry (an embedded fit's progress
        gauges; empty otherwise).  The served artifact's fingerprint
        rides as an info-style labeled gauge."""
        info = self.metrics.gauge(
            "dcfm_serve_artifact_info",
            "served artifact identity (fingerprint label); value is "
            "always 1", labels=("fingerprint",))
        info.set(1, fingerprint=self.artifact.fingerprint)
        return obs_metrics.render_prometheus(
            self.metrics, obs_metrics.default_registry())

    # -- lifecycle -----------------------------------------------------
    def start(self) -> tuple:
        """Serve in a background thread (tests, benchmarks, embedding);
        returns the bound (host, port)."""
        self._accept_thread = threading.Thread(
            target=self._httpd.serve_forever, name="dcfm-serve-accept")
        self._accept_thread.start()
        return self.address

    def close(self) -> None:
        """Graceful drain: stop accepting, finish in-flight requests,
        close the socket and the batcher worker.  Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._draining = True
        self._httpd.shutdown()            # stops serve_forever
        if self._accept_thread is not None:
            self._accept_thread.join()
            self._accept_thread = None
        self._httpd.server_close()        # joins in-flight handler threads
        # _swap_lock: a hot-swap observed pre-drain must finish
        # installing (and closing the predecessor batcher) before we
        # close the current one - otherwise its successor would leak
        with self._swap_lock:
            self.batcher.close()
        # persist this generation's hot set beside its artifact so a
        # restarted worker pre-warms from the traffic just served
        hot = self.engine.hot_panels(PREWARM_LIMIT)
        if hot:
            _save_hotset(self.artifact.path, hot)

    def run(self) -> None:
        """Serve until SIGTERM/SIGINT, then drain gracefully.

        The accept loop runs in a worker thread while the main thread -
        the only one Python delivers signals to - waits on an event the
        handlers set; calling ``shutdown()`` from a signal handler while
        ``serve_forever`` runs on the handler's own thread would
        deadlock.  SIGHUP forces an immediate promotion-pointer probe
        (the fleet supervisor's swap-now nudge for idle workers).
        """
        stop = threading.Event()
        prev = {s: signal.signal(s, lambda *_: stop.set())
                for s in (signal.SIGTERM, signal.SIGINT)}
        if hasattr(signal, "SIGHUP"):
            prev[signal.SIGHUP] = signal.signal(
                signal.SIGHUP, lambda *_: self._swap_sighup.set())
        self.start()
        try:
            while not stop.wait(0.2):
                # idle workers still observe promotions (and SIGHUP)
                self._maybe_swap()
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
            self.close()


def serve_main(args) -> int:
    """The CLI's ``serve`` (an argparse Namespace from cli.py)."""
    rec = None
    obs_dir = os.environ.get(obs_recorder.OBS_DIR_ENV_VAR)
    if obs_dir:
        rec = obs_recorder.install(obs_recorder.FlightRecorder(obs_dir))
    worker_index = getattr(args, "worker_index", None)
    server = PosteriorServer(
        args.artifact, host=args.host, port=args.port,
        cache_bytes=int(args.cache_mb) << 20, max_queue=args.max_queue,
        max_batch=args.max_batch, request_timeout=args.request_timeout,
        io_timeout=getattr(args, "io_timeout", 10.0),
        reuse_port=bool(getattr(args, "reuse_port", False)),
        swap_poll=getattr(args, "swap_poll", 0.5),
        shed_high=getattr(args, "shed_high", 0.75),
        shed_low=getattr(args, "shed_low", 0.50),
        worker_index=worker_index,
        swap_adopt=getattr(args, "swap_adopt", "auto"),
        device=getattr(args, "device", None))
    host, port = server.address
    record("serve_start", worker=worker_index, pid=os.getpid(),
           generation=server.generation,
           fingerprint=server.artifact.fingerprint)
    print(json.dumps({"serving": f"http://{host}:{port}",  # dcfm: ignore[DCFM901] - the serve CLI's stdout protocol
                      "artifact": args.artifact,
                      "p": server.artifact.p_original,
                      "has_sd": server.artifact.has_sd,
                      "generation": server.generation,
                      "worker": worker_index,
                      "device": server.device_label}), flush=True)
    try:
        server.run()
    finally:
        record("serve_stop", worker=worker_index,
               generation=server.generation)
        if rec is not None:
            obs_recorder.uninstall(rec)
            rec.close()
    print(json.dumps({"drained": True,  # dcfm: ignore[DCFM901] - the serve CLI's stdout protocol
                      "statuses": server.status_counts()}), flush=True)
    return 0
