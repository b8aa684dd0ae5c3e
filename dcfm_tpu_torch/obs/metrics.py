"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of ``dcfm_tpu/obs/metrics.py``: the Prometheus text of
equal registries is the JAX package's, byte for byte.

One registry abstraction under every surface that used to roll its own:
the serve layer's latency histograms and cache/batcher stats, and the
fit loop's progress gauges (iteration, chunk seconds, stream skips,
sentinel rewinds, checkpoint generation).  Two render paths:

* :meth:`MetricsRegistry.snapshot` - a lock-guarded plain-dict snapshot
  (what the serve layer's JSON ``/metrics`` is built from);
* :func:`render_prometheus` - Prometheus text exposition format 0.0.4
  (``# HELP`` / ``# TYPE`` / samples; histograms as cumulative
  ``_bucket{le=...}`` series plus ``_sum`` / ``_count``), served by
  ``GET /metrics?format=prometheus``.

Metrics are cheap on the hot path: a counter increment or gauge set is
one small lock acquire; histograms do one linear bucket scan (the
bucket sets here are ~a dozen bounds).  Labels are supported as
keyword arguments (``hist.observe(1.2, route="/v1/entry")``); each
label-value combination materializes one series lazily.

``default_registry()`` is the process-wide registry the fit pipeline
publishes its gauges into; servers keep their own instance (so two
servers in one process never collide) and render both.

Stdlib-only, like the rest of the obs package.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple


def _label_key(label_names: Tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(
            f"expected labels {label_names}, got {tuple(sorted(labels))}")
    return tuple(str(labels[k]) for k in label_names)


class _Metric:
    """Shared series bookkeeping for all three metric kinds."""

    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._series: Dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _child(self, labels: dict):
        key = _label_key(self.label_names, labels)
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._series[key] = self._new_child()
            return child

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def series(self) -> Iterable[Tuple[dict, object]]:
        with self._lock:
            items = list(self._series.items())
        for key, child in items:
            yield dict(zip(self.label_names, key)), child


class Counter(_Metric):
    """Monotonically increasing count (optionally labeled)."""

    kind = "counter"

    class _Child:
        __slots__ = ("value", "lock")

        def __init__(self):
            self.value = 0.0
            self.lock = threading.Lock()

    def _new_child(self):
        return Counter._Child()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        c = self._child(labels)
        with c.lock:
            c.value += amount

    def value(self, **labels) -> float:
        c = self._child(labels)
        with c.lock:
            return c.value


class Gauge(_Metric):
    """Point-in-time value: ``set()`` it, or register a pull callback
    (``fn``) that is sampled at snapshot/render time - how the serve
    layer exposes cache/batcher stats without a push site per field."""

    kind = "gauge"

    class _Child:
        __slots__ = ("value", "fn", "lock")

        def __init__(self):
            self.value = 0.0
            self.fn: Optional[Callable[[], float]] = None
            self.lock = threading.Lock()

        def read(self) -> float:
            with self.lock:
                if self.fn is not None:
                    try:
                        return float(self.fn())
                    except Exception:  # dcfm: ignore[DCFM601] - a failing pull callback must not take /metrics down with it
                        return float("nan")
                return self.value

    def _new_child(self):
        return Gauge._Child()

    def set(self, value: float, **labels) -> None:
        c = self._child(labels)
        with c.lock:
            c.value = float(value)
            c.fn = None

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        c = self._child(labels)
        with c.lock:
            c.fn = fn

    def value(self, **labels) -> float:
        return self._child(labels).read()


class Histogram(_Metric):
    """Fixed-bucket histogram.  ``buckets`` are the upper bounds, in
    increasing order; a trailing ``inf`` is appended when absent (the
    Prometheus ``+Inf`` bucket).  ``percentile`` reproduces the serve
    layer's historical readout (upper bound of the bucket containing
    the quantile) so the JSON ``/metrics`` stays bitwise-compatible."""

    kind = "histogram"

    class _Child:
        __slots__ = ("counts", "count", "sum", "lock")

        def __init__(self, n_buckets: int):
            self.counts = [0] * n_buckets
            self.count = 0
            self.sum = 0.0
            self.lock = threading.Lock()

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float],
                 label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        bounds = [float(b) for b in buckets]
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise ValueError(f"buckets must be increasing, got {buckets}")
        if not math.isinf(bounds[-1]):
            bounds.append(float("inf"))
        self.buckets = tuple(bounds)

    def _new_child(self):
        return Histogram._Child(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        c = self._child(labels)
        with c.lock:
            for k, bound in enumerate(self.buckets):
                if value <= bound:
                    c.counts[k] += 1
                    break
            c.count += 1
            c.sum += value

    def data(self, **labels) -> Tuple[Tuple[int, ...], int, float]:
        """(per-bucket counts, total count, sum) - one consistent read."""
        c = self._child(labels)
        with c.lock:
            return tuple(c.counts), c.count, c.sum

    def percentile(self, q: float, **labels) -> float:
        """Upper bucket bound containing quantile q (the final +Inf
        bucket reports the last finite bound) - the serve layer's
        historical p50/p99 readout, verbatim."""
        counts, n, _ = self.data(**labels)
        target = q * n
        seen = 0
        for k, bound in enumerate(self.buckets):
            seen += counts[k]
            if seen >= target:
                return bound if not math.isinf(bound) else self.buckets[-2]
        return self.buckets[-2]


class MetricsRegistry:
    """Named metrics with get-or-create registration (re-registering
    the same name returns the existing metric; a kind or label
    mismatch raises - two subsystems silently sharing one name with
    different meanings is the bug this check exists for)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, labels, factory):
        """The ONE get-or-create: an existing metric is returned only
        when kind AND label names match; a mismatch raises (two
        subsystems silently sharing one name with different meanings is
        the bug this check exists for)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.label_names}")
                return m
            m = self._metrics[name] = factory()
            return m

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, labels,
                              lambda: Counter(name, help_, labels))

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, labels,
                              lambda: Gauge(name, help_, labels))

    def histogram(self, name: str, buckets: Sequence[float],
                  help_: str = "",
                  labels: Sequence[str] = ()) -> Histogram:
        return self._register(
            Histogram, name, labels,
            lambda: Histogram(name, help_, buckets, labels))

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Plain-dict snapshot of every series (lock-guarded per
        series; the registry listing itself is a point-in-time copy)."""
        out = {}
        for m in self.metrics():
            series = []
            for labels, child in m.series():
                if isinstance(m, Histogram):
                    counts, count, total = m.data(**labels)
                    series.append({"labels": labels, "count": count,
                                   "sum": total, "counts": list(counts)})
                elif isinstance(m, Gauge):
                    series.append({"labels": labels,
                                   "value": child.read()})
                else:
                    series.append({"labels": labels,
                                   "value": m.value(**labels)})
            entry = {"type": m.kind, "help": m.help, "series": series}
            if isinstance(m, Histogram):
                entry["buckets"] = ["+Inf" if math.isinf(b) else b
                                    for b in m.buckets]
            out[m.name] = entry
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the fit pipeline publishes its gauges
    into (servers keep their own instance and render both)."""
    return _DEFAULT


# ---------------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4)
# ---------------------------------------------------------------------------

def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Render one or more registries as Prometheus text format.  When
    a name appears in several registries the first rendering wins (the
    serve layer renders its own registry first, then the process
    default registry carrying the fit gauges)."""
    lines = []
    seen = set()
    for reg in registries:
        for m in reg.metrics():
            if m.name in seen:
                continue
            seen.add(m.name)
            lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for labels, _child in m.series():
                    counts, count, total = m.data(**labels)
                    cum = 0
                    for k, bound in enumerate(m.buckets):
                        cum += counts[k]
                        le = dict(labels)
                        le["le"] = ("+Inf" if math.isinf(bound)
                                    else _fmt_value(bound))
                        lines.append(f"{m.name}_bucket{_fmt_labels(le)}"
                                     f" {cum}")
                    lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(total)}")
                    lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                                 f"{count}")
            elif isinstance(m, Gauge):
                for labels, child in m.series():
                    lines.append(f"{m.name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(child.read())}")
            else:
                for labels, _child in m.series():
                    lines.append(f"{m.name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(m.value(**labels))}")
    return "\n".join(lines) + "\n"
