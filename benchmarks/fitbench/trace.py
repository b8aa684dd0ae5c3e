"""Reading a profiler trace of one fit.

The traced fit runs under ``torch.profiler`` with the benchmark's own
spans (``record_function``) around the fit (``fit``) and around the
program's phases it calls (``api.*``, :func:`phase_spans`).  From the raw
events this takes:

* the device's busy time: the union of its kernels, copies and fills
  inside the ``fit`` span, and the span's length (the traced window);
* device time by operation name, and launches by name;
* the graph replays: the device operations of each ``cudaGraphLaunch``
  (grouped by the launch's correlation id), so one replayed trip's
  device time and operation count can be read;
* the idle gaps inside the window, each named by the innermost of the
  benchmark's spans that was open at its middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np

# the program's phase functions, as the entry module calls them, and the
# span each gets in a traced fit
PHASES = {
    "preprocess": "api.preprocess",
    "upload_data": "api.upload",
    "run_chain": "api.chain",
    "fetch_prep": "api.fetch_prep",
    "quant8_start": "api.fetch_start",
    "quant8_fetch_assemble": "api.fetch_drain_assemble",
    "assemble_from_upper": "api.assemble",
    "assemble_q8_sigma": "api.assemble",
}
FIT_SPAN = "fit"


@contextlib.contextmanager
def phase_spans(api):
    """Wrap the entry module's phase functions in profiler spans while a
    traced fit runs, and put them back after.  A span is a host-side
    marker: it launches nothing and changes no result."""
    import functools

    from torch.profiler import record_function

    def spanned(fn, span):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(span):
                return fn(*args, **kwargs)
        return wrapped

    saved = {}
    for attr, span in PHASES.items():
        fn = getattr(api, attr, None)
        if fn is not None:
            saved[attr] = fn
            setattr(api, attr, spanned(fn, span))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(api, attr, fn)


def _union_ns(starts: np.ndarray, ends: np.ndarray) -> list:
    """Merged [start, end) intervals of sorted starts."""
    out = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    by_name: dict           # device op name -> (seconds, count)
    replays: list           # (device ops, device seconds) per graph launch
    gaps_by_span: dict      # span name -> idle seconds inside the window

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def ops(self, pattern: str) -> tuple:
        """(seconds, launches) of the device ops whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        s = c = 0
        for name, (sec, cnt) in self.by_name.items():
            if rx.search(name):
                s += sec
                c += cnt
        return s, c

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def summarize(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    spans, launches, host_names = [], set(), set()
    dev = []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            host_names.add(name)
            if name == FIT_SPAN or name.startswith("api."):
                spans.append((name, start, end))
            elif "GraphLaunch" in name:
                launches.add(e.correlation_id())
        else:
            dev.append((e.name(), start, end, e.correlation_id(),
                        e.linked_correlation_id()))
    fit = [s for s in spans if s[0] == FIT_SPAN]
    if not fit:
        raise ValueError("the trace holds no 'fit' span")
    w0, w1 = fit[0][1], fit[0][2]
    # a host span opened while the profiler records (the benchmark's, the
    # program's ``scope`` ranges) also shows on the device timeline, over
    # the kernels it launched: not device work of its own
    dev = [d for d in dev if d[2] > w0 and d[1] < w1
           and d[0] not in host_names]
    by_name: dict = {}
    groups: dict = {}
    for name, s, e, corr, linked in dev:
        sec, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + (e - s) * 1e-9, cnt + 1)
        key = corr if corr in launches else (
            linked if linked in launches else None)
        if key is not None:
            n, t = groups.get(key, (0, 0))
            groups[key] = (n + 1, t + (e - s))
    if dev:
        arr = np.array([(max(s, w0), min(e, w1)) for _, s, e, _, _ in dev],
                       dtype=np.int64)
        arr = arr[np.argsort(arr[:, 0], kind="stable")]
        busy = _union_ns(arr[:, 0], arr[:, 1])
    else:
        busy = []
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps: the window minus the busy intervals
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    g0 = np.array(edges[0::2], dtype=np.int64)
    g1 = np.array(edges[1::2], dtype=np.int64)
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    mid = (g0 + g1) // 2
    named = np.full(mid.shape, FIT_SPAN, dtype=object)
    width = np.full(mid.shape, np.iinfo(np.int64).max, dtype=np.int64)
    for name, s, e in spans:
        inside = (mid >= s) & (mid < e) & ((e - s) < width)
        named[inside] = name
        width[inside] = e - s
    gaps: dict = {}
    for name, length in zip(named.tolist(), (g1 - g0).tolist()):
        gaps[name] = gaps.get(name, 0.0) + length * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                 by_name=by_name,
                 replays=[(n, t * 1e-9) for n, t in groups.values()],
                 gaps_by_span=gaps)
