"""Observability of the port: flight recorder, span traces, metrics.

The port's copy of ``dcfm_tpu/obs`` (stdlib-only, like the original; the
port imports nothing of the JAX package):

* :mod:`dcfm_tpu_torch.obs.recorder` - the **flight recorder**: a per-run,
  per-process append-only JSONL event log (line-buffered, fsynced at
  chunk boundaries, a torn final line tolerated on replay), in the JAX
  package's file names and event schema, so either package's reader
  replays the other's run directory;
* :mod:`dcfm_tpu_torch.obs.spans` - Chrome trace-event JSON from the same
  events, and the stream overlap fraction;
* :mod:`dcfm_tpu_torch.obs.metrics` - counters, gauges and fixed-bucket
  histograms with Prometheus text exposition; the fit loop publishes its
  progress gauges into the process default registry;
* :mod:`dcfm_tpu_torch.obs.cli` - the run directory's reader
  (``summarize``).

Recording is host-side only: no event is emitted inside a CUDA-graph
capture or reads the card, and ``FitConfig.obs="off"`` gives a Sigma
bitwise equal to a recorded fit's.
"""

from dcfm_tpu_torch.obs.recorder import (  # noqa: F401
    FlightRecorder, active, install, read_events, record, record_sync,
    run_events, tail_events, uninstall)
from dcfm_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry, default_registry, render_prometheus)
from dcfm_tpu_torch.obs.spans import (  # noqa: F401
    chrome_trace, overlap_fraction)

__all__ = [
    "FlightRecorder", "active", "install", "uninstall", "record",
    "record_sync", "read_events", "run_events", "tail_events",
    "MetricsRegistry", "default_registry", "render_prometheus",
    "chrome_trace", "overlap_fraction",
]
