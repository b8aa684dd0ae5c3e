"""The online fit->serve loop: fresh data to fresh posteriors, live.

The port of ``dcfm_tpu/online``: four subsystems of the port composed
into one loop:

* **warm-started refits** - ``config.WarmStart`` + the resume seam
  (runtime/resume._try_warm_start) seed a new chain from the previous
  run's checkpointed state instead of re-burning from scratch;
* **supervised execution** - each refit runs under the crash-only
  supervisor (resilience/supervisor.supervise), so daemon-era fits keep
  the poison/watchdog/retry contract;
* **streamed export** - ``FitConfig.stream_artifact`` lands the serving
  artifact during the fit's accumulator drain, so fit->export is free;
* **atomic promotion** - serve/promote flips the fleet's ``CURRENT``
  pointer only after the cycle's validation gates pass; a failed gate
  keeps the old artifact serving.

:mod:`dcfm_tpu_torch.online.cycle` is the typed state machine for ONE pass
(detect -> refit -> export -> validate -> promote);
:mod:`dcfm_tpu_torch.online.watch` is the daemon that runs cycles forever
(``dcfm-tpu-torch watch``), polling a data directory or woken by SIGUSR1.
"""

from dcfm_tpu_torch.online.cycle import (
    CycleRefusedError, CycleResult, CycleSettings, OnlineError, plan_cycle,
    run_cycle)
from dcfm_tpu_torch.online.watch import Watcher, watch_main

__all__ = [
    "CycleRefusedError", "CycleResult", "CycleSettings", "OnlineError",
    "plan_cycle", "run_cycle", "Watcher", "watch_main",
]
