"""Fault-tolerant runs: supervised auto-resume, deterministic fault
injection, and the on-chain divergence sentinel.

The port of ``dcfm_tpu/resilience``:

* :mod:`~dcfm_tpu_torch.resilience.supervisor` - ``supervise()`` /
  ``dcfm-tpu-torch fit --supervise``: the fit runs in a child process
  and, on crash/SIGKILL/preemption, resumes from the last good
  checkpoint with exponential backoff, a max-retry budget, and
  poison-iteration detection (typed :class:`PoisonedRunError`);
  ``supervise_pod`` / ``supervise --pod N`` does the same for an
  N-process pod (coordinated stop, unanimous-generation resume, elastic
  degrade).
* :mod:`~dcfm_tpu_torch.resilience.faults` - the deterministic fault
  harness (``DCFM_FAULT_PLAN``), threaded through the fit's chunk loop,
  resume windows and checkpoint writer and the serving plane.
* :mod:`~dcfm_tpu_torch.resilience.sentinel` - the divergence sentinel
  the chunk loop folds in: on NaN/Inf it rewinds to the last checkpoint
  on re-lineaged streams with an escalated ridge jitter.
"""

from dcfm_tpu_torch.resilience.faults import (
    FaultPlan, fault_event, fault_plan, fuzz_spec)
from dcfm_tpu_torch.resilience.sentinel import (
    ChainDivergedError, DivergenceSentinel)
from dcfm_tpu_torch.resilience.supervisor import (
    PodCapacityError, PodHangError, PoisonedRunError,
    RetriesExhaustedError, SuperviseReport, supervise, supervise_command,
    supervise_pod)

__all__ = [
    "ChainDivergedError",
    "DivergenceSentinel",
    "FaultPlan",
    "fault_event",
    "fault_plan",
    "fuzz_spec",
    "PodCapacityError",
    "PodHangError",
    "PoisonedRunError",
    "RetriesExhaustedError",
    "SuperviseReport",
    "supervise",
    "supervise_command",
    "supervise_pod",
]
