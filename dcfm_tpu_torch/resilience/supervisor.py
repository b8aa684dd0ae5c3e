"""The supervisor's helpers that the serving fleet reuses.

The port's copy of two names of ``dcfm_tpu/resilience/supervisor.py``:
the typed :class:`PoisonedRunError` and the child reaper :func:`_reap`,
which ``serve/fleet.py`` imports.  The rest of the module - ``supervise``,
``supervise_pod``, the relaunch loop with its backoff and poison
detection for fits, and the supervised CLI - waits for ROADMAP Queue A
item 7 (e), with the fit's fault seams it drives.

Stdlib only: a supervising parent never initializes the card.
"""

from __future__ import annotations

import time


class PoisonedRunError(RuntimeError):
    """The same failure killed the child repeatedly: it is deterministic,
    not environmental - relaunching cannot help.  ``checkpoint_path`` is
    the last good checkpoint of a fit (empty for a serving fleet),
    ``iteration`` its saved position."""

    def __init__(self, message: str, *, checkpoint_path: str = "",
                 iteration: int = -1):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path
        self.iteration = iteration


def _reap(procs: list, grace: float) -> None:
    """SIGTERM every live process, SIGKILL what is still alive after
    ``grace`` seconds, and wait for all of them (no zombie is left)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.perf_counter() + grace
    for p in procs:
        while p.poll() is None and time.perf_counter() < deadline:
            time.sleep(0.02)
        if p.poll() is None:
            p.kill()
        p.wait()
