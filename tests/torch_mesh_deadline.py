"""A deadline for the shard mesh's CPU tests (tests/test_torch_mesh_stream.py,
tests/test_torch_mesh_warm.py, tests/test_torch_mesh_elastic.py): a hung
collective or drain fails the one test that hangs, never the suite."""

import contextlib
import signal
import threading

from dcfm_tpu_torch.parallel import shard


@contextlib.contextmanager
def deadline(seconds: float):
    """Bound a block of mesh fits: rank 0's collectives time out after a
    third of ``seconds`` (the ranks it started die with it), and the block
    raises TimeoutError past ``seconds`` (a wait in Python, such as a
    drain's join, is interrupted there)."""
    timeout, shard.TIMEOUT_S = shard.TIMEOUT_S, seconds / 3
    main = threading.current_thread() is threading.main_thread()
    if main:
        def expire(*_):
            raise TimeoutError(f"mesh test past its {seconds} s deadline")
        before = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, before)
        shard.TIMEOUT_S = timeout
