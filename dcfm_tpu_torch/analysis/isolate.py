"""Crash-isolated test runner: one pytest subprocess per test file.

The tier-1 suite runs in a single long-lived process; a native-level
abort (SIGABRT from heap corruption in the ctypes assembler, an XLA
CPU segfault, a daemon thread dying inside numpy at teardown) kills
that process and silently hides every test after the crash point.  This
runner is the fallback lane: each test file runs in its own
interpreter, so a crash fails ONE file - with its signal identified -
and the rest of the suite still reports.

Usage::

    python -m dcfm_tpu_torch.analysis.isolate [tests_dir] [-- pytest args...]
    dcfm-tpu-torch test-isolated [tests_dir] [-- pytest args...]

Exit code 0 iff every file's subprocess exited 0 (or collected nothing,
pytest's exit code 5 - an empty file under a marker filter is not a
failure).  Default pytest arguments mirror the tier-1 command
(``-q -m 'not slow' -p no:cacheprovider``).

The port's copy of ``dcfm_tpu/analysis/isolate.py``: the same per-file
outcomes, signal names, summary line and exit code.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time

_DEFAULT_PYTEST_ARGS = ["-q", "-m", "not slow",
                        "--continue-on-collection-errors",
                        "-p", "no:cacheprovider", "-p", "no:xdist",
                        "-p", "no:randomly"]
_OK_CODES = (0, 5)                      # 5 = no tests collected


def _signal_name(returncode: int) -> str:
    """'SIGABRT' for -6 / 134-style codes, '' for plain failures."""
    num = None
    if returncode < 0:
        num = -returncode
    elif returncode > 128:              # shell-style 128+N
        num = returncode - 128
    if num is not None:
        try:
            return signal.Signals(num).name
        except ValueError:
            return f"signal {num}"
    return ""


def run_isolated(test_files, pytest_args=None, *, timeout=600,
                 out=sys.stdout) -> int:
    """Run each file in its own pytest subprocess; return an exit code.

    Prints one status line per file and an ``ISOLATED SUMMARY`` line -
    greppable the same way the tier-1 DOTS_PASSED line is.
    """
    pytest_args = list(_DEFAULT_PYTEST_ARGS if pytest_args is None
                      else pytest_args)
    passed, failed, crashed = [], [], []
    for tf in test_files:
        cmd = [sys.executable, "-m", "pytest", tf, *pytest_args]
        t0 = time.monotonic()
        timed_out = False
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
            rc = proc.returncode
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-12:]
        except subprocess.TimeoutExpired as e:
            # a hang is its own failure class - do NOT borrow the signal
            # namespace (nothing was ever delivered to the child)
            rc, timed_out = 1, True
            tail = [f"timeout after {e.timeout}s (hang, not a crash)"]
        dt = time.monotonic() - t0
        sig = _signal_name(rc)
        if timed_out:
            crashed.append((tf, "TIMEOUT"))
            print(f"[isolated] HANG  {tf} (timeout, {dt:.1f}s)", file=out)
            for line in tail:
                print(f"    {line}", file=out)
        elif rc in _OK_CODES:
            passed.append(tf)
            print(f"[isolated] PASS  {tf} ({dt:.1f}s)", file=out)
        elif sig:
            crashed.append((tf, sig))
            print(f"[isolated] CRASH {tf} ({sig}, {dt:.1f}s)", file=out)
            for line in tail:
                print(f"    {line}", file=out)
        else:
            failed.append(tf)
            print(f"[isolated] FAIL  {tf} (rc={rc}, {dt:.1f}s)", file=out)
            for line in tail:
                print(f"    {line}", file=out)
    print(f"ISOLATED SUMMARY: {len(passed)} file(s) passed, "
          f"{len(failed)} failed, {len(crashed)} crashed"
          + (" [" + ", ".join(f"{t}:{s}" for t, s in crashed) + "]"
             if crashed else ""), file=out)
    return 0 if not failed and not crashed else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    passthrough = None
    if "--" in argv:
        i = argv.index("--")
        argv, passthrough = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(
        prog="dcfm-tpu-torch test-isolated", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("tests", nargs="?", default="tests",
                   help="test directory or single test file")
    p.add_argument("--timeout", type=int, default=600,
                   help="per-file subprocess timeout in seconds")
    args = p.parse_args(argv)
    if os.path.isdir(args.tests):
        files = sorted(glob.glob(os.path.join(args.tests, "test_*.py")))
    else:
        files = [args.tests]
    if not files:
        print(f"no test files under {args.tests}", file=sys.stderr)  # dcfm: ignore[DCFM901] - the test-isolated CLI's own usage error
        return 2
    return run_isolated(files, passthrough, timeout=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
