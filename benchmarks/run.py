"""Run one cell of the benchmark of ``dcfm_tpu_torch`` once.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run makes
its data from the seed, warms up, fits back to back for ``--seconds``
(fitbench/cell.py), holds one fit against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced) and,
last, ``compared``: each number compared beside its limit, which are also
the last lines on standard error.  Without a CUDA device, with fewer than
the cell's chips, or with JAX loaded, it prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def say(line: str, out) -> None:
    """One line of the run's console protocol on ``out``."""
    print(line, file=out, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e!r})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi read nothing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(1, os.path.dirname(here))
    from fitbench import cell as runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        say("no CUDA device: the benchmark measures the card only",
            sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible", sys.stderr)
        return 2
    try:
        import dcfm_tpu_torch  # noqa: F401
    except ImportError as e:
        say(f"the program is not in this checkout: {e}", sys.stderr)
        return 2
    try:
        out = runner.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0)
    except runner.JaxLoaded as e:
        say(str(e), sys.stderr)
        return 2
    say(f"card: {card_line()}", sys.stderr)
    for name, row in out["compared"].items():
        say(f"compared {name}: {row['value']!r} limit {row['limit']!r}",
            sys.stderr)
    say(json.dumps(out), sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
