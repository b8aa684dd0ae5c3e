"""``dcfm-tpu-torch watch``: the daemon that runs online cycles forever.

The port of ``dcfm_tpu/online/watch.py``.  The refits run on the card
unless ``--backend torch_cpu`` asks for the CPU (the port's one flag
beyond the JAX daemon's, as ``--device`` is for ``serve``); a supervised
refit leaves the card to its child, and the daemon materializes no
FitResult (online/cycle.default_runner).

The watcher polls a data directory every ``interval`` seconds (or is
woken immediately by SIGUSR1), reads the manifest of ``Y.npy``, and
when it changed runs one :mod:`~dcfm_tpu_torch.online.cycle` - refit (warm
when the change is additive), validate, promote - so a serving fleet
pointed at the same promotion root hot-swaps generation N -> N+1 with
zero dropped requests.

Crash-only by construction, like everything upstream of it:

* the *refit* runs under ``supervise()`` (its own checkpoint, poison
  detection, retry budget) - killing the daemon mid-refit loses
  nothing a relaunch cannot resume;
* the *promotion* is the atomic pointer write of serve/promote - a
  kill mid-promotion leaves the old pointer (plus a stale tmp file),
  never a torn one;
* the watcher's own progress (``state.json``: last promoted manifest +
  the checkpoint that becomes the next warm-start donor) is written
  with the same tmp+fsync+replace discipline, and only AFTER a
  promotion - a daemon killed anywhere mid-cycle re-detects the same
  change on restart and runs the cycle again, resuming the refit from
  its checkpoint.

A refused cycle (:class:`~dcfm_tpu_torch.online.cycle.CycleRefusedError`)
does not kill the daemon: the refusal is recorded and the watcher keeps
polling - fresh data may supersede the refused change.  Every other
exception is wrapped in the typed :class:`WatchError`, whose message
names the flight-recorder path (the ``PoisonedRunError`` triage
contract).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from typing import Callable, Optional

from dcfm_tpu_torch.obs.recorder import (
    OBS_DIR_ENV_VAR, RUN_ID_ENV_VAR, FlightRecorder, install, record,
    uninstall)
from dcfm_tpu_torch.online.cycle import (
    DATA_FILE, CyclePlan, CycleRefusedError, CycleResult, CycleSettings,
    OnlineError, default_runner, plan_cycle, read_manifest, run_cycle)

STATE_FILE = "state.json"


class WatchError(OnlineError):
    """The watch daemon itself failed (unreadable state, bad data dir).
    The message names the flight-recorder path."""


def _log(msg: str) -> None:
    # structured telemetry lives in the flight recorder; this line is
    # the operator-visible stderr trail, like the supervisor's
    print(f"[watch] {msg}", file=sys.stderr, flush=True)  # dcfm: ignore[DCFM901] - the watch daemon's documented stderr mirror


class Watcher:
    """One watch daemon: data directory in, promoted generations out.

    ``runner`` is the cycle's refit seam (tests inject an in-process
    fit; production uses the supervised default).  The loop consults
    ``stop`` on every turn and ``wake`` both paces the poll and lets a
    signal (or a test) trigger an immediate scan - SHUTDOWN-SAFE by
    construction, which is exactly what dcfm-lint DCFM1301 pins for
    every polling loop in this library."""

    def __init__(self, data_dir: str, settings: CycleSettings, *,
                 interval: float = 5.0,
                 runner: Optional[Callable] = None,
                 obs_dir: Optional[str] = None,
                 log: Callable[[str], None] = _log):
        self.data_dir = data_dir
        self.settings = settings
        self.interval = float(interval)
        self.runner = runner
        self.obs_dir = obs_dir
        self.log = log
        self.stop = threading.Event()
        self.wake = threading.Event()
        self.cycles = 0
        os.makedirs(settings.workdir, exist_ok=True)
        self._state_path = os.path.join(settings.workdir, STATE_FILE)

    # -- persisted progress ------------------------------------------------

    def load_state(self) -> dict:
        """Last promoted manifest + donor checkpoint.  A torn or missing
        state file degrades to "never promoted" - the next cycle
        re-detects and re-runs, which is idempotent by the generation
        gate."""
        try:
            with open(self._state_path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _save_state(self, state: dict) -> None:
        tmp = self._state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path)

    # -- one pass ----------------------------------------------------------

    def scan(self) -> Optional[CyclePlan]:
        """Read the data manifest and plan a cycle, or None when the
        data is absent or unchanged."""
        try:
            manifest = read_manifest(self.data_dir)
        except (OSError, ValueError):
            return None      # no data yet - keep polling
        state = self.load_state()
        return plan_cycle(self.settings, state.get("manifest"), manifest,
                          state.get("checkpoint"))

    def run_once(self) -> Optional[CycleResult]:
        """One full pass: scan, and when something changed, run the
        cycle and persist the new state.  Raises
        :class:`CycleRefusedError` on a refused gate (state unchanged -
        the same change re-detects next pass)."""
        plan = self.scan()
        if plan is None:
            return None
        self.log(f"detected {plan.kind}: n={plan.manifest['n']} "
                 f"p={plan.manifest['p']} -> generation "
                 f"{plan.target_generation} "
                 f"({'warm' if plan.warm_from else 'cold'} refit)")
        import numpy as np
        Y = np.load(os.path.join(self.data_dir, DATA_FILE))
        result = run_cycle(self.settings, Y, plan, runner=self.runner,
                           obs_dir=self.obs_dir)
        self._save_state({"manifest": result.manifest,
                          "checkpoint": result.checkpoint,
                          "generation": result.generation})
        self.cycles += 1
        d = result.delta
        self.log(f"promoted generation {result.generation} "
                 f"({'warm' if result.warm else 'cold'}, "
                 f"refit {result.refit_s:.1f}s, "
                 f"data-to-serving {result.cycle_s:.1f}s"
                 + (f", delta {d['panels_changed']}/{d['panels_total']}"
                    f" panels, {d['bytes_shipped']}/{d['full_bytes']} B"
                    if d else ", full artifact") + ")")
        return result

    # -- the daemon loop ---------------------------------------------------

    def run(self) -> int:
        """Poll until :attr:`stop` is set.  Refused cycles are logged
        and survived; unexpected failures stop the daemon with the
        typed error."""
        while not self.stop.is_set():
            try:
                self.run_once()
            except CycleRefusedError as e:
                # refusals are the gates WORKING: old artifact serving,
                # refusal recorded; fresh data may supersede the change
                self.log(f"cycle refused: {e}")
            except OnlineError as e:
                self.log(f"cycle failed: {e}")
            except Exception as e:
                # wrapped into the one typed daemon error, naming the
                # flight-recorder path (PoisonedRunError's contract)
                from dcfm_tpu_torch.resilience.supervisor import postmortem
                raise WatchError(
                    f"watch daemon failed: {type(e).__name__}: {e}"
                    + postmortem(self.obs_dir)) from e
            self.wake.wait(self.interval)
            self.wake.clear()
        self.log("stopped")
        return 0

    def install_signals(self) -> None:
        """SIGUSR1 wakes the poll immediately; SIGTERM/SIGINT stop the
        daemon at the next loop turn (the refit child, if any, is the
        supervisor's to reap)."""
        def _wake(signum, frame):
            self.wake.set()

        def _stop(signum, frame):
            self.stop.set()
            self.wake.set()

        signal.signal(signal.SIGUSR1, _wake)
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcfm-tpu-torch watch",
        description="Watch a data directory; refit (warm) and promote "
                    "artifact generations to a serving fleet's "
                    "promotion root.")
    p.add_argument("data_dir", help="directory holding Y.npy")
    p.add_argument("root", help="promotion root the fleet watches")
    p.add_argument("--workdir", default=None,
                   help="checkpoints + state + obs "
                        "(default: <root>/.watch)")
    p.add_argument("--interval", type=float, default=5.0,
                   help="poll period seconds (SIGUSR1 wakes immediately)")
    p.add_argument("--once", action="store_true",
                   help="run a single pass and exit (exit 3 = refused)")
    p.add_argument("--shard-width", type=int, required=True,
                   help="features per shard; p grows by whole shards")
    p.add_argument("--factors", type=int, required=True,
                   help="latent factors per shard")
    p.add_argument("--rho", type=float, default=0.5)
    p.add_argument("--prior", default="mgp",
                   choices=("mgp", "horseshoe", "dl"))
    p.add_argument("--burnin", type=int, required=True,
                   help="cold-start burn-in iterations")
    p.add_argument("--mcmc", type=int, required=True)
    p.add_argument("--warm-burnin", type=int, default=None,
                   help="burn-in for warm refits (default: burnin // 4)")
    p.add_argument("--thin", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-size", type=int, default=0)
    p.add_argument("--max-drift", type=float, default=0.5,
                   help="rel-Frobenius promotion gate vs the serving "
                        "artifact")
    p.add_argument("--max-retries", type=int, default=3)
    p.add_argument("--no-supervise", action="store_true",
                   help="refit in-process instead of under supervise() "
                        "(tests / debugging)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "torch_cuda", "torch_cpu"],
                   help="device of the refits: 'auto' and 'torch_cuda' "
                        "fit on the card, 'torch_cpu' on the host")
    return p


def watch_main(argv: Optional[list] = None) -> int:
    """CLI entry (``dcfm-tpu-torch watch``)."""
    args = build_parser().parse_args(argv)
    workdir = args.workdir or os.path.join(args.root, ".watch")
    settings = CycleSettings(
        root=args.root, workdir=workdir,
        factors_per_shard=args.factors, rho=args.rho,
        shard_width=args.shard_width, burnin=args.burnin, mcmc=args.mcmc,
        warm_burnin=(args.warm_burnin if args.warm_burnin is not None
                     else max(1, args.burnin // 4)),
        thin=args.thin, seed=args.seed, chunk_size=args.chunk_size,
        max_drift=args.max_drift, supervised=not args.no_supervise,
        max_retries=args.max_retries, prior=args.prior)
    os.makedirs(workdir, exist_ok=True)
    obs_dir = os.environ.get(OBS_DIR_ENV_VAR) or os.path.join(workdir,
                                                              "obs")
    rec = FlightRecorder(obs_dir, role="watch")
    # export the obs session so every supervised refit child records
    # into the SAME directory - one loop, one event trail (the
    # supervisor does the same for its launches)
    prev_env = {k: os.environ.get(k)
                for k in (OBS_DIR_ENV_VAR, RUN_ID_ENV_VAR)}
    os.environ[OBS_DIR_ENV_VAR] = obs_dir
    os.environ[RUN_ID_ENV_VAR] = rec.run_id
    install(rec)
    watcher = Watcher(args.data_dir, settings, interval=args.interval,
                      runner=default_runner(settings, args.backend),
                      obs_dir=obs_dir)
    try:
        record("watch_start", data_dir=args.data_dir, root=args.root,
               interval=args.interval, once=bool(args.once))
        if args.once:
            try:
                res = watcher.run_once()
            except CycleRefusedError as e:
                _log(f"cycle refused: {e}")
                return 3
            _log("no change" if res is None
                 else f"promoted generation {res.generation}")
            return 0
        watcher.install_signals()
        return watcher.run()
    finally:
        record("watch_stop", cycles=watcher.cycles)
        uninstall(rec)
        rec.close()
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
