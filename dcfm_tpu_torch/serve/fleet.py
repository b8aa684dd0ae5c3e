"""Serving fleet: N supervised SO_REUSEPORT workers on one port.

The port's copy of ``dcfm_tpu/serve/fleet.py``.  Each worker is a
``python -m dcfm_tpu_torch.cli serve`` process with its own CUDA context
on the card named by ``--device`` (several workers share one card);
start-up therefore includes the interpreter, torch and CUDA
initialisation, so a death counts as INSTANT when it comes before the
worker's serving line or within ``--fleet-min-uptime`` of its launch - a
worker that fails CUDA initialisation is poison however long the failure
took, and one that is merely slow to start is never declared poisoned.

``dcfm-tpu-torch serve ARTIFACT --workers N`` runs N single-server worker
PROCESSES (each a plain ``serve`` child) that all bind+listen
the same port with ``SO_REUSEPORT`` - the kernel load-balances accepted
connections across them, and because every worker memory-maps the same
read-only artifact, the OS page cache IS the shared panel-byte cache:
a panel paged in by one worker is a warm read for all of them.

The parent holds the port open with a RESERVE socket that is bound but
never listening (TCP listener lookup only selects LISTEN sockets, so
the reserve socket receives no connections) - workers can die and
respawn freely without the port ever being stealable by another
process, and ``--port 0`` resolves to one concrete port before the
first worker spawns.

Supervision mirrors the fit side (``resilience/supervisor.py``, whose
reaper and typed poison error this module reuses):

* a dead worker is respawned; consecutive INSTANT deaths (uptime under
  ``--fleet-min-uptime``) back off exponentially and, past
  ``--fleet-poison-deaths``, trip the typed :class:`PoisonedRunError` -
  a worker that dies on arrival every time is deterministic breakage,
  and relaunching it in a tight loop would just burn the machine;
* SIGTERM/SIGINT drain the WHOLE fleet: each worker gets SIGTERM and
  finishes its in-flight requests (the single-server drain), stragglers
  past ``--fleet-grace`` are reaped, and the parent exits 0;
* SIGHUP fans out to every worker - the force-a-promotion-probe nudge;
* ``--fleet-watchdog S`` hard-bounds the supervisor's lifetime (the
  chaos harness's no-hang guarantee, like ``supervise --pod``);
* every transition is a flight-recorder event (``worker_launch``,
  ``worker_death``, ``fleet_drained``, ...) under the run dir, and the
  liveness table is atomically rewritten to ``fleet.json`` there -
  workers serve it on ``/healthz`` (via ``DCFM_FLEET_STATUS``), so any
  single replica answers for fleet-wide liveness + generation.

Worker stdout/stderr go to per-worker log files in the run dir, not
pipes: a supervisor that must pump pipes can deadlock against a chatty
child, and log files survive the worker for the postmortem.
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

from dcfm_tpu_torch.obs import recorder as _recorder
from dcfm_tpu_torch.obs.recorder import record, record_sync
from dcfm_tpu_torch.resilience.supervisor import PoisonedRunError, _reap

_STATUS_FILE = "fleet.json"


def _log(msg: str) -> None:
    print(f"[fleet] {msg}", file=sys.stderr, flush=True)  # dcfm: ignore[DCFM901] - the fleet supervisor's documented stderr mirror


def _reserve_port(host: str, port: int) -> tuple:
    """Bind (but never listen) a SO_REUSEPORT socket: resolves port 0 to
    a concrete port and keeps it reserved for the fleet's lifetime -
    bound-not-listening sockets receive no connections, so the reserve
    never steals traffic from the workers."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
    except BaseException:
        sock.close()
        raise
    return sock, sock.getsockname()[1]


class _Worker:
    """One supervised serve-worker slot."""

    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.launch = 0
        self.started_at = 0.0
        self.respawn_at = 0.0
        self.instant_deaths = 0
        self.last_exit = None
        # the worker's log and its size at this launch: the launch is
        # ready once its serving line lands past that offset
        self.log_path = ""
        self.log_offset = 0
        self.ready_at = None

    def ready(self) -> bool:
        """Did this launch print its serving line (it bound the port)?"""
        try:
            with open(self.log_path, "rb") as f:
                f.seek(self.log_offset)
                return b'"serving"' in f.read()
        except OSError:
            return False

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FleetSupervisor:
    """Spawn, watch, respawn, and drain the worker processes."""

    def __init__(self, args, *, run_dir: str, host: str, port: int):
        self.args = args
        self.run_dir = run_dir
        self.host = host
        self.port = port
        self.status_path = os.path.join(run_dir, _STATUS_FILE)
        self.workers = [_Worker(i) for i in range(int(args.workers))]
        self.min_uptime = float(getattr(args, "fleet_min_uptime", 1.0))
        self.poison_deaths = int(getattr(args, "fleet_poison_deaths", 3))
        self.backoff_base = float(getattr(args, "fleet_backoff", 0.5))
        self.grace = float(getattr(args, "fleet_grace", 30.0))
        self.watchdog = float(getattr(args, "fleet_watchdog", 0.0))
        self.run_id = os.environ.get("DCFM_RUN_ID", "")

    # -- worker lifecycle ---------------------------------------------
    def _spawn(self, w: _Worker) -> None:
        w.launch += 1
        a = self.args
        argv = [sys.executable, "-u", "-m", "dcfm_tpu_torch.cli", "serve",
                a.artifact, "--host", self.host, "--port", str(self.port),
                "--reuse-port", "--worker-index", str(w.index),
                "--cache-mb", str(a.cache_mb),
                "--max-queue", str(a.max_queue),
                "--max-batch", str(a.max_batch),
                "--request-timeout", str(a.request_timeout),
                "--io-timeout", str(getattr(a, "io_timeout", 10.0)),
                "--swap-poll", str(getattr(a, "swap_poll", 0.5)),
                "--shed-high", str(getattr(a, "shed_high", 0.75)),
                "--shed-low", str(getattr(a, "shed_low", 0.50)),
                "--swap-adopt", str(getattr(a, "swap_adopt", "auto")),
                "--device", str(getattr(a, "device", "cuda"))]
        env = dict(
            os.environ,
            DCFM_OBS_DIR=self.run_dir,
            DCFM_OBS_ROLE=f"serve-w{w.index}.L{w.launch}",
            DCFM_FLEET_STATUS=self.status_path,
            # chaos gating: process-targeted faults address a worker by
            # slot index; launch-gated kills fire on launch 1 only, so a
            # respawned worker runs clean (the supervisor's job is to
            # recover from environmental failure, not replay it)
            DCFM_FAULT_PROCESS=str(w.index),
            DCFM_FAULT_LAUNCH=str(w.launch),
        )
        if self.run_id:
            env["DCFM_RUN_ID"] = self.run_id
        log_path = os.path.join(self.run_dir, f"worker-{w.index}.log")
        w.log_path = log_path
        w.log_offset = (os.path.getsize(log_path)
                        if os.path.exists(log_path) else 0)
        with open(log_path, "ab") as log:
            w.proc = subprocess.Popen(argv, stdout=log, stderr=log,
                                      env=env)
        w.started_at = time.monotonic()
        w.ready_at = None
        record("worker_launch", worker=w.index, launch=w.launch,
               pid=w.proc.pid)
        _log(f"worker {w.index} launch {w.launch} pid {w.proc.pid}")

    def _on_death(self, w: _Worker, now: float) -> None:
        exit_code = w.proc.returncode
        uptime = now - w.started_at
        w.proc = None
        w.last_exit = exit_code
        # before its serving line (CUDA initialisation, a bad artifact) or
        # within min_uptime of the launch
        ready = w.ready_at is not None or w.ready()
        instant = uptime < self.min_uptime or not ready
        w.instant_deaths = w.instant_deaths + 1 if instant else 0
        record("worker_death", worker=w.index, exit=exit_code,
               uptime_s=round(uptime, 3), launch=w.launch,
               instant=instant, ready=ready)
        _log(f"worker {w.index} died exit={exit_code} "
             f"uptime={uptime:.2f}s (launch {w.launch})")
        if w.instant_deaths >= self.poison_deaths:
            record_sync("fleet_poisoned", worker=w.index,
                        instant_deaths=w.instant_deaths)
            raise PoisonedRunError(
                f"worker {w.index} died instantly {w.instant_deaths}x "
                f"in a row (last exit {exit_code}): deterministic "
                f"breakage, not environmental - see "
                f"{os.path.join(self.run_dir, f'worker-{w.index}.log')}")
        # exponential backoff on INSTANT deaths only (a worker that
        # served for a while earned an immediate respawn), with FULL
        # jitter under the cap like the fit supervisor's relaunch
        # backoff: N workers killed by one environmental event must not
        # respawn in lockstep onto the same cold page cache
        cap = (min(self.backoff_base * (2 ** (w.instant_deaths - 1)),
                   30.0)
               if instant else 0.0)
        delay = random.uniform(0.0, cap) if cap else 0.0
        if cap:
            record("supervisor_backoff", worker=w.index,
                   seconds=round(delay, 4), cap=round(cap, 4),
                   next_attempt=w.launch + 1)
        w.respawn_at = now + delay

    # -- status + readiness -------------------------------------------
    def write_status(self) -> None:
        payload = {
            "updated": time.time(),
            "host": self.host, "port": self.port,
            "run_id": self.run_id, "run_dir": self.run_dir,
            "workers": [{"index": w.index, "alive": w.alive(),
                         "pid": (w.proc.pid if w.proc is not None
                                 else None),
                         "launch": w.launch, "last_exit": w.last_exit}
                        for w in self.workers],
        }
        tmp = self.status_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, self.status_path)

    def await_ready(self, timeout: float = 60.0) -> bool:
        """True once SOME worker is accepting on the shared port (the
        reserve socket never listens, so a successful connect proves a
        live worker)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                socket.create_connection((self.host, self.port),
                                         timeout=0.5).close()
                return True
            except OSError:
                if not any(w.alive() for w in self.workers):
                    # every worker already dead: let the supervision
                    # loop decide (respawn or poison), don't spin here
                    return False
                time.sleep(0.05)
        return False

    # -- the loop ------------------------------------------------------
    def supervise(self, stop: threading.Event,
                  hup: threading.Event) -> int:
        """Run until ``stop``; returns the CLI exit code.  The workers
        are already spawned (``fleet_main`` spawns before the readiness
        probe and the protocol line)."""
        deadline = (time.monotonic() + self.watchdog
                    if self.watchdog > 0 else None)
        next_status = 0.0
        try:
            while not stop.is_set():
                stop.wait(0.05)
                now = time.monotonic()
                if hup.is_set():
                    hup.clear()
                    for w in self.workers:
                        if w.alive() and hasattr(signal, "SIGHUP"):
                            w.proc.send_signal(signal.SIGHUP)
                dirty = False
                for w in self.workers:
                    if (w.ready_at is None and w.alive() and w.ready()):
                        # start-up seconds: interpreter, torch, CUDA
                        # initialisation, artifact open, bind
                        w.ready_at = now
                        record("worker_ready", worker=w.index,
                               launch=w.launch, pid=w.proc.pid,
                               startup_s=round(now - w.started_at, 3))
                    if w.proc is not None and w.proc.poll() is not None:
                        self._on_death(w, now)
                        dirty = True
                    if w.proc is None and now >= w.respawn_at:
                        self._spawn(w)
                        dirty = True
                if deadline is not None and now > deadline:
                    record_sync("fleet_watchdog_fired",
                                bound_s=self.watchdog)
                    _log(f"watchdog fired after {self.watchdog}s - "
                         "reaping the fleet")
                    return 3
                if dirty or now >= next_status:
                    self.write_status()
                    next_status = now + 1.0
        except PoisonedRunError as e:
            _log(str(e))
            print(json.dumps({"poisoned": True,  # dcfm: ignore[DCFM901] - the fleet CLI's stdout protocol
                              "error": str(e)}), flush=True)
            return 2
        finally:
            self._drain()
        return 0

    def _drain(self) -> None:
        record("fleet_drain_begin",
               alive=sum(w.alive() for w in self.workers))
        live = [w.proc for w in self.workers if w.alive()]
        for p in live:
            p.terminate()           # workers drain in-flight requests
        deadline = time.monotonic() + self.grace
        for p in live:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
        _reap(live, grace=2.0)      # stragglers: the supervisor's reaper
        for w in self.workers:
            if w.proc is not None:
                w.last_exit = w.proc.returncode
                w.proc = None
        self.write_status()
        record_sync("fleet_drained",
                    exits=[w.last_exit for w in self.workers])
        _log("fleet drained")


def fleet_main(args) -> int:
    """The CLI's ``serve --workers N``."""
    run_dir = (getattr(args, "run_dir", None)
               or os.environ.get("DCFM_OBS_DIR"))
    if not run_dir:
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="dcfm-serve-fleet-")
    os.makedirs(run_dir, exist_ok=True)
    rec = _recorder.install(_recorder.FlightRecorder(run_dir,
                                                     role="fleet"))
    os.environ["DCFM_RUN_ID"] = rec.run_id
    sock, port = _reserve_port(args.host, int(args.port))
    fleet = FleetSupervisor(args, run_dir=run_dir, host=args.host,
                            port=port)
    fleet.run_id = rec.run_id
    stop = threading.Event()
    hup = threading.Event()
    prev = {s: signal.signal(s, lambda *_: stop.set())
            for s in (signal.SIGTERM, signal.SIGINT)}
    if hasattr(signal, "SIGHUP"):
        prev[signal.SIGHUP] = signal.signal(signal.SIGHUP,
                                            lambda *_: hup.set())
    record("fleet_start", workers=int(args.workers), port=port,
           artifact=args.artifact, run_dir=run_dir)
    try:
        # spawn first so await_ready has listeners to probe, print the
        # protocol line, then hand the main thread to the supervision
        # loop (signals land here)
        for w in fleet.workers:
            fleet._spawn(w)
        fleet.write_status()
        ready = fleet.await_ready(timeout=60.0)
        print(json.dumps({"serving": f"http://{args.host}:{port}",  # dcfm: ignore[DCFM901] - the fleet CLI's stdout protocol
                          "workers": int(args.workers),
                          "artifact": args.artifact,
                          "run_dir": run_dir,
                          "ready": ready}), flush=True)
        rc = fleet.supervise(stop, hup)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        sock.close()
        _recorder.uninstall(rec)
    print(json.dumps({"drained": True,  # dcfm: ignore[DCFM901] - the fleet CLI's stdout protocol
                      "workers": int(args.workers)}), flush=True)
    return rc
