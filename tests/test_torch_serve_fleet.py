"""The port's serving fleet: port workers (``python -m dcfm_tpu_torch.cli
serve --device cpu``) behind SO_REUSEPORT, supervised by the port's fleet.

A SIGKILLed worker respawns while traffic keeps flowing bitwise, SIGTERM
drains the fleet, and the port's ``events`` CLI narrates the run; workers
that die before serving - a missing artifact, or a card that is not
there - trip poison detection however long their start-up took; and one
seeded chaos point of ``serve_fuzz_spec`` (the JAX package's stream)
runs end to end.  The 25-point sweep is ``slow``-marked, as the JAX
package's is.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.resilience.faults import serve_fuzz_spec as jax_spec  # noqa: E402
from dcfm_tpu_torch.obs.cli import summarize  # noqa: E402
from dcfm_tpu_torch.resilience.faults import serve_fuzz_spec  # noqa: E402
from dcfm_tpu_torch.serve.artifact import (  # noqa: E402
    MEAN_PANELS_FILE, PosteriorArtifact)
from dcfm_tpu_torch.serve.loadgen import run_load  # noqa: E402
from dcfm_tpu_torch.serve.promote import promote_artifact  # noqa: E402
from tests.test_torch_serve_delta import _flip_byte, _variant  # noqa: E402
from tests.test_torch_serve_server import P_ORIG, make_artifact  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(base, path, timeout=15):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get_retry(base, path, tries=40):
    """A SIGKILLed SO_REUSEPORT worker resets in-flight connections; the
    retry lands on a live replica."""
    for attempt in range(tries):
        try:
            return _get(base, path)
        except OSError:
            time.sleep(0.05 * (attempt + 1))
    raise AssertionError(f"no replica ever answered {path}")


def _readline_bounded(proc, timeout=120.0):
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()))
    t.start()
    t.join(timeout)
    if t.is_alive():
        proc.kill()
        proc.communicate()
        raise AssertionError("fleet never printed its protocol line")
    return out[0]


def _spawn_fleet(root, run_dir, *, workers=2, extra=(), env_extra=None,
                 device="cpu"):
    env = dict(os.environ, **(env_extra or {}))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "dcfm_tpu_torch.cli", "serve", root,
         "--workers", str(workers), "--port", "0", "--run-dir", run_dir,
         "--fleet-min-uptime", "0.2", "--fleet-backoff", "0.1",
         "--request-timeout", "30", "--swap-poll", "0.05",
         "--device", device, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    line = _readline_bounded(proc)
    assert line, proc.stderr.read()
    return proc, json.loads(line)


def _terminate_fleet(proc, timeout=120.0):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("fleet hung past the drain bound")


def _ready_events(run_dir):
    """The fleet's ``worker_ready`` events (one per launch that served,
    with its start-up seconds)."""
    try:
        with open(os.path.join(run_dir, "events-fleet.jsonl")) as f:
            return [json.loads(ln) for ln in f if '"worker_ready"' in ln]
    except OSError:
        return []


def _await_ready_events(run_dir, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = _ready_events(run_dir)
        if len(got) >= n:
            return got
        time.sleep(0.05)
    raise AssertionError(f"fewer than {n} worker launches ever served")


def test_fleet_kill_respawn_drain_and_events(tmp_path):
    root = str(tmp_path / "root")
    os.makedirs(root)
    v1 = make_artifact(os.path.join(root, "v1"), seed=6)
    ref = PosteriorArtifact.open(v1).assemble()
    promote_artifact(root, "v1")
    run_dir = str(tmp_path / "obs")
    proc, info = _spawn_fleet(root, run_dir)
    try:
        assert info["ready"] is True and info["workers"] == 2
        base = info["serving"]
        st, h, _ = _get_retry(base, "/healthz")
        assert st == 200 and h["device"] == "cpu"
        assert h["worker"]["index"] in (0, 1)
        assert h["artifact_generation"] == 1
        ready = _await_ready_events(run_dir, 2)
        os.kill(ready[0]["pid"], signal.SIGKILL)
        # traffic keeps flowing while the worker respawns and serves again
        rng = np.random.default_rng(0)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and len(_ready_events(run_dir)) < 3:
            i, j = (int(v) for v in rng.integers(0, P_ORIG, 2))
            st, e, _ = _get_retry(base, f"/v1/entry?i={i}&j={j}")
            assert st == 200 and np.float32(e["value"]) == ref[i, j]
        relaunch = _await_ready_events(run_dir, 3)[2]
        assert relaunch["launch"] == 2 and relaunch["startup_s"] > 0
        ws = _get_retry(base, "/healthz")[1]["fleet"]["workers"]
        assert all(w["alive"] for w in ws)
    finally:
        out, err = _terminate_fleet(proc)
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1])["drained"] is True
    s = summarize(run_dir)
    assert len(s["worker_launches"]) >= 3
    assert len(s["worker_deaths"]) >= 1
    assert s["fleet_drained"] is True and not s["fleet_poisoned"]
    cp = subprocess.run(
        [sys.executable, "-m", "dcfm_tpu_torch.cli", "events", run_dir],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert cp.returncode == 0, cp.stderr
    assert "serve worker deaths" in cp.stdout
    assert "fleet drained cleanly" in cp.stdout
    # the SIGKILL after serving is no instant death
    with open(os.path.join(run_dir, "events-fleet.jsonl")) as f:
        deaths = [json.loads(ln) for ln in f if '"worker_death"' in ln]
    assert deaths and not deaths[0]["instant"] and deaths[0]["ready"]


@pytest.mark.parametrize("case", ["no_artifact", "no_card"])
def test_fleet_poison_detection_on_deaths_before_serving(tmp_path, case):
    """Workers that die before their serving line every launch are
    deterministic breakage - a missing artifact, or ``--device cuda`` on
    a host without a card (its start-up outlasts ``--fleet-min-uptime``
    and is still an instant death): the fleet exits 2, poisoned."""
    if case == "no_card" and torch.cuda.is_available():
        pytest.skip("a card is present: CUDA initialisation succeeds")
    if case == "no_artifact":
        target, device = str(tmp_path / "no-such-artifact"), "cpu"
    else:
        target = make_artifact(str(tmp_path / "a"), seed=1)
        device = "cuda"
    run_dir = str(tmp_path / "obs")
    proc, info = _spawn_fleet(target, run_dir, device=device,
                              extra=["--fleet-poison-deaths", "2"])
    try:
        out, err = proc.communicate(timeout=120.0)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("poisoned fleet never gave up")
    assert info["ready"] is False
    assert proc.returncode == 2, (out, err)
    lines = [json.loads(ln) for ln in out.strip().splitlines()]
    assert any(ln.get("poisoned") for ln in lines), lines
    s = summarize(run_dir)
    assert s["fleet_poisoned"] is True and len(s["worker_deaths"]) >= 2
    with open(os.path.join(run_dir, "events-fleet.jsonl")) as f:
        deaths = [json.loads(ln) for ln in f if '"worker_death"' in ln]
    assert all(d["instant"] and not d["ready"] for d in deaths)
    if case == "no_card":
        assert all(d["uptime_s"] > 0.2 for d in deaths)


def _run_chaos_point(tmp_path, seed, index):
    """One seeded chaos point end to end: the promotion root, the point's
    fault plan exported to a 2-worker port fleet, the loadgen (with the
    point's slow-loris clients), an optional mid-load promotion (of a
    corrupted candidate if the point says so), then a bounded drain."""
    spec = serve_fuzz_spec(seed, index, workers=2, max_requests=30)
    assert spec == jax_spec(seed, index, workers=2, max_requests=30)
    sv = spec["serve"]
    root = str(tmp_path / f"root{index}")
    os.makedirs(root)
    v1 = make_artifact(os.path.join(root, "v1"), seed=100 + index)
    promote_artifact(root, "v1")
    v2 = _variant(v1, os.path.join(root, "v2"), negate=True)
    if sv["promotion_fault"] == "torn":
        size = os.path.getsize(os.path.join(v2, MEAN_PANELS_FILE))
        with open(os.path.join(v2, MEAN_PANELS_FILE), "r+b") as f:
            f.truncate(size // 2)
    elif sv["promotion_fault"] == "bit_flip":
        _flip_byte(os.path.join(v2, MEAN_PANELS_FILE))
    run_dir = str(tmp_path / f"obs{index}")
    proc, info = _spawn_fleet(
        root, run_dir, extra=["--io-timeout", "1.0",
                              "--fleet-watchdog", "300"],
        env_extra={"DCFM_FAULT_PLAN": json.dumps(spec)})
    timer = None
    try:
        if sv["promote"]:
            timer = threading.Timer(0.3, lambda: promote_artifact(
                root, "v2", verify=not sv["promotion_fault"]))
            timer.start()
        res = run_load(info["serving"], threads=6, requests_per_thread=10,
                       seed=seed * 1000 + index, p=P_ORIG, retries=10,
                       timeout=30.0, slow_clients=sv["slow_clients"],
                       slow_hold_s=3.0)
        if timer is not None:
            timer.join()
    finally:
        if timer is not None:
            timer.cancel()
        out, err = _terminate_fleet(proc)
    assert proc.returncode == 0, (sv, err[-2000:])
    assert res["untyped"] == [], (sv, res["untyped"][:3])
    assert res["dropped"] == 0, (sv, res)
    assert res["generation"]["violations"] == 0, (sv, res)
    if sv["promotion_fault"]:
        assert res["generation"]["max"] in (None, 1), (sv, res)
    return res, spec


def test_serve_chaos_point(tmp_path):
    """Tier-1: the first worker_kill point of the seed-0 stream (a worker
    SIGKILLed mid-request) through the full port fleet."""
    idx = next(i for i in range(40)
               if serve_fuzz_spec(0, i)["serve"]["kind"] == "worker_kill")
    _run_chaos_point(tmp_path, 0, idx)


@pytest.mark.slow
@pytest.mark.parametrize("index", range(25))
def test_serve_chaos_sweep(tmp_path, index):
    """The 25-point sweep (DCFM_SERVE_FUZZ_SEED reseeds the stream)."""
    seed = int(os.environ.get("DCFM_SERVE_FUZZ_SEED", "0"))
    _run_chaos_point(tmp_path, seed, index)
