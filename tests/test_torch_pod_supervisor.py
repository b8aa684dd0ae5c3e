"""The port's pod supervisor (resilience/supervisor.py: ``supervise_pod``,
``supervise --pod N``) against the JAX package's.

The twins of the JAX package's pod tests (tests/test_resilience.py): the
coordinated stop reaps a parked sibling and two no-progress deaths are
poison; a launch where nothing dies and nothing finishes is a typed
hang; the watchdog's deadline moves with checkpoint progress.  The
unanimous-generation pre-pass promotes, demotes and orphans exactly what
the JAX package's does on the same trees of v8 ``.procK-of-N``
generations (files both packages read); the capacity probe parses the
environment as the JAX package's; the progress measures agree.  And a
real ``supervise --pod 2`` of a gloo pod through a SIGKILL of process 1
returns the unsupervised pod's Sigma bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu.resilience.supervisor as jsup  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402
from tests.torch_pod_rank import REPO, free_port_base, run_pod  # noqa: E402

import dcfm_tpu_torch.resilience.supervisor as tsup  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402


def test_supervise_pod_coordinated_stop_and_poison(tmp_path):
    """One process exits 7 while its sibling sleeps like a process parked
    in a collective: the sibling is reaped at once (the coordinated stop),
    and two no-progress deaths in a row are the typed poison."""
    def spawn(attempt):
        return [subprocess.Popen([sys.executable, "-c",
                                  "import sys; sys.exit(7)"]),
                subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(120)"])]

    t0 = time.perf_counter()
    with pytest.raises(tsup.PoisonedRunError):
        tsup.supervise_pod(spawn, checkpoint_path=str(tmp_path / "pod.ck"),
                           num_processes=2, backoff_base=0.01,
                           poison_deaths=2, grace=2.0, log=lambda m: None)
    assert time.perf_counter() - t0 < 40


def test_supervise_pod_watchdog_raises_typed_hang(tmp_path):
    """Nothing dies and nothing finishes: the watchdog kills the pod and
    raises the typed hang instead of waiting forever."""
    def spawn(attempt):
        return [subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(120)"])
                for _ in range(2)]

    t0 = time.perf_counter()
    with pytest.raises(tsup.PodHangError, match="watchdog"):
        tsup.supervise_pod(spawn, checkpoint_path=str(tmp_path / "pod.ck"),
                           num_processes=2, launch_timeout=1.5, grace=1.0,
                           log=lambda m: None)
    assert time.perf_counter() - t0 < 30


class _FakeProc:
    """Exits 0 once ``done_after`` seconds have passed."""

    def __init__(self, done_after):
        self._t0, self._done_after = time.perf_counter(), done_after

    def poll(self):
        return (0 if time.perf_counter() - self._t0 >= self._done_after
                else None)

    def terminate(self):
        self._done_after = 0.0

    kill = terminate

    def wait(self):
        return 0


def test_await_pod_watchdog_resets_on_checkpoint_progress():
    """A launch longer than the watchdog is not a hang while its
    checkpoint score advances."""
    t0 = time.perf_counter()

    def progress():
        return int((time.perf_counter() - t0) / 0.4)

    assert tsup._await_pod([_FakeProc(2.5)], launch_timeout=1.2, grace=0.1,
                           log=lambda m: None, progress_fn=progress) == 0


def _gen(path, iteration, keep_last=2):
    """One v8 generation at ``path`` (the keep_last rotation first): the
    meta both packages' scans read and one CRC-recorded leaf."""
    ck._atomic_savez(path, {"version": 8, "config": {}, "treedef": "",
                            "iteration": iteration, "fingerprint": "f",
                            "topology": {"num_chains": 1,
                                         "num_devices": 2,
                                         "num_processes": 2}},
                     {"leaf_0": np.arange(256.0) + iteration},
                     keep_last=keep_last)


def _rot(path):
    """Flip a payload byte in place (a media error the CRC catches)."""
    raw = bytearray(open(path, "rb").read())
    i = bytes(raw).find((np.arange(256.0)
                         + ck.read_checkpoint_meta(path)["iteration"])
                        .tobytes()[64:96])
    assert i > 0
    raw[i] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _tree(d, case):
    base = os.path.join(d, "pod.ck")
    s = [ck.proc_path(base, i, 2) for i in range(2)]
    if case == "lone newest":
        _gen(s[0], 16)
        _gen(s[0], 24)
        _gen(s[1], 16)
    elif case == "corrupt newest":
        for p in s:
            _gen(p, 16)
            _gen(p, 24)
        _rot(s[1])
    elif case == "no unanimous generation":
        _gen(s[0], 8)
        _gen(s[1], 16)
    elif case == "stale other-count family":
        for p in s:
            _gen(p, 8)
        for i in range(3):
            _gen(ck.proc_path(base, i, 3), 24)
        _rot(ck.proc_path(base, 1, 3))
    elif case == "plain beside the set":
        _gen(base, 4)
        _gen(base, 12)
        _rot(base)
        for p in s:
            _gen(p, 8)
        _gen(ck.proc_path(base + ".full", 0, 2), 8)
        _rot(ck.proc_path(base + ".full", 0, 2))
    return base


def _state(d):
    out = {}
    for f in sorted(os.listdir(d)):
        try:
            out[f] = int(ck.read_checkpoint_meta(os.path.join(d, f))
                         ["iteration"])
        except Exception:  # an orphaned / demoted / unreadable file
            out[f] = None
    return out


@pytest.mark.parametrize("case", ["lone newest", "corrupt newest",
                                  "no unanimous generation",
                                  "stale other-count family",
                                  "plain beside the set"])
def test_the_unanimous_pre_pass_is_the_jax_packages(tmp_path, case):
    """On copies of one tree of v8 generations, the port's
    ``_ensure_unanimous_checkpoint`` returns the JAX package's progress,
    demotes as many files and leaves the same files at the same
    iterations (promoted, ``.corrupt``, ``.orphan``); the pod's progress
    and watchdog scores before the pass agree too."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    base = _tree(str(port), case)
    shutil.copytree(port, ref)
    jbase = str(ref / "pod.ck")
    assert tsup._pod_progress(base, 2) == jsup._pod_progress(jbase, 2)
    assert (tsup._watchdog_progress(base, 2)
            == jsup._watchdog_progress(jbase, 2))
    got_r, want_r = tsup.SuperviseReport(), jsup.SuperviseReport()
    got = tsup._ensure_unanimous_checkpoint(base, 2, got_r, lambda m: None)
    want = jsup._ensure_unanimous_checkpoint(jbase, 2, want_r,
                                             lambda m: None)
    assert got == want
    assert got_r.corrupt_fallbacks == want_r.corrupt_fallbacks
    assert _state(str(port)) == _state(str(ref))
    if case == "lone newest":
        assert got == 16


@pytest.mark.parametrize("env,current", [
    ({}, 4), ({"DCFM_POD_CAPACITY": "3"}, 4), ({"DCFM_POD_CAPACITY": "9"}, 4),
    ({"DCFM_POD_CAPACITY": "0"}, 4), ({"DCFM_POD_CAPACITY": "abc"}, 4),
    ({"DCFM_POD_CAPACITY": ""}, 2), ({"DCFM_POD_CAPACITY_FILE": "cap"}, 4),
    ({"DCFM_POD_CAPACITY_FILE": "missing"}, 4),
])
def test_pod_capacity_parses_the_environment_as_the_jax_package(
        tmp_path, monkeypatch, env, current):
    (tmp_path / "cap").write_text(" 2\n")
    for k in ("DCFM_POD_CAPACITY", "DCFM_POD_CAPACITY_FILE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(tmp_path / v) if k.endswith("FILE")
                           else v)
    assert tsup._pod_capacity(current) == jsup._pod_capacity(current)


def test_supervise_pod_2_through_a_sigkill_is_the_unsupervised_pod(
        tmp_path):
    """``dcfm-tpu-torch supervise --pod 2 -- fit ...`` on gloo processes:
    launch 1 loses process 1 after its save at iteration 10, the pod is
    reaped and relaunched on a fresh coordinator port, resumes at 10, and
    writes the unsupervised pod's Sigma bit for bit; the report counts 2
    launches and one death at iteration 10."""
    Y, _ = make_synthetic(40, 64, 3, seed=9)
    np.save(tmp_path / "Y.npy", Y)
    fit = ["fit", str(tmp_path / "Y.npy"), "-g", "4", "-k", "12",
           "--burnin", "10", "--mcmc", "10", "--chunk-size", "5",
           "--backend", "torch_cpu"]
    plan = {"faults": [{"op": "kill", "at_iteration": 10,
                        "when": "post_save", "process": 1,
                        "at_launch": 1}]}
    env = dict(os.environ, DCFM_FAULT_PLAN=json.dumps(plan),
               DCFM_OBS_DIR=str(tmp_path / "obs"), PYTHONPATH=REPO)
    with deadline(110):
        codes = run_pod(lambda i: [sys.executable, "-m", "dcfm_tpu_torch.cli"]
                        + fit + ["--out", str(tmp_path / f"U{i}.npy")], 2,
                        str(tmp_path), timeout=60)
        assert [c for c, _ in codes] == [0, 0], codes[0][1][-3000:]
        sup = subprocess.run(
            [sys.executable, "-m", "dcfm_tpu_torch.cli", "supervise",
             "--pod", "2", "--port-base", str(free_port_base(3)),
             "--backoff", "0.05", "--"] + fit + [
                "--checkpoint", str(tmp_path / "ck.npz"),
                "--checkpoint-every", "1", "--keep-last", "2",
                "--out", str(tmp_path / "S.npy")],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=90)
    assert sup.returncode == 0, sup.stderr[-3000:]
    report = json.loads(sup.stderr.strip().splitlines()[-1])
    assert report["launches"] == 2 and report["final_iteration"] == 20
    assert [d[1] for d in report["deaths"]] == [10]
    np.testing.assert_array_equal(np.load(tmp_path / "S.npy"),
                                  np.load(tmp_path / "U0.npy"))
    assert not os.path.exists(tmp_path / "U1.npy")
    with open(tmp_path / "obs" / "events-supervisor.jsonl") as f:
        launches = [e for e in map(json.loads, f)
                    if e["event"] == "supervisor_launch"]
    assert [e["num_processes"] for e in launches] == [2, 2]
