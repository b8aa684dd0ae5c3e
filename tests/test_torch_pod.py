"""A pod of the port: N processes of one fit meeting through the
``DCFM_*`` environment (parallel/multihost.py), on gloo ranks of the CPU.

A 2-process pod started from the environment is the port's
``mesh_devices=2`` fit bit for bit, every process returns the same Sigma,
and only process 0's CLI writes files.  Its resume is the JAX package's
collective one (runtime/resume.resume_state_multiproc): a process killed
inside the ``resume_gate`` window is resumed bitwise by the next launch;
files one chunk apart are refused under ``resume=True`` with the JAX
package's text and the refusal event's signatures, and start fresh under
``"auto"``.  A 2-process set resumed by one process is the
host-elastic adoption (a ``pod_elastic`` event), refused under
``--no-elastic`` with the JAX package's ``_pod_refusal`` text.

Each pod launch costs a few seconds (every process imports torch); each
test runs under its own deadline.
"""

import functools
import glob
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
from dcfm_tpu.runtime import resume as jresume  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402
from tests.torch_pod_rank import run_pod, run_pod_fit  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.runtime import resume  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402

N, P_COLS, G, K = 40, 64, 4, 3
KW = dict(model=dict(num_shards=G, factors_per_shard=K, rho=0.6),
          run=dict(burnin=10, mcmc=10, thin=2, seed=0, num_chains=1,
                   chunk_size=5),
          backend=dict(sse_mode="gram"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 3, seed=7)
    return Y


def _cfg(pkg=dt, backend=None, **fit_kw):
    return pkg.FitConfig(
        model=pkg.ModelConfig(**KW["model"]), run=pkg.RunConfig(**KW["run"]),
        backend=pkg.BackendConfig(**KW["backend"], **(backend or {})),
        **fit_kw)


@functools.lru_cache(maxsize=None)
def _mesh_sigma():
    """The shard mesh's fit on 2 gloo ranks: the pod's reference."""
    with deadline(60):
        return dt.fit(_data(), _cfg(backend={"mesh_devices": 2}),
                      device="cpu").Sigma


def _pod(tmp_path, name, fit, plan=None):
    """One launch of a 2-process pod fit (tests/torch_pod_rank.py):
    ``[(exit code, log)]`` and each process's result file (None where it
    wrote none)."""
    np.save(tmp_path / "Y.npy", _data())
    out = str(tmp_path / name)
    env = {"DCFM_FAULT_PLAN": json.dumps(plan)} if plan else None
    with deadline(90):
        codes = run_pod_fit(dict(KW, data=str(tmp_path / "Y.npy"), out=out,
                                 fit=fit), 2, str(tmp_path), env=env,
                            timeout=75)
    res = []
    for r in range(2):
        path = f"{out}.proc{r}.npz"
        res.append(dict(np.load(path)) if os.path.exists(path) else None)
    return codes, res


def _events(obs_dir: str, launch_role: str) -> list:
    with open(os.path.join(obs_dir, f"events-{launch_role}.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_a_pod_from_the_environment_is_the_mesh_fit_bitwise(tmp_path):
    """The CLI's ``fit`` under DCFM_COORDINATOR / DCFM_NUM_PROCESSES /
    DCFM_PROCESS_ID, the same command line in 2 processes but for the
    output names: Sigma (and its SD) bitwise the port's
    ``--mesh-devices 2`` fit of the same config; process 0 alone writes
    Sigma, the SD and the draws, and both print the JSON line."""
    np.save(tmp_path / "Y.npy", _data())
    base = [sys.executable, "-m", "dcfm_tpu_torch.cli", "fit",
            str(tmp_path / "Y.npy"), "-g", str(G), "-k", str(G * K),
            "--burnin", "10", "--mcmc", "10", "--chunk-size", "5",
            "--backend", "torch_cpu", "--posterior-sd"]
    with deadline(100):
        codes = run_pod(lambda i: base + [
            "--out", str(tmp_path / f"S{i}.npy"),
            "--draws-out", str(tmp_path / f"D{i}.npz")], 2, str(tmp_path),
            timeout=80)
        assert [c for c, _ in codes] == [0, 0], codes[0][1][-3000:]
        from dcfm_tpu_torch import cli
        assert cli.main(base[3:] + ["--mesh-devices", "2", "--out",
                                    str(tmp_path / "M.npy")]) == 0
    written = sorted(os.path.basename(p) for p in
                     glob.glob(str(tmp_path / "[SD]*.np*")))
    assert written == ["D0.npz", "S0.npy", "S0_sd.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "S0.npy"),
                                  np.load(tmp_path / "M.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "S0_sd.npy"),
                                  np.load(tmp_path / "M_sd.npy"))
    lines = [json.loads(log.strip().splitlines()[-1]) for _, log in codes]
    assert lines[0]["out"] == str(tmp_path / "S0.npy")
    assert lines[0]["shape"] == lines[1]["shape"] == [P_COLS, P_COLS]


def test_a_kill_in_the_resume_gate_is_resumed_bitwise(tmp_path):
    """Launch 1 loses process 1 after its save at iteration 10 (process 0
    dies at its next collective); launch 2 loses process 0 inside the
    ``resume_gate`` window, before the signature gather (process 1 fails
    in the gather); launch 3 resumes at 10, every process agreeing on the
    set's signature, and returns the uninterrupted mesh fit's Sigma on
    both processes."""
    ckpt = str(tmp_path / "ck.npz")
    fit = {"checkpoint_path": ckpt, "checkpoint_every_chunks": 1,
           "resume": "auto", "obs": str(tmp_path / "obs")}
    codes, _ = _pod(tmp_path, "a", fit, {"faults": [
        {"op": "kill", "at_iteration": 10, "when": "post_save",
         "process": 1}]})
    assert codes[1][0] == -9 and codes[0][0] != 0
    assert {int(ck.read_checkpoint_meta(ck.proc_path(ckpt, r, 2))
                ["iteration"]) for r in range(2)} == {10}
    codes, _ = _pod(tmp_path, "b", fit, {"faults": [
        {"op": "kill_event", "event": "resume_gate", "process": 0}]})
    assert codes[0][0] == -9 and codes[1][0] != 0
    codes, res = _pod(tmp_path, "c", fit)
    assert [c for c, _ in codes] == [0, 0], codes[0][1][-3000:]
    for r in range(2):
        assert int(res[r]["executed"]) == 10
        np.testing.assert_array_equal(res[r]["Sigma"], _mesh_sigma())
    decisions = [e for e in _events(str(tmp_path / "obs"), "L1.p0")
                 if e["event"] == "resume_decision"]
    assert {k: decisions[-1][k] for k in
            ("decision", "agree", "kind", "iteration", "acc_start")} == {
        "decision": "resume", "agree": True, "kind": "set",
        "iteration": 10, "acc_start": 0}


def test_files_one_chunk_apart_are_refused_and_auto_starts_fresh(tmp_path):
    """Process 1's file rolled back one save (its ``.bak1``): under
    ``resume=True`` both processes raise the JAX package's refusal, naming
    the signatures, and record the refused decision; under ``"auto"`` the
    pod starts fresh and returns the mesh fit's Sigma."""
    ckpt = str(tmp_path / "ck.npz")
    fit = {"checkpoint_path": ckpt, "checkpoint_every_chunks": 1,
           "checkpoint_keep_last": 2, "obs": str(tmp_path / "obs")}
    codes, _ = _pod(tmp_path, "a", fit)
    assert [c for c, _ in codes] == [0, 0], codes[0][1][-3000:]
    p1 = ck.proc_path(ckpt, 1, 2)
    os.replace(ck.retained_path(p1, 1), p1)
    sigs = [[20, 1, 2, 0], [15, 1, 2, 0]]
    want = ("resume=True but the per-process checkpoints disagree on the "
            f"resume source ({sigs} as [iteration, kind, count, "
            "state_only] rows) - a crash between two processes' saves, or "
            "mixed stale files; delete the files or use resume='auto' to "
            "restart fresh")
    codes, _ = _pod(tmp_path, "b", dict(fit, resume=True))
    for code, log in codes:
        assert code != 0 and f"ValueError: {want}" in log, log[-2000:]
    refused = [e for e in _events(str(tmp_path / "obs"), "L1.p1")
               if e["event"] == "resume_decision"][-1]
    assert {k: refused[k] for k in ("decision", "iteration",
                                    "signatures")} == {
        "decision": "refused", "iteration": 15, "signatures": sigs}
    codes, res = _pod(tmp_path, "c", dict(fit, resume="auto"))
    assert [c for c, _ in codes] == [0, 0], codes[0][1][-3000:]
    for r in range(2):
        assert int(res[r]["executed"]) == 20
        np.testing.assert_array_equal(res[r]["Sigma"], _mesh_sigma())


def test_a_pods_set_resumed_by_one_process_is_pod_elastic(tmp_path,
                                                          monkeypatch):
    """A 2-process pod killed after its saves at iteration 10 leaves a
    complete set; one process resumes it host-elastically - a
    ``pod_elastic`` event (2 -> 1 hosts, one adoption) - bitwise the
    one-process resume of the set's assembled leaves written as a plain
    file.  Under ``--no-elastic`` (DCFM_NO_ELASTIC=1) the resume is refused
    with the JAX package's ``_pod_refusal`` text."""
    ckpt = str(tmp_path / "ck.npz")
    fit = {"checkpoint_path": ckpt, "checkpoint_every_chunks": 1}
    codes, _ = _pod(tmp_path, "a", fit, {"faults": [
        {"op": "kill", "at_iteration": 10, "when": "post_save",
         "process": r} for r in range(2)]})
    assert [c for c, _ in codes] == [-9, -9]
    count, paths, it = ck.find_multiprocess_checkpoint(ckpt)
    assert (count, it) == (2, 10)
    tpl = ck.carry_template(_cfg().model, n=N, P=P_COLS // G, num_chains=1)
    leaves, meta = ck.load_checkpoint_resharded(paths, tpl)
    plain = str(tmp_path / "plain.npz")
    ck.save_checkpoint(plain, leaves, _cfg(), fingerprint=meta["fingerprint"])
    ref = dt.fit(_data(), _cfg(checkpoint_path=plain, resume=True),
                 device="cpu")
    events = []
    monkeypatch.setattr(resume, "record",
                        lambda name, **kw: events.append((name, kw)))
    res = dt.fit(_data(), _cfg(checkpoint_path=ckpt, resume=True),
                 device="cpu")
    np.testing.assert_array_equal(res.Sigma, ref.Sigma)
    assert res.traces.shape[1] == 10
    assert events[0] == ("pod_elastic", {
        "decision": "adopted", "from_hosts": 2, "to_hosts": 1,
        "pod_adoptions": 1, "pair_panels": 12, "iteration": 10})
    monkeypatch.setenv("DCFM_NO_ELASTIC", "1")
    os.unlink(ckpt)                     # the resumed run's plain file
    with pytest.raises(ValueError) as e:
        dt.fit(_data(), _cfg(checkpoint_path=ckpt, resume=True),
               device="cpu")
    text = jresume._pod_refusal(ck.read_checkpoint_meta(paths[0]),
                                _cfg(dcfm_tpu))
    assert str(e.value) == f"refusing to resume: {text}"
