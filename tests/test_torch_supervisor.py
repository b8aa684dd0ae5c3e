"""The port's crash supervisor against the JAX package's.

``dcfm_tpu_torch.resilience.supervisor`` is the JAX supervisor: the same
relaunch loop (integrity pre-pass, death accounting, poison detection,
retry budget, watchdog), the same report and typed errors, the same CLI
protocol.  Its supervised children fit with the port; a supervised kill
-> resume is bitwise the port's uninterrupted fit, and the reports equal
the JAX supervisor's under the same plan and schedule.  ``--pod N``
starts the N processes of a pod with the JAX package's environment
contract (the pod half itself: tests/test_torch_pod_supervisor.py).
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu.cli as jax_cli  # noqa: E402
import dcfm_tpu.resilience.supervisor as jsup  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
import dcfm_tpu_torch.cli as port_cli  # noqa: E402
import dcfm_tpu_torch.resilience.supervisor as tsup  # noqa: E402
from dcfm_tpu_torch.resilience import faults as tf  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_resilience.py's data and schedule: boundaries 8, 16, 24, 32
_ARGS = ["--shards", "2", "--factors", "6", "--burnin", "16", "--mcmc",
         "16", "--thin", "2", "--chunk-size", "8"]
_SUPERVISE = ["--checkpoint-every", "1", "--keep-last", "2", "--supervise",
              "--supervise-backoff", "0.05"]


@pytest.fixture(autouse=True)
def _no_plan():
    tf.clear()
    yield
    tf.clear()


def _env(plan=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(REPO, ".jax_cache"))
    env.pop("DCFM_FAULT_PLAN", None)
    if plan is not None:
        env["DCFM_FAULT_PLAN"] = json.dumps(plan)
    return env


def _fit_cli(module, data, out, extra, plan=None):
    return subprocess.Popen(
        [sys.executable, "-m", module, "fit", data] + _ARGS
        + ["--out", out] + extra, env=_env(plan), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _report(proc) -> tuple:
    """(exit code, the stderr JSON of the supervision protocol)."""
    err = proc.communicate(timeout=900)[1]
    assert proc.returncode in (0, 3), err[-3000:]
    return proc.returncode, json.loads(err.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sup")
    Y, _ = make_synthetic(n=40, p=24, k_true=3, seed=7)
    path = str(d / "Y.npy")
    np.save(path, Y)
    ref = str(d / "ref.npy")
    proc = _fit_cli("dcfm_tpu_torch.cli", path, ref,
                    ["--backend", "torch_cpu"])
    assert proc.wait(timeout=900) == 0, proc.communicate()[1][-3000:]
    return path, np.load(ref)


# Each plan is deterministic whatever the write-behind writer defers: the
# first boundary always saves (the writer is idle), and so does the last
@pytest.mark.parametrize("plan,extra,want", [
    # a post-save kill at the first boundary: one death, resumed to the end
    ({"faults": [{"op": "kill", "at_iteration": 8, "when": "post_save"}]},
     [], {"launches": 2, "deaths": [[-9, 8]], "corrupt_fallbacks": 0}),
    # the poison drill: every launch dies before its first save
    ({"faults": [{"op": "kill", "at_iteration": 8, "when": "pre_save"}]},
     [], {"error": "PoisonedRunError", "iteration": -1}),
    # two boundaries, 16 and 32: the last save is bit-flipped and the
    # child dies after it; the relaunch demotes it and resumes the save
    # at 16
    ({"faults": [{"op": "bit_flip", "target": "checkpoint", "at_write": 2,
                  "at_launch": 1},
                 {"op": "kill", "at_iteration": 32, "when": "post_save",
                  "at_launch": 1}]},
     ["--chunk-size", "16"],
     {"launches": 2, "deaths": [[-9, 32]], "corrupt_fallbacks": 1}),
])
def test_supervised_report_is_the_jax_supervisors(tmp_path, data, plan,
                                                  extra, want):
    """``fit --supervise`` under one plan and schedule in both CLIs, side
    by side: the same exit, the same report (launches, deaths with their
    codes and iterations, corrupt fallbacks, final iteration) or the same
    typed failure; a finished run is bitwise the port's uninterrupted
    fit."""
    path, ref = data
    out = str(tmp_path / "port.npy")
    port = _fit_cli("dcfm_tpu_torch.cli", path, out,
                    ["--backend", "torch_cpu", "--checkpoint",
                     str(tmp_path / "port.ck")] + _SUPERVISE + extra, plan)
    jax = _fit_cli("dcfm_tpu.cli", path, str(tmp_path / "jax.npy"),
                   ["--checkpoint", str(tmp_path / "jax.ck")] + _SUPERVISE
                   + extra, plan)
    (t_rc, t_rep), (j_rc, j_rep) = _report(port), _report(jax)
    assert t_rc == j_rc
    if t_rc == 3:
        for k in ("message", "checkpoint"):
            t_rep.pop(k), j_rep.pop(k)
        assert t_rep == j_rep == {"error": want["error"],
                                  "iteration": want["iteration"]}
        return
    assert t_rep == j_rep
    assert t_rep == dict(want, supervised=True, final_iteration=32)
    np.testing.assert_array_equal(np.load(out), ref)


@pytest.fixture(scope="module")
def two_chain_checkpoints(data, tmp_path_factory):
    """Each package's finished 2-chain checkpoint of ``data``'s fit."""
    d = tmp_path_factory.mktemp("elastic")
    procs = {}
    for module, extra in _PACKAGES:
        ck = str(d / f"{module}.ck")
        procs[module] = (ck, _fit_cli(module, data[0], ck + ".S.npy",
                                      extra + ["--chains", "2",
                                               "--checkpoint", ck]))
    for ck, proc in procs.values():
        assert proc.wait(timeout=900) == 0, proc.communicate()[1][-3000:]
    return {m: ck for m, (ck, _) in procs.items()}


_PACKAGES = (("dcfm_tpu_torch.cli", ["--backend", "torch_cpu"]),
             ("dcfm_tpu.cli", []))


@pytest.mark.parametrize("veto", [True, False])
def test_no_elastic_is_honoured_as_in_the_jax_package(
        tmp_path, data, two_chain_checkpoints, veto):
    """``supervise`` over a 2-chain checkpoint resumed at 1 chain, in both
    packages side by side.  With ``--no-elastic`` every child refuses the
    file by the same ValueError and the supervisor stops typed at its
    iteration; without it both adopt the file and finish in one launch."""
    import shutil
    procs = []
    for module, extra in _PACKAGES:
        ck = str(tmp_path / os.path.basename(two_chain_checkpoints[module]))
        shutil.copy(two_chain_checkpoints[module], ck)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "supervise", "--backoff", "0.05"]
            + (["--no-elastic"] if veto else [])
            + ["--", "fit", data[0]] + _ARGS + extra
            + ["--chains", "1", "--checkpoint", ck,
               "--out", ck + ".S1.npy"],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for proc in procs:
        err = proc.communicate(timeout=900)[1]
        rep = json.loads(err.strip().splitlines()[-1])
        refusals = re.findall(r"ValueError: (refusing to resume: .*)", err)
        for k in ("message", "checkpoint", "elapsed_s"):
            rep.pop(k, None)
        outs.append((proc.returncode, rep, refusals))
    assert outs[0] == outs[1]
    rc, rep, refusals = outs[0]
    if veto:
        assert (rc, rep) == (3, {"error": "PoisonedRunError",
                                 "iteration": 32})
        assert len(refusals) == 2 and "chain" in refusals[0]
    else:
        assert (rc, refusals) == (0, [])
        assert rep == {"supervised": True, "launches": 1, "deaths": [],
                       "corrupt_fallbacks": 0, "final_iteration": 32}


def test_supervise_returns_the_fit_with_its_report(tmp_path, monkeypatch):
    """``supervise()``: launch 1 killed after its last save (boundaries 12
    and 24: both always save), which is bit-flipped, launch 2 killed
    inside the resume gate of the save at 12 it falls back to, launch 3
    finishes; the materialized FitResult is bitwise the unsupervised
    fit's and carries the report (a plain fit carries none)."""
    monkeypatch.chdir(REPO)        # the children import the package
    Y, _ = make_synthetic(n=40, p=24, k_true=3, seed=7)
    cfg = dt.FitConfig(
        model=dt.ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8),
        run=dt.RunConfig(burnin=8, mcmc=16, chunk_size=12, num_chains=2),
        backend=dt.BackendConfig(backend="torch_cpu", fetch_dtype="quant8"),
        checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_keep_last=2,
        checkpoint_every_chunks=1)
    plain = dt.fit(Y, dt.FitConfig(**{**cfg.__dict__,
                                      "checkpoint_path": None}))
    assert plain.supervise_report is None
    monkeypatch.setenv("DCFM_FAULT_PLAN", json.dumps({"faults": [
        {"op": "kill", "at_iteration": 24, "when": "post_save",
         "at_launch": 1},
        {"op": "kill_event", "event": "resume_gate", "at_launch": 2},
        {"op": "bit_flip", "target": "checkpoint", "at_write": 2,
         "at_launch": 1}]}))
    res = tsup.supervise(Y, cfg, backoff_base=0.05, log=lambda m: None)
    rep = res.supervise_report
    assert (rep.launches, rep.deaths, rep.corrupt_fallbacks,
            rep.final_iteration) == (3, [(-9, 24), (-9, 12)], 1, 24)
    np.testing.assert_array_equal(res.Sigma, plain.Sigma)
    # the materialization records under its own role and the run's id
    roles = {f.split("events-")[1] for f in os.listdir(res.events_path)}
    assert {"supervisor.jsonl", "materialize.jsonl"} <= roles
    ids = set()
    for f in os.listdir(res.events_path):
        with open(os.path.join(res.events_path, f)) as fh:
            ids |= {json.loads(line)["run"] for line in fh}
    assert ids == {rep.run_id}


def test_supervise_refuses_as_the_jax_package(tmp_path):
    """No checkpoint, or a light one: the JAX package's ValueErrors."""
    Y, _ = make_synthetic(n=40, p=24, k_true=3, seed=7)
    bad = [{}, {"checkpoint_path": str(tmp_path / "x"),
                "checkpoint_mode": "light"}]
    for kw in bad:
        msgs = []
        for pkg, sup in ((dt, tsup), (__import__("dcfm_tpu"), jsup)):
            cfg = pkg.FitConfig(
                model=pkg.ModelConfig(num_shards=2, factors_per_shard=3,
                                      rho=0.8),
                run=pkg.RunConfig(burnin=2, mcmc=2), **kw)
            with pytest.raises(ValueError) as e:
                sup.supervise(Y, cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("argv,kw,want", [
    # exits 1 at once, no checkpoint: the same iteration (-1) twice
    ("import sys; sys.exit(1)", {}, "PoisonedRunError"),
    # ... past the retry budget when poison needs more deaths
    ("import sys; sys.exit(1)", {"max_retries": 2, "poison_deaths": 9},
     "RetriesExhaustedError"),
    # neither dies nor progresses: the watchdog
    ("import time; time.sleep(60)", {"launch_timeout": 1.0},
     "PodHangError"),
    ("pass", {}, None),
])
def test_the_relaunch_loop_is_the_jax_packages(tmp_path, monkeypatch, argv,
                                               kw, want):
    """``supervise_command`` over the same child in both packages: the
    same typed outcome, launches and deaths."""
    monkeypatch.delenv("DCFM_OBS_DIR", raising=False)
    outs = []
    for sup in (tsup, jsup):
        ck = str(tmp_path / f"{sup.__name__}.ck")
        try:
            rep = sup.supervise_command(
                [sys.executable, "-c", argv], checkpoint_path=ck,
                backoff_base=0.01, log=lambda m: None, **kw)
            outs.append((None, rep.launches, rep.deaths,
                         rep.final_iteration))
        except (sup.PoisonedRunError, sup.RetriesExhaustedError,
                sup.PodHangError) as e:
            # the message up to its explanation (the JAX hang message
            # speaks of a pod's collectives)
            outs.append((type(e).__name__,
                         re.sub(r"; flight recorder.*", "", str(e))
                         .split(" - ")[0]))
    assert outs[0] == outs[1]
    assert outs[0][0] == want


def test_pod_supervision_is_refused_citing_item_7(tmp_path, monkeypatch):
    """``supervise --pod N`` is ported (ROADMAP item 7 (f)): the CLI hands
    the pod size and port base to ``run_supervised_cli``, which starts N
    copies of the child command under ``supervise_pod``, each with the
    JAX package's environment contract - coordinator ``127.0.0.1:
    port_base + attempt``, ``DCFM_NUM_PROCESSES``, ``DCFM_PROCESS_ID``,
    ``DCFM_FAULT_PROCESS``, ``DCFM_FAULT_LAUNCH`` - and returns 0 when
    every process exits 0."""
    seen = {}

    def routed(cmd, **kw):
        seen.update(kw, cmd=cmd)
        return 0
    with monkeypatch.context() as m:
        m.setattr(tsup, "run_supervised_cli", routed)
        assert port_cli.main(["supervise", "--pod", "2", "--port-base",
                              "31000", "--", "fit", "Y.npy",
                              "--checkpoint", str(tmp_path / "ck")]) == 0
    assert (seen["pod"], seen["port_base"]) == (2, 31000)
    started = []

    class Done:
        def __init__(self, argv, env):
            started.append((argv, env))

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(tsup.subprocess, "Popen", Done)
    monkeypatch.setenv("DCFM_OBS_DIR", str(tmp_path / "obs"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tsup.run_supervised_cli(
            ["fit", "Y.npy"], checkpoint=str(tmp_path / "ck"), pod=4,
            port_base=31000) == 0
    assert [a[-2:] for a, _ in started] == [["fit", "Y.npy"]] * 4
    assert [(e["DCFM_COORDINATOR"], e["DCFM_NUM_PROCESSES"],
             e["DCFM_PROCESS_ID"], e["DCFM_FAULT_PROCESS"],
             e["DCFM_FAULT_LAUNCH"]) for _, e in started] == [
        ("127.0.0.1:31001", "4", str(i), str(i), "1") for i in range(4)]
    report = json.loads(err.getvalue().strip().splitlines()[-1])
    assert report["supervised"] and report["launches"] == 1


def _help_flags(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(argv)
    return sorted(set(re.findall(r"(?<![\w-])--[a-z][a-z-]*",
                                 out.getvalue())))


def test_supervise_flags_are_the_jax_clis():
    """``supervise``'s parser and ``fit``'s ``--supervise*`` flags."""
    assert (_help_flags(port_cli.main, ["supervise", "--help"])
            == _help_flags(jax_cli.main, ["supervise", "--help"]))
    flags = [f for f in _help_flags(port_cli.main, ["fit", "--help"])
             if f.startswith("--supervise")]
    assert flags == [f for f in _help_flags(jax_cli.main, ["fit", "--help"])
                     if f.startswith("--supervise")]
    assert len(flags) == 5
