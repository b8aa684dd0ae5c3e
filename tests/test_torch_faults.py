"""The port's fault plan against the JAX package's.

``dcfm_tpu_torch.resilience.faults`` is a copy: the same specs are
accepted and refused (with the same error class and message), the four
seeded spec streams are equal, the write seams the serving plane carries
fire the same way, and the fit's seams fire at the JAX package's places:
the same per-event and per-target counts in the same scenarios, every
fault honoured, and supervised fuzz points that end as the JAX CLI's do.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.resilience import faults as jf  # noqa: E402
from dcfm_tpu_torch.resilience import faults as tf  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402


@pytest.fixture(autouse=True)
def _no_plans():
    jf.clear()
    tf.clear()
    yield
    jf.clear()
    tf.clear()


SPECS = [
    {"faults": []},
    {"faults": [{"op": "kill", "at_iteration": 4, "when": "pre_save"}]},
    {"faults": [{"op": "io_delay", "target": "panel", "at_write": 2,
                 "seconds": 0.01, "process": 1}]},
    {"faults": [{"op": "bit_flip", "target": "artifact", "at_write": 1}]},
    {"faults": [{"op": "kill_event", "event": "serve_request",
                 "at_occurrence": 3, "at_launch": 1}]},
    {"faults": [{"op": "bogus"}]},
    {"faults": [{"op": "kill"}]},
    {"faults": [{"op": "poison_state"}]},
    {"faults": [{"op": "kill_event"}]},
    {"faults": [{"op": "torn_write", "target": "delta"}]},
    {"nope": []},
    {"faults": {"op": "kill"}},
]


@pytest.mark.parametrize("spec", SPECS)
def test_plans_accept_and_refuse_as_in_the_jax_package(spec):
    def outcome(mod):
        try:
            plan = mod.FaultPlan(spec)
        except mod.FaultPlanError as e:
            return ("refused", str(e))
        return ("ok", plan.faults)

    assert outcome(tf) == outcome(jf)


def test_env_plans_and_fuzz_variable_parse_the_same(monkeypatch, tmp_path):
    plan = {"faults": [{"op": "io_error", "target": "pointer",
                        "at_write": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    for raw in (json.dumps(plan), f"@{path}"):
        monkeypatch.setenv("DCFM_FAULT_PLAN", raw)
        assert tf.FaultPlan.from_env().faults == jf.FaultPlan.from_env().faults
    monkeypatch.setenv("DCFM_FAULT_PLAN", "{not json")
    for mod in (tf, jf):
        with pytest.raises(mod.FaultPlanError, match="not valid JSON"):
            mod.FaultPlan.from_env()
    monkeypatch.delenv("DCFM_FAULT_PLAN")
    for fuzz in ("7:3", "7:3:elastic", "7:3:pod", "-2:11"):
        monkeypatch.setenv("DCFM_FAULT_FUZZ", fuzz)
        assert tf.FaultPlan.from_env().faults == jf.FaultPlan.from_env().faults
    monkeypatch.setenv("DCFM_FAULT_FUZZ", "7")
    for mod in (tf, jf):
        with pytest.raises(mod.FaultPlanError, match="seed:index"):
            mod.FaultPlan.from_env()


@pytest.mark.parametrize("seed", [0, 1, 20260804])
def test_the_four_spec_streams_are_the_jax_packages(seed):
    for i in range(12):
        assert tf.fuzz_spec(seed, i) == jf.fuzz_spec(seed, i)
        assert tf.fuzz_spec(seed, i, events=()) == \
            jf.fuzz_spec(seed, i, events=())
        assert tf.elastic_fuzz_spec(seed, i) == jf.elastic_fuzz_spec(seed, i)
        assert tf.pod_fuzz_spec(seed, i) == jf.pod_fuzz_spec(seed, i)
        assert tf.serve_fuzz_spec(seed, i) == jf.serve_fuzz_spec(seed, i)
        assert tf.serve_fuzz_spec(seed, i, workers=3, max_requests=9) == \
            jf.serve_fuzz_spec(seed, i, workers=3, max_requests=9)


def test_write_seams_and_gates_fire_the_same(monkeypatch, tmp_path):
    """on_write / mutate_payload / after_replace / kill_event counting and
    the process and launch gates, driven identically on both plans."""
    spec = {"faults": [
        {"op": "io_error", "target": "panel", "at_write": 2, "process": 0},
        {"op": "bit_flip", "target": "artifact", "at_write": 1},
        {"op": "torn_write", "target": "artifact", "at_write": 2,
         "keep_fraction": 0.25},
        {"op": "io_delay", "target": "delta", "at_write": 1,
         "seconds": 0.0, "at_launch": 2}]}
    monkeypatch.setenv("DCFM_FAULT_PROCESS", "0")
    monkeypatch.setenv("DCFM_FAULT_LAUNCH", "1")
    results = []
    for mod in (tf, jf):
        plan = mod.install(spec)
        out = [plan.on_write("panel", "mean:0")]
        with pytest.raises(OSError, match="injected I/O failure"):
            plan.on_write("panel", "mean:1")
        c = plan.on_write("artifact", "a")
        payload = {"x": np.arange(6, dtype=np.int8)}
        out.append(plan.mutate_payload("artifact", "a", c, payload)["x"]
                   .tolist())
        f = tmp_path / f"{mod.__name__}.bin"
        f.write_bytes(b"\x01" * 100)
        c2 = plan.on_write("artifact", "a")
        plan.after_replace("artifact", str(f), c2)
        out += [c, c2, os.path.getsize(f), plan.on_write("delta", "d")]
        results.append(out)
    assert results[0] == results[1]
    assert results[0][1][0] == 1 and results[0][4] == 25


# one process fires every fit-side seam of the JAX package; a fault that
# did not fire would leave the chain or the file untouched
# boundaries 4, 8, 12, 16; the first always saves (the writer is idle),
# a later one only when the write-behind writer is done with the last
@pytest.mark.parametrize("fault,check", [
    ({"op": "kill", "at_iteration": 4, "when": "post_save"}, 4),
    ({"op": "kill", "at_iteration": 8, "when": "pre_save"}, 4),
    ({"op": "poison_state", "at_iteration": 8}, "rewound"),
    ({"op": "torn_write", "at_write": 2}, "corrupt"),
    ({"op": "bit_flip", "target": "checkpoint", "at_write": 2}, "corrupt"),
    ({"op": "io_error", "target": "checkpoint", "at_write": 1}, "raised"),
    # the stream's first dispatch is at iteration 8 (the first saved
    # draw), before that boundary's save
    ({"op": "kill_event", "event": "stream_submit"}, 4),
    ({"op": "kill_event", "event": "stream_submit_post"}, 4),
])
def test_fit_honours_every_fit_side_fault(tmp_path, monkeypatch, fault,
                                          check):
    """The port's fit fires each fault of a plan at the JAX package's
    seam (the resume windows' events are held against the JAX package in
    test_seam_counters_are_the_jax_packages): a kill SIGKILLs the process
    (here the kill is caught, as the signal would end the test), a poison
    trips the sentinel's rewind, a write fault corrupts or fails the
    checkpoint write it names (a kill's entry is the iteration of the
    checkpoint it leaves once the writer's thread is done)."""
    import signal
    import threading

    import dcfm_tpu_torch as dt
    from dcfm_tpu_torch.utils.checkpoint import (
        read_checkpoint_meta, scan_generations)

    class Killed(BaseException):
        pass

    def kill(pid, sig):
        assert pid == os.getpid() and sig == signal.SIGKILL
        raise Killed

    monkeypatch.setattr(tf.os, "kill", kill)
    Y, _ = make_synthetic(24, 8, 2, seed=0)
    ck = str(tmp_path / "ck.npz")
    cfg = dt.FitConfig(
        model=dt.ModelConfig(num_shards=2, factors_per_shard=2, rho=0.5),
        run=dt.RunConfig(burnin=4, mcmc=12, chunk_size=4),
        backend=dt.BackendConfig(backend="torch_cpu", fetch_dtype="quant8"),
        checkpoint_path=ck, checkpoint_every_chunks=1,
        checkpoint_keep_last=3)
    tf.install({"faults": [fault]})
    if isinstance(check, int):
        with pytest.raises(Killed):
            dt.fit(Y, cfg)
        # the process would be gone; here the writer may still finish a
        # save it was handed before the kill
        for t in threading.enumerate():
            if t.name == "dcfm-checkpoint-writer":
                t.join()
        assert read_checkpoint_meta(ck)["iteration"] == check
        return
    if check == "raised":
        # the writer's failure surfaces at a later boundary (raised), or,
        # when the writer is still busy until the last one, as the
        # finished chain's checkpoint_error
        try:
            res = dt.fit(Y, cfg)
        except OSError as e:
            assert "injected I/O failure" in str(e)
        else:
            assert "injected I/O failure" in res.checkpoint_error
        return
    res = dt.fit(Y, cfg)
    assert np.isfinite(res.Sigma).all()
    if check == "rewound":
        assert res.sentinel_rewinds == 1
    else:                   # write #2 (iteration 8) fails its CRC
        bad = [it for p, it, err in scan_generations(ck) if err is not None]
        assert bad == [-1]


def test_artifact_seam_flips_after_the_crcs_in_both_packages(tmp_path):
    """bit_flip on an artifact write lands after the CRCs: both packages
    write the same (corrupt) bytes and meta, and the port's engine refuses
    the flipped panel on first touch."""
    from dcfm_tpu.serve.artifact import write_artifact as jwrite
    from dcfm_tpu.utils.preprocess import preprocess as jpre
    from dcfm_tpu_torch.serve.artifact import (
        ArtifactCorruptError, write_artifact)
    from dcfm_tpu_torch.serve.engine import QueryEngine
    from dcfm_tpu_torch.utils.preprocess import preprocess

    rng = np.random.default_rng(0)
    Y = rng.standard_normal((20, 12)).astype(np.float32)
    q = rng.integers(-127, 128, size=(3, 6, 6)).astype(np.int8)
    s = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    spec = {"faults": [{"op": "bit_flip", "target": "artifact",
                        "at_write": 1}]}
    tf.install(spec)
    jf.install(spec)
    a = write_artifact(str(tmp_path / "t"), mean_q8=q, mean_scale=s,
                       pre=preprocess(Y, 2))
    jwrite(str(tmp_path / "j"), mean_q8=q, mean_scale=s, pre=jpre(Y, 2))
    for name in ("mean_q8.bin", "meta.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    with pytest.raises(ArtifactCorruptError):
        QueryEngine(a, device="cpu").entry(int(a.pre.kept_cols[
            a.pre.perm[0]]), int(a.pre.kept_cols[a.pre.perm[0]]))


# the resume windows the JAX package opens only around the collectives of
# its pod resume; the port's one-process resume opens them at the same
# places (runtime/resume.py), once per resume of a loaded file
_POD_WINDOWS = {"resume_gate": 1, "resume_gate_post": 1}
_SIDECAR_WINDOWS = {"sidecar_gate": 1, "sidecar_load": 1,
                    "sidecar_commit": 1, "sidecar_commit_post": 1}


def _seam_counts(pkg, faults_mod, Y, make_cfgs, tmp_path, monkeypatch):
    """Run ``make_cfgs(pkg, tmp)``'s fits in order under one plan whose
    fault never fires; the plan's per-event and per-target counters.  The
    write-behind writer finishes each save before the chain goes on (a
    busy writer defers a due save, so the saves would follow the clock)."""
    import importlib
    pipeline = importlib.import_module(pkg.__name__ + ".runtime.pipeline")

    class Writer(pipeline.AsyncCheckpointWriter):
        def submit(self, *args, **kwargs):
            super().submit(*args, **kwargs)
            self.wait()

    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", Writer)
    d = tmp_path / pkg.__name__
    d.mkdir()
    plan = faults_mod.install({"faults": [
        {"op": "kill_event", "event": "never_emitted"}]})
    kw = {} if pkg.__name__ == "dcfm_tpu" else {"device": "cpu"}
    for cfg in make_cfgs(pkg, str(d)):
        pkg.fit(Y, cfg, **kw)
    return dict(plan._events), dict(plan._writes)


def _base(pkg, d, **kw):
    run = {"burnin": 4, "mcmc": 12, "chunk_size": 4} | kw.pop("run", {})
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=2, factors_per_shard=2, rho=0.5),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(fetch_dtype="quant8"),
        checkpoint_path=os.path.join(d, "ck.npz"),
        checkpoint_every_chunks=1, **kw)


def _fresh_streamed(pkg, d):
    return [_base(pkg, d, stream_artifact=os.path.join(d, "art"))]


def _sidecar_resume(pkg, d):
    # a light run whose second of three saves is the full sidecar (the
    # last one stays light), extended: the light file's restart window
    # keeps fewer draws than the sidecar
    light = dict(checkpoint_mode="light", checkpoint_full_every=2)
    return [_base(pkg, d, run={"mcmc": 8}, **light),
            _base(pkg, d, resume=True, **light)]


def _elastic_shrink(pkg, d):
    return [_base(pkg, d, run={"num_chains": 2}),
            _base(pkg, d, run={"num_chains": 1, "mcmc": 16}, resume=True)]


@pytest.mark.parametrize("scenario,extra", [
    (_fresh_streamed, {}),
    (_sidecar_resume, _POD_WINDOWS | _SIDECAR_WINDOWS),
    (_elastic_shrink, {}),
])
def test_seam_counters_are_the_jax_packages(tmp_path, monkeypatch, scenario,
                                            extra):
    """The same scenario in both packages under a plan that never fires:
    every code-path event the JAX package's one-process fit emits fires as
    often in the port, and every write target counts the same writes.
    The port's one-process resume also opens the pod resume's windows
    (``extra``), once each."""
    import dcfm_tpu
    import dcfm_tpu_torch

    Y, _ = make_synthetic(24, 8, 2, seed=0)
    j_events, j_writes = _seam_counts(dcfm_tpu, jf, Y, scenario, tmp_path,
                                      monkeypatch)
    t_events, t_writes = _seam_counts(dcfm_tpu_torch, tf, Y, scenario,
                                      tmp_path, monkeypatch)
    assert t_writes == j_writes and t_writes.get("checkpoint", 0) >= 3
    assert t_events == j_events | extra, (t_events, j_events)
    assert t_events            # the scenario reaches the seams


def _plain_resume(pkg, d):
    return [_base(pkg, d), _base(pkg, d, run={"mcmc": 16}, resume=True)]


_LOADED = ["load ck.npz", "resume_gate"]
_SIDECAR = ["resume_gate_post", "sidecar_gate", "sidecar_load",
            "load ck.npz.full", "sidecar_commit"]


@pytest.mark.parametrize("scenario,torn,steps", [
    # a full file: its bookkeeping is adopted inside the gate
    (_plain_resume, False, _LOADED + ["carryover", "resume_gate_post"]),
    # a light file: the sidecar's bookkeeping is adopted inside the commit
    (_sidecar_resume, False, _LOADED + _SIDECAR
     + ["carryover", "sidecar_commit_post"]),
    # a sidecar that fails to load: the commit window opens and commits
    # nothing, as the JAX vote does with a failed load
    (_sidecar_resume, True, _LOADED + _SIDECAR + ["sidecar_commit_post"]),
])
def test_resume_windows_bracket_their_steps(tmp_path, monkeypatch, scenario,
                                            torn, steps):
    """Where the port's one-process resume opens the pod resume's
    windows: each pair is around a step of its own (the decision on the
    loaded file, the sidecar's adoption), never back to back."""
    import dcfm_tpu_torch as dt
    from dcfm_tpu_torch.runtime import pipeline, resume

    class Writer(pipeline.AsyncCheckpointWriter):
        def submit(self, *args, **kwargs):
            super().submit(*args, **kwargs)
            self.wait()

    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", Writer)
    Y, _ = make_synthetic(24, 8, 2, seed=0)
    *first, last = scenario(dt, str(tmp_path))
    for cfg in first:
        dt.fit(Y, cfg, device="cpu")
    log = []
    real_load, real_carry = resume.load_checkpoint, resume._elastic_carryover

    def load(path, template):
        log.append("load " + os.path.basename(path))
        if torn and path.endswith(".full"):
            raise ValueError("a torn sidecar")
        return real_load(path, template)

    def carryover(meta, cfg):
        log.append("carryover")
        return real_carry(meta, cfg)

    monkeypatch.setattr(resume, "load_checkpoint", load)
    monkeypatch.setattr(resume, "_elastic_carryover", carryover)
    monkeypatch.setattr(resume, "fault_event", log.append)
    res = dt.fit(Y, last, device="cpu")
    assert log == steps
    assert np.isfinite(res.Sigma).all()


# the JAX package's single-process crash fuzz (tests/test_resilience.py,
# test_crash_fuzz_smoke_single_process): its data, schedule, seed and
# stream of points
_FUZZ_SEED = 20260804
_FUZZ_ARGS = ["--shards", "2", "--factors", "6", "--burnin", "16",
              "--mcmc", "16", "--thin", "2", "--chunk-size", "8"]
_FUZZ_SUPERVISE = ["--checkpoint-every", "1", "--keep-last", "2",
                   "--supervise", "--supervise-backoff", "0.05",
                   "--supervise-max-retries", "4",
                   "--supervise-poison-deaths", "3",
                   "--supervise-watchdog", "420"]
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(module, data, out, extra, plan=None):
    """The CLI's ``fit`` started in a child process (``communicate()``
    joins it)."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(_REPO, ".jax_cache"))
    env.pop("DCFM_FAULT_PLAN", None)
    if plan is not None:
        env["DCFM_FAULT_PLAN"] = json.dumps(plan)
        env["DCFM_FAULT_PROCESS"] = "0"
    return subprocess.Popen(
        [sys.executable, "-m", module, "fit", data] + _FUZZ_ARGS
        + ["--out", out] + extra, env=env, cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _outcome(proc) -> str:
    proc.stderr = proc.communicate(timeout=900)[1]
    if proc.returncode == 0:
        return "clean"
    assert proc.returncode == 3, proc.stderr[-3000:]
    err = json.loads(proc.stderr.strip().splitlines()[-1])
    assert err["error"] in ("PoisonedRunError", "RetriesExhaustedError"), err
    return err["error"]


@pytest.fixture(scope="module")
def fuzz_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz")
    Y, _ = make_synthetic(n=40, p=24, k_true=3, seed=7)
    data = str(d / "Y.npy")
    np.save(data, Y)
    ref = str(d / "ref.npy")
    assert _outcome(_cli("dcfm_tpu_torch.cli", data, ref,
                         ["--backend", "torch_cpu"])) == "clean"
    return data, np.load(ref)


@pytest.mark.parametrize("index", range(8))
def test_fuzz_point_ends_bitwise_or_typed(tmp_path, fuzz_data, index):
    """Each of the JAX package's 8 single-process fuzz points, through the
    port's supervised CLI: a clean finish is bitwise the port's
    uninterrupted fit, anything else a typed exit 3.  For the first four
    the JAX CLI's outcome on the same spec is the oracle."""
    data, ref = fuzz_data
    spec = tf.fuzz_spec(_FUZZ_SEED, index, boundaries=(8, 16, 24, 32),
                        max_writes=4, nproc=1, events=())
    assert spec == jf.fuzz_spec(_FUZZ_SEED, index, boundaries=(8, 16, 24, 32),
                                max_writes=4, nproc=1, events=())
    out = str(tmp_path / "port.npy")
    port = _cli("dcfm_tpu_torch.cli", data, out,
                ["--backend", "torch_cpu", "--checkpoint",
                 str(tmp_path / "port.ck.npz")] + _FUZZ_SUPERVISE, spec)
    jax = None
    if index < 4:       # side by side: the two runs share nothing
        jax = _cli("dcfm_tpu.cli", data, str(tmp_path / "jax.npy"),
                   ["--checkpoint", str(tmp_path / "jax.ck.npz")]
                   + _FUZZ_SUPERVISE, spec)
    got = _outcome(port)
    if got == "clean":
        np.testing.assert_array_equal(np.load(out), ref)
    if jax is not None:
        want = _outcome(jax)
        assert got == want, (spec, got, want)
