"""Kill, resume, save failures, the cadence and the divergence sentinel of
the port's chunk loop (runtime/pipeline.py, runtime/resume.py), on the
CPU at the JAX package's checkpoint-test size (n = 40, p = 24, g = 2,
K = 3).

A kill is a synchronous writer double that raises after its k-th save: the
file on disk is what a SIGKILL after that save leaves.  Every resumed fit
is held bitwise to the uninterrupted one.  The sentinel is held to the JAX
package under the same poison (fault C6: the port had none).
"""

import dataclasses
import functools
import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
from dcfm_tpu.resilience import faults as jfaults  # noqa: E402
from dcfm_tpu.resilience.sentinel import (  # noqa: E402
    ChainDivergedError as JChainDivergedError)
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch import api  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models.state import num_upper_pairs  # noqa: E402
from dcfm_tpu_torch.resilience.sentinel import (  # noqa: E402
    ChainDivergedError, DivergenceSentinel)
from dcfm_tpu_torch.runtime import fetch, pipeline  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402

N, P_COLS, G, K = 40, 24, 2, 3

# the three fit paths: (ModelConfig knobs, BackendConfig knobs)
PATHS = {"f32": ({"lambda_kernel": "pallas"}, {}),
         "bf16": ({"lambda_kernel": "auto"}, {"compute_dtype": "bf16"}),
         "fused": ({"lambda_kernel": "pallas-fused"}, {})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 2, seed=3)
    return Y


def _cfg(path="f32", C=2, pkg=dt, **run):
    model, backend = PATHS[path]
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=4) | run
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6,
                              **model),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(sse_mode="gram", **backend))


def _fit(cfg, **kw):
    return dt.fit(_data(), dataclasses.replace(cfg, **kw), device="cpu")


@functools.lru_cache(maxsize=None)
def _plain(path="f32", C=2, **run):
    return dt.fit(_data(), _cfg(path, C, **run), device="cpu")


class _Killed(BaseException):
    """The double's kill: a BaseException, so the save-failure policy
    (which handles Exceptions) never sees it."""


class _SyncWriter(ck.AsyncCheckpointWriter):
    """Saves synchronously; records (target, iteration, state_only) per
    save and raises _Killed after the ``kill_after``-th."""

    kill_after = None
    saves: list = []
    seconds = 0.0

    def submit(self, save_fn, path, carries, cfg, *, fingerprint, **kw):
        self.wait()
        leaves = ck.Snapshot(carries,
                             state_only=bool(kw.get("state_only"))).wait()
        save_fn(path, leaves, cfg, fingerprint=fingerprint, **kw)
        self.last_save_seconds = type(self).seconds
        type(self).saves.append((os.path.basename(path),
                                 int(np.asarray(leaves["iteration"])
                                     .reshape(-1)[0]),
                                 bool(kw.get("state_only"))))
        if len(type(self).saves) == type(self).kill_after:
            raise _Killed()


@pytest.fixture
def writer(monkeypatch):
    _SyncWriter.kill_after, _SyncWriter.saves = None, []
    _SyncWriter.seconds = 0.0
    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", _SyncWriter)
    return _SyncWriter


def _killed_run(cfg, writer, k):
    writer.kill_after, writer.saves = k, []
    with pytest.raises(_Killed):
        dt.fit(_data(), cfg, device="cpu")
    writer.kill_after = None


def _same(a, b):
    np.testing.assert_array_equal(a.Sigma, b.Sigma)
    for x, y in zip(sampler.state_leaves(a.state),
                    sampler.state_leaves(b.state), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("path", ["f32", "bf16", "fused"])
def test_a_kill_at_every_boundary_resumes_bitwise(tmp_path, writer, path):
    """14 iterations in chunks of 4 (the last chunk 2): a kill after each
    boundary's save, then resume=True - Sigma, state and the remaining
    traces are the uninterrupted fit's bits."""
    ref = _plain(path)
    for k, at in enumerate((4, 8, 12), start=1):
        cfg = dataclasses.replace(
            _cfg(path), checkpoint_path=str(tmp_path / f"{path}{k}.npz"),
            checkpoint_every_chunks=1)
        _killed_run(cfg, writer, k)
        assert writer.saves[-1][1] == at
        res = _fit(cfg, resume=True)
        _same(res, ref)
        np.testing.assert_array_equal(res.traces, ref.traces[:, at:])
        assert res.iters_per_sec > 0 and res.sentinel_rewinds == 0


def test_a_resume_may_change_the_chunking(tmp_path, writer):
    """The chunk size is not the chain's identity: killed in chunks of 4,
    resumed in chunks of 3 and 5 (neither divides the rest)."""
    ref = _plain()
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "c.npz"),
                              checkpoint_every_chunks=1)
    _killed_run(cfg, writer, 1)
    for chunk in (3, 5):
        res = _fit(cfg, run=dataclasses.replace(cfg.run, chunk_size=chunk),
                   checkpoint_path=None)
        _same(res, ref)     # no checkpoint: the fresh run, other chunks
        res = _fit(cfg, resume=True, run=dataclasses.replace(
            cfg.run, chunk_size=chunk))
        _same(res, ref)
        _killed_run(cfg, writer, 1)     # put the iteration-4 file back


def test_a_resume_with_a_longer_mcmc_is_the_longer_run(tmp_path, writer):
    ref = _plain(mcmc=16)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "l.npz"))
    _fit(cfg)                                       # finished at 14
    res = _fit(cfg, resume=True, run=dataclasses.replace(cfg.run, mcmc=16))
    _same(res, ref)
    assert res.traces.shape == (2, 8, 4)


def test_a_finished_checkpoint_resumes_as_a_noop(tmp_path, writer):
    ref = _plain()
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "f.npz"))
    _fit(cfg)
    n = len(writer.saves)
    res = _fit(cfg, resume=True)
    _same(res, ref)
    assert res.traces.shape == (2, 0, 4) and res.chunk_seconds == []
    assert len(writer.saves) == n                   # nothing ran, no save
    assert res.stats == ref.stats


@pytest.mark.parametrize("case", ["missing", "corrupt", "incompatible",
                                  "unreadable"])
def test_resume_true_refuses_and_auto_starts_fresh(tmp_path, writer, case):
    path = str(tmp_path / "x.npz")
    if case != "missing":
        _fit(dataclasses.replace(_cfg(seed=1 if case == "incompatible"
                                      else 0), checkpoint_path=path),
             run=dataclasses.replace(_cfg().run, mcmc=4,
                                     seed=1 if case == "incompatible"
                                     else 0))
    if case == "corrupt":
        raw = bytearray(open(path, "rb").read())
        with np.load(path) as z:
            big = z["leaf_6"].tobytes()
        raw[bytes(raw).index(big[:64]) + 9] ^= 2
        open(path, "wb").write(bytes(raw))
    if case == "unreadable":
        open(path, "wb").write(b"not a zip file")
    cfg = dataclasses.replace(_cfg(), checkpoint_path=path)
    want = {"missing": FileNotFoundError, "corrupt": ck.CheckpointCorruptError,
            "incompatible": ValueError, "unreadable": Exception}[case]
    with pytest.raises(want) as e:
        _fit(cfg, resume=True)
    if case == "incompatible":
        assert "refusing to resume: seed changed" in str(e.value)
    res = _fit(cfg, resume="auto")
    _same(res, _plain())
    assert res.traces.shape == (2, 14, 4)


def test_a_light_resume_restarts_the_window(tmp_path, writer):
    """Light files keep no accumulator: the resumed chain is the same
    chain (state bitwise), and its posterior mean is the draws saved after
    the light file's iteration over their own count - the uninterrupted
    run's accumulator difference, to float32 rounding of that difference
    (the retained full generations give it)."""
    full = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "f.npz"),
                               checkpoint_every_chunks=1,
                               checkpoint_keep_last=5)
    ref = _fit(full)
    gens = {it: p for p, it, err in ck.scan_generations(full.checkpoint_path)}
    light = dataclasses.replace(full, checkpoint_path=str(tmp_path / "l.npz"),
                                checkpoint_mode="light")
    _killed_run(light, writer, 2)                  # light file at 8
    assert writer.saves[-1] == ("l.npz", 8, True)
    res = _fit(light, resume=True)
    for x, y in zip(sampler.state_leaves(res.state),
                    sampler.state_leaves(ref.state), strict=True):
        assert torch.equal(x, y)
    tpl = ck.carry_template(res.config.model, n=N,
                            P=res.preprocess.data.shape[2], num_chains=2)
    a8 = ck.load_checkpoint(gens[8], tpl)[0]["sigma_acc"].astype(np.float64)
    a14 = ck.load_checkpoint(gens[14], tpl)[0]["sigma_acc"].astype(np.float64)
    q = num_upper_pairs(G)
    n_win = 8 // 2 - 2 // 2          # saved draws in (8, 14]
    want = (a14 - a8).sum(axis=0)[:q] / 2 / n_win
    np.testing.assert_allclose(res.upper_panels, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_a_finished_light_file_is_refused_unless_the_chain_grows(tmp_path,
                                                                 writer):
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "l.npz"),
                              checkpoint_mode="light")
    _fit(cfg)
    with pytest.raises(ValueError, match="nothing to report"):
        _fit(cfg, resume=True)
    longer = _fit(cfg, resume=True, run=dataclasses.replace(cfg.run,
                                                            mcmc=16))
    assert longer.traces.shape == (2, 8, 4)
    assert np.isfinite(longer.Sigma).all()


def test_the_full_sidecar_wins_when_it_keeps_more_draws(tmp_path, writer):
    """Light mode with a full save every 2nd save: saves land at 4 (light),
    8 (full, the sidecar), 12 (light).  A kill after 12: the light window
    (12, 14] keeps 1 draw, the sidecar all 4 - resume takes the sidecar
    and is the uninterrupted fit's bits."""
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "s.npz"),
                              checkpoint_every_chunks=1,
                              checkpoint_mode="light",
                              checkpoint_full_every=2)
    _killed_run(cfg, writer, 3)
    assert writer.saves == [("s.npz", 4, True), ("s.npz.full", 8, False),
                            ("s.npz", 12, True)]
    res = _fit(cfg, resume=True)
    _same(res, _plain())
    assert res.traces.shape == (2, 6, 4)             # from the sidecar's 8


def test_a_save_failure_before_the_last_boundary_raises(tmp_path,
                                                        monkeypatch):
    """The real write-behind writer: a save that fails in its thread
    re-raises at the next boundary (fail fast, lose one chunk)."""
    calls = []

    def failing(path, leaves, cfg, **kw):
        calls.append(int(np.asarray(leaves["iteration"]).reshape(-1)[0]))
        raise OSError("disk full")

    monkeypatch.setattr(pipeline, "save_checkpoint", failing)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "e.npz"),
                              checkpoint_every_chunks=1)
    with pytest.raises(OSError, match="disk full"):
        _fit(cfg)
    assert calls == [4]


def test_a_save_failure_after_the_last_boundary_warns(tmp_path,
                                                      monkeypatch):
    """Once the chain is complete, a failed save only warns and sets
    checkpoint_error: the results stand."""
    save = ck.save_checkpoint

    def failing_last(path, leaves, cfg, **kw):
        if int(np.asarray(leaves["iteration"]).reshape(-1)[0]) == 14:
            raise OSError("disk full")
        save(path, leaves, cfg, **kw)

    monkeypatch.setattr(pipeline, "save_checkpoint", failing_last)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "w.npz"),
                              checkpoint_every_chunks=1)
    with pytest.warns(RuntimeWarning, match="NOT resumable"):
        res = _fit(cfg)
    assert "disk full" in res.checkpoint_error
    _same(res, _plain())
    assert ck.read_checkpoint_meta(cfg.checkpoint_path)["iteration"] == 12
    assert res.phase_seconds["checkpoint_s"] >= 0


@pytest.mark.parametrize("last,secs", [
    (0.3, [5.0, 0.1, 0.1]), (0.0, [1.0]), (2.0, [0.4]), (1.0, [9.0, 0.2, 0.4]),
    (1e-12, [0.0, 0.0])])
def test_the_auto_cadence_is_the_reference_formula(last, secs):
    """dcfm_tpu/runtime/pipeline.py's re-size: the steady chunk mean
    (chunk 0 left out when there are others), 1.5x headroom."""
    steady = secs[1:] if len(secs) > 1 else secs
    want = max(1, int(np.ceil(1.5 * last / max(sum(steady) / len(steady),
                                                1e-9))))
    assert pipeline.auto_cadence(last, secs) == want


@pytest.mark.parametrize("seconds,saved_at", [
    (0.0, [4, 8, 12, 14]), (1e9, [4, 14])])
def test_the_auto_cadence_follows_the_latest_save(tmp_path, writer, seconds,
                                                  saved_at):
    """A save as slow as 1e9 s pushes the next one past the chain: only
    the first and the (always saved) last boundary save."""
    writer.seconds = seconds
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "a.npz"))
    _fit(cfg)
    assert [it for _, it, _ in writer.saves] == saved_at


# ---- the divergence sentinel (fault C6) ------------------------------------

def _poison(monkeypatch, at: int, chain: int = 0, times=1):
    """A runner double: before the chunk that starts at global iteration
    ``at``, chain ``chain``'s Lambda becomes NaN (rebound, so a snapshot
    still reading the old tensor is untouched) - ``times`` times."""
    run_chunk = sampler.ChainRunner.run_chunk
    left = [times]

    def poisoned(self, c, carry, n):
        if c == chain and carry.iteration == at and left[0] > 0:
            left[0] -= 1
            carry.state = dataclasses.replace(
                carry.state, Lambda=carry.state.Lambda * float("nan"))
        return run_chunk(self, c, carry, n)

    monkeypatch.setattr(sampler.ChainRunner, "run_chunk", poisoned)


def _jax_fit_poisoned(at, **kw):
    jfaults.install({"faults": [{"op": "poison_state", "at_iteration": at}]})
    try:
        return dcfm_tpu.fit(_data(), dataclasses.replace(
            _cfg(pkg=dcfm_tpu), **kw))
    finally:
        jfaults.clear()


def test_a_diverged_chain_raises_where_the_jax_package_raises(monkeypatch):
    """Fault C6: the port had no sentinel and returned a Sigma built from
    a NaN chain.  Poisoned at iteration 8, both packages raise
    ChainDivergedError at the next boundary, 12 (sentinel "auto" without a
    checkpoint is "abort"), and "abort" says so too."""
    with pytest.raises(JChainDivergedError) as je:
        _jax_fit_poisoned(8)
    _poison(monkeypatch, 8)
    with pytest.raises(ChainDivergedError) as pe:
        _fit(_cfg())
    assert pe.value.iteration == je.value.iteration == 12
    assert pe.value.rewinds == 0
    _poison(monkeypatch, 8, chain=1)
    with pytest.raises(ChainDivergedError, match="'abort'") as pe:
        _fit(_cfg(), sentinel="abort")
    assert pe.value.iteration == 12


def test_sentinel_off_runs_a_diverged_chain_to_the_end(monkeypatch):
    jres = _jax_fit_poisoned(8, sentinel="off")
    _poison(monkeypatch, 8)
    res = _fit(_cfg(), sentinel="off")
    assert res.traces.shape == (2, 14, 4)
    assert jres.stats.nonfinite_count > 0 and res.stats.nonfinite_count > 0
    assert not np.isfinite(res.Sigma).all()
    assert not np.isfinite(np.asarray(jres.Sigma)).all()


def test_a_rewind_escalates_the_jitter_and_relineages(tmp_path, monkeypatch):
    """sentinel="rewind" (and "auto" with a checkpoint): back to the last
    good file (8), the ridge jitter 1e-6 (then 10x per rewind), the sweeps'
    streams re-lineaged - a finite chain, not the undiverged one's bits."""
    built = []

    class Spy(sampler.ChainRunner):
        def __init__(self, noise, Y, cfg, *a, **kw):
            built.append((cfg.ridge_jitter, noise.lineage))
            super().__init__(noise, Y, cfg, *a, **kw)

    monkeypatch.setattr(api, "ChainRunner", Spy)
    _poison(monkeypatch, 8)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "r.npz"),
                              checkpoint_every_chunks=1)
    for mode in ("rewind", "auto"):
        built.clear()
        _poison(monkeypatch, 8)
        res = _fit(cfg, sentinel=mode)
        assert res.sentinel_rewinds == 1
        assert built == [(0.0, ()), (1e-6, (1,))]
        assert np.isfinite(res.Sigma).all() and res.stats.acc_nonfinite == 0
        assert res.traces.shape == (2, 14, 4)     # 0..8 kept, 8..14 re-run
        assert not np.array_equal(res.Sigma, _plain().Sigma)
    s = DivergenceSentinel("rewind", base_jitter=0.0)
    js = dcfm_tpu.resilience.sentinel.DivergenceSentinel("rewind")
    for _ in range(3):
        s.record_rewind(1)
        js.record_rewind(1)
        assert s.escalated_jitter() == js.escalated_jitter()
    s = DivergenceSentinel("rewind", base_jitter=1e-4)
    s.record_rewind(1)
    assert math.isclose(s.escalated_jitter(), 1e-3)


def test_a_rewind_frees_the_diverged_carries(tmp_path, monkeypatch):
    """The rewound chains are built from the file only after nothing
    holds the diverged ones: on the card each is an accumulator-sized
    allocation that would otherwise stay alive across the rewind."""
    import gc
    import weakref
    born, dead_at_rebuild = [], []
    new_chain = sampler.ChainRunner.new_chain
    rebuild = pipeline.carries_from_leaves

    def tracked(self, c):
        carry = new_chain(self, c)
        born.append(weakref.ref(carry.sigma_acc))
        return carry

    def checked(*a, **kw):
        gc.collect()
        dead_at_rebuild.append([r() is None for r in born])
        return rebuild(*a, **kw)

    monkeypatch.setattr(sampler.ChainRunner, "new_chain", tracked)
    monkeypatch.setattr(pipeline, "carries_from_leaves", checked)
    _poison(monkeypatch, 8)
    res = _fit(_cfg(), checkpoint_path=str(tmp_path / "g.npz"),
               checkpoint_every_chunks=1, sentinel="rewind")
    assert res.sentinel_rewinds == 1
    assert dead_at_rebuild == [[True, True]]


def test_the_rewind_budget_is_enforced(tmp_path, monkeypatch):
    _poison(monkeypatch, 8, times=10)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "b.npz"),
                              checkpoint_every_chunks=1, sentinel="rewind",
                              sentinel_max_rewinds=2)
    with pytest.raises(ChainDivergedError, match="budget") as e:
        _fit(cfg)
    assert e.value.rewinds == 3 and e.value.iteration == 12


@pytest.mark.parametrize("mode", ["off", "abort", "rewind", "auto"])
def test_a_healthy_chain_is_bitwise_unaffected_by_the_sentinel(tmp_path,
                                                              mode):
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "h.npz"),
                              sentinel=mode)
    res = _fit(cfg)
    _same(res, _plain())
    assert res.sentinel_rewinds == 0


# ---- chunk-major order -----------------------------------------------------

def test_the_chunk_major_fit_is_the_chain_major_loop():
    """fit runs every chain one chunk before the next chunk; the same
    chains driven one after another through the runner's static carry
    (the loop before chunk-major chains) give every state leaf,
    accumulator and trace bit, and the pooled fetch of those accumulators
    is the fit's panels."""
    cfg = _cfg(C=3)
    res = _fit(cfg)
    m = dataclasses.replace(cfg.model, sse_mode="gram")
    Yd = torch.as_tensor(preprocess(_data(), G, seed=0).data)
    runner = sampler.ChainRunner(dt.noise.TorchNoise(0, "cpu"), Yd, m,
                                 dt.models.priors.make_prior(m), burnin=6,
                                 thin=2)
    pooled, traces = None, []
    for c in range(3):
        carry, tr = runner.init_chain(c), []
        while carry.iteration < 14:
            carry, _, t = runner.run_chunk(c, carry,
                                           min(4, 14 - carry.iteration))
            tr.append(t)
        for a, b in zip(sampler.state_leaves(carry.state),
                        sampler.state_leaves(res.state), strict=True):
            assert torch.equal(a, b[c])
        pooled = (carry.sigma_acc.clone() if pooled is None
                  else pooled + carry.sigma_acc)
        traces.append(torch.cat(tr).numpy())
    np.testing.assert_array_equal(np.stack(traces), res.traces)
    inv = fetch.accumulator_window(14, 6, 2, 0, 3)[1]
    np.testing.assert_array_equal(
        fetch.fetch_upper(pooled, 3, G, inv, "float32"), res.upper_panels)


def test_elastic_adoption_is_refused_unless_elastic_is_off(tmp_path, writer):
    """A full file written at another chain count is adopted when elastic
    is True or "auto" (tests/test_torch_elastic.py holds the adoption to
    the JAX package's); with elastic=False it is refused as incompatible,
    as the JAX package refuses it, and resume="auto" then starts fresh.
    (The port refused the adoption itself before it was ported; the test
    keeps its name.)"""
    path = str(tmp_path / "e.npz")
    _fit(dataclasses.replace(_cfg(C=1), checkpoint_path=path))
    cfg = dataclasses.replace(_cfg(C=2), checkpoint_path=path, resume=True)
    for elastic in ("auto", True):
        shutil.copy(path, str(tmp_path / f"a_{elastic}.npz"))
        res = _fit(cfg, elastic=elastic,
                   checkpoint_path=str(tmp_path / f"a_{elastic}.npz"))
        assert res.elastic_resume["birthed"] == 1
        assert res.traces.shape[1] == 0       # the donor had finished
    with pytest.raises(ValueError, match="num_chains=1"):
        _fit(cfg, elastic=False)
    res = _fit(cfg, elastic=False, resume="auto")
    _same(res, _plain())


def test_multiprocess_sets_are_refused_by_name(tmp_path, writer,
                                               monkeypatch):
    """``.procK-of-N`` sets are ported (ROADMAP item 7 (f)): a file
    killed at iteration 8, rewritten as the set a 2-process pod writes,
    resumes on this one process bitwise the uninterrupted fit, narrated as
    one ``pod_elastic`` event (2 -> 1 hosts, one adoption) before the
    decision; every later save carries the adoption.  Under the
    supervisor's ``--no-elastic`` (DCFM_NO_ELASTIC=1) the same resume is
    refused with the JAX package's text, and resume="auto" starts
    fresh."""
    from dcfm_tpu.runtime import resume as jresume
    from dcfm_tpu_torch.runtime import resume
    from tests.torch_pod_rank import write_set
    path = str(tmp_path / "m.npz")
    cfg = dataclasses.replace(_cfg(), checkpoint_path=path,
                              checkpoint_every_chunks=1)
    ref = _plain()
    _killed_run(cfg, writer, 2)                     # the file at 8
    write_set(path, path, 2)
    os.rename(path, path + ".plain")
    events = []
    monkeypatch.setattr(resume, "record",
                        lambda name, **kw: events.append((name, kw)))
    res = _fit(cfg, resume=True)
    _same(res, ref)
    assert [e for e, _ in events] == ["pod_elastic", "resume_decision"]
    pod = events[0][1]
    assert pod | {"pair_panels": 0} == {
        "decision": "adopted", "from_hosts": 2, "to_hosts": 1,
        "pod_adoptions": 1, "pair_panels": 0, "iteration": 8}
    assert pod["pair_panels"] == dt.models.state.num_padded_pairs(G)
    assert events[1][1] | {"kind": 0} == {
        "decision": "resume", "kind": 0, "iteration": 8, "acc_start": 0}
    assert events[1][1]["kind"] == "set"
    meta = ck.read_checkpoint_meta(path)
    assert (meta["pod_hosts"], meta["pod_adoptions"]) == (1, 1)
    os.unlink(path)
    monkeypatch.setenv("DCFM_NO_ELASTIC", "1")
    with pytest.raises(ValueError, match="refusing to resume") as e:
        _fit(cfg, resume=True)
    smeta = ck.read_checkpoint_meta(path + ".proc0-of-2")
    want = jresume._pod_refusal(smeta, _cfg(pkg=dcfm_tpu))
    assert str(e.value) == f"refusing to resume: {want}"
    assert "2-host pod, run has 1 host(s)" in want
    _same(_fit(cfg, resume="auto"), ref)


def test_export_from_a_checkpoint_is_refused_by_name(tmp_path):
    """export_from_checkpoint is ported (tests/test_torch_export.py), and
    so are the ``.procK-of-N`` sets it reads (ROADMAP item 7 (f)): a file
    rewritten as a 2-rank set exports byte for byte what the file
    exports; a missing file is a FileNotFoundError naming both kinds of
    source."""
    from dcfm_tpu_torch.serve.artifact import export_from_checkpoint
    from tests.torch_pod_rank import same_artifact_bytes, write_set
    path = str(tmp_path / "c.npz")
    with pytest.raises(FileNotFoundError, match="procK-of-N"):
        export_from_checkpoint(path, _data(), str(tmp_path / "art"))
    _fit(_cfg(), checkpoint_path=path)
    export_from_checkpoint(path, _data(), str(tmp_path / "plain"))
    write_set(path, path, 2)
    os.rename(path, path + ".plain")
    export_from_checkpoint(path, _data(), str(tmp_path / "set"))
    same_artifact_bytes(str(tmp_path / "plain"), str(tmp_path / "set"))
