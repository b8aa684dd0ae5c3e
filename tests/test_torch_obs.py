"""The port's observability against the JAX package's: the flight recorder,
the metrics registry and the span traces (dcfm_tpu_torch/obs), a recorded
fit, the profiler trace and the device switch (``BackendConfig.backend``).

The units of ``tests/test_obs.py`` run here as one test over both
packages' modules; where the two can be compared (Prometheus text, Chrome
traces, overlap fractions) they must give the same bytes or values for the
same inputs.  A recorded fit of the port must write the JAX package's
event sequence for the same config (the events of the writer and drain
threads compared apart: their place in the file is a race), and the JAX
package's own reader must read the port's run directory.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
import dcfm_tpu.obs.cli  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
import dcfm_tpu_torch.obs.cli  # noqa: E402
from dcfm_tpu import obs as jax_obs  # noqa: E402
from dcfm_tpu_torch import obs as port_obs  # noqa: E402
from dcfm_tpu_torch.obs import metrics as port_metrics  # noqa: E402
from dcfm_tpu_torch.obs import recorder as port_recorder  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_obs import parse_prometheus  # noqa: E402

PKGS = {"jax": jax_obs, "torch": port_obs}


@pytest.fixture(params=sorted(PKGS))
def obs(request):
    """One package's obs modules (recorder, metrics, spans)."""
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# recorder units, in both packages
# ---------------------------------------------------------------------------

def test_recorder_roundtrip(obs, tmp_path):
    rec = obs.recorder.FlightRecorder(str(tmp_path), role="L1.p0",
                                      run_id="abc")
    rec.emit("chunk", start=0, end=8, dur_s=0.5)
    rec.emit("checkpoint_save", iteration=8)
    rec.flush(fsync=True)
    rec.close()
    assert os.path.basename(rec.path) == "events-L1.p0.jsonl"
    evs = obs.recorder.read_events(rec.path)
    assert [e["event"] for e in evs] == ["chunk", "checkpoint_save"]
    assert [e["seq"] for e in evs] == [0, 1]
    assert all(e["run"] == "abc" and e["role"] == "L1.p0" for e in evs)
    assert all({"t", "mono"} <= set(e) for e in evs)
    assert evs[0]["dur_s"] == 0.5 and evs[1]["iteration"] == 8


def test_recorder_torn_final_line_tolerated(obs, tmp_path):
    rec = obs.recorder.FlightRecorder(str(tmp_path), role="L1.p0")
    rec.emit("chunk", start=0, end=8)
    rec.close()
    with open(rec.path, "a", encoding="utf-8") as f:
        f.write('{"event": "chunk", "t": 1.0, "trunca')   # torn mid-line
    evs, skipped = obs.recorder.read_events_with_stats(rec.path)
    assert [e["event"] for e in evs] == ["chunk"] and skipped == 1
    assert [e["event"] for e in obs.recorder.run_events(str(tmp_path))] \
        == ["chunk"]


def test_recorder_concurrent_emit_is_line_atomic(obs, tmp_path):
    rec = obs.recorder.FlightRecorder(str(tmp_path), role="L1.p0")
    n_threads, per = 4, 50

    def worker(k):
        for i in range(per):
            rec.emit("tick", thread=k, i=i)  # dcfm: ignore[DCFM101] - an event emitter, not a PRNG key

    ts = [threading.Thread(target=worker, args=(k,))
          for k in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    rec.close()
    evs, skipped = obs.recorder.read_events_with_stats(rec.path)
    assert skipped == 0 and len(evs) == n_threads * per
    assert sorted(e["seq"] for e in evs) == list(range(len(evs)))


def test_record_is_noop_without_active_recorder(obs):
    assert obs.recorder.active() is None
    obs.recorder.record("chunk", start=0)          # must not raise
    obs.recorder.record_sync("fault", op="kill")


def test_active_recorder_stack(obs, tmp_path):
    a = obs.recorder.FlightRecorder(str(tmp_path), role="supervisor")
    b = obs.recorder.FlightRecorder(str(tmp_path), role="L1.p0")
    obs.recorder.install(a)
    obs.recorder.install(b)
    try:
        assert obs.recorder.active() is b
        obs.recorder.uninstall(b)
        assert obs.recorder.active() is a
        obs.recorder.uninstall(b)                  # idempotent
        assert obs.recorder.active() is a
    finally:
        obs.recorder.uninstall(a)
        obs.recorder.uninstall(b)
        a.close()
        b.close()
    assert obs.recorder.active() is None


def test_tail_events_filters_by_launch(obs, tmp_path):
    for role, n in (("L1.p0", 3), ("L2.p0", 2), ("supervisor", 4)):
        rec = obs.recorder.FlightRecorder(str(tmp_path), role=role)
        for i in range(n):
            rec.emit("tick", i=i)
        rec.close()
    t = obs.recorder.tail_events(str(tmp_path), 5, launch=2)
    assert len(t) == 2 and all(e["role"] == "L2.p0" for e in t)
    assert len(obs.recorder.tail_events(str(tmp_path), 5)) == 5


def test_role_and_run_id_come_from_the_shared_environment(obs, tmp_path,
                                                          monkeypatch):
    """DCFM_RUN_ID, DCFM_FAULT_LAUNCH and DCFM_OBS_ROLE name the file and
    the records as in the JAX package, so a supervisor can drive either
    package into one run directory."""
    monkeypatch.setenv("DCFM_RUN_ID", "run7")
    monkeypatch.setenv("DCFM_FAULT_LAUNCH", "3")
    rec = obs.recorder.FlightRecorder(str(tmp_path), process_index=1)
    rec.emit("tick")
    rec.close()
    assert os.path.basename(rec.path) == "events-L3.p1.jsonl"
    (ev,) = obs.recorder.read_events(rec.path)
    assert (ev["run"], ev["role"]) == ("run7", "L3.p1")
    monkeypatch.setenv("DCFM_OBS_ROLE", "materialize")
    rec = obs.recorder.FlightRecorder(str(tmp_path))
    rec.close()
    assert os.path.basename(rec.path) == "events-materialize.jsonl"


# ---------------------------------------------------------------------------
# metrics: the units in both packages, the exposition byte for byte
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_snapshot(obs):
    reg = obs.metrics.MetricsRegistry()
    c = reg.counter("c_total", "a counter", labels=("kind",))
    c.inc(kind="x")
    c.inc(2, kind="x")
    c.inc(kind="y")
    reg.gauge("g", "a gauge").set(7.5)
    reg.gauge("g_pull", "a pull gauge").set_function(lambda: 42.0)
    h = reg.histogram("h_ms", (1.0, 10.0), "a histogram")
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    snap = reg.snapshot()
    cx = {tuple(s["labels"].items()): s["value"]
          for s in snap["c_total"]["series"]}
    assert cx[(("kind", "x"),)] == 3.0 and cx[(("kind", "y"),)] == 1.0
    assert snap["g"]["series"][0]["value"] == 7.5
    assert snap["g_pull"]["series"][0]["value"] == 42.0
    hs = snap["h_ms"]["series"][0]
    assert hs["count"] == 3 and hs["counts"] == [1, 1, 1]
    assert hs["sum"] == pytest.approx(105.5)
    assert snap["h_ms"]["buckets"] == [1.0, 10.0, "+Inf"]


def test_histogram_percentile_matches_legacy_rule(obs):
    h = obs.metrics.Histogram("h", "", (1.0, 2.0, 4.0))
    for v in (0.5, 0.6, 1.5, 3.0):
        h.observe(v)
    assert h.percentile(0.50) == 1.0
    assert h.percentile(0.99) == 4.0
    h.observe(99.0)     # lands in +Inf -> reported as the last finite
    assert h.percentile(0.999) == 4.0


def test_registry_kind_and_label_mismatch_raises(obs):
    reg = obs.metrics.MetricsRegistry()
    reg.counter("m", "x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("m", "x")
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("m", "x", labels=("a",))
    assert reg.counter("m", "x") is reg.counter("m", "x")


def _fill(metrics):
    """Two registries of one package with the same metrics and values."""
    reg, other = metrics.MetricsRegistry(), metrics.MetricsRegistry()
    h = reg.histogram("lat_ms", (0.5, 2.5), "latency\nwith \\ escapes",
                      labels=("route",))
    for v in (0.1, 1.0, 9.0, 2.5):
        h.observe(v, route='/v1/"entry"')
    reg.counter("resp_total", "responses", labels=("status",)).inc(
        3, status="200")
    reg.gauge("up", "uptime").set(1.25)
    reg.gauge("nan", "not a number").set(float("nan"))
    reg.gauge("big", "large").set(1e20)
    other.gauge("up", "shadowed by the first registry").set(9.0)
    other.gauge("dcfm_fit_iteration", "fit").set(16)
    return reg, other


def test_prometheus_text_is_the_jax_packages_byte_for_byte():
    texts = {name: pkg.metrics.render_prometheus(*_fill(pkg.metrics))
             for name, pkg in PKGS.items()}
    assert texts["torch"] == texts["jax"]
    types = parse_prometheus(texts["torch"])
    assert types == {"lat_ms": "histogram", "resp_total": "counter",
                     "up": "gauge", "nan": "gauge", "big": "gauge",
                     "dcfm_fit_iteration": "gauge"}
    lines = texts["torch"].splitlines()
    buckets = [int(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith("lat_ms_bucket")]
    assert buckets == sorted(buckets) and buckets[-1] == 4
    assert "up 1.25" in lines


# ---------------------------------------------------------------------------
# spans: the units in both packages, the traces value for value
# ---------------------------------------------------------------------------

def _ev(event, t, role="L1.p0", **kw):
    return {"event": event, "t": t, "mono": t, "run": "r", "role": role,
            "seq": 0, **kw}


_TRACE_EVENTS = [
    _ev("chunk", 10.0, dur_s=2.0, start=0, end=8),
    _ev("stream_drain", 9.5, dur_s=1.0, final=False),
    _ev("checkpoint_save", 10.5, dur_s=0.25, iteration=8),
    _ev("fault", 9.9, op="kill"),
    _ev("supervisor_launch", 8.0, role="supervisor", attempt=1),
    _ev("chunk", 13.0, role="L2.p1", dur_s=1.5, start=8, end=16),
    _ev("resume_decision", 11.0, role="odd-role", decision="fresh"),
]


def test_chrome_trace_spans_and_instants(obs):
    tr = obs.spans.chrome_trace(_TRACE_EVENTS[:5])
    xs = {e["name"]: e for e in tr["traceEvents"] if e["ph"] == "X"}
    instants = {e["name"] for e in tr["traceEvents"] if e["ph"] == "i"}
    assert set(xs) == {"chunk", "stream_drain", "checkpoint_save"}
    assert instants == {"fault", "supervisor_launch"}
    c, d = xs["chunk"], xs["stream_drain"]
    assert c["ts"] < d["ts"] + d["dur"] and d["ts"] < c["ts"] + c["dur"]
    assert c["pid"] == d["pid"] and c["tid"] != d["tid"]
    json.dumps(tr)


def test_chrome_trace_and_overlap_are_the_jax_packages(tmp_path):
    """Equal events give an equal trace (every slice, instant, track and
    argument) and an equal overlap fraction; the written trace files are
    the same bytes."""
    evs = [dict(e) for e in _TRACE_EVENTS]
    traces = {n: pkg.spans.chrome_trace(evs) for n, pkg in PKGS.items()}
    assert traces["torch"] == traces["jax"]
    for n, pkg in PKGS.items():
        pkg.spans.write_chrome_trace(evs, str(tmp_path / f"{n}.json"))
    assert (tmp_path / "torch.json").read_bytes() \
        == (tmp_path / "jax.json").read_bytes()
    assert port_obs.spans.chrome_trace([]) == jax_obs.spans.chrome_trace([])
    geo = [_ev("chunk", 10.0, dur_s=2.0),
           _ev("stream_drain", 9.0, dur_s=1.0),
           _ev("stream_drain", 11.0, dur_s=1.0)]
    for events, want in ((geo, 0.5),
                         (geo + [_ev("fit_done", 12.0, stream={
                             "overlap_fraction": 0.875})], 0.875),
                         ([_ev("chunk", 1.0, dur_s=1.0)], None)):
        got = {n: pkg.spans.overlap_fraction(events)
               for n, pkg in PKGS.items()}
        assert got["torch"] == got["jax"]
        if want is None:
            assert got["torch"] is None
        else:
            assert got["torch"] == pytest.approx(want)


# ---------------------------------------------------------------------------
# a recorded fit, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    Y, _ = make_synthetic(n=40, p=24, k_true=3, seed=11)
    return Y


def _cfg(pkg, **kw):
    """One config in either package: quant8 (streamed), chunks of 4 over
    8 + 8 iterations, a checkpoint that saves only at the last boundary
    (so the saves, like the stream's two snapshots, are deterministic)."""
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=2, factors_per_shard=2, rho=0.7),
        run=pkg.RunConfig(burnin=8, mcmc=8, thin=1, seed=0, chunk_size=4),
        backend=pkg.BackendConfig(fetch_dtype="quant8"),
        checkpoint_every_chunks=100, **kw)


# the events of the writer's and the drain's threads: their place among
# the chain thread's events is a race, so they are compared apart
_THREADED = ("checkpoint_save", "stream_drain")
# the fields of an event that name no time, no path and no process
_TIMING = {"t", "mono", "seq", "run", "dur_s", "seconds", "phases",
           "path", "exposed_fetch_s", "chunk_fetch_s", "overlap_fraction",
           "role"}


def _untimed(e: dict) -> dict:
    out = {k: v for k, v in e.items() if k not in _TIMING}
    if isinstance(out.get("stream"), dict):
        out["stream"] = {k: v for k, v in out["stream"].items()
                         if k not in _TIMING}
    return out


def _recorded(pkg, Y, tmp_path, name):
    ck = str(tmp_path / f"{name}.npz")
    obs_dir = str(tmp_path / f"{name}.events")
    kw = {"device": "cpu"} if pkg is dt else {}
    res = pkg.fit(Y, _cfg(pkg, obs=obs_dir, checkpoint_path=ck), **kw)
    files = port_recorder.event_files(obs_dir)
    assert [os.path.basename(f) for f in files] == ["events-L1.p0.jsonl"]
    evs = sorted(port_recorder.read_events(files[0]), key=lambda e: e["seq"])
    return res, evs, obs_dir


def test_a_recorded_fit_writes_the_jax_packages_events(tmp_path, data):
    res_p, evs_p, dir_p = _recorded(dt, data, tmp_path, "port")
    res_j, evs_j, _ = _recorded(dcfm_tpu, data, tmp_path, "jax")
    assert res_p.events_path == os.path.abspath(dir_p)
    main_p = [_untimed(e) for e in evs_p if e["event"] not in _THREADED]
    main_j = [_untimed(e) for e in evs_j if e["event"] not in _THREADED]
    assert [e["event"] for e in main_p] == [
        "fit_start", "resume_decision", "chunk", "chunk", "chunk",
        "stream_snapshot", "chunk", "stream_snapshot", "fit_done"]
    assert main_p == main_j
    for kind in _THREADED:
        got = {n: sorted((_untimed(e) for e in evs
                          if e["event"] == kind), key=json.dumps)
               for n, evs in (("port", evs_p), ("jax", evs_j))}
        assert got["port"] == got["jax"], kind
        assert got["port"], kind
    done = evs_p[-1]
    assert done["stream"] == res_p.stream_stats
    assert [e["iteration"] for e in evs_p
            if e["event"] == "checkpoint_save"] == [16]
    chunks = [e for e in evs_p if e["event"] == "chunk"]
    assert sum(e["end"] - e["start"] for e in chunks) == 16
    assert all(e["dur_s"] > 0 for e in chunks)


def test_the_jax_package_reads_the_port_run_directory(tmp_path, data):
    """The cross-reader check: the JAX package's run_events, summarize and
    Chrome trace read a directory the port wrote, as the port's do."""
    res, _, obs_dir = _recorded(dt, data, tmp_path, "port")
    evs = jax_obs.recorder.run_events(obs_dir)
    assert evs == port_obs.recorder.run_events(obs_dir)
    s = dcfm_tpu.obs.cli.summarize(obs_dir)
    assert s == dcfm_tpu_torch.obs.cli.summarize(obs_dir)
    assert s["chunks"] == 4 and s["checkpoint_saves"] == 1
    assert s["last_checkpoint_iteration"] == 16
    assert [r["decision"] for r in s["resume_decisions"]] == ["fresh"]
    assert s["phases"] == {k: round(v, 4)
                           for k, v in res.phase_seconds.items()}
    assert s["stream"]["snapshots"] == 2
    assert s["overlap_fraction"] == res.stream_stats["overlap_fraction"]
    lines = []
    dcfm_tpu.obs.cli._print_summary(s, lines)
    port_lines = []
    dcfm_tpu_torch.obs.cli._print_summary(s, port_lines)
    assert port_lines == lines and "chunks: 4" in "\n".join(lines)
    assert jax_obs.spans.chrome_trace(evs) == port_obs.chrome_trace(evs)
    out = tmp_path / "t.json"
    assert dcfm_tpu_torch.obs.cli.events_main(
        [obs_dir, "--trace", str(out), "--json"]) == 0
    assert json.loads(out.read_text())["traceEvents"]


def test_obs_off_is_bitwise_identical(tmp_path, data):
    on = dt.fit(data, _cfg(dt, obs=str(tmp_path / "on")), device="cpu")
    off = dt.fit(data, _cfg(dt, obs="off"), device="cpu")
    np.testing.assert_array_equal(on.Sigma, off.Sigma)
    assert on.events_path is not None and off.events_path is None
    assert not os.path.exists(str(tmp_path / "off"))


@pytest.mark.parametrize("where", ["env", "checkpoint", "none"])
def test_obs_auto_resolves_as_the_jax_package(tmp_path, data, monkeypatch,
                                              where):
    monkeypatch.delenv("DCFM_OBS_DIR", raising=False)
    kw = {}
    want = None
    if where == "env":
        want = str(tmp_path / "envobs")
        monkeypatch.setenv("DCFM_OBS_DIR", want)
        kw["checkpoint_path"] = str(tmp_path / "ck.npz")    # env wins
    elif where == "checkpoint":
        kw["checkpoint_path"] = str(tmp_path / "ck.npz")
        want = kw["checkpoint_path"] + ".obs"
    cfg = dataclasses.replace(_cfg(dt), **kw)
    res = dt.fit(data, cfg, device="cpu")
    if want is None:
        assert res.events_path is None
        assert not [f for f in os.listdir(tmp_path) if "obs" in f]
    else:
        assert res.events_path == os.path.abspath(want)
        assert [e["event"] for e in port_obs.run_events(want)][-1] \
            == "fit_done"
    with pytest.raises(ValueError, match="obs must be"):
        dt.fit(data, dataclasses.replace(cfg, obs=""), device="cpu")


def test_fit_sets_the_default_registry_gauges(tmp_path, data):
    reg = port_metrics.default_registry()
    reg.gauge("dcfm_fit_checkpoint_generation").set(0)
    dt.fit(data, _cfg(dt, checkpoint_path=str(tmp_path / "ck.npz")),
           device="cpu")
    assert reg.gauge("dcfm_fit_iteration").value() == 16.0
    assert reg.gauge("dcfm_fit_chunk_seconds").value() > 0.0
    assert reg.gauge("dcfm_fit_checkpoint_generation").value() == 1.0
    assert reg.gauge("dcfm_fit_stream_skips").value() == 0.0
    assert reg.gauge("dcfm_fit_sentinel_rewinds").value() == 0.0
    assert reg.gauge("dcfm_fit_carry_relayouts").value() == 0.0
    text = port_metrics.render_prometheus(reg)
    assert "dcfm_fit_iteration 16" in text.splitlines()
    parse_prometheus(text)


def test_a_failed_fit_records_fit_failed(tmp_path, data, monkeypatch):
    """A raise inside the fit is the log's last event (fsynced), and the
    recorder is uninstalled."""
    from dcfm_tpu_torch.models import sampler

    def boom(*a, **k):
        raise RuntimeError("the chain fell over")

    monkeypatch.setattr(sampler.ChainRunner, "run_chunk", boom)
    obs_dir = str(tmp_path / "failed")
    with pytest.raises(RuntimeError, match="fell over"):
        dt.fit(data, _cfg(dt, obs=obs_dir), device="cpu")
    evs = port_obs.run_events(obs_dir)
    assert [e["event"] for e in evs][-1] == "fit_failed"
    assert "fell over" in evs[-1]["error"]
    assert port_obs.active() is None


# ---------------------------------------------------------------------------
# profile_dir and backend
# ---------------------------------------------------------------------------

def test_profile_dir_writes_a_trace_and_changes_no_bit(tmp_path, data):
    prof = tmp_path / "prof"
    cfg = _cfg(dt, obs="off")
    traced = dt.fit(data, dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, profile_dir=str(prof))), device="cpu")
    plain = dt.fit(data, cfg, device="cpu")
    np.testing.assert_array_equal(traced.Sigma, plain.Sigma)
    files = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(prof / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the JAX package's named scopes, as profiler ranges of the CPU sweeps
    assert {"z_update", "x_update", "lambda_update", "prior_update",
            "ps_update", "combine", "health_trace"} <= names


def test_backend_values_and_device_conflicts(data):
    cfg = _cfg(dt, obs="off")

    def on(backend):
        return dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, backend=backend))

    ref = dt.fit(data, cfg, device="cpu")
    res = dt.fit(data, on("torch_cpu"))
    assert res.device == "cpu"
    np.testing.assert_array_equal(res.Sigma, ref.Sigma)
    np.testing.assert_array_equal(
        dt.fit(data, on("torch_cpu"), device="cpu").Sigma, ref.Sigma)
    for name in ("jax_cpu", "jax_tpu", "matlab"):
        with pytest.raises(ValueError, match="auto | torch_cuda | torch_cpu"):
            dt.fit(data, on(name), device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        dt.fit(data, on("torch_cuda"), device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        dt.fit(data, on("torch_cpu"), device="cuda")
    np.testing.assert_array_equal(
        dt.divideconquer(data, 2, 4, 8, 8, 1, 0.7, backend="torch_cpu"),
        dt.divideconquer(data, 2, 4, 8, 8, 1, 0.7, device="cpu"))
    with pytest.raises(ValueError, match="contradicts"):
        dt.divideconquer(data, 2, 4, 8, 8, 1, 0.7, backend="torch_cpu",
                         device="cuda")


def test_torch_cuda_without_a_card_raises(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: torch_cuda runs (tests/"
                    "test_torch_gpu.py)")
    cfg = _cfg(dt, obs="off")
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, backend="torch_cuda"))
    with pytest.raises(RuntimeError, match="no fallback"):
        dt.fit(data, cfg)
