"""The port's streamed accumulator fetch (runtime/pipeline.StreamingFetcher)
on the CPU: under ``fetch_dtype="quant8"`` with ``fetch_stream`` "auto" or
"on" a fit snapshots the chains' pooled accumulator at every boundary after
the first saved draw, and the final snapshot's int8 panels and scales are
bitwise the post-hoc quant8 fetch's (which tests/test_torch_fetch.py holds
to the JAX fetch jit).  A busy double buffer skips a boundary; a failed
drain or dispatch warns and lets the post-hoc fetch serve the result.
"""

import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.runtime import fetch, pipeline  # noqa: E402

N, P_COLS, G, K = 40, 24, 2, 3


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


def _cfg(stream="auto", C=2, pkg=dt, **run):
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=2) | run
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(sse_mode="gram", fetch_dtype="quant8",
                                  fetch_stream=stream))


@functools.lru_cache(maxsize=None)
def _post_hoc(C=2, **run):
    return dt.fit(_data(), _cfg("off", C, **run), device="cpu")


def _same_q8(a, b):
    np.testing.assert_array_equal(a._q8_panels, b._q8_panels)
    np.testing.assert_array_equal(a._q8_scales, b._q8_scales)
    np.testing.assert_array_equal(a.Sigma, b.Sigma)


@pytest.mark.parametrize("stream", ["auto", "on"])
@pytest.mark.parametrize("C,chunk", [(1, 2), (2, 2), (3, 5), (2, 0)])
def test_the_final_snapshot_is_the_post_hoc_quant8_fetch(stream, C, chunk):
    """Boundaries every 2 iterations from 2 to 14: the burn-in ones (2, 4,
    6: no saved draw yet) stream nothing, 8..14 each one snapshot."""
    res = dt.fit(_data(), _cfg(stream, C, chunk_size=chunk), device="cpu")
    _same_q8(res, _post_hoc(C, chunk_size=chunk))
    st = res.stream_stats
    assert st["streamed"] and st["skipped"] == 0
    assert st["snapshots"] == {2: 4, 5: 2, 0: 1}[chunk]
    assert len(st["chunk_fetch_s"]) == st["snapshots"]
    assert res.phase_seconds["exposed_fetch_s"] == st["exposed_fetch_s"]
    assert _post_hoc(C, chunk_size=chunk).stream_stats is None


def test_other_fetch_dtypes_and_off_do_not_stream():
    """'auto' engages under quant8 only (as in the JAX package)."""
    cfg = _cfg("auto")
    res = dt.fit(_data(), dataclasses.replace(
        cfg, backend=dataclasses.replace(cfg.backend,
                                         fetch_dtype="bfloat16")),
        device="cpu")
    assert res.stream_stats is None


def test_the_streamed_divisor_is_the_jax_packages_under_quant8():
    """The JAX package streams the same fit shape (its own chain): both
    report a streamed result over the same boundaries."""
    jres = dcfm_tpu.fit(_data(), _cfg(pkg=dcfm_tpu, chunk_size=2))
    res = dt.fit(_data(), _cfg(chunk_size=2), device="cpu")
    assert jres.stream_stats["streamed"] and res.stream_stats["streamed"]
    assert (jres.stream_stats["snapshots"]
            == res.stream_stats["snapshots"] == 4)


def test_a_busy_slot_skips_the_boundary(monkeypatch):
    """The drain of the first snapshot holds its slot until a boundary has
    found both slots busy: that boundary is skipped, the final one waits
    for a slot, and the result is still the post-hoc fetch's bits."""
    gate = threading.Event()
    drain = pipeline.quant8_drain

    def slow_drain(started):
        assert gate.wait(timeout=60)
        return drain(started)

    submit = pipeline.StreamingFetcher.submit

    def watching(self, carries, *, final=False):
        out = submit(self, carries, final=final)
        if self.skipped:
            gate.set()
        return out

    monkeypatch.setattr(pipeline, "quant8_drain", slow_drain)
    monkeypatch.setattr(pipeline.StreamingFetcher, "submit", watching)
    res = dt.fit(_data(), _cfg(), device="cpu")
    st = res.stream_stats
    assert st["skipped"] == 1 and st["snapshots"] == 3
    _same_q8(res, _post_hoc())


def test_a_drain_failure_falls_back_with_a_warning(monkeypatch):
    def failing(started):
        raise OSError("link lost")

    monkeypatch.setattr(pipeline, "quant8_drain", failing)
    with pytest.warns(RuntimeWarning, match="falling back to the post-hoc"):
        res = dt.fit(_data(), _cfg(), device="cpu")
    assert res.stream_stats is None
    _same_q8(res, _post_hoc())


def test_a_dispatch_failure_disables_streaming_with_a_warning(monkeypatch):
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        raise RuntimeError("out of memory")

    monkeypatch.setattr(pipeline, "fetch_prep", failing)
    with pytest.warns(RuntimeWarning, match="disabling streaming"):
        res = dt.fit(_data(), _cfg(), device="cpu")
    assert calls == [1] and res.stream_stats is None
    _same_q8(res, _post_hoc())


def test_a_resumed_streamed_fit_is_the_uninterrupted_one(tmp_path):
    """Killed at the boundary 10 (the writer's save then raises), resumed:
    the stream's divisor is the whole window's, and the bits hold."""
    path = str(tmp_path / "s.npz")
    cfg = dataclasses.replace(_cfg(), checkpoint_path=path,
                              checkpoint_every_chunks=1)
    save = pipeline.save_checkpoint

    class Stop(BaseException):
        pass

    def stop_after_10(p, leaves, c, **kw):
        save(p, leaves, c, **kw)
        if int(np.asarray(leaves["iteration"]).reshape(-1)[0]) == 10:
            raise Stop()

    with pytest.MonkeyPatch.context() as mp:
        class Sync(pipeline.AsyncCheckpointWriter):
            def submit(self, save_fn, p, carries, c, *, fingerprint, **kw):
                from dcfm_tpu_torch.utils.checkpoint import Snapshot
                stop_after_10(p, Snapshot(carries, state_only=False).wait(),
                              c, fingerprint=fingerprint, **kw)
        mp.setattr(pipeline, "AsyncCheckpointWriter", Sync)
        with pytest.raises(Stop):
            dt.fit(_data(), cfg, device="cpu")
    res = dt.fit(_data(), dataclasses.replace(cfg, resume=True),
                 device="cpu")
    assert res.stream_stats["snapshots"] == 2           # 12 and 14
    _same_q8(res, _post_hoc())


def test_the_stream_is_fetch_prep_on_the_chain_order_sum():
    """One submit by hand: the landed panels are fetch_prep's on the
    chains' accumulators summed in chain order."""
    rng = np.random.default_rng(0)
    accs = [torch.as_tensor(rng.standard_normal((4, 5, 5)).astype(np.float32)
                            * (c + 1)) for c in range(3)]
    carries = [type("C", (), {"sigma_acc": a, "readers": []})()
               for a in accs]
    inv = np.float32(1 / 7)
    s = pipeline.StreamingFetcher(inv, 3, 2)
    assert s.submit(carries, final=True)
    out = s.finish()
    pooled = accs[0].clone()
    for a in accs[1:]:
        pooled += a
    q, scale = fetch.fetch_prep(pooled, 3, 2, inv, "quant8")
    np.testing.assert_array_equal(out["q8"], q.numpy())
    np.testing.assert_array_equal(out["scales"], scale.numpy())
    assert out["final_landed"] and out["snapshots"] == 1
    for a, b in zip(accs, [c.sigma_acc for c in carries]):
        assert a is b                          # the carries are untouched
