"""The R-hat early stop (``RunConfig.early_stop="rhat"``) of the PyTorch
port's chunk loop, on the CPU: the stop metric against the JAX package's,
the stop truncating the fit to the short schedule bitwise (post hoc and
through the streamed fetch), the stopped file resumed to the full
schedule bitwise, and a sentinel rewind trimming the trajectory.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.runtime import pipeline as jpipeline  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _trace_cases():
    """(traces list, trace0, burnin) cases: a long post-burn-in window, a
    resumed run's offset, a window too short (NaN), one chain (NaN), a
    summary with no variance, a NaN trace value and a drifting chain."""
    rng = np.random.default_rng(3)

    def chunks(C, sizes, start=0):
        out, it = [], start
        for ni in sizes:
            out.append((it, rng.standard_normal((C, ni, 4))
                        .astype(np.float32)))
            it += ni
        return out

    flat = chunks(2, [10, 10])
    flat[1][1][:, :, 2] = 1.0
    flat[0][1][:, :, 2] = 1.0
    bad = chunks(3, [8, 8])
    bad[1][1][1, 3, 0] = np.nan
    drift = chunks(2, [20, 20, 20])
    drift[2][1][0] += 3.0
    return {"long": (chunks(2, [10, 10, 10]), 0, 5),
            "resumed": (chunks(3, [6, 6], start=12), 12, 10),
            "short": (chunks(2, [4, 4]), 0, 6),
            "one_chain": (chunks(1, [10, 10]), 0, 0),
            "flat": (flat, 0, 2), "nan": (bad, 0, 0),
            "drift": (drift, 0, 10)}


@pytest.mark.parametrize("case", sorted(_trace_cases()))
def test_early_stop_metrics_are_the_jax_packages(case):
    """Exactly the JAX package's (rhat_max, ess_min), NaN where it gives
    NaN: the same split-R-hat and ESS on the same post-burn-in slice."""
    traces, trace0, burnin = _trace_cases()[case]
    got = pipeline.early_stop_metrics(traces, trace0, burnin)
    want = jpipeline.early_stop_metrics(traces, trace0, burnin)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if case in ("short", "one_chain"):
        assert np.isnan(got[0]) and np.isnan(got[1])


N, P_COLS, G, K = 40, 24, 2, 3


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 2, seed=3)
    return Y


def _cfg(es="rhat", mcmc=40, fetch_dtype="float32", **kw):
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6),
        run=dt.RunConfig(burnin=8, mcmc=mcmc, thin=2, seed=0, num_chains=2,
                         chunk_size=4, early_stop=es, rhat_threshold=1.5,
                         ess_target=8.0),
        backend=dt.BackendConfig(sse_mode="gram", fetch_dtype=fetch_dtype),
        **kw)


def _fit(cfg, **kw):
    return dt.fit(_data(), dataclasses.replace(cfg, **kw), device="cpu")


@functools.lru_cache(maxsize=None)
def _stopped(fetch_dtype="float32"):
    return _fit(_cfg(fetch_dtype=fetch_dtype))


def _same(a, b):
    np.testing.assert_array_equal(a.Sigma, b.Sigma)
    np.testing.assert_array_equal(a.traces, b.traces)
    for x, y in zip(sampler.state_leaves(a.state),
                    sampler.state_leaves(b.state), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("fetch_dtype", ["float32", "quant8"])
def test_the_stop_is_the_short_schedule_bitwise(fetch_dtype):
    """Loose thresholds stop the 48-iteration schedule at a boundary with
    chunks left: Sigma, the traces and the state are bitwise an
    early_stop="off" fit whose schedule ends there - through the streamed
    quant8 fetch too, whose final snapshot takes the truncated divisor."""
    res = _stopped(fetch_dtype)
    stop = res.stopped_at_iter
    assert stop is not None and 8 < stop < 48 and stop % 4 == 0
    traj = res.rhat_trajectory
    assert traj.dtype == np.float64 and traj.shape == (stop // 4, 3)
    np.testing.assert_array_equal(traj[:, 0], np.arange(4, stop + 1, 4))
    # only the last row clears both thresholds
    ok = (traj[:, 1] < 1.5) & (traj[:, 2] >= 8.0)
    assert ok[-1] and not ok[:-1].any()
    if fetch_dtype == "quant8":
        assert res.stream_stats is not None
    short = _fit(_cfg("off", mcmc=stop - 8, fetch_dtype=fetch_dtype))
    _same(res, short)
    assert short.stopped_at_iter is None and short.rhat_trajectory is None
    assert res.traces.shape == (2, stop, 4)
    assert res.diagnostics == short.diagnostics


def test_no_stop_at_the_last_boundary_and_none_unconverged():
    """A schedule whose first converged boundary is its last runs to the
    end unstopped; unreachable thresholds never stop."""
    stop = _stopped().stopped_at_iter
    res = _fit(_cfg(mcmc=stop - 8))
    assert res.stopped_at_iter is None
    assert len(res.rhat_trajectory) == stop // 4
    _same(res, _fit(_cfg("off", mcmc=stop - 8)))
    never = _fit(dataclasses.replace(_cfg(mcmc=16), run=dataclasses.replace(
        _cfg(mcmc=16).run, ess_target=1e9)))
    assert never.stopped_at_iter is None
    _same(never, _fit(_cfg("off", mcmc=16)))


def test_a_stopped_file_resumes_to_the_full_schedule_bitwise(tmp_path):
    """The stop boundary saves the final checkpoint; resumed with
    early_stop="off", the fit runs on to the full schedule and is bitwise
    the uninterrupted full run."""
    path = str(tmp_path / "es.npz")
    res = _fit(_cfg(), checkpoint_path=path)
    stop = res.stopped_at_iter
    assert ck.read_checkpoint_meta(path)["iteration"] == stop
    _same(res, _stopped())
    full = _fit(_cfg("off"), checkpoint_path=path, resume=True)
    assert full.stopped_at_iter is None
    assert full.traces.shape == (2, 48 - stop, 4)
    ref = _fit(_cfg("off"))
    np.testing.assert_array_equal(full.Sigma, ref.Sigma)
    np.testing.assert_array_equal(full.traces, ref.traces[:, stop:])
    for x, y in zip(sampler.state_leaves(full.state),
                    sampler.state_leaves(ref.state), strict=True):
        assert torch.equal(x, y)


def test_a_rewind_trims_the_trajectory(tmp_path, monkeypatch):
    """Chain 0 poisoned before the chunk at iteration 8: the sentinel
    trips at 12 and rewinds to the file at 8; the trajectory keeps the
    boundaries up to the rewind and the re-run ones, each once."""
    run_chunk = sampler.ChainRunner.run_chunk
    left = [1]

    def poisoned(self, c, carry, n):
        if c == 0 and carry.iteration == 8 and left[0]:
            left[0] -= 1
            carry.state = dataclasses.replace(
                carry.state, Lambda=carry.state.Lambda * float("nan"))
        return run_chunk(self, c, carry, n)

    monkeypatch.setattr(sampler.ChainRunner, "run_chunk", poisoned)
    res = _fit(_cfg(), checkpoint_path=str(tmp_path / "rw.npz"),
               checkpoint_every_chunks=1, sentinel="rewind")
    assert res.sentinel_rewinds == 1
    its = res.rhat_trajectory[:, 0]
    assert (np.diff(its) > 0).all() and its[0] == 4
    assert res.stopped_at_iter is None or res.stopped_at_iter == its[-1]
