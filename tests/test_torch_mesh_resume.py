"""The shard mesh's checkpoints, resume and failures (dcfm_tpu_torch/
parallel/), on gloo ranks of the CPU.

A mesh fit writes ONE ordinary checkpoint - every chain's carry gathered
to rank 0, shard-major leaves in rank order, the packed accumulators in
pair order - which the JAX package's loader reads, which resumes on one
device, and which a mesh of any legal width resumes from a one-device
file; bitwise on a one-rank mesh, within the JAX package's mesh band on
four ranks.  A rank that dies fails the fit in the caller with a typed
error at once, and no rank outlives the call.
"""

import dataclasses
import functools
import os
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import dcfm_tpu  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from dcfm_tpu_torch import api  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.parallel import shard  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

G, K, N, P_COLS = 8, 3, 50, 96
RTOL, ATOL = 1e-3, 1e-4       # tests/test_shard.py's mesh-parity band


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 3, seed=7)
    return Y


def _cfg(C=2, **run):
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=4) | run
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6),
        run=dt.RunConfig(**run),
        backend=dt.BackendConfig(backend="torch_cpu", sse_mode="gram"))


def _fit(cfg, ranks=0, **kw):
    """``cfg``'s fit (through ``fit``, with its flight recorder) on one
    device, on ``ranks`` > 1 gloo ranks (``mesh_devices``), or with
    ``ranks`` = 1 as the mesh's rank program in a world of one rank."""
    cfg = dataclasses.replace(cfg, **kw)
    if ranks > 1:
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, mesh_devices=ranks))
    if ranks != 1:
        return dt.fit(_data(), cfg)
    with mock.patch.object(api, "_fit", functools.partial(
            api._fit, one_rank_mesh=True)):
        return dt.fit(_data(), cfg)


def _same(a, b, ranks):
    if ranks == 1:
        np.testing.assert_array_equal(a.Sigma, b.Sigma)
        for x, y in zip(sampler.state_leaves(a.state),
                        sampler.state_leaves(b.state), strict=True):
            assert torch.equal(x, y)
        return
    np.testing.assert_allclose(a.sigma_blocks, b.sigma_blocks, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(a.state.Lambda, b.state.Lambda, rtol=RTOL,
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _plain(mcmc):
    return _fit(_cfg(mcmc=mcmc))


@pytest.mark.parametrize("ranks", [1, 4])
def test_a_mesh_file_resumes_on_one_device_and_back(tmp_path, ranks):
    """A finished mesh fit's file continued on one device to a longer
    schedule, and a one-device file continued on the mesh: both are the
    one-device fit of the longer schedule (bitwise on one rank)."""
    ref = _plain(16)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "m.npz"))
    _fit(cfg, ranks)                                # mesh, finished at 14
    assert sorted(os.listdir(tmp_path)) == ["m.npz", "m.npz.obs"]
    res = _fit(cfg, resume=True, run=dataclasses.replace(cfg.run, mcmc=16))
    _same(res, ref, ranks)
    assert res.traces.shape == (2, 8, 4)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "o.npz"))
    _fit(cfg)                                       # one device
    res = _fit(cfg, ranks, resume=True,
               run=dataclasses.replace(cfg.run, mcmc=16))
    _same(res, ref, ranks)


class _Killed(BaseException):
    """The writer double's kill (the save-failure policy never sees a
    BaseException)."""


class _KillAfter(ck.AsyncCheckpointWriter):
    """Saves synchronously (rank 0's writer) and raises _Killed after the
    ``kill_after``-th save."""

    kill_after = 1
    saves = 0

    def submit(self, save_fn, path, carries, cfg, *, fingerprint, **kw):
        leaves = ck.Snapshot(carries,
                             state_only=bool(kw.get("state_only"))).wait()
        save_fn(path, leaves, cfg, fingerprint=fingerprint, **kw)
        type(self).saves += 1
        if type(self).saves == type(self).kill_after:
            raise _Killed()


def test_a_mesh_killed_mid_run_resumes_on_one_device(tmp_path, monkeypatch):
    """Four ranks killed after their second boundary's save (iteration 8,
    the file written by rank 0 from the gathered carries), resumed on one
    device and on a 2-rank mesh: the uninterrupted one-device fit within
    the mesh band."""
    ref = _plain(8)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "k.npz"),
                              checkpoint_every_chunks=1)
    _KillAfter.kill_after, _KillAfter.saves = 2, 0
    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", _KillAfter)
    with pytest.raises(_Killed):
        _fit(cfg, 4)
    monkeypatch.undo()
    meta = ck.verify_checkpoint(cfg.checkpoint_path)
    assert meta["iteration"] == 8 and meta["topology"]["num_devices"] == 4
    _same(_fit(cfg, resume=True), ref, 4)
    _same(_fit(cfg, 2, resume=True), ref, 4)


def test_the_jax_package_opens_the_mesh_file(tmp_path):
    """The mesh's file is the one-device format: the JAX package's
    verify_checkpoint and load_checkpoint read it, every state leaf the
    mesh fit's final state, the accumulator its packed (Q, P, P)."""
    path = str(tmp_path / "j.npz")
    res = _fit(dataclasses.replace(_cfg(), checkpoint_path=path), 4)
    meta = jck.verify_checkpoint(path)
    assert meta["crc_verified"] and meta["version"] == 8
    assert meta["iteration"] == 14
    m = dcfm_tpu.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6)
    init_fn = dcfm_tpu.api._local_fns(m, 4, 2)[0]
    Pw = preprocess(_data(), G, seed=0).data.shape[2]
    tpl = jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                         jax.ShapeDtypeStruct((G, N, Pw), np.float32))
    carry, _ = jck.load_checkpoint(path, tpl)
    got = jax.tree.leaves(carry)
    st = res.state
    for a, b in zip(got[:6], [st.Lambda, st.Z, st.X, st.ps,
                              st.prior["delta"], st.prior["psijh"]],
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    acc = np.asarray(got[6])
    assert acc.shape == (2, dt.models.state.num_padded_pairs(G), Pw, Pw)
    assert np.isfinite(acc).all() and acc.any()


def test_a_rewind_on_the_mesh_reloads_every_rank(tmp_path, monkeypatch):
    """A chain poisoned on rank 0's block trips the sentinel on every rank
    (the health statistics are reduced over the ranks): all of them
    rewind to the file rank 0 wrote and finish a finite chain."""
    run_chunk = sampler.ChainRunner.run_chunk
    left = [1]

    def poisoned(self, c, carry, n):
        if c == 0 and carry.iteration == 8 and left[0]:
            left[0] -= 1
            carry.state = dataclasses.replace(
                carry.state, Lambda=carry.state.Lambda * float("nan"))
        return run_chunk(self, c, carry, n)

    monkeypatch.setattr(sampler.ChainRunner, "run_chunk", poisoned)
    cfg = dataclasses.replace(_cfg(), checkpoint_path=str(tmp_path / "r.npz"),
                              checkpoint_every_chunks=1)
    res = _fit(cfg, 4, sentinel="rewind")
    assert res.sentinel_rewinds == 1
    assert np.isfinite(res.Sigma).all() and res.stats.acc_nonfinite == 0
    assert res.traces.shape == (2, 14, 4)


def test_a_killed_rank_fails_the_fit_typed_and_leaves_nothing(monkeypatch):
    """A rank SIGKILLed after the first chunk breaks its peers' collectives
    at once: the caller raises MeshRankError naming the rank and its exit
    code well inside the collective timeout, and every rank has exited."""
    started = []
    start_mesh = shard.start_mesh

    def spy(*a, **kw):
        started.append(start_mesh(*a, **kw))
        return started[-1]

    monkeypatch.setattr(api, "start_mesh", spy)
    run_chunk = sampler.ChainRunner.run_chunk
    calls = [0]

    def kill_rank_2(self, c, carry, n):
        calls[0] += 1
        if calls[0] == 3:           # rank 0's second chunk
            started[0].procs[1].kill()
        return run_chunk(self, c, carry, n)

    monkeypatch.setattr(sampler.ChainRunner, "run_chunk", kill_rank_2)
    t = time.perf_counter()
    with pytest.raises(shard.MeshRankError, match="rank 2 exited with code "
                                                  "-9"):
        _fit(_cfg(burnin=40, mcmc=40), 4)
    assert time.perf_counter() - t < shard.TIMEOUT_S / 4
    assert all(p.returncode is not None for p in started[0].procs)
    assert not torch.distributed.is_initialized()
