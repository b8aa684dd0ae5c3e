"""The port's shard mesh (dcfm_tpu_torch/parallel/) on gloo ranks of the
CPU, against the JAX package and against the port's one-process fit.

* one sweep of 4 ranks, from the same state and on the JAX package's own
  draws, against the JAX ``gibbs_sweep`` leaf by leaf, and one saved
  draw's panels gathered from the ranks' pair slices against the JAX
  package's ``covariance_panels``;
* ``fit(..., mesh_devices=4)`` against the one-process fit, with one and
  several shards per rank and on a packed (chains x shards) grid, within
  the JAX package's own mesh-parity band (rtol 1e-3, atol 1e-4,
  ``tests/test_shard.py``); a one-rank mesh is bitwise the one-device
  fit;
* the mesh fit and the JAX package's mesh fit recover the same truth to
  the same accuracy;
* (every model knob the mesh carries, and lazy inputs: in
  tests/test_torch_mesh_knobs.py);
* the layout's checks and messages against the JAX package's, and a
  rank's draws against the one-device chain's.

Ranks are processes (4 per fit, one thread each); a mesh fit costs about
3 s of start-up here.
"""

import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu.models import conditionals as jcond  # noqa: E402
from dcfm_tpu.models import state as jstate  # noqa: E402
from dcfm_tpu.models.priors import make_prior as jmake_prior  # noqa: E402
from dcfm_tpu.parallel import mesh as jmesh  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from dcfm_tpu_torch.interop import state_from_numpy  # noqa: E402
from dcfm_tpu_torch.models import conditionals as tcond  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.noise import SITE_X, ShardSliceNoise, TorchNoise  # noqa: E402
from dcfm_tpu_torch.ops import cuda_lib  # noqa: E402
from dcfm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RTOL, ATOL = 1e-3, 1e-4       # tests/test_shard.py's mesh-parity band


# ---------------------------------------------------------------------------
# one sweep on four ranks against the JAX sweep
# ---------------------------------------------------------------------------

class _JaxDraws:
    """The JAX sweep's draws at iteration key ``key`` over all G shards
    (tests/test_torch_sweep.py's JaxNoise), each call recorded with its
    value: the ranks replay the record."""

    def __init__(self, key, G):
        self.key, self.G, self.calls = key, G, []

    def _each(self, site, part, fn, shared=False):
        site_key = jax.random.fold_in(self.key, site)
        keys = ([site_key] if shared else
                [jax.random.fold_in(site_key, g) for g in range(self.G)])
        if part is not None:
            keys = [jax.random.split(k)[part] for k in keys]
        out = [np.asarray(fn(k, g)) for g, k in enumerate(keys)]
        return out[0] if shared else np.stack(out)

    def _rec(self, kind, site, part, shape, value):
        value = np.array(value, np.float32)
        self.calls.append((kind, site, part, tuple(shape), value))
        return torch.as_tensor(value)

    def normal(self, site, shape, *, part=None):
        shape = tuple(shape)
        if site == SITE_X:
            v = self._each(site, part, lambda k, _: jax.random.normal(
                k, shape, jnp.float32), shared=True)
        else:
            v = self._each(site, part, lambda k, _: jax.random.normal(
                k, shape[1:], jnp.float32))
        return self._rec("normal", site, part, shape, v)

    def exponential(self, site, shape, *, part=None):
        v = self._each(site, part, lambda k, _: jax.random.exponential(
            k, tuple(shape)[1:], jnp.float32))
        return self._rec("exponential", site, part, shape, v)

    def standard_gamma(self, site, alpha, *, part=None):
        a = alpha.numpy()
        v = self._each(site, part, lambda k, g: jax.random.gamma(
            k, jnp.asarray(a[g], jnp.float32)))
        return self._rec("standard_gamma", site, part, alpha.shape, v)


G1, N1, P1, K1 = 8, 40, 12, 3


@functools.lru_cache(maxsize=None)
def _sweep_case(sse_mode):
    """(Y, JAX cfg, jitted sweep, a state 6 JAX sweeps from init)."""
    rng = np.random.default_rng(21)
    L = rng.standard_normal((G1 * P1, 2)) / 2
    Y = (rng.standard_normal((N1, 2)) @ L.T
         + 0.3 * rng.standard_normal((N1, G1 * P1)))
    Y = jpre.preprocess(Y.astype(np.float32), G1, seed=0).data
    cfg = dcfm_tpu.ModelConfig(num_shards=G1, factors_per_shard=K1, rho=0.8,
                               sse_mode=sse_mode)
    prior = jmake_prior(cfg)
    sweep = jax.jit(lambda k, y, s: jcond.gibbs_sweep(k, y, s, cfg, prior))
    state = jstate.init_state(jax.random.key(1), prior, num_local_shards=G1,
                              n=N1, P=P1, K=K1, as_=cfg.as_, bs=cfg.bs)
    for i in range(6):
        state, _ = sweep(jax.random.key(100 + i), jnp.asarray(Y), state)
    s = {"Lambda": np.asarray(state.Lambda), "Z": np.asarray(state.Z),
         "X": np.asarray(state.X), "ps": np.asarray(state.ps),
         "prior": {k: np.asarray(v) for k, v in state.prior.items()}}
    return Y, cfg, sweep, s


def _run_ranks(script_args, world, tmp_path):
    """Start ``world`` ranks of tests/torch_mesh_rank.py and wait."""
    env = dict(os.environ, PYTHONPATH=REPO)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_rank.py"),
         script_args[0], str(r), str(world), store, script_args[1]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out


@pytest.mark.parametrize("sse_mode", ["gram", "resid"])
def test_one_sweep_on_four_ranks_matches_the_jax_sweep(tmp_path, sse_mode):
    """From the same state and the JAX package's draws (recorded once for
    all shards; each rank keeps its block through ShardSliceNoise), a
    4-rank gloo sweep - the X update's sums all-reduced - gives the JAX
    sweep's leaves, and the panels each rank forms from the all-gathered
    loadings on its pair slice are the JAX panels of the new state."""
    Y, jcfg, jsweep, s0 = _sweep_case(sse_mode)
    key = jax.random.key(7)
    js = jstate.SamplerState(
        Lambda=jnp.asarray(s0["Lambda"]), Z=jnp.asarray(s0["Z"]),
        X=jnp.asarray(s0["X"]), ps=jnp.asarray(s0["ps"]),
        prior={k: jnp.asarray(v) for k, v in s0["prior"].items()})
    jnew, jsse = jsweep(key, jnp.asarray(Y), js)
    rows, cols = jstate.packed_pair_indices(G1)
    jeta = (np.sqrt(0.8) * jnew.X[None] + np.sqrt(0.2) * jnew.Z)
    jpanels = np.asarray(jcond.covariance_panels(
        jnew.Lambda, jnew.ps, 0.8, rows, cols, eta_all=jeta))
    cfg = dict(num_shards=G1, factors_per_shard=K1, rho=0.8,
               sse_mode=sse_mode)
    rec = _JaxDraws(key, G1)
    tcond.gibbs_sweep(rec, torch.as_tensor(Y), state_from_numpy(s0, "cpu"),
                      dt.ModelConfig(**cfg), make_prior(dt.ModelConfig(**cfg)))
    inp = tmp_path / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"cfg": cfg, "Y": Y, "state": s0, "calls": rec.calls}, f)
    _run_ranks((str(inp), str(tmp_path / "out.npz")), 4, tmp_path)
    out = np.load(tmp_path / "out.npz")
    # every rank holds the same X: the all-reduced sums are the same bits
    for r in range(1, 4):
        np.testing.assert_array_equal(out["X"][r], out["X"][0])
    ref = {"Lambda": jnew.Lambda, "Z": jnew.Z, "ps": jnew.ps, "sse": jsse,
           "X": jnew.X, "panels": jpanels,
           **{k: v for k, v in jnew.prior.items()}}
    # tests/test_torch_sweep.py's band: 1e-4 of the leaf's scale (its
    # worst measured one-device leaf is 7.1e-6); the all-reduce adds the
    # shards in another order, an ulp-sized change
    for leaf, b in ref.items():
        a = out[leaf][0, 0] if leaf == "X" else out[leaf]
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.max(np.abs(b))),
                                   err_msg=leaf)


# ---------------------------------------------------------------------------
# whole fits: the mesh against the one-process fit
# ---------------------------------------------------------------------------

def _cfg(g=8, K=3, C=1, mesh=0, model=None, run=None, backend=None, **kw):
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=g, factors_per_shard=K, rho=0.8,
                             **(model or {})),
        run=dt.RunConfig(**({"burnin": 10, "mcmc": 10, "thin": 1, "seed": 1,
                             "num_chains": C, "chunk_size": 5}
                            | (run or {}))),
        backend=dt.BackendConfig(backend="torch_cpu", mesh_devices=mesh,
                                 **(backend or {})), **kw)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("g,C,n,p", [(4, 1, 80, 96), (16, 1, 60, 160),
                                     (8, 2, 50, 128)],
                         ids=["one-shard-per-rank", "four-per-rank",
                              "packed-2x2"])
def test_the_mesh_fit_matches_the_one_process_fit(g, C, n, p):
    """Four gloo ranks against one process: Sigma's blocks, the final
    Lambda and the traces within the JAX package's mesh band, with 1 and
    4 shards per rank, and with 2 chains packed one per row of a (2 x 2)
    grid (tests/test_chains_mesh.py's legal packed case)."""
    Y, _ = make_synthetic(n, p, 3, seed=g + C)
    one = dt.fit(Y, _cfg(g=g, C=C))
    cuda_lib.reset_collective_counts()
    mesh = dt.fit(Y, _cfg(g=g, C=C, mesh=4))
    if C > 1:
        assert tmesh.make_layout(4, 0, g, C).rows == 2
    _close(one.sigma_blocks, mesh.sigma_blocks)
    _close(one.state.Lambda.numpy(), mesh.state.Lambda.numpy())
    _close(one.traces, mesh.traces)
    assert mesh.stats.nonfinite_count == 0
    assert abs(mesh.stats.rank_mean - one.stats.rank_mean) < 1e-6
    # rank 0's sweep collectives (one chain on it here): per sweep two
    # all-reduces for the X update and one for the trace, per saved draw
    # three all-gathers (loadings, residual precisions, factors)
    assert cuda_lib.collective_counts() == {"all_reduce": 3 * 20,
                                            "all_gather": 3 * 10}


def test_a_one_rank_mesh_is_bitwise_the_one_device_fit():
    """The mesh's rank program as a world of one rank (``one_rank_mesh``: its
    all-reduce and all-gather are identities) gives the one-device fit's
    bits, and mesh_devices=1 IS the one-device path, as in the JAX
    package."""
    Y, _ = make_synthetic(50, 96, 3, seed=5)
    one = dt.fit(Y, _cfg(C=2))
    m1 = dt.api._fit(Y, _cfg(C=2), None, one_rank_mesh=True)
    d1 = dt.fit(Y, _cfg(C=2, mesh=1))
    for res in (m1, d1):
        np.testing.assert_array_equal(res.Sigma, one.Sigma)
        np.testing.assert_array_equal(res.traces, one.traces)
        assert torch.equal(res.state.Lambda, one.state.Lambda)


def test_the_mesh_fit_agrees_with_the_jax_mesh_fit_statistically():
    """The port's 4-rank fit and the JAX package's mesh_devices=4 fit of
    the same data recover the truth to the same accuracy (the band of
    tests/test_shard.py's statistical mesh test)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual CPU devices for the JAX mesh")
    Y, St = make_synthetic(120, 64, 3, seed=8)
    m, r = dict(num_shards=4, factors_per_shard=3, rho=0.8), dict(
        burnin=80, mcmc=80, thin=1, seed=3)
    jres = dcfm_tpu.fit(Y, dcfm_tpu.FitConfig(
        model=dcfm_tpu.ModelConfig(**m), run=dcfm_tpu.RunConfig(**r),
        backend=dcfm_tpu.BackendConfig(mesh_devices=4)))
    tres = dt.fit(Y, dt.FitConfig(
        model=dt.ModelConfig(**m), run=dt.RunConfig(**r),
        backend=dt.BackendConfig(backend="torch_cpu", mesh_devices=4)))

    def err(S):
        return np.linalg.norm(S - St) / np.linalg.norm(St)

    ej, et = err(jres.Sigma), err(tres.Sigma)
    assert np.isfinite(tres.Sigma).all()
    assert ej < 0.4 and et < 0.4
    assert abs(ej - et) < 0.1


# ---------------------------------------------------------------------------
# the layout and a rank's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,N,g", [(2, 4, 8), (2, 4, 6), (3, 4, 12),
                                   (1, 4, 8), (2, 8, 4), (4, 4, 4)])
def test_the_layout_is_the_jax_package_s(C, N, g):
    """The packing predicate and the shards-per-rank check: the JAX
    package's, message included."""
    assert (tmesh.legal_chain_grid(C, N, g)
            == jmesh.legal_chain_grid(C, N, g))
    cols = N // C if tmesh.legal_chain_grid(C, N, g) else N
    if g % cols:
        with pytest.raises(ValueError) as e:
            tmesh.shards_per_device(g, cols)
        msg = (f"g={g} shards must divide over {cols} mesh devices; choose "
               "g as a multiple of the mesh size")
        assert str(e.value) == msg
        return
    lays = [tmesh.make_layout(N, r, g, C) for r in range(N)]
    # every shard and every packed panel of every chain exactly once
    for c in range(C):
        mine = [lay for lay in lays if c in lay.chains]
        shards = sorted(s for lay in mine for s in range(
            lay.shard_offset, lay.shard_offset + lay.local_shards))
        assert shards == list(range(g))
        pairs = np.concatenate([tmesh.pair_slice(lay)[0] for lay in mine])
        np.testing.assert_array_equal(pairs, jstate.packed_pair_indices(g)[0])


def test_a_rank_draws_its_slice_of_the_one_device_chain():
    """ShardSliceNoise: the init and a sweep's draws of every site on a
    rank are its rows of the one-device chain's draws (the shared sites
    whole), through draw_into's out slots too."""
    from dcfm_tpu_torch.noise import RecordingDraws, draw_into
    base = TorchNoise(3, "cpu")
    sl = ShardSliceNoise(base, 2, 2, 6)
    for a, b in ((base.sweep(1, 7), sl.sweep(1, 7)),
                 (base.init(1), sl.init(1))):
        np.testing.assert_array_equal(a.normal(1, (6, 4, 3))[2:4],
                                      b.normal(1, (2, 4, 3)))
        np.testing.assert_array_equal(a.normal(2, (4, 3)),
                                      b.normal(2, (4, 3)))
        np.testing.assert_array_equal(a.exponential(4, (6, 5))[2:4],
                                      b.exponential(4, (2, 5)))
        np.testing.assert_array_equal(
            a.standard_gamma(5, torch.full((6, 3), 2.5))[2:4],
            b.standard_gamma(5, torch.full((2, 3), 2.5)))
        np.testing.assert_array_equal(a.uniform(6, ()), b.uniform(6, ()))
    recipe = []
    live = RecordingDraws(sl.sweep(0, 2), recipe).uniform(4, (2, 9))
    slot = [torch.empty(2, 9)]
    draw_into(sl.sweep(0, 2), recipe, slot)
    np.testing.assert_array_equal(slot[0], live)
    np.testing.assert_array_equal(slot[0],
                                  base.sweep(0, 2).uniform(4, (6, 9))[2:4])
    with pytest.raises(ValueError, match="leading axis"):
        sl.sweep(0, 0).normal(1, (6, 4))


def test_the_mesh_s_refusals_and_checks():
    """Wider than the visible devices, or g not dividing over the ranks:
    the JAX package's ValueErrors.  The forced streamed fetch, once
    refused on the mesh, streams there as on one device (the JAX
    package's one-process mesh streams too)."""
    Y, _ = make_synthetic(30, 48, 2, seed=0)
    wide = len(os.sched_getaffinity(0)) + 1
    with pytest.raises(ValueError, match="devices visible .no silent "
                                         "fallback"):
        dt.fit(Y, _cfg(g=4, mesh=wide))
    with pytest.raises(ValueError, match="g=6 shards must divide over 4 "
                                         "mesh devices"):
        dt.fit(Y, _cfg(g=6, mesh=4))
    forced = {"fetch_dtype": "quant8", "fetch_stream": "on"}
    mesh = dt.fit(Y, _cfg(g=4, mesh=2, backend=forced))
    res = dt.fit(Y, _cfg(g=4, backend=forced))
    assert res.stream_stats is not None and mesh.stream_stats is not None
    assert mesh.stream_stats["snapshots"] == res.stream_stats["snapshots"]


def test_the_mesh_s_cards_count_from_the_caller_s(monkeypatch):
    """Rank r runs on the r-th card from the one the caller named (rank 0
    where it asked), and the width is checked against the cards from
    there: never a silent move to card 0.  On a stand-in count of two
    cards (the check reads only the count)."""
    from dcfm_tpu_torch.parallel import shard
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert shard.rank_device(torch.device("cuda", 1), 0) == torch.device(
        "cuda", 1)
    assert shard.rank_device(torch.device("cuda", 0), 1) == torch.device(
        "cuda", 1)
    assert shard.rank_device(torch.device("cpu"), 3) == torch.device("cpu")
    shard.check_mesh_devices(2, torch.device("cuda", 0))
    shard.check_mesh_devices(1, torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"mesh_devices=2 but only 1 "
                       r"devices visible from cuda:1 \(no silent fallback"):
        shard.check_mesh_devices(2, torch.device("cuda", 1))
