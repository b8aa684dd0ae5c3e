"""Stored posterior draws (``RunConfig.store_draws``) in the PyTorch port,
against the JAX package on the CPU: the draw ring and the imputation sum
over a chunk of sweeps on the JAX package's own draws, the per-draw
covariance entries and credible intervals, the draw mean against the
accumulator, and the ring in checkpoints (read by the JAX package, resumed
bitwise, exported as the JAX package exports it).
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.api import FitResult as JFitResult  # noqa: E402
from dcfm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dcfm_tpu.models import sampler as jsampler  # noqa: E402
from dcfm_tpu.models.priors import make_prior as jmake_prior  # noqa: E402
from dcfm_tpu.serve import artifact as jart  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from dcfm_tpu.utils import estimate as jest  # noqa: E402
from tests.test_draws import (  # noqa: E402
    _data, _plain_sigma_from_draws, _scaled_sigma_from_draws)
from tests.test_torch_priors import JaxNoise  # noqa: E402
from tests.test_torch_resume import _Killed, _SyncWriter  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.config import ModelConfig  # noqa: E402
from dcfm_tpu_torch.interop import (  # noqa: E402
    draws_from_numpy, draws_to_numpy, state_from_numpy, state_to_numpy)
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils import estimate as test  # noqa: E402
from dcfm_tpu_torch.utils import preprocess as tpre  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- a chunk of sweeps on the JAX package's draws --------------------------

class _OutNoise(JaxNoise):
    """JaxNoise with the ``out=`` of the port's providers, so the chain
    runner can draw a trip's recipe ahead into its slots."""

    def _out(self, kind, *args, part=None, out=None):
        t = getattr(JaxNoise, kind)(self, *args, part=part)
        return t if out is None else out.copy_(t)

    def normal(self, site, shape, *, part=None, out=None):
        return self._out("normal", site, shape, part=part, out=out)

    def exponential(self, site, shape, *, part=None, out=None):
        return self._out("exponential", site, shape, part=part, out=out)

    def uniform(self, site, shape, *, part=None, out=None):
        return self._out("uniform", site, shape, part=part, out=out)

    def standard_gamma(self, site, alpha, *, part=None, out=None):
        return self._out("standard_gamma", site, alpha, part=part, out=out)


class _JaxChain:
    """The JAX chain's streams for the port's chain runner: iteration
    ``it`` (0-based, global) draws from ``fold_in(key, it)``, as
    ``run_chunk`` keys its scan."""

    def __init__(self, key, G: int):
        self.key, self.G = key, G

    def sweep(self, chain, iteration):
        return _OutNoise(jax.random.fold_in(self.key, iteration), self.G)


CG, CN, CP, CK = 3, 20, 8, 3
BURNIN, THIN, ITERS = 2, 2, 8       # saved at 4, 6, 8: a ring of 3


@functools.lru_cache(maxsize=None)
def _chunk_case(estimator: str):
    rng = np.random.default_rng(21)
    L = rng.standard_normal((CG * CP, 2)) / 2
    Y = (rng.standard_normal((CN, 2)) @ L.T
         + 0.3 * rng.standard_normal((CN, CG * CP))).astype(np.float32)
    Y[rng.random(Y.shape) < 0.15] = np.nan
    data = tpre.preprocess(Y, CG, seed=0).data
    jm = JModelConfig(num_shards=CG, factors_per_shard=CK, rho=0.7,
                      estimator=estimator, impute_missing=True)
    prior = jmake_prior(jm)
    key = jax.random.key(5)
    S = (ITERS - BURNIN) // THIN
    carry0 = jsampler.init_chain(key, jnp.asarray(data), jm, prior,
                                 num_global_shards=CG, num_stored_draws=S)
    run = jax.jit(functools.partial(jsampler.run_chunk, cfg=jm, prior=prior,
                                    num_iters=ITERS))
    sched = jnp.asarray([BURNIN, THIN], jnp.float32)
    carry, _, trace = run(key, jnp.asarray(data), carry0, sched)
    return data, key, S, carry0, carry, np.asarray(trace)


def _port_carry(jcarry, device="cpu"):
    """The port's carry from a JAX ChainCarry, through the interop."""
    s = jcarry.state
    state = state_from_numpy(
        {"Lambda": np.asarray(s.Lambda), "Z": np.asarray(s.Z),
         "X": np.asarray(s.X), "ps": np.asarray(s.ps),
         "prior": {k: np.asarray(v) for k, v in s.prior.items()}}, device)
    d = jcarry.draws

    def put(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return sampler.ChainCarry(
        state=state, sigma_acc=put(jcarry.sigma_acc), iteration=0,
        health=put(jcarry.health),
        draws=draws_from_numpy({"Lambda": d.Lambda, "ps": d.ps, "X": d.X,
                                "H": d.H}, device),
        y_imp_acc=put(jcarry.y_imp_acc))


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
@pytest.mark.parametrize("unroll", [1, 3])
def test_a_chunk_fills_the_ring_as_jax(estimator, unroll):
    """From the same carry and on the JAX chain's draws, 8 sweeps with
    imputation (burn-in 2, thin 2): the draw ring slot by slot (Lambda,
    ps, X and, under the scaled estimator, H), the imputation sum and
    the covariance sums are the JAX package's, in trips of 1 and of 3
    sweeps (the slot is computed on the device from the iteration
    tensor, never from the trip's first iteration)."""
    data, key, S, jc0, jc, jtrace = _chunk_case(estimator)
    m = ModelConfig(num_shards=CG, factors_per_shard=CK, rho=0.7,
                    estimator=estimator, impute_missing=True)
    runner = sampler.ChainRunner(_JaxChain(key, CG), torch.as_tensor(data),
                                 m, make_prior(m), burnin=BURNIN, thin=THIN,
                                 unroll=unroll, num_stored_draws=S)
    carry, _, trace = runner.run_chunk(0, _port_carry(jc0), ITERS)
    ring = draws_to_numpy(carry.draws)
    assert (estimator == "plain") == (ring["H"] is None) \
        == (jc.draws.H is None)
    pairs = [(f"draws.{k}", ring[k], np.asarray(getattr(jc.draws, k)))
             for k in ("Lambda", "ps", "X", "H") if ring[k] is not None]
    pairs += [("y_imp_acc", carry.y_imp_acc.numpy(),
               np.asarray(jc.y_imp_acc)),
              ("sigma_acc", carry.sigma_acc.numpy(),
               np.asarray(jc.sigma_acc)),
              ("trace", trace.numpy(), jtrace)]
    t = state_to_numpy(carry.state)
    pairs += [(k, t[k], np.asarray(getattr(jc.state, k)))
              for k in ("Lambda", "X", "ps")]
    # every slot written: no draw is the zero the ring started at
    assert (np.abs(ring["Lambda"]).sum(axis=(1, 2, 3)) > 0).all()
    # the chain's last saved draw is its final state, bit for bit
    assert torch.equal(carry.draws.Lambda[-1], carry.state.Lambda)
    # eight sweeps of float32 rounding differences compounding through
    # the chain: measured at most 7.3e-7 of a leaf's scale over these four
    # cases (ps); 1e-4 keeps 100x headroom and fails a draw in the wrong
    # slot (slots differ by O(1) of the scale)
    for leaf, a, b in pairs:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.max(np.abs(b))),
                                   err_msg=leaf)


def test_interop_round_trip_of_the_ring_is_exact():
    _, _, _, _, jc, _ = _chunk_case("scaled")
    back = draws_to_numpy(draws_from_numpy(
        {k: np.asarray(getattr(jc.draws, k)) for k in jc.draws._fields},
        "cpu"))
    for k in jc.draws._fields:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jc.draws,
                                                                  k)))


# ---- fits ------------------------------------------------------------------

def _cfg(estimator="scaled", chains=1, store=True, pkg=dt, **kw):
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=4, factors_per_shard=2, rho=0.8,
                              estimator=estimator),
        run=pkg.RunConfig(burnin=20, mcmc=20, thin=2, seed=0, chunk_size=15,
                          num_chains=chains, store_draws=store), **kw)


@functools.lru_cache(maxsize=None)
def _fit(estimator="scaled", chains=1, store=True):
    Y = _data().copy()
    Y[:, 7] = 0.0                                     # an all-zero column
    return dt.fit(Y, _cfg(estimator, chains, store), device="cpu")


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
@pytest.mark.parametrize("chains", [1, 2])
def test_draws_are_chain_major_with_the_jax_packages_keys(estimator, chains):
    res = _fit(estimator, chains)
    S = res.config.run.num_saved
    want = {"Lambda": (chains, S, 4, 12, 2), "ps": (chains, S, 4, 12),
            "X": (chains, S, 50, 2)}
    if estimator == "scaled":
        want["H"] = (chains, S, 4, 4, 2, 2)
    assert {k: v.shape for k, v in res.draws.items()} == want
    assert all(v.dtype == np.float32 for v in res.draws.values())
    assert _fit(estimator, chains, False).draws is None


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
def test_storing_draws_leaves_the_chain_alone(estimator):
    """Storing consumes no randomness and writes only the ring: Sigma and
    the traces are bitwise the fit without it."""
    a, b = _fit(estimator, 2), _fit(estimator, 2, False)
    np.testing.assert_array_equal(a.Sigma, b.Sigma)
    np.testing.assert_array_equal(a.traces, b.traces)


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
@pytest.mark.parametrize("chains", [1, 2])
def test_the_draw_mean_reproduces_the_accumulator(estimator, chains):
    """The stored draws define the accumulated mean: rebuilt from the
    ring (H under the scaled estimator), it is the fit's panels to float32
    rounding of the sums (the JAX package's bound, tests/test_draws.py)."""
    res = _fit(estimator, chains)
    acc = test.stitch_blocks(res.sigma_blocks)
    d = test._pool_chain_axis(res.draws)
    rebuilt = (_scaled_sigma_from_draws(d) if estimator == "scaled"
               else _plain_sigma_from_draws(d, rho=0.8))
    np.testing.assert_allclose(rebuilt, acc, rtol=2e-4, atol=2e-4)


ROWS = np.array([0, 5, 13, 30, 47, 7, 3])
COLS = np.array([0, 5, 40, 2, 47, 3, 9])


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
def test_draw_covariance_entries_are_the_jax_packages(estimator):
    """The same numpy arithmetic on the same draws: bitwise."""
    res = _fit(estimator, 2)
    sr = tpre.caller_to_shard_index(res.preprocess, ROWS[ROWS != 7])
    sc = tpre.caller_to_shard_index(res.preprocess, COLS[ROWS != 7])
    out = test.draw_covariance_entries(res.draws, sr, sc, rho=0.8)
    ref = jest.draw_covariance_entries(res.draws, sr, sc, rho=0.8)
    assert out.shape == (2 * res.config.run.num_saved, sr.size)
    np.testing.assert_array_equal(out, ref)
    pooled = test._pool_chain_axis(res.draws)
    for k, v in jest._pool_chain_axis(res.draws).items():
        np.testing.assert_array_equal(pooled[k], v)


@pytest.mark.parametrize("alpha", [0.1, 1e-9])
def test_covariance_credible_interval_is_the_jax_packages(alpha):
    """The port's method against the JAX package's on the same result's
    draws (caller coordinates, the zero column at (0, 0)); the widest
    interval brackets the posterior mean."""
    res = _fit("scaled", 2)
    lo, hi = res.covariance_credible_interval(ROWS, COLS, alpha=alpha)
    view = types.SimpleNamespace(draws=res.draws, preprocess=res.preprocess,
                                 config=res.config)
    jlo, jhi = JFitResult.covariance_credible_interval(view, ROWS, COLS,
                                                       alpha=alpha)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    zero = (ROWS == 7) | (COLS == 7)
    assert (lo[zero] == 0).all() and (hi[zero] == 0).all()
    assert (lo <= hi).all()
    if alpha < 1e-6:
        S = res.Sigma[ROWS, COLS]
        assert ((lo <= S + 1e-6) & (S <= hi + 1e-6)).all()


def test_credible_interval_needs_the_draws():
    with pytest.raises(ValueError, match="store_draws"):
        _fit("scaled", 1, False).covariance_credible_interval([0], [1])


# ---- checkpoints and export ------------------------------------------------

def _jax_template(C, S, estimator="scaled"):
    m = dcfm_tpu.ModelConfig(num_shards=4, factors_per_shard=2, rho=0.8,
                             estimator=estimator)
    init_fn = dcfm_tpu.api._local_fns(m, 4, C, S)[0]
    P = tpre.preprocess(_data(), 4, seed=0).data.shape[2]
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((4, 50, P), np.float32))


@pytest.mark.parametrize("mode", ["full", "light"])
@pytest.mark.parametrize("C", [1, 2])
def test_jax_package_reads_the_ring_leaf_for_leaf(tmp_path, mode, C):
    """The ring's leaves follow the accumulators in the JAX ChainCarry's
    order (a light file keeps the ring, as the JAX package's _slim
    does); the JAX package's load_checkpoint reads them byte for byte."""
    path = str(tmp_path / "d.npz")
    dt.fit(_data(), _cfg(chains=C, checkpoint_path=path,
                         checkpoint_mode=mode), device="cpu")
    m = ModelConfig(num_shards=4, factors_per_shard=2, rho=0.8)
    S = 10
    tpl = ck.carry_template(m, n=50, P=12, num_chains=C, num_stored_draws=S)
    leaves, meta = ck.load_checkpoint(path, tpl)
    names = list(leaves)
    assert names[-4:] == list(ck.DRAW_LEAVES)
    assert "DrawBuffers(Lambda, ps, X, H)" in meta["treedef"]
    jcarry, _ = jck.load_checkpoint(path, _jax_template(C, S))
    got = jax.tree.leaves(jck._slim(jcarry) if mode == "light" else jcarry)
    assert len(got) == len(names)
    for name, b in zip(names, got, strict=True):
        assert leaves[name].tobytes() == np.asarray(b).tobytes(), name


def test_a_killed_fit_resumes_with_its_ring_bitwise(tmp_path, monkeypatch):
    """A kill after the first chunk's save (iteration 15 of 40): the
    resumed fit's draws, Sigma and state are the uninterrupted fit's."""
    from dcfm_tpu_torch.runtime import pipeline
    cfg = _cfg(chains=2, checkpoint_path=str(tmp_path / "k.npz"),
               checkpoint_every_chunks=1)
    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", _SyncWriter)
    monkeypatch.setattr(_SyncWriter, "kill_after", 1)
    monkeypatch.setattr(_SyncWriter, "saves", [])
    with pytest.raises(_Killed):
        dt.fit(_data(), cfg, device="cpu")
    assert _SyncWriter.saves[-1][1] == 15
    monkeypatch.undo()
    res = dt.fit(_data(), dataclasses.replace(cfg, resume=True),
                 device="cpu")
    ref = dt.fit(_data(), dataclasses.replace(cfg, checkpoint_path=None),
                 device="cpu")
    np.testing.assert_array_equal(res.Sigma, ref.Sigma)
    for k in ref.draws:
        np.testing.assert_array_equal(res.draws[k], ref.draws[k])
    for a, b in zip(sampler.state_leaves(res.state),
                    sampler.state_leaves(ref.state), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change", ["toggle", "mcmc"])
def test_resume_refuses_what_the_jax_package_refuses(tmp_path, change):
    """A store_draws toggle, and an mcmc change under store_draws (the
    ring is sized by num_saved): refused, with the JAX package's reason
    on the same file."""
    path = str(tmp_path / "r.npz")
    dt.fit(_data(), _cfg(chains=1, checkpoint_path=path), device="cpu")
    meta = ck.read_checkpoint_meta(path)
    fp = meta["fingerprint"]
    if change == "toggle":
        new, jnew = _cfg(store=False), _cfg(store=False, pkg=dcfm_tpu)
    else:
        new, jnew = (dataclasses.replace(c, run=dataclasses.replace(
            c.run, mcmc=40)) for c in (_cfg(), _cfg(pkg=dcfm_tpu)))
    reason = ck.checkpoint_compatible(meta, new, fp)
    jreason = jck.checkpoint_compatible(jck.read_checkpoint_meta(path),
                                        jnew, fp)
    assert reason is not None and reason == jreason
    with pytest.raises(ValueError, match="refusing to resume"):
        dt.fit(_data(), dataclasses.replace(new, checkpoint_path=path,
                                            resume=True), device="cpu")


def test_an_elastic_adoption_refuses_a_ring(tmp_path):
    path = str(tmp_path / "e.npz")
    dt.fit(_data(), _cfg(chains=2, checkpoint_path=path), device="cpu")
    cfg = dataclasses.replace(_cfg(chains=1), checkpoint_path=path,
                              resume=True)
    with pytest.raises(ValueError, match="refuses store_draws"):
        dt.fit(_data(), cfg, device="cpu")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_export_of_a_store_draws_file_is_the_jax_packages(tmp_path, writer):
    """A store_draws checkpoint of either package: the ring is sized from
    the file's schedule and skipped; the artifact's panels, scales and
    maps are the JAX package's export's, byte for byte."""
    path = str(tmp_path / "x.npz")
    if writer == "port":
        dt.fit(_data(), _cfg(chains=2, checkpoint_path=path), device="cpu")
    else:
        dcfm_tpu.fit(_data(), _cfg(chains=2, pkg=dcfm_tpu,
                                   checkpoint_path=path))
    a = tart.export_from_checkpoint(path, _data(), str(tmp_path / "t"))
    b = jart.export_from_checkpoint(path, _data(), str(tmp_path / "j"))
    for name in ("mean_q8.bin",):
        assert (open(f"{a.path}/{name}", "rb").read()
                == open(f"{b.path}/{name}", "rb").read())
    np.testing.assert_array_equal(a.mean_scale, b.mean_scale)
    assert a.meta["panel_crc"] == b.meta["panel_crc"]
