"""The chunked combine (``ModelConfig.combine_chunks``) of the PyTorch port
on one device, against the JAX package on the CPU.

The accumulation of one saved draw is held to the JAX package's chunked
body (``covariance_panels`` on the same pair slices, added with
``.at[c0:c1].add``) on an identical state; a short fit to the JAX
package's chunked fit in rel. Frobenius, as the whole-fit checks are; the
port's chunked fit to its unchunked one (f32 tolerance: a smaller batched
GEMM may round another way on the card; on the CPU they agree), with the
posterior SD and the draw ring on; and a checkpoint's config carries the
knob to the JAX package's reader.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.models import conditionals as jcond  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_torch_fit import TWIN, _rel_frob, _twin_data  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models import state as tstate  # noqa: E402
from dcfm_tpu_torch.models.conditionals import cross_moments  # noqa: E402

# two K-term float32 contractions per entry in another summation order
# (the tolerance of tests/test_torch_sweep.py's covariance_panels check),
# relative to the accumulator's largest entry
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("g", [1, 4, 5, 16])
def test_pair_chunks_are_the_jax_bounds(g):
    """Every divisor of g: contiguous ranges covering the packed-pair axis
    at the JAX package's (i * Q) // c."""
    Q = tstate.num_padded_pairs(g)
    for c in (d for d in range(1, g + 1) if g % d == 0):
        got = sampler.pair_chunks(Q, c)
        want = [(i * Q) // c for i in range(c + 1)]
        assert got == list(zip(want[:-1], want[1:]))
        assert got[0][0] == 0 and got[-1][1] == Q


def _jax_chunked_body(acc, acc_sq, Lam, ps, rho, rows, cols, chunks,
                      eta):
    """The JAX package's chunked accumulation (models/sampler.py, single
    device: reduce_fn is a local sum and the barrier passes values
    through)."""
    acc, acc_sq = jnp.asarray(acc), jnp.asarray(acc_sq)
    Q = acc.shape[0]
    bounds = [(i * Q) // chunks for i in range(chunks + 1)]
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        blocks = jcond.covariance_panels(
            jnp.asarray(Lam), jnp.asarray(ps), rho, rows[c0:c1],
            cols[c0:c1], eta_all=None if eta is None else jnp.asarray(eta))
        acc = acc.at[c0:c1].add(blocks)
        acc_sq = acc_sq.at[c0:c1].add(blocks * blocks)
    return np.asarray(acc), np.asarray(acc_sq)


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
@pytest.mark.parametrize("chunks", [2, "g"])
def test_chunked_accumulation_matches_the_jax_body(chunks, estimator):
    """Identical state and accumulators (already holding draws) into both
    packages' chunked bodies: the accumulator and the second moment within
    the stated float32 tolerance of the JAX package's, and the port's
    chunked sums within it of its unchunked ones."""
    rng = np.random.default_rng(3)
    g, P_, K_, n, rho = 4, 6, 3, 12, 0.7
    chunks = g if chunks == "g" else chunks
    Lam = rng.standard_normal((g, P_, K_)).astype(np.float32)
    ps = rng.gamma(2.0, 1.0, (g, P_)).astype(np.float32)
    eta = (rng.standard_normal((g, n, K_)).astype(np.float32)
           if estimator == "scaled" else None)
    rows, cols = tstate.packed_pair_indices(g)
    Q = rows.size
    acc0 = rng.standard_normal((Q, P_, P_)).astype(np.float32)
    sq0 = rng.gamma(2.0, 1.0, (Q, P_, P_)).astype(np.float32)
    state = tstate.SamplerState(
        Lambda=torch.as_tensor(Lam), Z=None, X=None,
        ps=torch.as_tensor(ps), prior={})
    eta_t = None if eta is None else torch.as_tensor(eta)
    out = {}
    for c in (chunks, 1):
        acc, sq = torch.as_tensor(acc0.copy()), torch.as_tensor(sq0.copy())
        sampler.add_panels(
            acc, sq, state, rho, torch.as_tensor(rows, dtype=torch.long),
            torch.as_tensor(cols, dtype=torch.long),
            sampler.pair_chunks(Q, c), eta=eta_t,
            H_grid=None if eta_t is None else cross_moments(eta_t))
        out[c] = acc.numpy(), sq.numpy()
    ref = _jax_chunked_body(acc0, sq0, Lam, ps, rho, rows, cols, chunks,
                            eta)
    for got, want, flat in zip(out[chunks], ref, out[1]):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale)
        np.testing.assert_allclose(got, flat, rtol=RTOL, atol=ATOL * scale)


def _twin_cfg(pkg, chunks, **model):
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=TWIN["g"],
                              factors_per_shard=TWIN["K"], rho=TWIN["rho"],
                              lambda_kernel="pallas", combine_chunks=chunks,
                              **model),
        run=pkg.RunConfig(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"], seed=0),
        backend=pkg.BackendConfig(sse_mode="gram"))


def test_chunked_fit_agrees_with_the_jax_chunked_fit():
    """The port's chunked fit and the JAX package's chunked fit of the same
    data (different random streams, the same model) within
    tests/test_torch_fit.py's port-against-JAX band."""
    Y, _ = _twin_data()
    S_jx = dcfm_tpu.fit(Y, _twin_cfg(dcfm_tpu, 2)).Sigma
    S_pt = dt.fit(Y, _twin_cfg(dt, 2), device="cpu").Sigma
    assert _rel_frob(S_pt, S_jx) < 0.05


SMALL = dict(num_shards=4, factors_per_shard=3, rho=0.6)


@functools.lru_cache(maxsize=None)
def _small_fit(chunks, estimator="scaled", sd=False, draws=False):
    Y, _ = make_synthetic(40, 24, 3, seed=2)
    cfg = dt.FitConfig(
        model=dt.ModelConfig(**SMALL, combine_chunks=chunks,
                             estimator=estimator, posterior_sd=sd),
        run=dt.RunConfig(burnin=10, mcmc=16, thin=2, num_chains=2,
                         store_draws=draws))
    return dt.fit(Y, cfg, device="cpu")


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_fit_is_the_unchunked_fit(chunks, estimator):
    """The same chain: the state bitwise (the combine feeds nothing back),
    the panels and Sigma within the float32 tolerance."""
    a, b = _small_fit(chunks, estimator), _small_fit(1, estimator)
    for x, y in zip(sampler.state_leaves(a.state),
                    sampler.state_leaves(b.state), strict=True):
        assert torch.equal(x, y)
    scale = float(np.abs(b.upper_panels).max())
    np.testing.assert_allclose(a.upper_panels, b.upper_panels, rtol=RTOL,
                               atol=ATOL * scale)
    np.testing.assert_allclose(a.Sigma, b.Sigma, rtol=RTOL,
                               atol=ATOL * float(np.abs(b.Sigma).max()))


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_fit_with_posterior_sd_and_stored_draws(chunks):
    """Under posterior_sd the second moment is chunked with the mean; under
    store_draws the ring's H is the combine's own cross-moments, formed
    once per saved draw for every range, so the ring is bitwise."""
    a, b = (_small_fit(c, sd=True, draws=True) for c in (chunks, 1))
    for name in ("Sigma", "Sigma_sd"):
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_allclose(x, y, rtol=RTOL,
                                   atol=ATOL * float(np.abs(y).max()))
    assert a.draws.keys() == b.draws.keys() and "H" in a.draws
    for k in a.draws:
        np.testing.assert_array_equal(a.draws[k], b.draws[k])


def test_checkpoint_config_round_trip(tmp_path):
    """A port checkpoint of a chunked fit: the JAX package verifies it and
    reads combine_chunks back; the port resumes it bitwise and exports it
    as the fit exports itself."""
    from dcfm_tpu_torch.serve.artifact import export_from_checkpoint
    Y, _ = make_synthetic(40, 24, 3, seed=2)
    path = str(tmp_path / "cc.npz")
    cfg = dt.FitConfig(
        model=dt.ModelConfig(**SMALL, combine_chunks=2),
        run=dt.RunConfig(burnin=10, mcmc=8, thin=2, chunk_size=6),
        backend=dt.BackendConfig(fetch_dtype="quant8"),
        checkpoint_path=path)
    res = dt.fit(Y, cfg, device="cpu")
    meta = jck.verify_checkpoint(path)
    assert meta["crc_verified"] and meta["iteration"] == 18
    jcfg = jck.config_from_checkpoint_meta(meta)
    assert jcfg.model.combine_chunks == 2
    art = export_from_checkpoint(path, Y, str(tmp_path / "art"))
    own = res.export_artifact(str(tmp_path / "own"))
    np.testing.assert_array_equal(np.asarray(art.mean_panels),
                                  np.asarray(own.mean_panels))
    np.testing.assert_array_equal(art.mean_scale, own.mean_scale)
    longer = dataclasses.replace(cfg.run, mcmc=16)
    again = dt.fit(Y, dataclasses.replace(cfg, resume=True, run=longer),
                   device="cpu")
    ref = dt.fit(Y, dataclasses.replace(cfg, checkpoint_path=None,
                                        run=longer), device="cpu")
    np.testing.assert_array_equal(again.Sigma, ref.Sigma)
