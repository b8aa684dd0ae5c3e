"""Elastic chain counts (``FitConfig.elastic``) in the port against the JAX
package, on the CPU at the JAX package's checkpoint-test size.

A full checkpoint written at C chains resumes at C' chains: a shrink keeps
the first C' chains and folds the dropped chains' sums into chain 0 in the
JAX package's order (the port's adopted leaves are the JAX package's
``load_checkpoint_elastic`` of the same file, bitwise), so the pooled
Sigma counts every draw ever taken; a grow births the new chains on a
bumped lineage, never on a stream a chain already used.  The bookkeeping
(``chain_acc_starts``, ``fold_draws``, ``elastic_lineage``) rides every
later save and the divisor.  Light and ``store_draws`` donors are refused
with the JAX package's messages.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models.state import num_upper_pairs  # noqa: E402
from dcfm_tpu_torch.noise import SITE_X, TorchNoise  # noqa: E402
from dcfm_tpu_torch.runtime import fetch  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402

N, P_COLS, G, K = 40, 24, 2, 3
TOTAL = 14            # burnin 6 + mcmc 8, thin 2: draws saved at 8..14


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


def _cfg(pkg=dt, C=2, sd=True, **run):
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=4) | run
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6,
                              posterior_sd=sd),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(sse_mode="gram"))


def _donor(tmp_path, C, mcmc=4, name=None, **fit_kw):
    """A port fit at C chains with a finished full file at iteration
    6 + mcmc (it resumes to TOTAL under mcmc=8)."""
    path = str(tmp_path / (name or f"donor{C}.npz"))
    dt.fit(_data(), dataclasses.replace(_cfg(C=C, mcmc=mcmc),
                                        checkpoint_path=path, **fit_kw),
           device="cpu")
    return path


def _template(C, sd=True):
    m = dataclasses.replace(_cfg(sd=sd).model, sse_mode="gram")
    P = dt.utils.preprocess.preprocess(_data(), G, seed=0).data.shape[2]
    return ck.carry_template(m, n=N, P=P, num_chains=C)


def _jax_template(C, sd=True):
    m = dcfm_tpu.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6,
                             posterior_sd=sd)
    init_fn = dcfm_tpu.api._local_fns(m, 4, C)[0]
    P = dt.utils.preprocess.preprocess(_data(), G, seed=0).data.shape[2]
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((G, N, P), np.float32))


@pytest.mark.parametrize("donor,to", [(2, 1), (3, 2)])
def test_the_adopted_leaves_are_the_jax_packages(tmp_path, donor, to):
    """A shrink of a port file (posterior_sd: both accumulators fold):
    the port's load_checkpoint_elastic and the JAX package's, leaf for
    leaf and bitwise on the folded sums, with the same bookkeeping."""
    path = _donor(tmp_path, donor)
    leaves, meta, info = ck.load_checkpoint_elastic(path, _template(to), to)
    jcarry, jmeta, jinfo = jck.load_checkpoint_elastic(
        path, _jax_template(to), to)
    got = jax.tree.leaves(jcarry)
    assert len(got) == len(ck.FULL_LEAVES_SD)
    for name, arr in zip(ck.FULL_LEAVES_SD, got, strict=True):
        assert leaves[name].dtype == np.asarray(arr).dtype, name
        assert leaves[name].tobytes() == np.asarray(arr).tobytes(), name
    for key in ("from_chains", "to_chains", "kept", "dropped", "birthed",
                "fold_draws", "chain_acc_starts", "elastic_lineage",
                "from_topology"):
        assert info[key] == jinfo[key], key
    assert info["fold_draws"] == (donor - to) * 2     # 2 draws at 10 each
    # the fold is the donor's chain 0 plus the dropped chains' sums
    raw, _ = ck.load_checkpoint(path, _template(donor))
    for name in (k for k in ck.ACC_LEAVES if k in raw):
        a = raw[name]
        c0 = leaves[name][0] if to > 1 else leaves[name]
        np.testing.assert_array_equal(c0, a[0] + a[to:].sum(axis=0))


def test_a_shrink_pools_every_draw_ever_taken(tmp_path):
    """2 -> 1 at iteration 10: Sigma is (chain 0's uninterrupted sums at
    14 + the dropped chain's sums at 10) / elastic_pooled_draws, within
    float32 summation order (the fold adds chain 1's sums at 10, the
    reference here at 14: 2e-6 of the largest entry allowed; measured over
    seeds 0-4, at most 1.7e-7)."""
    path = _donor(tmp_path, 2)
    donor, _ = ck.load_checkpoint(path, _template(2))
    # only a chain-count mismatch is adopted: the donor ran posterior_sd
    with pytest.raises(ValueError, match="model config changed"):
        dt.fit(_data(), dataclasses.replace(
            _cfg(C=1, sd=False), checkpoint_path=path, resume=True),
            device="cpu")
    res = dt.fit(_data(), dataclasses.replace(
        _cfg(C=1), checkpoint_path=path, resume=True), device="cpu")
    el = res.elastic_resume
    assert (el["from_chains"], el["to_chains"], el["kept"], el["dropped"],
            el["birthed"]) == (2, 1, 1, 1, 0)
    assert el["fold_draws"] == 2 and el["chain_acc_starts"] == (0,)
    assert el["elastic_lineage"] == 1
    assert res.traces.shape == (1, 4, 4)
    total = fetch.elastic_pooled_draws(TOTAL, 6, 2, [0], 2)
    assert total == 6
    # chain 0's own sums at 14: a one-chain fit (chain 0's stream does not
    # depend on how many chains run beside it)
    c0 = str(tmp_path / "c0.npz")
    dt.fit(_data(), dataclasses.replace(_cfg(C=1), checkpoint_path=c0),
           device="cpu")
    own, _ = ck.load_checkpoint(c0, _template(1))
    n = num_upper_pairs(G)
    for name, got in (("sigma_acc", res.upper_panels),):
        want = ((own[name].astype(np.float64)
                 + donor[name][1].astype(np.float64))[:n] / total)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
    # the chain itself continued: chain 0's state is the uninterrupted one
    np.testing.assert_array_equal(res.state.Lambda.numpy(), own["Lambda"])


def test_a_grow_births_chains_on_a_fresh_lineage(tmp_path):
    """1 -> 2 at iteration 10: chain 0 continues verbatim; chain 1 is
    born from TorchNoise.init(1, lineage 1) - not chain 0's initial
    draws, nor chain 1's of lineage 0 - with zero accumulators and window
    start 10; its sweeps are chain 1's, never chain 0's.  A second grow
    after a shrink bumps the lineage again."""
    path = _donor(tmp_path, 1)
    res = dt.fit(_data(), dataclasses.replace(
        _cfg(C=2), checkpoint_path=path, resume=True,
        checkpoint_every_chunks=1), device="cpu")
    el = res.elastic_resume
    assert (el["birthed"], el["fold_draws"], el["chain_acc_starts"],
            el["elastic_lineage"]) == (1, 0, (0, 10), 1)
    assert res.traces.shape == (2, 4, 4)
    assert not np.array_equal(res.traces[0], res.traces[1])
    assert not torch.equal(res.state.Lambda[0], res.state.Lambda[1])
    noise = TorchNoise(0, "cpu")
    shape = (N, K)
    born = noise.init(1, 1).normal(SITE_X, shape)
    for other in (noise.init(0).normal(SITE_X, shape),
                  noise.init(1).normal(SITE_X, shape),
                  noise.init(1, 2).normal(SITE_X, shape)):
        assert not torch.equal(born, other)
    # chain 0 is the one-chain run continued: its state is that fit's
    one = dt.fit(_data(), _cfg(C=1), device="cpu")
    np.testing.assert_array_equal(res.state.Lambda[0].numpy(),
                                  one.state.Lambda.numpy())
    # the bookkeeping rides the saves; the divisor counts 4 + 2 draws
    meta = ck.read_checkpoint_meta(path)
    assert (meta["chain_acc_starts"], meta["fold_draws"],
            meta["elastic_lineage"]) == ([0, 10], 0, 1)
    assert fetch.accumulator_window(TOTAL, 6, 2, 0, 2, [0, 10])[1] \
        == np.float32(2 / 6)
    again = dt.fit(_data(), dataclasses.replace(
        _cfg(C=2), checkpoint_path=path, resume=True), device="cpu")
    assert again.traces.shape[1] == 0
    assert again.elastic_resume["elastic_lineage"] == 1
    np.testing.assert_array_equal(again.Sigma, res.Sigma)
    np.testing.assert_array_equal(again.Sigma_sd, res.Sigma_sd)
    # 2 -> 1 -> 2 chains: the second birth is on lineage 3 (each adoption
    # bumps it), never a state an earlier chain started from
    mid = _donor(tmp_path, 2, mcmc=2, name="mid.npz")
    dt.fit(_data(), dataclasses.replace(_cfg(C=1, mcmc=4),
                                        checkpoint_path=mid, resume=True),
           device="cpu")
    assert ck.read_checkpoint_meta(mid)["elastic_lineage"] == 1
    regrown = dt.fit(_data(), dataclasses.replace(
        _cfg(C=2), checkpoint_path=mid, resume=True), device="cpu")
    assert regrown.elastic_resume["elastic_lineage"] == 2
    assert regrown.elastic_resume["fold_draws"] == 1
    assert regrown.elastic_resume["chain_acc_starts"] == (0, 10)


def test_an_adopted_run_resumes_bitwise_and_exports(tmp_path):
    """After a 2 -> 1 adoption the run's saves carry the fold: killed and
    resumed at one chain, its Sigma is the uninterrupted adopted run's,
    and export_from_checkpoint of its final file (the elastic divisor)
    is the fit's own export_artifact."""
    ref_path = _donor(tmp_path, 2, name="ref.npz")
    ref = dt.fit(_data(), dataclasses.replace(
        _cfg(C=1), checkpoint_path=ref_path, resume=True), device="cpu")
    path = _donor(tmp_path, 2, mcmc=2, name="k.npz")          # file at 8
    mid = dt.fit(_data(), dataclasses.replace(
        _cfg(C=1, mcmc=4), checkpoint_path=path, resume=True),
        device="cpu")
    assert mid.elastic_resume["fold_draws"] == 1
    meta = ck.read_checkpoint_meta(path)
    assert (meta["iteration"], meta["fold_draws"],
            meta["chain_acc_starts"]) == (10, 1, [0])
    out = dt.fit(_data(), dataclasses.replace(
        _cfg(C=1), checkpoint_path=path, resume=True), device="cpu")
    assert out.elastic_resume["fold_draws"] == 1
    assert out.elastic_resume["dropped"] == 0     # a same-count resume
    assert out.traces.shape[1] == 4
    # the shrink at 8 folded 1 draw, the one at 10 folds 2: other chains
    assert not np.array_equal(out.Sigma, ref.Sigma)
    one = dt.fit(_data(), dataclasses.replace(
        _cfg(C=1), checkpoint_path=str(tmp_path / "k2.npz")), device="cpu")
    np.testing.assert_array_equal(out.state.Lambda.numpy(),
                                  one.state.Lambda.numpy())
    art = tart.export_from_checkpoint(path, _data(), str(tmp_path / "a"))
    own = out.export_artifact(str(tmp_path / "own"))
    assert art.mean_panels.tobytes() == own.mean_panels.tobytes()
    assert art.mean_scale.tobytes() == own.mean_scale.tobytes()


def test_light_and_store_draws_donors_are_refused(tmp_path):
    """The JAX package's refusals, by both packages' loaders on the same
    files: a light donor (no accumulators to fold) and a store_draws donor
    (the JAX package's; the port refuses store_draws itself).  Through
    fit: resume=True names the refusal, resume="auto" starts fresh."""
    light = _donor(tmp_path, 2, name="light.npz", checkpoint_mode="light")
    jfile = str(tmp_path / "draws.npz")
    dcfm_tpu.fit(_data(), dataclasses.replace(
        _cfg(dcfm_tpu, C=2, sd=False, store_draws=True),
        checkpoint_path=jfile))
    for path, match, sd in ((light, "needs a FULL checkpoint", True),
                            (jfile, "refuses store_draws", False)):
        with pytest.raises(ValueError, match=match):
            ck.load_checkpoint_elastic(path, _template(1, sd), 1)
        with pytest.raises(ValueError, match=match):
            jck.load_checkpoint_elastic(path, _jax_template(1, sd), 1)
    cfg = dataclasses.replace(_cfg(C=1), checkpoint_path=light, resume=True)
    with pytest.raises(ValueError, match="needs a FULL checkpoint"):
        dt.fit(_data(), cfg, device="cpu")
    auto = dt.fit(_data(), dataclasses.replace(cfg, resume="auto"),
                  device="cpu")
    assert auto.elastic_resume is None and auto.traces.shape[1] == TOTAL
    np.testing.assert_array_equal(auto.Sigma,
                                  dt.fit(_data(), _cfg(C=1),
                                         device="cpu").Sigma)
