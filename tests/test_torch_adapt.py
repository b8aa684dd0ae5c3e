"""Adaptive rank truncation and the scenario priors in the PyTorch port:
``adapt_rank`` against the JAX package's bit for bit, the pre-drawn chain
against the live one across adaptations, whole fits against the JAX
package and the truth, and checkpoints of horseshoe + ``rank_adapt`` and
DL fits read, exported and resumed - on the CPU.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.config import AdaptConfig as JAdaptConfig  # noqa: E402
from dcfm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dcfm_tpu.models.adapt import adapt_rank as jadapt_rank  # noqa: E402
from dcfm_tpu.models.state import SamplerState as JSamplerState  # noqa: E402
from dcfm_tpu.serve import artifact as jart  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_torch_priors import JaxNoise  # noqa: E402
from tests.test_torch_resume import _Killed, _SyncWriter  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models.adapt import adapt_rank  # noqa: E402
from dcfm_tpu_torch.models.conditionals import gibbs_sweep  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.models.state import SamplerState, init_state  # noqa: E402
from dcfm_tpu_torch.noise import TorchNoise  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_frob(A, B):
    return np.linalg.norm(A - B) / np.linalg.norm(B)


# ---------------------------------------------------------------------------
# adapt_rank, bit for bit the JAX package's given the same state, coin and
# iteration (the cases of tests/test_adapt.py)
# ---------------------------------------------------------------------------

# a0 = 1 makes p(t) = exp(1 + a1 t) > 1 early: adaptation always fires
_ALWAYS = dict(a0=1.0, a1=-1e-6, eps=0.01, prop=1.0, min_active=1)


def _adapt_pair(Lam, active, it, burnin, adapt, key=0):
    G_, _, K_ = Lam.shape
    key = jax.random.key(key)
    jcfg = JModelConfig(num_shards=G_, factors_per_shard=K_, rho=0.5,
                        rank_adapt=True, adapt=JAdaptConfig(**adapt))
    js = JSamplerState(Lambda=jnp.asarray(Lam), Z=jnp.zeros((G_, 4, K_)),
                       X=jnp.zeros((4, K_)), ps=jnp.ones(Lam.shape[:2]),
                       prior={}, active=jnp.asarray(active))
    j = jadapt_rank(key, js, jnp.int32(it), jnp.int32(burnin), jcfg)
    cfg = dt.ModelConfig(num_shards=G_, factors_per_shard=K_, rho=0.5,
                         rank_adapt=True, adapt=dt.AdaptConfig(**adapt))
    ts = SamplerState(Lambda=torch.as_tensor(Lam), Z=torch.zeros(G_, 4, K_),
                      X=torch.zeros(4, K_), ps=torch.ones(Lam.shape[:2]),
                      prior={}, active=torch.as_tensor(active))
    t = adapt_rank(JaxNoise(key, G_), ts, torch.tensor(float(it)), burnin,
                   cfg)
    return (t.active.numpy(), np.asarray(j.active), t.Lambda.numpy(),
            np.asarray(j.Lambda))


def _assert_bitwise(pair):
    ta, ja, tl, jl = pair
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tl, jl)
    return ta


def test_adapt_drops_redundant_and_grows_when_saturated():
    Lam = np.full((2, 5, 3), 0.5, np.float32)
    Lam[0, :, 1] = 1e-4
    Lam[1, :, 2] = 0.0
    active = np.array([[1, 1, 1], [1, 1, 0]], np.float32)
    got = _assert_bitwise(_adapt_pair(Lam, active, 5, 100, _ALWAYS))
    np.testing.assert_array_equal(got, [[1, 0, 1], [1, 1, 1]])


def test_adapt_respects_min_active():
    Lam = np.full((1, 5, 3), 1e-4, np.float32)
    got = _assert_bitwise(_adapt_pair(
        Lam, np.ones((1, 3), np.float32), 5, 100,
        _ALWAYS | {"min_active": 2}))
    np.testing.assert_array_equal(got, [[1, 1, 1]])


def test_adapt_frozen_after_burnin():
    Lam = np.full((1, 5, 3), 1e-4, np.float32)
    got = _assert_bitwise(_adapt_pair(Lam, np.ones((1, 3), np.float32),
                                      101, 100, _ALWAYS))
    np.testing.assert_array_equal(got, [[1, 1, 1]])


@pytest.mark.parametrize("seed", range(6))
def test_adapt_on_random_states_and_coins(seed):
    """Random loadings and masks, the coin at p(t) = exp(-0.7 - 0.01 t)
    near one half: drops, growths and no-ops, bit for bit."""
    rng = np.random.default_rng(seed)
    Lam = (rng.standard_normal((4, 6, 5))
           * rng.choice([1e-3, 1.0], (4, 1, 5))).astype(np.float32)
    active = (rng.uniform(size=(4, 5)) < 0.7).astype(np.float32)
    active[:, 0] = 1.0
    Lam *= active[:, None, :]
    adapt = dict(a0=-0.7, a1=-0.01, eps=0.05, prop=0.8, min_active=2)
    _assert_bitwise(_adapt_pair(Lam, active, 1 + seed, 50, adapt,
                                key=seed))


# ---------------------------------------------------------------------------
# the pre-drawn chain (noise.BufferedDraws, the CPU's trips) is the live
# one, bit for bit, across trips in which adaptation fires
# ---------------------------------------------------------------------------

G, N, P, K = 3, 24, 10, 4
_FIRE = dt.AdaptConfig(a0=1.0, a1=-1e-3, eps=0.2, prop=0.6, min_active=1)


@pytest.mark.parametrize("prior,rank_adapt", [("dl", False),
                                              ("horseshoe", True),
                                              ("mgp", True), ("dl", True)])
def test_pre_drawn_draws_are_the_live_draws_across_adaptation(prior,
                                                              rank_adapt):
    rng = np.random.default_rng(2)
    Yd = torch.as_tensor(rng.standard_normal((G, N, P)).astype(np.float32))
    m = dt.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                       prior=prior, rank_adapt=rank_adapt, adapt=_FIRE,
                       sse_mode="gram")
    pr = make_prior(m)
    burnin, iters, unroll = 9, 15, 3
    runner = sampler.ChainRunner(TorchNoise(0, "cpu"), Yd, m, pr,
                                 burnin=burnin, thin=2, unroll=unroll,
                                 graphs=False)
    carry = runner.init_chain(0)
    runner.run_chunk(0, carry, iters)
    assert runner.eager_trips == iters // unroll

    noise = TorchNoise(0, "cpu")
    state = init_state(noise.init(0), pr, G=G, n=N, P=P, K=K, as_=m.as_,
                       bs=m.bs, device="cpu", rank_adapt=rank_adapt)
    masks = []
    for i in range(iters):
        d = noise.sweep(0, i)
        state, _ = gibbs_sweep(d, Yd, state, m, pr)
        state = adapt_rank(d, state, torch.tensor(float(i + 1)), burnin, m)
        if rank_adapt:
            masks.append(state.active.clone())
    for a, b in zip(sampler.state_leaves(carry.state),
                    sampler.state_leaves(state), strict=True):
        assert torch.equal(a, b)
    if rank_adapt:
        # the mask changed after the first trip (whose live draws were
        # recorded as the recipe) and froze after burn-in
        changed = [i for i in range(1, iters)
                   if not torch.equal(masks[i], masks[i - 1])]
        assert any(i >= unroll for i in changed), changed
        assert all(i < burnin for i in changed), changed


# ---------------------------------------------------------------------------
# whole fits: against the JAX package's fits and against the truth (the
# cases of tests/test_adapt.py)
# ---------------------------------------------------------------------------

def _adapt_cfg(pkg, prior, eps, a1, burnin, seed_offset=0):
    return pkg.FitConfig(
        model=pkg.ModelConfig(
            num_shards=2, factors_per_shard=4, rho=0.9, prior=prior,
            rank_adapt=True,
            adapt=pkg.AdaptConfig(a0=-0.5, a1=a1, eps=eps, prop=0.9)),
        run=pkg.RunConfig(burnin=burnin, mcmc=200, thin=1, seed=0))


# (data seed, prior, eps, a1, burn-in) of tests/test_adapt.py's cases
TRUTH = {"mgp": (29, "mgp", 0.1, -2e-3, 400),
         "dl": (41, "dl", 0.2, -1.5e-3, 600),
         "horseshoe": (43, "horseshoe", 0.15, -2e-3, 600)}


@functools.lru_cache(maxsize=None)
def _truth_fit(case, pkg_name="port"):
    seed, prior, eps, a1, burnin = TRUTH[case]
    Y, St = make_synthetic(200, 48, 2, seed=seed)
    if pkg_name == "jax":
        return dcfm_tpu.fit(Y, _adapt_cfg(dcfm_tpu, prior, eps, a1,
                                          burnin)), St
    return dt.fit(Y, _adapt_cfg(dt, prior, eps, a1, burnin),
                  device="cpu"), St


@pytest.mark.parametrize("case", ["mgp", "dl", "horseshoe"])
def test_rank_adapt_recovers_the_true_rank(case):
    """K = 2x the true per-shard rank: the effective rank shrinks toward
    the truth during burn-in, accuracy is kept (the JAX package's bands),
    and the frozen mask is in the state and the loadings."""
    res, St = _truth_fit(case)
    assert res.stats.nonfinite_count == 0
    assert res.stats.rank_max <= 4
    assert res.stats.rank_mean <= 2 + 1.0
    assert res.stats.rank_min >= 1
    assert _rel_frob(res.Sigma, St) < 0.35
    act = res.state.active.numpy()
    assert np.all((act == 0) | (act == 1))
    lam = res.state.Lambda.numpy()
    for m in range(act.shape[0]):
        assert np.all(lam[m][:, act[m] == 0] == 0)


def test_horseshoe_rank_adapt_fit_agrees_with_the_jax_fit():
    """BASELINE config 5's prior and knob at unit scale, both packages on
    the same Y (different random streams, the same model)."""
    port, _ = _truth_fit("horseshoe")
    jax_res, _ = _truth_fit("horseshoe", "jax")
    # two chains of 800 iterations each, different streams: the Monte
    # Carlo spread between them is the band (test_torch_fit.py's JAX
    # parity band, 0.05)
    assert _rel_frob(port.Sigma, jax_res.Sigma) < 0.05
    assert abs(port.stats.rank_mean - float(jax_res.stats.rank_mean)) <= 1.0
    assert 1 <= float(jax_res.stats.rank_min) <= port.stats.rank_max <= 4


def test_dl_fit_agrees_with_the_jax_fit():
    """The DL prior without adaptation: test_torch_fit.py's twin-parity
    shape (n = 120, p = 48, g = 2, K = 3, rho = 0.7, 400 + 400)."""
    Y, St = make_synthetic(120, 48, 3, seed=5)
    cfgs = [pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=2, factors_per_shard=3, rho=0.7,
                              prior="dl"),
        run=pkg.RunConfig(burnin=400, mcmc=400, seed=0),
        backend=pkg.BackendConfig(sse_mode="gram")) for pkg in (dt, dcfm_tpu)]
    port = dt.fit(Y, cfgs[0], device="cpu")
    jax_res = dcfm_tpu.fit(Y, cfgs[1])
    assert port.stats.rank_min == port.stats.rank_max == 3
    assert _rel_frob(port.Sigma, jax_res.Sigma) < 0.05
    assert abs(_rel_frob(port.Sigma, St) - _rel_frob(jax_res.Sigma, St)) \
        < 0.05


# ---------------------------------------------------------------------------
# checkpoints of horseshoe + rank_adapt and of DL
# ---------------------------------------------------------------------------

CN, CP, CG, CK = 40, 24, 2, 3
SCEN = {"hs_adapt": {"prior": "horseshoe", "rank_adapt": True},
        "dl": {"prior": "dl"}}
# fires during burn-in: the kills below land mid-adaptation
_CK_ADAPT = dict(a0=1.0, a1=-1e-3, eps=0.3, prop=0.5)


@functools.lru_cache(maxsize=None)
def _ck_data():
    return make_synthetic(CN, CP, 2, seed=3)[0]


def _ck_cfg(pkg, scen, C=2, **kw):
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=CG, factors_per_shard=CK, rho=0.6,
                              adapt=pkg.AdaptConfig(**_CK_ADAPT),
                              **SCEN[scen]),
        run=pkg.RunConfig(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
                          chunk_size=4),
        backend=pkg.BackendConfig(sse_mode="gram"), **kw)


@functools.lru_cache(maxsize=None)
def _ck_plain(scen):
    return dt.fit(_ck_data(), _ck_cfg(dt, scen), device="cpu")


@pytest.fixture
def writer(monkeypatch):
    _SyncWriter.kill_after, _SyncWriter.saves = None, []
    _SyncWriter.seconds = 0.0
    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", _SyncWriter)
    return _SyncWriter


def _killed_run(cfg, writer, k):
    writer.kill_after, writer.saves = k, []
    with pytest.raises(_Killed):
        dt.fit(_ck_data(), cfg, device="cpu")
    writer.kill_after = None


def _same(a, b):
    np.testing.assert_array_equal(a.Sigma, b.Sigma)
    for x, y in zip(sampler.state_leaves(a.state),
                    sampler.state_leaves(b.state), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("scen", ["hs_adapt", "dl"])
def test_the_jax_package_reads_a_scenario_checkpoint(tmp_path, scen):
    """Leaf for leaf in the JAX ChainCarry's order (the prior's leaves by
    name, then the mask), the config field for field."""
    path = str(tmp_path / "c.npz")
    cfg = _ck_cfg(dt, scen, checkpoint_path=path)
    res = dt.fit(_ck_data(), cfg, device="cpu")
    jm = _ck_cfg(dcfm_tpu, scen).model
    init_fn = dcfm_tpu.api._local_fns(jm, 4, 2)[0]
    P = res.preprocess.data.shape[2]
    tpl = jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                         jax.ShapeDtypeStruct((CG, CN, P), np.float32))
    carry, meta = jck.load_checkpoint(path, tpl)
    got = jax.tree.leaves(carry)
    want = sampler.state_leaves(res.state)
    names = ck.state_leaf_names(cfg.model)
    assert len(want) == len(names) == (9 if scen == "hs_adapt" else 7)
    for name, a, b in zip(names, got[:len(want)], want, strict=False):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    jcfg = jck.config_from_checkpoint_meta(meta)
    assert dataclasses.asdict(jcfg.model) == dataclasses.asdict(
        _ck_cfg(dcfm_tpu, scen).model)
    if scen == "hs_adapt":
        assert (np.asarray(carry.state.active) == 0).any()   # it adapted
    assert ck.config_from_checkpoint_meta(meta) == cfg


@pytest.mark.parametrize("scen", ["hs_adapt", "dl"])
def test_both_packages_export_a_scenario_checkpoint_alike(tmp_path, scen):
    """The JAX package's export_from_checkpoint of a port file, the port's,
    and the fit's own export: mean panels and scales byte for byte; and
    the port exports a JAX-written file of the same config as the JAX
    package does."""
    path = str(tmp_path / "c.npz")
    res = dt.fit(_ck_data(), _ck_cfg(dt, scen, checkpoint_path=path),
                 device="cpu")
    jpath = str(tmp_path / "j.npz")
    dcfm_tpu.fit(_ck_data(), _ck_cfg(dcfm_tpu, scen, checkpoint_path=jpath))
    outs = {}
    for name, fn, src in (("jax", jart.export_from_checkpoint, path),
                          ("port", tart.export_from_checkpoint, path),
                          ("jax_j", jart.export_from_checkpoint, jpath),
                          ("port_j", tart.export_from_checkpoint, jpath)):
        outs[name] = str(tmp_path / name)
        fn(src, _ck_data(), outs[name])
    outs["fit"] = str(tmp_path / "fit")
    res.export_artifact(outs["fit"])

    def files(d):
        a = tart.PosteriorArtifact.open(d)
        return (open(os.path.join(d, "mean_q8.bin"), "rb").read(),
                np.asarray(a.panels("mean")[1]).tobytes())

    assert files(outs["jax"]) == files(outs["port"]) == files(outs["fit"])
    assert files(outs["jax_j"]) == files(outs["port_j"])


@pytest.mark.parametrize("scen", ["hs_adapt", "dl"])
def test_a_killed_scenario_fit_resumes_bitwise(tmp_path, writer, scen):
    """Killed after each boundary's save (4 and 8: mid-adaptation, and
    after burn-in), resumed: Sigma and every state leaf, the mask
    included, are the uninterrupted fit's bits."""
    ref = _ck_plain(scen)
    for k, at in enumerate((4, 8), start=1):
        cfg = _ck_cfg(dt, scen, checkpoint_path=str(tmp_path / f"{k}.npz"),
                      checkpoint_every_chunks=1)
        _killed_run(cfg, writer, k)
        assert writer.saves[-1][1] == at
        res = dt.fit(_ck_data(), dataclasses.replace(cfg, resume=True),
                     device="cpu")
        _same(res, ref)
        assert res.stats == ref.stats


@pytest.mark.parametrize("scen", ["hs_adapt", "dl"])
def test_a_light_scenario_file_resumes_through_its_sidecar(tmp_path, writer,
                                                           scen):
    cfg = _ck_cfg(dt, scen, checkpoint_path=str(tmp_path / "s.npz"),
                  checkpoint_every_chunks=1, checkpoint_mode="light",
                  checkpoint_full_every=2)
    _killed_run(cfg, writer, 3)
    assert writer.saves == [("s.npz", 4, True), ("s.npz.full", 8, False),
                            ("s.npz", 12, True)]
    res = dt.fit(_ck_data(), dataclasses.replace(cfg, resume=True),
                 device="cpu")
    _same(res, _ck_plain(scen))
