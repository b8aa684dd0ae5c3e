"""Missing values (NaN input) in the PyTorch port, against the JAX package
on the CPU: the NaN-aware preprocess and its inverse, the upload, one
imputing sweep on the JAX package's own draws (site 7), whole fits within
the Monte Carlo band, and the imputation sum in checkpoints (read by the
JAX package, folded by an elastic shrink as it folds it, resumed bitwise).

The JAX package's own missing-data resume test fails in the reference
(ROADMAP, "Known reference-side failures"), so the port's resume is held
port against port.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dcfm_tpu.models import conditionals as jcond  # noqa: E402
from dcfm_tpu.models import state as jstate  # noqa: E402
from dcfm_tpu.models.priors import make_prior as jmake_prior  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_missing import _mcar  # noqa: E402
from tests.test_torch_priors import JaxNoise  # noqa: E402
from tests.test_torch_resume import _Killed, _SyncWriter  # noqa: E402
from tests.test_torch_sweep import _raw_y as _complete_raw_y  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.config import ModelConfig  # noqa: E402
from dcfm_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from dcfm_tpu_torch.models import conditionals as tcond  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.runtime import fetch, pipeline  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils import preprocess as tpre  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw_y():
    """tests/test_torch_sweep.py's raw-scale data (a zero column, dropped)
    with NaN entries and a column of zeros and NaNs (kept: NaN != 0)."""
    Y = _complete_raw_y()
    Y[:, 9] = 0.0
    Y, _ = _mcar(Y, 0.15, seed=2)
    Y[:5, 9] = np.nan
    return Y


# ---- the host layer: preprocess, restore, fingerprint, upload --------------

@pytest.mark.parametrize("permute,standardize", [(True, True), (False, True),
                                                 (True, False)])
def test_nan_preprocess_is_bitwise_jax(permute, standardize):
    """The shard data with its NaN positions (the bytes, NaN payloads
    included), the observed-only column statistics, n_missing, the maps
    and the data fingerprint are the JAX package's."""
    Y = _raw_y()
    a = tpre.preprocess(Y, 4, permute=permute, standardize=standardize,
                        seed=3)
    b = jpre.preprocess(Y, 4, permute=permute, standardize=standardize,
                        seed=3)
    assert a.n_missing == b.n_missing == int(np.isnan(Y).sum()) > 0
    assert np.isnan(a.data).sum() == a.n_missing
    for f in ("data", "perm", "inv_perm", "col_mean", "col_scale",
              "kept_cols", "zero_cols"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.n_pad, a.p_original, a.p_used) == (b.n_pad, b.p_original,
                                                 b.p_used)
    assert ck.data_fingerprint(a.data) == jck.data_fingerprint(b.data)


@pytest.mark.parametrize("case", ["inf", "one_observed", "none_observed"])
def test_preprocess_refuses_what_the_jax_package_refuses(case):
    """inf is refused (NaN is a missing value, inf is bad data), and so is
    a column with fewer than 2 observed entries (1 unstandardized), with
    the JAX package's error type and message."""
    Y = _raw_y()
    if case == "inf":
        Y[3, 2] = np.inf
    else:
        Y[: Y.shape[0] - (case == "one_observed"), 6] = np.nan
    for mod in (tpre, jpre):
        for standardize in (True, False):
            if case == "one_observed" and not standardize:
                # one observation anchors an unstandardized column
                assert mod.preprocess(Y, 4, standardize=False).n_missing
                continue
            with pytest.raises(ValueError) as e:
                mod.preprocess(Y, 4, standardize=standardize)
            want = ("infinite entries" if case == "inf"
                    else "observed entries")
            assert want in str(e.value)


@pytest.mark.parametrize("destandardize", [True, False])
def test_restore_data_matrix_is_bitwise_jax(destandardize):
    Y = _raw_y()
    a = tpre.preprocess(Y, 4, seed=1)
    b = jpre.preprocess(Y, 4, seed=1)
    shard = np.random.default_rng(0).standard_normal(
        a.data.shape).astype(np.float32)
    out = tpre.restore_data_matrix(shard, a, destandardize=destandardize)
    ref = jpre.restore_data_matrix(shard, b, destandardize=destandardize)
    assert out.dtype == ref.dtype and out.tobytes() == ref.tobytes()
    # the inverse of preprocess at the observed entries, zero at the
    # dropped column
    back = tpre.restore_data_matrix(np.nan_to_num(a.data), a)
    obs = ~np.isnan(Y)
    np.testing.assert_allclose(back[obs], Y[obs], rtol=1e-5, atol=1e-5)
    assert (back[:, 4] == 0).all()


@pytest.mark.parametrize("upload_dtype,standardize", [
    ("float32", True), ("float32", False), ("bfloat16", True),
    ("bfloat16", False), ("float16", True)])
def test_nan_survives_every_upload_dtype(upload_dtype, standardize):
    """The missing entries reach the sweep as NaN under every link dtype
    (float16 runs only under standardize), and nothing else becomes NaN."""
    pre = tpre.preprocess(_raw_y(), 4, standardize=standardize)
    up = fetch.upload_host_array(pre.data, upload_dtype).float().numpy()
    np.testing.assert_array_equal(np.isnan(up), np.isnan(pre.data))


# ---- one imputing sweep on the JAX package's draws ---------------------------

G, N, P, K = 3, 24, 10, 4


@functools.lru_cache(maxsize=None)
def _case(compute_dtype: str):
    """(Y with NaN, JAX model config, the JAX imputation + sweep jitted as
    run_chunk's body runs them, the state after 6 complete-data sweeps)."""
    rng = np.random.default_rng(11)
    L = rng.standard_normal((G * P, 2)) / 2
    Yraw = (rng.standard_normal((N, 2)) @ L.T
            + 0.3 * rng.standard_normal((N, G * P))).astype(np.float32)
    Y = jpre.preprocess(Yraw, G, seed=0).data
    Ym = jpre.preprocess(_mcar(Yraw, 0.2, seed=4)[0], G, seed=0).data
    kern = "pallas-interpret" if compute_dtype == "f32" else "auto"
    cfg = JModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                       sse_mode="gram", lambda_kernel=kern,
                       compute_dtype=compute_dtype, impute_missing=True)
    prior = jmake_prior(cfg)

    def body(k, y, s):
        with jax.default_matmul_precision("highest"):
            yc = jcond.impute_missing_y(k, y, s, cfg.rho)
            new, sse = jcond.gibbs_sweep(k, yc, s, cfg, prior)
        return yc, new, sse

    sweep = jax.jit(lambda k, y, s: jcond.gibbs_sweep(k, y, s, cfg, prior))
    state = jstate.init_state(jax.random.key(1), prior, num_local_shards=G,
                              n=N, P=P, K=K, as_=cfg.as_, bs=cfg.bs)
    for i in range(6):
        state, _ = sweep(jax.random.key(100 + i), jnp.asarray(Y), state)
    s0 = {"Lambda": np.asarray(state.Lambda), "Z": np.asarray(state.Z),
          "X": np.asarray(state.X), "ps": np.asarray(state.ps),
          "prior": {k: np.asarray(v) for k, v in state.prior.items()}}
    return Ym, cfg, jax.jit(body), s0


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_one_imputing_sweep_matches_jax_leaf_by_leaf(compute_dtype):
    """The completed matrix and every leaf of the sweep that reads it,
    from the same state on JAX's draws: the imputation normals are site
    7's, one block per shard (JaxNoise's per-shard fold, part None)."""
    Ym, jcfg, jbody, s0 = _case(compute_dtype)
    key = jax.random.key(7)
    js = jstate.SamplerState(
        **{k: jnp.asarray(s0[k]) for k in ("Lambda", "Z", "X", "ps")},
        prior={k: jnp.asarray(v) for k, v in s0["prior"].items()})
    jyc, jnew, jsse = jbody(key, jnp.asarray(Ym), js)
    cfg = ModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                      sse_mode="gram", impute_missing=True,
                      compute_dtype=compute_dtype,
                      lambda_kernel=("pallas" if compute_dtype == "f32"
                                     else "auto"))
    st = state_from_numpy(s0, "cpu")
    draws = JaxNoise(key, G)
    yc = tcond.impute_missing_y(draws, torch.as_tensor(Ym), st, cfg.rho)
    ts, tsse = tcond.gibbs_sweep(draws, yc, st, cfg, make_prior(cfg))
    t = state_to_numpy(ts)
    miss = np.isnan(Ym)
    # observed entries pass through untouched, bit for bit
    np.testing.assert_array_equal(yc.numpy()[~miss], Ym[~miss])
    assert np.isfinite(yc.numpy()).all()
    pairs = [("Yc", yc.numpy(), np.asarray(jyc)), ("sse", tsse.numpy(),
                                                   np.asarray(jsse))]
    pairs += [(k, t[k], np.asarray(getattr(jnew, k)))
              for k in ("Z", "X", "Lambda", "ps")]
    pairs += [(k, t["prior"][k], np.asarray(jnew.prior[k]))
              for k in ("psijh", "delta")]
    # tests/test_torch_sweep.py's bounds for the sweep (1e-4 of the leaf's
    # scale in float32, 1e-3 under bf16's input roundings); the imputation
    # itself is one float32 product and an elementwise draw, run in full
    # float32 under both dtypes - its entries agree to float32 rounding
    tol = 1e-4 if compute_dtype == "f32" else 1e-3
    for leaf, a, b in pairs:
        np.testing.assert_allclose(
            a, b, rtol=0, atol=(1e-5 if leaf == "Yc" else tol)
            * float(np.max(np.abs(b))), err_msg=leaf)


def test_imputation_runs_in_float32_under_bf16():
    """The completed matrix is the same bits under compute_dtype "bf16"
    and "f32": the imputation never takes the bf16 products."""
    Ym, _, _, s0 = _case("f32")
    key = jax.random.key(9)
    out = [tcond.impute_missing_y(JaxNoise(key, G), torch.as_tensor(Ym),
                                  state_from_numpy(s0, "cpu"), 0.8)
           for _ in ("f32", "bf16")]
    assert torch.equal(out[0], out[1])


# ---- whole fits ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _twin():
    Y, St = make_synthetic(120, 48, 3, seed=51)
    Ym, mask = _mcar(Y, 0.15, seed=1)
    return Y, St, Ym, mask


def _twin_cfg(pkg, **run):
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8),
        run=pkg.RunConfig(**({"burnin": 200, "mcmc": 200, "thin": 2,
                              "seed": 0, "num_chains": 2} | run)),
        backend=pkg.BackendConfig(sse_mode="gram"))


def _rmse(Yi, Y, mask):
    return float(np.sqrt(np.mean((Yi[mask] - Y[mask]) ** 2)))


def test_missing_data_fit_agrees_with_jax():
    """15% MCAR: the port's fit and the JAX package's (different random
    streams, the same model) within the Monte Carlo band, for Sigma and
    for the imputation's RMSE at the missing entries; both far below the
    column-mean imputation's RMSE; observed entries the caller's bits."""
    Y, St, Ym, mask = _twin()
    res = dt.fit(Ym, _twin_cfg(dt), device="cpu")
    ref = dcfm_tpu.fit(Ym, _twin_cfg(dcfm_tpu))
    assert res.preprocess.n_missing == int(mask.sum())
    assert res.stats.nonfinite_count == 0 and np.isfinite(res.Sigma).all()
    assert res.config.model.impute_missing is False   # the caller's config
    np.testing.assert_array_equal(res.Y_imputed[~mask], Ym[~mask])
    # Sigma of the two packages: the twin band of tests/test_torch_fit.py.
    # Measured at seeds 0 and 1: 0.0055 apart, the errors against the
    # truth 0.0008-0.0017 apart, the imputation RMSEs 0.2-0.4% apart;
    # either package's fits of the two seeds differ by 0.0126
    rel = np.linalg.norm(res.Sigma - ref.Sigma) / np.linalg.norm(ref.Sigma)
    assert rel < 0.05, rel
    e_t = np.linalg.norm(res.Sigma - St) / np.linalg.norm(St)
    e_j = np.linalg.norm(ref.Sigma - St) / np.linalg.norm(St)
    assert abs(e_t - e_j) < 0.02, (e_t, e_j)
    r_t, r_j = _rmse(res.Y_imputed, Y, mask), _rmse(ref.Y_imputed, Y, mask)
    col_mean = np.where(mask, np.nanmean(Ym, axis=0), Ym)
    base = _rmse(col_mean, Y, mask)
    assert r_t < 0.8 * base and r_j < 0.8 * base, (r_t, r_j, base)
    assert abs(r_t - r_j) < 0.1 * r_j, (r_t, r_j)


def test_complete_data_fits_are_unchanged_by_the_knob():
    """A complete-data fit draws no imputation normals: a forced
    impute_missing=True leaves the chain bitwise (Sigma, traces) and
    Y_imputed None, as the JAX package leaves it."""
    Y = _twin()[0]
    cfg = _twin_cfg(dt, burnin=20, mcmc=20)
    plain = dt.fit(Y, cfg, device="cpu")
    forced = dt.fit(Y, dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, impute_missing=True)), device="cpu")
    np.testing.assert_array_equal(forced.Sigma, plain.Sigma)
    np.testing.assert_array_equal(forced.traces, plain.traces)
    assert forced.Y_imputed is None and plain.Y_imputed is None


# ---- checkpoints -----------------------------------------------------------

SMALL_N, SMALL_P, SG, SK = 40, 24, 2, 3


@functools.lru_cache(maxsize=None)
def _small():
    Y, _ = make_synthetic(SMALL_N, SMALL_P, 2, seed=3)
    return _mcar(Y, 0.15, seed=6)[0]


def _small_cfg(pkg, C=2, **kw):
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=SG, factors_per_shard=SK, rho=0.6),
        run=pkg.RunConfig(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
                          chunk_size=4),
        backend=pkg.BackendConfig(sse_mode="gram"), **kw)


def _jax_template(C):
    m = dcfm_tpu.ModelConfig(num_shards=SG, factors_per_shard=SK, rho=0.6,
                             impute_missing=True)
    init_fn = dcfm_tpu.api._local_fns(m, 4, C)[0]
    P = tpre.preprocess(_small(), SG, seed=0).data.shape[2]
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((SG, SMALL_N, P), np.float32))


def _template(C):
    m = ModelConfig(num_shards=SG, factors_per_shard=SK, rho=0.6,
                    impute_missing=True)
    P = tpre.preprocess(_small(), SG, seed=0).data.shape[2]
    return ck.carry_template(m, n=SMALL_N, P=P, num_chains=C)


@pytest.mark.parametrize("C", [1, 2])
def test_jax_package_reads_the_imputation_leaf(tmp_path, C):
    """A port file of a missing-data fit: the JAX package's
    load_checkpoint reads every leaf, y_imp_acc last, byte for byte."""
    path = str(tmp_path / "m.npz")
    res = dt.fit(_small(), _small_cfg(dt, C, checkpoint_path=path),
                 device="cpu")
    assert res.Y_imputed is not None
    leaves, meta = ck.load_checkpoint(path, _template(C))
    assert list(leaves)[-1] == "y_imp_acc"
    assert meta["acc_leaf_indices"] == [
        i for i, k in enumerate(leaves) if k in ck.ACC_LEAVES]
    jcarry, _ = jck.load_checkpoint(path, _jax_template(C))
    got = jax.tree.leaves(jcarry)
    assert len(got) == len(leaves)
    for (name, a), b in zip(leaves.items(), got, strict=True):
        assert a.dtype == np.asarray(b).dtype, name
        assert a.tobytes() == np.asarray(b).tobytes(), name
    np.testing.assert_array_equal(np.asarray(jcarry.y_imp_acc),
                                  leaves["y_imp_acc"])


def test_an_elastic_shrink_folds_the_imputation_sum_as_jax(tmp_path):
    """2 -> 1 chains: y_imp_acc folds as a[0] + a[1:].sum(0), bitwise the
    JAX package's load_checkpoint_elastic; the resumed fit's Y_imputed
    divides by every draw the pooled sums hold."""
    path = str(tmp_path / "e.npz")
    dt.fit(_small(), _small_cfg(dt, 2, checkpoint_path=path), device="cpu")
    leaves, _, info = ck.load_checkpoint_elastic(path, _template(1), 1)
    jcarry, _, jinfo = jck.load_checkpoint_elastic(path, _jax_template(1), 1)
    assert info["fold_draws"] == jinfo["fold_draws"] == 4
    assert (leaves["y_imp_acc"].tobytes()
            == np.asarray(jcarry.y_imp_acc).tobytes())
    raw, _ = ck.load_checkpoint(path, _template(2))
    a = raw["y_imp_acc"]
    np.testing.assert_array_equal(leaves["y_imp_acc"], a[0] + a[1:].sum(0))
    res = dt.fit(_small(), dataclasses.replace(
        _small_cfg(dt, 1, checkpoint_path=path, resume=True),
        run=dataclasses.replace(_small_cfg(dt, 1).run, mcmc=12)),
        device="cpu")
    assert res.elastic_resume["fold_draws"] == 4
    # chain 0's 6 draws of (6, 18] and the 4 folded ones: the divisor
    assert fetch.elastic_pooled_draws(18, 6, 2, [0], 4) == 10
    miss = np.isnan(_small())
    assert np.isfinite(res.Y_imputed).all()
    np.testing.assert_array_equal(res.Y_imputed[~miss], _small()[~miss])


@pytest.mark.parametrize("mode", ["full", "light"])
def test_a_killed_missing_data_fit_resumes_bitwise(tmp_path, monkeypatch,
                                                   mode):
    """Killed after its second save (iteration 8 of 14) and resumed:
    Sigma, Y_imputed and every leaf of the carry (y_imp_acc included) are
    the uninterrupted fit's bits.  A light file drops y_imp_acc and the
    resume restarts it with the covariance sums at the file's iteration,
    as the JAX package does."""
    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", _SyncWriter)
    cfg = _small_cfg(dt, 2, checkpoint_path=str(tmp_path / "k.npz"),
                     checkpoint_every_chunks=1, checkpoint_mode=mode)
    carries = []
    real = pipeline.run_chain

    def keep(**kw):
        rr = real(**kw)
        carries.append([sampler.carry_tensors(c) for c in rr.carries])
        return rr

    monkeypatch.setattr(dt.api, "run_chain", keep)
    ref = dt.fit(_small(), dataclasses.replace(cfg, checkpoint_path=None),
                 device="cpu")
    _SyncWriter.kill_after, _SyncWriter.saves = 2, []
    with pytest.raises(_Killed):
        dt.fit(_small(), cfg, device="cpu")
    _SyncWriter.kill_after = None
    assert _SyncWriter.saves[-1][1] == 8
    res = dt.fit(_small(), dataclasses.replace(cfg, resume=True),
                 device="cpu")
    assert len(carries) == 2
    # full: every leaf; light: the chain is the same chain (the state
    # leaves), its sums restarted at iteration 8
    n = (None if mode == "full"
         else len(ck.state_leaf_names(cfg.model)))
    for a, b in zip(carries[1], carries[0], strict=True):
        assert len(a) == len(b)
        for x, y in zip(a[:n], b[:n], strict=True):
            assert torch.equal(x, y)
    miss = np.isnan(_small())
    np.testing.assert_array_equal(res.Y_imputed[~miss], _small()[~miss])
    if mode == "full":
        np.testing.assert_array_equal(res.Sigma, ref.Sigma)
        np.testing.assert_array_equal(res.Y_imputed, ref.Y_imputed)
    else:
        assert np.isfinite(res.Y_imputed).all()
        assert not np.array_equal(res.Y_imputed, ref.Y_imputed)
