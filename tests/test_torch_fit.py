"""Whole fits of the PyTorch port on the CPU: against the NumPy twin
(``reference_numpy.gibbs_numpy``), against the truth, against the JAX
package's ``fit``, and the reference-shaped ``divideconquer`` - at the
shapes and bands of ``tests/test_e2e.py``.  Plus what the port promises
about itself: chunking never changes the chain, knobs outside the port
are refused, TF32 matmuls are refused, and no module imports JAX or the
JAX package.
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu  # noqa: E402
import dcfm_tpu_torch  # noqa: E402
from dcfm_tpu.reference_numpy import gibbs_numpy  # noqa: E402
from dcfm_tpu.utils.estimate import stitch_blocks  # noqa: E402
from dcfm_tpu.utils.preprocess import preprocess  # noqa: E402
from dcfm_tpu_torch import (  # noqa: E402
    BackendConfig, FitConfig, ModelConfig, RunConfig, divideconquer, fit)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Fits at these sizes are launch-bound; one intra-op thread per test
    worker keeps the parallel test run from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_frob(A, B):
    return np.linalg.norm(A - B) / np.linalg.norm(B)


# test_e2e.py's twin-parity shape: n=120, p=48, g=2, K=3, rho=0.7, 400+400
TWIN = dict(g=2, K=3, rho=0.7, burnin=400, mcmc=400)


@functools.lru_cache(maxsize=None)
def _twin_data():
    Y, _ = make_synthetic(120, 48, 3, seed=5)
    pre = preprocess(Y, TWIN["g"], seed=0)
    blocks_np, _ = gibbs_numpy(pre.data.astype(np.float64), TWIN["K"],
                               TWIN["rho"], TWIN["burnin"], TWIN["mcmc"],
                               seed=1)
    return Y, stitch_blocks(blocks_np)


def _twin_cfg(sse_mode="resid"):
    return FitConfig(
        model=ModelConfig(num_shards=TWIN["g"], factors_per_shard=TWIN["K"],
                          rho=TWIN["rho"]),
        run=RunConfig(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"], seed=0),
        backend=BackendConfig(sse_mode=sse_mode))


@functools.lru_cache(maxsize=None)
def _port_twin_fit(sse_mode):
    Y, _ = _twin_data()
    return fit(Y, _twin_cfg(sse_mode), device="cpu")


@pytest.mark.parametrize("sse_mode", ["resid", "gram"])
def test_parity_with_numpy_twin(sse_mode):
    """The port and the independent NumPy twin agree statistically on the
    posterior-mean covariance (test_e2e's band for the JAX package)."""
    _, S_np = _twin_data()
    res = _port_twin_fit(sse_mode)
    S_pt = stitch_blocks(res.sigma_blocks.astype(np.float64))
    assert _rel_frob(S_pt, S_np) < 0.05
    assert res.kernel_launches == {                              # CPU
        "chol_sample": 0, "chol_solve_sample": 0, "cho_solve": 0,
        "lam_update": 0, "sse_ps": 0, "combine_panels": 0}


def test_parity_with_jax_fit():
    """The port's fit and the JAX package's fit of the same data and
    config agree statistically (different RNG streams, same model); the
    JAX fit runs the slice's kernels in interpret mode."""
    Y, _ = _twin_data()
    cfg = _twin_cfg("gram")
    jcfg = dcfm_tpu.FitConfig(
        model=dcfm_tpu.ModelConfig(num_shards=TWIN["g"],
                                   factors_per_shard=TWIN["K"],
                                   rho=TWIN["rho"], lambda_kernel="pallas"),
        run=dcfm_tpu.RunConfig(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"],
                               seed=0),
        backend=dcfm_tpu.BackendConfig(sse_mode="gram"))
    S_jx = dcfm_tpu.fit(Y, jcfg).Sigma
    S_pt = _port_twin_fit(cfg.backend.sse_mode).Sigma
    assert _rel_frob(S_pt, S_jx) < 0.05


def test_multishard_recovers_sigma():
    """test_e2e's truth-recovery shape and bands (2 pooled chains)."""
    Y, St = make_synthetic(150, 96, 4, seed=3)
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.95,
                          lambda_kernel="pallas"),
        run=RunConfig(burnin=300, mcmc=300, thin=2, seed=0, num_chains=2),
        backend=BackendConfig(sse_mode="auto"))
    res = fit(Y, cfg, device="cpu")
    assert _rel_frob(res.Sigma, St) < 0.25
    assert _rel_frob(np.diag(np.diag(res.Sigma)), np.diag(np.diag(St))) < 0.15
    assert res.stats.nonfinite_count == 0 and res.stats.acc_nonfinite == 0
    assert res.stats.ps_min > 0 and np.isfinite(res.stats.tau_log_max)
    assert res.traces.shape == (2, 600, 4) and np.isfinite(res.traces).all()
    ph = res.phase_seconds
    assert set(ph) == {"preprocess_s", "upload_s", "init_s", "chain_s",
                       "fetch_s", "exposed_fetch_s", "assemble_s",
                       "checkpoint_s"}
    assert ph["checkpoint_s"] == 0.0
    # fault C2: the JAX package's meanings - one state with a leading
    # chain axis, rates of the executed iterations counted once (not once
    # per chain) over the fit's seconds and over chain_s, chunk walls,
    # split-R-hat and ESS of every trace summary
    assert res.state.Lambda.shape == (2, 4, 24, 4)
    assert res.state.prior["delta"].shape[0] == 2
    assert res.iters_per_sec == pytest.approx(600 / res.seconds)
    assert res.chain_iters_per_sec == pytest.approx(600 / ph["chain_s"])
    assert len(res.chunk_seconds) == 1
    assert sum(res.chunk_seconds) == pytest.approx(ph["chain_s"])
    assert ph["exposed_fetch_s"] == ph["fetch_s"]
    assert set(res.diagnostics["rhat"]) == set(res.diagnostics["ess"]) == {
        "signal_var_mean", "resid_var_mean", "sigma_diag_mean", "avg_loglik"}
    assert all(np.isfinite(v) for v in res.diagnostics["ess"].values())


def test_divideconquer_compat_entrypoint():
    """Reference-shaped API (divideconquer.m:1): 7 positional args."""
    Y, St = make_synthetic(100, 40, 3, seed=9)
    S = divideconquer(Y, 2, 6, 100, 100, 1, 0.8, seed=0, device="cpu")
    assert S.shape == (40, 40)
    np.testing.assert_allclose(S, S.T, atol=1e-5)
    assert _rel_frob(S, St) < 1.0
    with pytest.raises(ValueError, match="divisible"):
        divideconquer(Y, 3, 7, 10, 10, 1, 0.8, device="cpu")


def test_zero_columns_reinserted_and_chunking_changes_nothing():
    """Sigma is (p, p) with zero rows/cols at all-zero input columns, and a
    chunked run is the same chain (draws keyed on the global iteration)."""
    Y, _ = make_synthetic(60, 20, 2, seed=13)
    Y[:, 5] = 0.0
    m = ModelConfig(num_shards=2, factors_per_shard=2, rho=0.5)
    one = fit(Y, FitConfig(model=m, run=RunConfig(burnin=20, mcmc=20)),
              device="cpu")
    chunked = fit(Y, FitConfig(model=m, run=RunConfig(burnin=20, mcmc=20,
                                                      chunk_size=7)),
                  device="cpu")
    assert one.Sigma.shape == (20, 20)
    assert np.all(one.Sigma[5, :] == 0) and np.all(one.Sigma[:, 5] == 0)
    assert one.Sigma[6, 6] > 0
    np.testing.assert_array_equal(one.Sigma, chunked.Sigma)
    np.testing.assert_array_equal(one.traces, chunked.traces)


def test_plain_estimator_twin_parity():
    """The reference's plain combine rule against the twin running the same
    rule, at the shape and band of test_reference_semantics.py: the plain
    rule is not invariant to the slow-mixing Lambda <-> eta scale ridge,
    so four pooled chains and the JAX package's own 0.15 band."""
    Y, _ = make_synthetic(120, 48, 3, seed=61)
    pre = preprocess(Y, TWIN["g"], seed=0)
    blocks_np, _ = gibbs_numpy(pre.data.astype(np.float64), TWIN["K"],
                               TWIN["rho"], TWIN["burnin"], TWIN["mcmc"],
                               seed=1, estimator="plain")
    cfg = FitConfig(
        model=ModelConfig(num_shards=TWIN["g"], factors_per_shard=TWIN["K"],
                          rho=TWIN["rho"], estimator="plain"),
        run=RunConfig(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"], seed=0,
                      num_chains=4))
    res = fit(Y, cfg, device="cpu")
    S_pt = stitch_blocks(res.sigma_blocks.astype(np.float64))
    assert _rel_frob(S_pt, stitch_blocks(blocks_np)) < 0.15


@pytest.mark.parametrize("bad", [
    RunConfig(burnin=5, mcmc=5, thin=0), RunConfig(burnin=-1, mcmc=5),
    RunConfig(burnin=0, mcmc=0), RunConfig(burnin=5, mcmc=5, thin=2)])
def test_run_config_validation(bad):
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    m = ModelConfig(num_shards=2, factors_per_shard=2, rho=0.5)
    with pytest.raises(ValueError):
        fit(Y, FitConfig(model=m, run=bad), device="cpu")


def _queue_a_items() -> set:
    """The item numbers ROADMAP.md's Queue A lists."""
    with open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8") as f:
        text = f.read()
    section = text.split("### Queue A", 1)[1].split("\n### ", 1)[0]
    return {int(n) for n in re.findall(r"^(\d+)\. \*\*", section, re.M)}


def _names_a_queue_a_item(message: str) -> bool:
    m = re.search(r"ROADMAP Queue A item (\d+)", message)
    return bool(m) and int(m.group(1)) in _queue_a_items()


# the refusals: the fetch and upload dtypes (now ported) gave their places
# to missing values and the DL prior, resume without a checkpoint (now a
# ValueError); posterior_sd, stream_artifact and the adoption of a
# checkpoint of another chain count (elastic) are ported and dropped out,
# and so are the horseshoe and DL priors and rank_adapt
# (test_ported_scenario_knobs_fit below fits them).  store_draws,
# early_stop, impute_missing and combine_chunks are ported too, and so is
# warm_start: their cases pair each with a knob still refused, which is
# refused naming its own item - a ported knob never masks a refusal (their
# invalid values are test_scenario_knob_values_are_refused_as_in_the_jax_
# package's and test_invalid_values_are_value_errors_in_both_packages's)
#
# The shard mesh (mesh_devices > 1) is ported too, with the forced
# streamed fetch, warm starts and elastic grows on it, and so is the
# multi-process layer (item 7): a ``.procK-of-N`` set is a resume source
# now, and each case pairs its ported knobs with a resume beside an
# INCOMPLETE set - no source, as in the JAX package's discovery, so
# resume=True raises its FileNotFoundError (on the mesh in every rank)
_ON_MESH = {"mesh_devices": 2, "fetch_dtype": "quant8", "fetch_stream": "on"}


@pytest.mark.parametrize("model,run,backend,extra", [
    ({"combine_chunks": 2}, {}, _ON_MESH, {}),
    ({}, {"store_draws": True}, _ON_MESH, {}),
    ({}, {"early_stop": "rhat", "num_chains": 2, "chunk_size": 1},
     _ON_MESH, {}),
    ({"impute_missing": True, "combine_chunks": 2}, {}, _ON_MESH, {}),
    ({}, {}, _ON_MESH, {}),
    ({"prior": "horseshoe"}, {}, {"mesh_devices": 2},
     {"warm_start": dcfm_tpu_torch.config.WarmStart("w.npz")}),
])
def test_knobs_outside_the_port_are_refused(tmp_path, model, run, backend,
                                            extra):
    """No knob is refused any more: each case's knobs reach the resume,
    where an incomplete ``.procK-of-N`` set (one member of two) is no
    source (utils/checkpoint.find_multiprocess_checkpoint, the JAX
    package's rule) and resume=True raises the JAX package's
    FileNotFoundError."""
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    path = str(tmp_path / "ck.npz")
    open(path + ".proc0-of-2", "wb").close()
    cfg = FitConfig(
        model=ModelConfig(num_shards=2, factors_per_shard=2, rho=0.5,
                          **model),
        run=RunConfig(burnin=2, mcmc=2, **run),
        backend=BackendConfig(**backend), checkpoint_path=path,
        resume=True, **extra)
    with pytest.raises(FileNotFoundError,
                       match=r"no checkpoint at .*\(or any \.procK-of-N "
                             r"set\)") as e:
        fit(Y, cfg, device="cpu")
    assert "ROADMAP" not in str(e.value)


# the JAX package's refusals of the scenario knobs the port now runs
@pytest.mark.parametrize("run,match", [
    ({"early_stop": "rhat", "chunk_size": 2}, "num_chains >= 2"),
    ({"early_stop": "rhat", "num_chains": 2}, "chunk_size >= 1"),
    ({"early_stop": "rhat", "num_chains": 2, "chunk_size": 2,
      "store_draws": True}, "incompatible with store_draws"),
    ({"early_stop": "rhat", "num_chains": 2, "chunk_size": 2,
      "rhat_threshold": 1.0}, "rhat_threshold must be > 1.0"),
    ({"early_stop": "rhat", "num_chains": 2, "chunk_size": 2,
      "ess_target": 0.0}, "ess_target must be > 0"),
    ({"early_stop": "rhat", "num_chains": 2, "chunk_size": 2,
      "rhat_threshold": float("nan")}, "rhat_threshold must be > 1.0")])
def test_scenario_knob_values_are_refused_as_in_the_jax_package(run, match):
    """Each a ValueError in both packages, saying the same thing."""
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    run = {"burnin": 2, "mcmc": 2} | run
    for pkg, kw in ((dcfm_tpu, {}), (dcfm_tpu_torch, {"device": "cpu"})):
        cfg = pkg.FitConfig(
            model=pkg.ModelConfig(num_shards=2, factors_per_shard=2,
                                  rho=0.5),
            run=pkg.RunConfig(**run))
        with pytest.raises(ValueError, match=match):
            pkg.fit(Y, cfg, **kw)


@pytest.mark.parametrize("model", [
    {"prior": "horseshoe"}, {"rank_adapt": True}, {"prior": "dl"},
    {"prior": "dl", "rank_adapt": True}])
def test_ported_scenario_knobs_fit(model):
    """The knobs the refusal test above no longer lists: the horseshoe
    and DL priors and adaptive rank truncation (with MGP and with DL) fit
    to a finite, symmetric Sigma with the effective-rank statistics."""
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    cfg = FitConfig(
        model=ModelConfig(num_shards=2, factors_per_shard=2, rho=0.5,
                          **model),
        run=RunConfig(burnin=6, mcmc=6, num_chains=2))
    res = fit(Y, cfg, device="cpu")
    assert np.isfinite(res.Sigma).all()
    np.testing.assert_array_equal(res.Sigma, res.Sigma.T)
    assert res.stats.nonfinite_count == 0
    assert 1 <= res.stats.rank_min <= res.stats.rank_mean \
        <= res.stats.rank_max <= 2
    if model.get("rank_adapt"):
        assert res.state.active.shape == (2, 2, 2)
    else:
        assert res.state.active is None
        assert res.stats.rank_min == res.stats.rank_max == 2


def _refusal_messages() -> list:
    """Every message of the package that cites the ROADMAP: the string
    constants (and f-string parts) of its sources that mention it,
    docstrings aside, and the rule registry of analysis/rules.py aside:
    its shared summaries are the JAX package's registry word for word
    (and may cite the JAX package's own history), and none is a
    refusal."""
    import ast
    import dcfm_tpu_torch
    root = os.path.dirname(dcfm_tpu_torch.__file__)
    registry = os.path.join(root, "analysis", "rules.py")
    found = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if (name.endswith(".py")
                    and os.path.join(dirpath, name) != registry):
                with open(os.path.join(dirpath, name)) as f:
                    tree = ast.parse(f.read())
                docs = {id(n.value) for n in ast.walk(tree)
                        if isinstance(n, ast.Expr)}
                found += [(name, node.value) for node in ast.walk(tree)
                          if isinstance(node, ast.Constant)
                          and isinstance(node.value, str)
                          and "ROADMAP" in node.value
                          and id(node) not in docs]
    return found


def test_every_refusal_names_a_queue_a_item():
    """Fault C1: refusals cited "'Still to port' item 8", which the ROADMAP
    never numbered.  Every ROADMAP citation in the package names a Queue A
    item the ROADMAP lists.  Item 7's last refusals (the multi-process
    layers) are ported, and items 4, 5 and 6 before them, so no refusal
    cites an item any more; ``lint`` / ``test-isolated`` (item 8, the last)
    run the port's own analysis (tests/test_torch_cli.py)."""
    cited = [(f, m) for f, m in _refusal_messages()
             if re.search(r"item \d", m)]
    assert {int(re.search(r"item (\d+)", m).group(1))
            for _, m in cited} == set()
    for name, message in cited:
        assert _names_a_queue_a_item(message), (name, message)


# fault C3: invalid values of knobs the port refuses are the JAX package's
# ValueErrors, not "not ported yet"
@pytest.mark.parametrize("model,run,backend,extra", [
    ({"prior": "bogus"}, {}, {}, {}),
    ({}, {"early_stop": "bogus"}, {}, {}),
    ({}, {"store_draws": True, "mcmc": 0}, {}, {}),
    ({}, {}, {"upload_dtype": "bogus"}, {}),
    ({"combine_chunks": 0}, {}, {}, {}),
    ({"combine_chunks": 3}, {}, {}, {}),
    ({}, {}, {}, {"resume": True}),
    ({}, {}, {"fetch_stream": "on"}, {}),
    ({}, {}, {"fetch_dtype": "float16"}, {"standardize": False}),
    ({}, {}, {"upload_dtype": "float16"}, {"standardize": False}),
    ({}, {}, {}, {"materialize_sigma": "bogus"}),
])
def test_invalid_values_are_value_errors_in_both_packages(model, run,
                                                          backend, extra):
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    run = {"burnin": 2, "mcmc": 2} | run
    errors = []
    for pkg, kw in ((dcfm_tpu, {}), (dcfm_tpu_torch, {"device": "cpu"})):
        cfg = pkg.FitConfig(
            model=pkg.ModelConfig(num_shards=2, factors_per_shard=2,
                                  rho=0.5, **model),
            run=pkg.RunConfig(**run), backend=pkg.BackendConfig(**backend),
            **extra)
        with pytest.raises(Exception) as e:
            pkg.fit(Y, cfg, **kw)
        errors.append(type(e.value))
    assert errors == [ValueError, ValueError]


@pytest.mark.parametrize("kind", ["memmap", "scipy", "sparsematrix",
                                  "triple"])
def test_streaming_inputs_fit_as_their_dense_twin(kind, tmp_path):
    """np.memmap, scipy sparse matrices and the port's SparseMatrix (the
    streaming inputs of the JAX package) fit with panels bitwise the dense
    fit's (fault C4 was their refusal before np.asarray mangled them; the
    ingest is ported).  A bare object with indptr/indices/data/shape is no
    streaming input in the JAX package: both packages raise its
    ValueError."""
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    cfg = FitConfig(model=ModelConfig(num_shards=2, factors_per_shard=2,
                                      rho=0.5),
                    run=RunConfig(burnin=2, mcmc=2))
    if kind == "triple":
        import types
        Y = types.SimpleNamespace(indptr=np.zeros(31, np.int64),
                                  indices=np.zeros(0, np.int64),
                                  data=np.zeros(0, np.float32),
                                  shape=(30, 8))
        messages = []
        for pkg, kw in ((dcfm_tpu, {}), (dcfm_tpu_torch, {"device": "cpu"})):
            with pytest.raises(ValueError) as e:
                pkg.fit(Y, pkg.FitConfig(
                    model=pkg.ModelConfig(num_shards=2, factors_per_shard=2,
                                          rho=0.5),
                    run=pkg.RunConfig(burnin=2, mcmc=2)), **kw)
            messages.append(str(e.value))
        assert messages[0] == messages[1]
        return
    if kind == "memmap":
        path = str(tmp_path / "Y.npy")
        np.save(path, Y)
        inp = np.load(path, mmap_mode="r")
    elif kind == "scipy":
        sparse = pytest.importorskip("scipy.sparse")
        inp = sparse.csr_matrix(Y)
    else:
        from dcfm_tpu_torch.utils.preprocess import SparseMatrix
        rows, cols = np.nonzero(Y)
        indptr = np.zeros(31, np.int64)
        np.cumsum(np.bincount(rows, minlength=30), out=indptr[1:])
        inp = SparseMatrix(indptr, cols, Y[rows, cols], Y.shape)
    res = fit(inp, cfg, device="cpu")
    ref = fit(Y, cfg, device="cpu")
    assert res.preprocess.is_lazy and res.Sigma is None
    np.testing.assert_array_equal(res.upper_panels, ref.upper_panels)


@pytest.mark.parametrize("model,match", [
    ({"combine_dtype": "float16"}, "combine_dtype"),
    ({"lambda_kernel": "pallas-fused", "factors_per_shard": 17}, "<= 16"),
    ({"lambda_kernel": "pallas", "factors_per_shard": 17}, "<= 16")])
def test_model_config_validation(model, match):
    """The JAX package's checks on the knobs the port now runs: an unknown
    combine_dtype, and K > 16 under either Pallas-named Lambda kernel."""
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    m = dict(num_shards=2, factors_per_shard=2, rho=0.5) | model
    with pytest.raises(ValueError, match=match):
        fit(Y, FitConfig(model=ModelConfig(**m),
                         run=RunConfig(burnin=2, mcmc=2)), device="cpu")


def test_missing_values_are_refused():
    """NaN is a missing value the fit imputes (tests/test_torch_missing.py);
    what the JAX package refuses of missing data the port refuses too: a
    column with fewer than 2 observed entries, and inf."""
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    Y[0, 0] = np.nan
    cfg = FitConfig(model=ModelConfig(num_shards=2, factors_per_shard=2,
                                      rho=0.5),
                    run=RunConfig(burnin=2, mcmc=2))
    assert fit(Y, cfg, device="cpu").Y_imputed.shape == Y.shape
    Y[1:, 3] = np.nan
    with pytest.raises(ValueError, match="fewer than 2 observed"):
        fit(Y, cfg, device="cpu")
    Y[1:, 3] = 0.5
    Y[2, 2] = np.inf
    with pytest.raises(ValueError, match="infinite entries"):
        fit(Y, cfg, device="cpu")


def test_tf32_matmuls_are_refused():
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    cfg = FitConfig(model=ModelConfig(num_shards=2, factors_per_shard=2,
                                      rho=0.5),
                    run=RunConfig(burnin=2, mcmc=2))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            fit(Y, cfg, device="cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
REFUSED = ("jax", "jaxlib", "dcfm_tpu", "flax", "scipy")
for name in list(sys.modules):
    if name.split(".")[0] in REFUSED:
        del sys.modules[name]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import dcfm_tpu_torch
mods = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    dcfm_tpu_torch.__path__, "dcfm_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "dcfm_tpu", "scipy")]
assert not bad, bad
print(" ".join(mods))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of dcfm_tpu_torch, and chip_smoke.py, imports with jax,
    dcfm_tpu and scipy refused (scipy sparse inputs are duck-typed, as in
    the JAX package) - the fetch, artifact, checkpoint, resume, pipeline,
    sentinel and preprocess modules among them, the port's own copy of
    the observability package (recorder, metrics, spans, cli), the
    serving plane (engine, batcher, server, fleet, promote, delta,
    loadgen), the fault plan, the supervisor and its child runner, the
    online loop (cycle, watch), the CLI, the shard mesh (parallel/: the
    rank layout, the rank program and its entry) and the pod's
    rendezvous (parallel/multihost)."""
    out = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert len(mods) >= 29
    assert {"dcfm_tpu_torch.native", "dcfm_tpu_torch.runtime.fetch",
            "dcfm_tpu_torch.serve.artifact",
            "dcfm_tpu_torch.utils.diagnostics",
            "dcfm_tpu_torch.utils.checkpoint",
            "dcfm_tpu_torch.runtime.resume",
            "dcfm_tpu_torch.runtime.pipeline",
            "dcfm_tpu_torch.resilience.sentinel",
            "dcfm_tpu_torch.utils.preprocess", "dcfm_tpu_torch.obs",
            "dcfm_tpu_torch.obs.recorder", "dcfm_tpu_torch.obs.metrics",
            "dcfm_tpu_torch.obs.spans", "dcfm_tpu_torch.obs.cli",
            "dcfm_tpu_torch.serve.engine", "dcfm_tpu_torch.serve.batcher",
            "dcfm_tpu_torch.serve.server", "dcfm_tpu_torch.serve.fleet",
            "dcfm_tpu_torch.serve.promote", "dcfm_tpu_torch.serve.delta",
            "dcfm_tpu_torch.serve.loadgen",
            "dcfm_tpu_torch.resilience.faults",
            "dcfm_tpu_torch.resilience.supervisor",
            "dcfm_tpu_torch.resilience._child", "dcfm_tpu_torch.online",
            "dcfm_tpu_torch.online.cycle", "dcfm_tpu_torch.online.watch",
            "dcfm_tpu_torch.cli", "dcfm_tpu_torch.parallel",
            "dcfm_tpu_torch.parallel.mesh", "dcfm_tpu_torch.parallel.shard",
            "dcfm_tpu_torch.parallel._rank",
            "dcfm_tpu_torch.parallel.multihost", "chip_smoke"} <= set(mods)
