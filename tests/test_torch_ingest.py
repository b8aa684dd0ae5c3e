"""Sparse (CSR/CSC, scipy) and out-of-core (np.memmap) ingest in the
PyTorch port, against the JAX package on the CPU.

Each test imports the matching ``dcfm_tpu`` function as its oracle.  The
streaming preprocess is held BITWISE to the JAX package's (perm, kept and
zero columns, ``n_missing``, the stats, every block and ``materialize()``)
and to the port's dense preprocess of the densified input; the lazy
fingerprint to the dense one and to the JAX package's; the lazy upload to
the dense upload.  Fits at ``tests/test_sparse_ingest.py``'s size hold a
streaming fit's panels bitwise to the dense fit's, and a checkpoint of one
resumes the other bitwise.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.serve import artifact as jart  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from dcfm_tpu.utils import estimate as jest  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from tests.test_torch_resume import _SyncWriter  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.runtime import fetch, pipeline  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils import estimate as test  # noqa: E402
from dcfm_tpu_torch.utils import preprocess as tpre  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _toy(seed=0, n=40, p=36, *, nan=True, zero_col=True):
    """tests/test_sparse_ingest.py's data: about 30% exact zeros, two NaN
    entries, one all-zero column."""
    Y = np.random.default_rng(seed).normal(size=(n, p))
    Y[Y < -0.5] = 0.0
    if nan:
        Y[0, 3] = np.nan
        Y[5, 11] = np.nan
    if zero_col:
        Y[:, 7] = 0.0
    return Y


def _csr(Y, pkg=tpre):
    """The CSR triple of ``Y``: NaN stored, zeros implicit."""
    n, p = Y.shape
    keep = (Y != 0) | np.isnan(Y)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    rows, cols = np.nonzero(keep)
    return pkg.SparseMatrix(indptr, cols, Y[rows, cols], (n, p),
                            format="csr")


def _csc(Y, pkg=tpre):
    csr = _csr(Y, pkg)
    indptr, indices, data = pkg._csr_to_csc(csr.indptr, csr.indices,
                                            csr.data, csr.shape)
    return pkg.SparseMatrix(indptr, indices, data, csr.shape, format="csc")


def _memmap(Y, tmp_path, name="Y.npy"):
    path = str(tmp_path / name)
    np.save(path, Y)
    return np.load(path, mmap_mode="r")


def _inputs(kind, Y, tmp_path):
    """(the port's input, the JAX package's input) of one kind."""
    if kind == "csr":
        return _csr(Y), _csr(Y, jpre)
    if kind == "csc":
        return _csc(Y), _csc(Y, jpre)
    if kind.startswith("scipy"):
        sp = pytest.importorskip("scipy.sparse")
        m = (sp.csr_matrix if kind == "scipy_csr" else sp.csc_matrix)(Y)
        return m, m
    mm = _memmap(Y, tmp_path)
    return mm, mm


KINDS = ["csr", "csc", "scipy_csr", "scipy_csc", "memmap"]


def _same_pre(a, b):
    """Two PreprocessResults equal field by field, bit for bit."""
    for f in ("perm", "inv_perm", "kept_cols", "zero_cols", "col_mean",
              "col_scale"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.n_missing, a.n_pad, a.p_original) == (
        b.n_missing, b.n_pad, b.p_original)


@pytest.mark.parametrize("g", [4, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_streaming_preprocess_is_the_jax_packages_bitwise(kind, g,
                                                          tmp_path,
                                                          monkeypatch):
    """perm, kept and zero columns, n_missing, the stats, every block, every
    chunk and materialize(): the JAX package's bytes, and the port's dense
    preprocess of the densified input.  The port walks blocks of shards;
    a block of two shards makes every pass cross block edges (g = 4 pads
    one dummy column, g = 5 none)."""
    monkeypatch.setattr(tpre.LazyShardData, "_CHUNK_ELEMS", 2 * 40 * 9)
    Y = _toy()
    mine, theirs = _inputs(kind, Y, tmp_path)
    assert tpre.is_streaming_input(mine) and jpre.is_streaming_input(theirs)
    a = tpre.preprocess(mine, g, seed=2)
    b = jpre.preprocess(theirs, g, seed=2)
    d = tpre.preprocess(Y, g, seed=2)
    assert a.is_lazy and b.is_lazy and not d.is_lazy
    assert a.data.shards_per_chunk == 2 and a.n_pad == (g == 4)
    _same_pre(a, b)
    _same_pre(a, d)
    assert a.data.shape == b.data.shape == d.data.shape
    assert a.data.dtype == d.data.dtype == np.float32
    for s in range(g):
        assert a.data.block(s).tobytes() == b.data.block(s).tobytes()
    assert a.data.chunk(1, 3).tobytes() == d.data[1:3].tobytes()
    assert a.data.materialize().tobytes() == b.data.materialize().tobytes()
    assert a.data.materialize().tobytes() == d.data.tobytes()
    assert not hasattr(a.data, "__array__")


@pytest.mark.parametrize("kind", ["csr", "memmap"])
def test_streaming_preprocess_without_standardization(kind, tmp_path):
    Y = _toy(nan=False)
    mine, theirs = _inputs(kind, Y, tmp_path)
    a = tpre.preprocess(mine, 4, seed=1, standardize=False, permute=False)
    b = jpre.preprocess(theirs, 4, seed=1, standardize=False, permute=False)
    _same_pre(a, b)
    assert a.data.materialize().tobytes() == b.data.materialize().tobytes()


@pytest.mark.parametrize("obj", ["ndarray", "list", "triple", "memmap",
                                 "sparse", "scipy"])
def test_is_streaming_input_is_the_jax_predicate(obj, tmp_path):
    """The port's predicate is the JAX package's exactly: a bare object
    with indptr/indices/data is not a streaming input."""
    Y = _toy(nan=False)
    cases = {
        "ndarray": (Y, Y), "list": (Y.tolist(), Y.tolist()),
        "triple": (types.SimpleNamespace(indptr=1, indices=2, data=3),) * 2,
        "memmap": (_memmap(Y, tmp_path),) * 2,
        "sparse": (_csr(Y), _csr(Y, jpre)),
    }
    if obj == "scipy":
        sp = pytest.importorskip("scipy.sparse")
        cases["scipy"] = (sp.csr_matrix(Y),) * 2
    mine, theirs = cases[obj]
    assert tpre.is_streaming_input(mine) == jpre.is_streaming_input(theirs)
    assert tpre.is_streaming_input(mine) == (obj in ("memmap", "sparse",
                                                     "scipy"))


@pytest.mark.parametrize("kind", ["csr", "memmap"])
def test_lazy_fingerprint_is_the_dense_one_and_the_jax_packages(kind,
                                                                tmp_path,
                                                                monkeypatch):
    """The lazy walk samples the dense walk's flat indices block of shards
    by block of shards: one digest for the dense array, the lazy source and
    the JAX package's either way, at a size where the sample is strided."""
    monkeypatch.setattr(tpre.LazyShardData, "_CHUNK_ELEMS", 3 * 300 * 40)
    Y = np.random.default_rng(4).normal(size=(300, 400))
    Y[Y < -1.0] = 0.0
    mine, theirs = _inputs(kind, Y, tmp_path)
    a = tpre.preprocess(mine, 10, seed=0)
    b = jpre.preprocess(theirs, 10, seed=0)
    d = tpre.preprocess(Y, 10, seed=0)
    assert a.data.shards_per_chunk == 3
    want = jck.data_fingerprint(d.data)
    assert ck.data_fingerprint(d.data) == want
    assert ck.data_fingerprint(a.data) == want
    assert jck.data_fingerprint(b.data) == want


def test_nan_against_explicit_zero_semantics():
    """Stored NaN is missing; a stored zero is a dense zero, so a column of
    only stored zeros is dropped - as in the JAX package."""
    n, p = 12, 8
    Y = np.random.default_rng(0).normal(size=(n, p))
    Y[:, 2] = 0.0
    Y[0, 5] = np.nan
    out = []
    for pkg in (tpre, jpre):
        csr = _csr(Y, pkg)
        indptr = csr.indptr.copy()
        indices, data = list(csr.indices), list(csr.data)
        for r in (4, 1):
            at = int(np.searchsorted(indices[indptr[r]:indptr[r + 1]], 2)
                     + indptr[r])
            indices.insert(at, 2)
            data.insert(at, 0.0)
            indptr[r + 1:] += 1
        out.append(pkg.preprocess(pkg.SparseMatrix(
            indptr, np.array(indices), np.array(data), (n, p)), 2, seed=0))
    a, b = out
    _same_pre(a, b)
    _same_pre(a, tpre.preprocess(Y, 2, seed=0))
    assert 2 in a.zero_cols and a.n_missing == 1
    assert a.data.materialize().tobytes() == b.data.materialize().tobytes()


@pytest.mark.parametrize("kind", ["csr", "memmap"])
@pytest.mark.parametrize("case", ["inf", "under-observed", "all-zero",
                                  "indivisible"])
def test_streaming_refusals_are_the_jax_packages(kind, case, tmp_path):
    """inf, a column with fewer than two observed entries, an all-zero
    matrix and p not divisible by g without padding: ValueErrors in both
    packages, with the same message."""
    Y = _toy(nan=False, zero_col=False)
    kw = {}
    if case == "inf":
        Y[1, 1] = np.inf
    elif case == "under-observed":
        Y[:-1, 4] = np.nan
    elif case == "all-zero":
        Y[:] = 0.0
    else:
        kw = {"pad_to_shards": False}
    messages = []
    for pkg, inp in zip((tpre, jpre), _inputs(kind, Y, tmp_path)):
        with pytest.raises(ValueError) as e:
            pkg.preprocess(inp, 5, seed=0, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_every_guard_raises_lazy_materialization_error():
    """The four functions the JAX package guards refuse a lazy ``pre``
    with the JAX package's type and message, and ``force=True`` is the
    escape: the dense restores then equal the dense ``pre``'s."""
    Y = _toy()
    lazy = tpre.preprocess(_csr(Y), 4, seed=2)
    jlazy = jpre.preprocess(_csr(Y, jpre), 4, seed=2)
    dense = tpre.preprocess(Y, 4, seed=2)
    g, P = 4, lazy.shard_size
    rng = np.random.default_rng(1)
    upper = rng.normal(size=(g * (g + 1) // 2, P, P)).astype(np.float32)
    q8 = rng.integers(-127, 128, upper.shape).astype(np.int8)
    scales = rng.uniform(0.5, 2.0, upper.shape[0]).astype(np.float32)
    S = np.eye(lazy.p_used, dtype=np.float32)
    data = rng.normal(size=lazy.data.shape).astype(np.float32)
    calls = [
        (lambda m, p, **k: m.restore_data_matrix(data, p, **k), tpre, jpre),
        (lambda m, p, **k: m.restore_covariance(S, p, **k), tpre, jpre),
        (lambda m, p, **k: m.assemble_from_upper(upper, p, **k), test,
         jest),
        (lambda m, p, **k: m.assemble_from_q8(q8, scales, p, **k), test,
         jest)]
    for call, mine, theirs in calls:
        with pytest.raises(tpre.LazyMaterializationError) as e:
            call(mine, lazy)
        with pytest.raises(jpre.LazyMaterializationError) as j:
            call(theirs, jlazy)
        assert str(e.value) == str(j.value)
        np.testing.assert_array_equal(call(mine, lazy, force=True),
                                      call(mine, dense))


# ---- fits ------------------------------------------------------------------

CFG = dt.FitConfig(
    model=dt.ModelConfig(num_shards=4, factors_per_shard=3, rho=0.5),
    run=dt.RunConfig(burnin=10, mcmc=20, thin=2, seed=3))


@functools.lru_cache(maxsize=None)
def _dense_fit(fetch_dtype="float32", nan=True):
    cfg = dataclasses.replace(CFG, backend=dt.BackendConfig(
        fetch_dtype=fetch_dtype))
    return dt.fit(_toy(nan=nan), cfg, device="cpu")


@pytest.mark.parametrize("fetch_dtype", ["float32", "quant8"])
@pytest.mark.parametrize("kind", ["csr", "csc", "scipy_csr", "memmap"])
def test_streaming_fit_is_its_dense_twin(kind, fetch_dtype, tmp_path):
    """Panels (and under quant8 the int8 panels and scales) bitwise the
    dense fit's; Sigma None under "auto" and the dense Sigma bit for bit
    under "always"; Y_imputed None on the lazy fit, n_missing equal;
    covariance() refused unless "always"."""
    Y = _toy(nan=kind != "scipy_csr")
    ref = _dense_fit(fetch_dtype, nan=kind != "scipy_csr")
    inp = _inputs(kind, Y, tmp_path)[0]
    cfg = dataclasses.replace(CFG, backend=dt.BackendConfig(
        fetch_dtype=fetch_dtype))
    res = dt.fit(inp, cfg, device="cpu")
    assert res.preprocess.is_lazy and res.Sigma is None
    assert res.preprocess.n_missing == ref.preprocess.n_missing
    assert res.Y_imputed is None
    if kind != "scipy_csr":
        assert ref.Y_imputed is not None
    np.testing.assert_array_equal(res.upper_panels, ref.upper_panels)
    if fetch_dtype == "quant8":
        np.testing.assert_array_equal(res._q8_panels, ref._q8_panels)
        np.testing.assert_array_equal(res._q8_scales, ref._q8_scales)
    with pytest.raises(tpre.LazyMaterializationError):
        res.covariance()
    always = dt.fit(inp, dataclasses.replace(cfg, materialize_sigma="always"),
                    device="cpu")
    np.testing.assert_array_equal(always.Sigma, ref.Sigma)
    np.testing.assert_array_equal(always.covariance(reinsert_zero_cols=True),
                                  ref.Sigma)


def test_lazy_posterior_sd_is_guarded_and_forced_by_always():
    Y = _toy()
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, posterior_sd=True))
    ref = dt.fit(Y, cfg, device="cpu")
    res = dt.fit(_csr(Y), cfg, device="cpu")
    assert res.Sigma_sd is None
    np.testing.assert_array_equal(res.sd_upper_panels, ref.sd_upper_panels)
    with pytest.raises(tpre.LazyMaterializationError):
        res.posterior_sd()
    res = dt.fit(_csr(Y), dataclasses.replace(cfg, materialize_sigma="always"),
                 device="cpu")
    np.testing.assert_array_equal(res.Sigma_sd, ref.Sigma_sd)
    np.testing.assert_array_equal(res.posterior_sd(reinsert_zero_cols=True),
                                  ref.Sigma_sd)


def test_sigma_block_of_a_lazy_fit_and_its_artifact(tmp_path):
    """sigma_block serves the lazy posterior from the panels (the JAX
    package's block rule on the same panels); export_artifact needs no
    dense Sigma, and the JAX package's PosteriorArtifact reads it and
    assembles the dense fit's quant8 Sigma."""
    Y = _toy()
    res = dt.fit(_csr(Y), CFG, device="cpu")
    g = CFG.model.num_shards
    blocks = jest.full_blocks_from_upper(res.upper_panels, g)
    scale = np.asarray(res.preprocess.col_scale, np.float32)
    for i, j in [(0, 0), (1, 3), (3, 1), (2, 2)]:
        want = blocks[i, j] * (scale[i][:, None] * scale[j][None, :])
        np.testing.assert_array_equal(res.sigma_block(i, j), want)
    np.testing.assert_array_equal(res.sigma_block(3, 1),
                                  res.sigma_block(1, 3).T)
    with pytest.raises(IndexError):
        res.sigma_block(0, g)
    path = str(tmp_path / "art")
    res.export_artifact(path)
    art = jart.PosteriorArtifact.open(path)
    assert art.meta["p_original"] == Y.shape[1]
    dense = dt.fit(Y, CFG, device="cpu")
    dense_path = str(tmp_path / "dense")
    dense.export_artifact(dense_path)
    np.testing.assert_array_equal(
        art.assemble(), jart.PosteriorArtifact.open(dense_path).assemble())


def test_divideconquer_returns_fits_sigma(tmp_path):
    """None for a lazy input under the default "auto", as in the JAX
    package; the dense Sigma for the dense input."""
    Y = _toy(nan=False)
    args = (4, 12, 6, 6, 2, 0.5)
    assert dt.divideconquer(_memmap(Y, tmp_path), *args, device="cpu") is None
    S = dt.divideconquer(Y, *args, device="cpu")
    assert S.shape == (Y.shape[1], Y.shape[1]) and np.isfinite(S).all()


@pytest.mark.parametrize("upload_dtype", ["float32", "bfloat16", "float16"])
def test_lazy_upload_is_the_dense_upload(upload_dtype, monkeypatch):
    """Block of shards by block of shards into one tensor: the dense
    upload's bytes, under every upload_dtype (NaN payloads included)."""
    monkeypatch.setattr(tpre.LazyShardData, "_CHUNK_ELEMS", 3 * 40 * 7)
    Y = _toy(p=70)
    lazy = tpre.preprocess(_csr(Y), 10, seed=0)
    dense = tpre.preprocess(Y, 10, seed=0)
    assert lazy.data.shards_per_chunk == 3
    a = fetch.upload_data(lazy.data, upload_dtype, "cpu")
    b = fetch.upload_data(dense.data, upload_dtype, "cpu")
    assert a.dtype == b.dtype == torch.float32
    assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("first,second", [("dense", "csr"),
                                          ("memmap", "dense")])
def test_a_checkpoint_resumes_across_the_ingest(first, second, tmp_path,
                                                monkeypatch):
    """A dense run's checkpoint resumed by a sparse refit (and a memmap
    run's by a dense one): the fingerprints agree, and the longer schedule
    is the uninterrupted longer run's bits."""
    monkeypatch.setattr(pipeline, "AsyncCheckpointWriter", _SyncWriter)
    _SyncWriter.kill_after, _SyncWriter.saves = None, []
    Y = _toy()
    forms = {"dense": Y, "csr": _csr(Y), "memmap": _memmap(Y, tmp_path)}
    path = str(tmp_path / "ck.npz")
    short = dataclasses.replace(CFG, checkpoint_path=path, run=dt.RunConfig(
        burnin=10, mcmc=10, thin=2, seed=3, chunk_size=5))
    dt.fit(forms[first], short, device="cpu")
    meta = jck.read_checkpoint_meta(path)
    assert meta["fingerprint"] == jck.data_fingerprint(
        jpre.preprocess(Y, 4, seed=3).data)
    longer = dataclasses.replace(short, resume=True, run=dataclasses.replace(
        short.run, mcmc=20))
    res = dt.fit(forms[second], longer, device="cpu")
    ref = dt.fit(Y, dataclasses.replace(longer, resume=False,
                                        checkpoint_path=None), device="cpu")
    assert res.traces.shape[1] == 10
    np.testing.assert_array_equal(res.upper_panels, ref.upper_panels)
    for x, y in zip(sampler.state_leaves(res.state),
                    sampler.state_leaves(ref.state), strict=True):
        assert torch.equal(x, y)


_RSS_PROBE = r"""
import json, resource, sys
import numpy as np
sys.path.insert(0, {repo!r})
from dcfm_tpu_torch.utils.preprocess import SparseMatrix, preprocess

n, p, g = 16, 800_000, 200
rng = np.random.default_rng(0)
nnz_per_row = p // 300
indptr = np.arange(n + 1, dtype=np.int64) * nnz_per_row
indices = np.concatenate(
    [np.sort(rng.choice(p, nnz_per_row, replace=False)) for _ in range(n)])
data = rng.standard_normal(indices.size)
Y = SparseMatrix(indptr, indices, data, (n, p), format="csr")
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
pre = preprocess(Y, g, seed=0)
for s in range(g):                  # stream every shard block once
    pre.data.block(s)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({{"delta_kb": int(after - before)}}))
"""


@pytest.mark.slow
def test_streaming_ingest_peak_rss_stays_bounded(tmp_path):
    """The port's twin of tests/test_sparse_ingest.py's guard, at its
    shape (p = 800k, n = 16, g = 200: the dense (g, n, P) float32 tensor
    is ~51 MB): the streaming path's RSS growth stays under half of it.
    ru_maxrss is a process-lifetime high-water mark, so the probe runs in
    its own subprocess with the baseline taken after the input is built."""
    probe = tmp_path / "rss_probe.py"
    probe.write_text(_RSS_PROBE.format(repo=REPO))
    out = subprocess.run([sys.executable, str(probe)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    sparse_kb = json.loads(out.stdout)["delta_kb"]
    assert sparse_kb < 24_000, f"streaming ingest peaked at {sparse_kb} kB"
