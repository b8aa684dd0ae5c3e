"""The port's fetch and assembly against the JAX package's, on the CPU.

The native one-pass assembler (g++ at first use) and the NumPy path beside
it, bit for bit against ``dcfm_tpu.native`` and
``dcfm_tpu.utils.estimate.assemble_from_upper``; the device-side fetch
prep (chain mean, trim, division, link cast) against the JAX fetch jit;
the upload cast; the convergence diagnostics; and whole fits at every
``fetch_dtype`` and ``materialize_sigma``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu import native as jnative  # noqa: E402
from dcfm_tpu.runtime import fetch as jfetch  # noqa: E402
from dcfm_tpu.utils import diagnostics as jdiag  # noqa: E402
from dcfm_tpu.utils import estimate as jest  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch import api, native  # noqa: E402
from dcfm_tpu_torch.models.state import num_padded_pairs, num_upper_pairs  # noqa: E402
from dcfm_tpu_torch.runtime import fetch  # noqa: E402
from dcfm_tpu_torch.serve.artifact import quantize_panels  # noqa: E402
from dcfm_tpu_torch.utils import diagnostics  # noqa: E402
from dcfm_tpu_torch.utils import estimate as test  # noqa: E402
from dcfm_tpu_torch.utils import preprocess as tpre  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw_y(p=23, seed=5):
    """Columns at unequal scales (0.01 to 100) and one all-zero column."""
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((30, p))
         * np.logspace(-2, 2, p)).astype(np.float32)
    Y[:, 4] = 0.0
    return Y


def _pres(g, p=23):
    Y = _raw_y(p)
    return tpre.preprocess(Y, g, seed=1), jpre.preprocess(Y, g, seed=1)


def _panels(g, P, kind, seed=9):
    """The full g(g+1)/2 panel set: float32 normals (asymmetric diagonal
    blocks), or int8 panels with per-panel scales, one of them zero."""
    rng = np.random.default_rng(seed + g)
    shape = (num_upper_pairs(g), P, P)
    if kind == "f32":
        return rng.standard_normal(shape).astype(np.float32), None
    q = rng.integers(-127, 128, shape).astype(np.int8)
    s = rng.uniform(0.01, 50.0, shape[0]).astype(np.float32)
    q[0], s[0] = 0, 0.0
    return q, s


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("destandardize", [True, False])
@pytest.mark.parametrize("reinsert", [True, False])
def test_native_assembler_matches_jax_native_and_numpy_bitwise(
        g, kind, destandardize, reinsert):
    """The port's native pass is the JAX package's, bit for bit, and the
    port's NumPy path is too: float32 and int8 panels, every option."""
    assert native.available(), "g++ should build the native assembler"
    a, b = _pres(g)
    panels, scales = _panels(g, a.shard_size, kind)
    opts = dict(destandardize=destandardize, reinsert_zero_cols=reinsert)
    maps = test.assembly_maps(a, g, a.shard_size, **opts)
    np.testing.assert_array_equal(
        maps[0], jest.assembly_maps(b, g, b.shard_size, **opts)[0])
    np.testing.assert_array_equal(
        maps[1], jest.assembly_maps(b, g, b.shard_size, **opts)[1])
    if kind == "f32":
        out = native.assemble_covariance(panels, *maps)
        via = test.assemble_from_upper(panels, a, **opts)
        if jnative.available():
            np.testing.assert_array_equal(
                out, jnative.assemble_covariance(panels, *maps))
    else:
        p_out = maps[2]
        out = np.zeros((p_out, p_out), np.float32)
        assert native.assemble_q8(panels, scales, *maps[:2], out)
        via = test.assemble_from_q8(panels, scales, a, **opts)
        if jnative.available():
            ref = np.zeros_like(out)
            assert jnative.assemble_q8(panels, scales, *maps[:2], ref)
            np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(via, out)
    np.testing.assert_array_equal(
        test.assemble_numpy(panels, scales, a, **opts), out)
    np.testing.assert_array_equal(out, out.T)


def test_sigma_is_the_jax_assembly_bitwise():
    """Fault C5: the port's NumPy path de-standardized in two steps and so
    differed from the JAX package's Sigma by ulps wherever the JAX native
    assembler loads.  Both port paths now give its bits, with unequal
    column scales and a zero column."""
    a, b = _pres(3, p=300)
    upper, _ = _panels(3, a.shard_size, "f32")
    for reinsert in (True, False):
        ref = jest.assemble_from_upper(upper, b, reinsert_zero_cols=reinsert)
        for out in (test.assemble_from_upper(upper, a,
                                             reinsert_zero_cols=reinsert),
                    test.assemble_numpy(upper, None, a,
                                        reinsert_zero_cols=reinsert)):
            np.testing.assert_array_equal(out, ref)
        if jnative.available():
            maps = jest.assembly_maps(b, 3, b.shard_size,
                                      reinsert_zero_cols=reinsert)
            np.testing.assert_array_equal(
                ref, jnative.assemble_covariance(upper, *maps))


def test_native_builds_warning_free_into_the_build_dir():
    """-Wall -Wextra report nothing, and the library lives under
    dcfm_tpu_torch/build/ (never the source tree)."""
    import subprocess
    out = subprocess.run(["g++", *native.CXX_FLAGS, "-o", "/dev/null",
                          native.SOURCE], capture_output=True, text=True)
    assert out.returncode == 0 and out.stderr == "", out.stderr
    assert native.library_path().startswith(native.BUILD + "/")


def _link_panels():
    """Float32 panels for the link: ties at .5 after scaling (a panel of
    max 127, where 127/scale is 1, and one of max -254, where it is 1/2),
    an all-zero panel, negative maxima, and random panels."""
    rng = np.random.default_rng(3)
    u = rng.standard_normal((6, 5, 5)).astype(np.float32) * 3
    u[0] = np.array([0.5, 1.5, 2.5, -0.5, -3.5] * 5).reshape(5, 5)
    u[0, 4, 4] = 127.0
    u[1] = (2 * rng.integers(-100, 100, (5, 5)) + 1).astype(np.float32)
    u[1, 0, 0] = -254.0
    u[2] = 0.0
    u[3] = -np.abs(u[3]) * 1e-3           # negative maximum, tiny scale
    return u


@pytest.mark.parametrize("mode", ["quant8", "bfloat16", "float16"])
def test_cast_for_link_matches_jax_bitwise(mode):
    u = _link_panels()
    got = fetch.cast_for_link(torch.from_numpy(u.copy()), mode)
    ref = jfetch.cast_for_link(jnp.asarray(u), mode)
    if mode == "quant8":
        assert got[0].dtype == torch.int8
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert got[0][0].tolist()[0][:3] == [0, 2, 2]      # half to even
        assert (got[0][2] == 0).all() and float(got[1][2]) == 0.0
    else:
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16",
                                  "quant8"])
def test_fetch_prep_matches_the_jax_fetch_bitwise(C, mode):
    """The chains' accumulators summed in place in chain order (as fit
    pools them) and fetch_prep give the JAX fetch jit's bits on the same
    accumulators: the chain mean as XLA computes acc.mean(axis=0), the
    trim, the division and the cast."""
    g, P = 5, 7
    rng = np.random.default_rng(C)
    accs = (rng.standard_normal((C, num_padded_pairs(g), P, P))
            * rng.uniform(0.1, 100.0, (C, 1, 1, 1))).astype(np.float32)
    inv = np.float32(1.0 / 37)
    pooled = torch.from_numpy(accs[0].copy())
    for c in range(1, C):
        pooled += torch.from_numpy(accs[c])
    got = fetch.fetch_prep(pooled, C, g, inv, mode)
    ref = jfetch.fetch_jit(g, C, mode)(accs if C > 1 else accs[0], inv)
    if mode == "quant8":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    else:
        assert got.shape == (num_upper_pairs(g), P, P)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("n,slices", [(15, 8), (3, 8), (1, 8), (9, 1)])
def test_drain_slices_cover_the_leading_axis(n, slices):
    """At most ``slices`` non-empty slices tile the leading axis, and the
    host copy is the tensor (on the CPU: the tensor itself; bfloat16 and
    float16 widened exactly to float32)."""
    x = torch.randn(n, 4).to(torch.bfloat16)  # dcfm-torch: ignore[DCFM101] - test data: only the host copy is compared with its source
    d = fetch.Drain(x, slices)
    assert len(d.ranges) == min(n, slices)
    assert [a for a, _ in d.ranges][1:] == [b for _, b in d.ranges][:-1]
    assert (d.ranges[0][0], d.ranges[-1][1]) == (0, n)
    np.testing.assert_array_equal(d.wait(), x.float().numpy())
    h = x.to(torch.float16)
    got = fetch.Drain(h, slices).wait()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, h.numpy().astype(np.float32))


@pytest.mark.parametrize("mode", ["float32", "float16", "bfloat16"])
def test_upload_host_array_matches_jax(mode):
    data = (np.random.default_rng(4).standard_normal((3, 11, 7))
            * 30).astype(np.float32)
    got = fetch.upload_host_array(data, mode)
    ref = jfetch.upload_host_array(data, mode)
    assert got.dtype == {"float32": torch.float32, "float16": torch.float16,
                         "bfloat16": torch.bfloat16}[mode]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("C", [1, 2, 4])
def test_diagnostics_match_jax(C):
    """Fault C2's diagnostics: split-R-hat and ESS are the JAX package's
    on the same traces (AR(1) chains, one of them shifted)."""
    rng = np.random.default_rng(C)
    x = np.zeros((C, 200))
    for t in range(1, 200):
        x[:, t] = 0.8 * x[:, t - 1] + rng.standard_normal(C)
    x[0] += 0.3
    assert diagnostics.ess(x) == jdiag.ess(x)
    r, jr = diagnostics.split_rhat(x), jdiag.split_rhat(x)
    assert r == jr or (np.isnan(r) and np.isnan(jr))
    assert np.isnan(diagnostics.ess(x[:, :3]))


# tests/test_torch_fit.py's twin-parity shape and its JAX-parity band
TWIN = dict(g=2, K=3, rho=0.7, burnin=400, mcmc=400)


@functools.lru_cache(maxsize=None)
def _twin_y():
    return make_synthetic(120, 48, 3, seed=5)[0]


def _rel_frob(A, B):
    return np.linalg.norm(A - B) / np.linalg.norm(B)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16",
                                  "quant8"])
def test_fit_matches_jax_fit_at_each_fetch_dtype(mode):
    """The port's fit and the JAX package's fit of the same data agree
    within test_torch_fit.py's 0.05 rel-Frobenius band at every
    fetch_dtype (different RNG streams, same model and fetch)."""
    Y = _twin_y()
    jres = dcfm_tpu.fit(Y, dcfm_tpu.FitConfig(
        model=dcfm_tpu.ModelConfig(num_shards=TWIN["g"],
                                   factors_per_shard=TWIN["K"],
                                   rho=TWIN["rho"], lambda_kernel="pallas"),
        run=dcfm_tpu.RunConfig(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"],
                               seed=0),
        backend=dcfm_tpu.BackendConfig(sse_mode="gram", fetch_dtype=mode,
                                       fetch_stream="off")))
    res = dt.fit(Y, dt.FitConfig(
        model=dt.ModelConfig(num_shards=TWIN["g"],
                             factors_per_shard=TWIN["K"], rho=TWIN["rho"]),
        run=dt.RunConfig(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"], seed=0),
        backend=dt.BackendConfig(sse_mode="gram", fetch_dtype=mode)),
        device="cpu")
    assert _rel_frob(res.Sigma, jres.Sigma) < 0.05
    assert (res._q8_panels is not None) == (mode == "quant8")
    assert (res._upper_f32 is not None) == (mode != "quant8")
    assert res.upper_panels.dtype == np.float32
    np.testing.assert_array_equal(res.Sigma,
                                  res.covariance(reinsert_zero_cols=True))


def _small_fit(**kw):
    Y, _ = make_synthetic(50, 30, 2, seed=2)
    Y[:, 7] = 0.0
    backend = {k: kw.pop(k) for k in ("fetch_dtype", "upload_dtype")
               if k in kw}
    return dt.fit(Y, dt.FitConfig(
        model=dt.ModelConfig(num_shards=4, factors_per_shard=2, rho=0.8),
        run=dt.RunConfig(burnin=10, mcmc=20, thin=2, num_chains=2),
        backend=dt.BackendConfig(**backend), **kw), device="cpu")


def test_quant8_sigma_is_the_float32_sigma_within_the_quant_bound():
    """The same chain fetched at float32 and at quant8: every Sigma entry
    within its panel's scale/254 times the two column scales (plus float32
    rounding of the products), and the float32 panels quantize on the host
    to the quant8 fetch's bytes."""
    f32, q8 = _small_fit(), _small_fit(fetch_dtype="quant8")
    pre = f32.preprocess
    g, P = pre.num_shards, pre.shard_size
    idx = tpre.caller_to_shard_index(pre, np.arange(pre.p_original))
    ok = idx >= 0
    sh, s = idx[ok] // P, pre.col_scale.reshape(-1)[idx[ok]]
    lo, hi = np.minimum.outer(sh, sh), np.maximum.outer(sh, sh)
    pair = lo * g - lo * (lo - 1) // 2 + (hi - lo)
    bound = q8._q8_scales[pair] / 254.0 * np.outer(s, s) * (1 + 1e-5)
    diff = np.abs(q8.Sigma - f32.Sigma)[np.ix_(ok, ok)]
    assert (diff <= bound + 1e-6 * np.abs(f32.Sigma[np.ix_(ok, ok)])).all()
    assert diff.max() > 0
    q, sc = quantize_panels(f32.upper_panels)
    np.testing.assert_array_equal(q, q8._q8_panels)
    np.testing.assert_array_equal(sc, q8._q8_scales)


@pytest.mark.parametrize("mode", ["float32", "quant8"])
def test_materialize_never_keeps_the_panels_packed(mode, tmp_path):
    """materialize_sigma='never': no Sigma, and every shard block from
    sigma_block is the assembled fit's Sigma at those columns (float32:
    bit for bit); the export works; 'auto' assembles only up to
    _AUTO_MATERIALIZE_MAX_P used columns."""
    full = _small_fit(fetch_dtype=mode, materialize_sigma="always")
    lazy = _small_fit(fetch_dtype=mode, materialize_sigma="never")
    assert lazy.Sigma is None and full.Sigma is not None
    pre = lazy.preprocess
    P = pre.shard_size
    pos = np.full(pre.p_used, -1)
    pos[tpre.caller_to_shard_index(pre, pre.kept_cols)] = pre.kept_cols
    for i in range(pre.num_shards):
        for j in range(pre.num_shards):
            blk = lazy.sigma_block(i, j)
            ri, cj = pos[i * P:(i + 1) * P], pos[j * P:(j + 1) * P]
            keep = np.ix_(ri >= 0, cj >= 0)
            want = full.Sigma[np.ix_(ri[ri >= 0], cj[cj >= 0])]
            if mode == "float32":
                np.testing.assert_array_equal(blk[keep], want)
            else:
                np.testing.assert_allclose(blk[keep], want, rtol=1e-5,
                                           atol=1e-6)
    art = lazy.export_artifact(str(tmp_path / "art"))
    np.testing.assert_array_equal(
        art.mean_panels, quantize_panels(lazy.upper_panels)[0])
    if mode == "quant8":
        np.testing.assert_array_equal(art.assemble(), full.Sigma)
    with pytest.raises(IndexError):
        lazy.sigma_block(0, pre.num_shards)


def test_materialize_auto_follows_the_used_width(monkeypatch):
    assert _small_fit().Sigma is not None
    monkeypatch.setattr(api, "_AUTO_MATERIALIZE_MAX_P", 31)
    assert _small_fit().Sigma is None
    assert _small_fit(materialize_sigma="always").Sigma is not None


@pytest.mark.parametrize("mode", ["float16", "bfloat16"])
def test_upload_dtype_runs_the_chain_on_the_cast_data(mode):
    """upload_dtype: the chain runs on the data rounded to the upload
    dtype - a different chain from the float32 upload, the same Sigma
    statistically."""
    a, b = _small_fit(), _small_fit(upload_dtype=mode)
    assert not np.array_equal(a.Sigma, b.Sigma)
    assert _rel_frob(b.Sigma, a.Sigma) < 0.05
