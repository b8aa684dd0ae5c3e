"""The port's posterior SD (``ModelConfig.posterior_sd``) against the JAX
package's, on the CPU.

One saved sweep from the same state on the JAX package's own draws adds
the same ``sigma_sq_acc`` (the panels' squares) as the JAX ``run_chunk``;
the device-side SD prep is the JAX ``fetch_sd_jit`` on identical sums at
every ``fetch_dtype``; a whole fit's SD lies in the JAX fit's Monte Carlo
band and leaves the mean's bits alone; the JAX loader reads a
posterior_sd port checkpoint leaf for leaf; and the SD panels travel
through ``FitResult``, the artifact and a resume.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.models import sampler as jsampler  # noqa: E402
from dcfm_tpu.models.priors import make_prior as jmake_prior  # noqa: E402
from dcfm_tpu.runtime import fetch as jfetch  # noqa: E402
from dcfm_tpu.serve import artifact as jart  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_torch_sweep import JaxNoise, _case  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.config import ModelConfig  # noqa: E402
from dcfm_tpu_torch.interop import state_from_numpy  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.models.state import (  # noqa: E402
    num_padded_pairs, num_upper_pairs)
from dcfm_tpu_torch.runtime import fetch  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402

# the JAX package's checkpoint tests' size
N, P_COLS, G, K = 40, 24, 2, 3


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


def _cfg(pkg, C=2, sd=True, backend=None, **run):
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=4) | run
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6,
                              posterior_sd=sd),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(**({"sse_mode": "gram"}
                                     | (backend or {}))))


@functools.lru_cache(maxsize=None)
def _fit(C=2, sd=True, mode="float32", materialize="auto"):
    cfg = dataclasses.replace(_cfg(dt, C, sd, {"fetch_dtype": mode}),
                              materialize_sigma=materialize)
    return dt.fit(_data(), cfg, device="cpu")


# ---- one saved sweep ------------------------------------------------------

class _JaxSweeps:
    """A provider whose iteration ``it`` draws are the JAX run_chunk's
    (the chunk key folded with the global iteration)."""

    def __init__(self, key, G):
        self.key, self.G = key, G

    def sweep(self, chain, iteration):
        return JaxNoise(jax.random.fold_in(self.key, iteration), self.G)


@pytest.mark.parametrize("sse_mode,compute_dtype", [
    ("gram", "f32"), ("resid", "f32"), ("gram", "bf16")])
def test_one_saved_sweep_accumulates_the_jax_second_moment(sse_mode,
                                                           compute_dtype):
    """From the same state and the same running sums, one saved iteration
    of the port's runner and of the JAX run_chunk (posterior_sd) on the
    JAX package's draws: sigma_acc and sigma_sq_acc leaf for leaf.  The
    tolerances are tests/test_torch_sweep.py's (1e-4 of the leaf's scale
    in float32, 1e-3 under bf16): the panels inherit the sweep's rounding
    and the square adds none of its own (it is rounded on its own, then
    added, in both packages)."""
    Y, jcfg, _, s0 = _case(sse_mode, compute_dtype)
    jcfg = dataclasses.replace(jcfg, posterior_sd=True)
    Gs, _, P = Y.shape
    Q = num_padded_pairs(Gs)
    rng = np.random.default_rng(5)
    acc0 = rng.standard_normal((Q, P, P)).astype(np.float32)
    sq0 = (acc0 * acc0 + rng.random((Q, P, P))).astype(np.float32)
    health0 = np.tile(np.array([0, np.inf, 0, 0], np.float32), (Gs, 1))
    it0 = 5
    key = jax.random.key(21)
    js = jax.tree.map(jnp.asarray, s0)
    jcarry = jsampler.ChainCarry(
        state=jsampler.SamplerState(Lambda=js["Lambda"], Z=js["Z"],
                                    X=js["X"], ps=js["ps"],
                                    prior=js["prior"]),
        sigma_acc=jnp.asarray(acc0), iteration=jnp.int32(it0),
        health=jnp.asarray(health0), sigma_sq_acc=jnp.asarray(sq0))
    sched = jsampler.schedule_array(dcfm_tpu.RunConfig(burnin=0, mcmc=1))
    jout, _, _ = jsampler.run_chunk(key, jnp.asarray(Y), jcarry, sched,
                                    jcfg, jmake_prior(jcfg), num_iters=1)
    cfg = ModelConfig(num_shards=Gs, factors_per_shard=jcfg.factors_per_shard,
                      rho=jcfg.rho, sse_mode=sse_mode,
                      compute_dtype=compute_dtype, posterior_sd=True)
    runner = sampler.ChainRunner(_JaxSweeps(key, Gs), torch.as_tensor(Y),
                                 cfg, make_prior(cfg), burnin=0, thin=1)
    carry = sampler.ChainCarry(
        state=state_from_numpy(s0, "cpu"),
        sigma_acc=torch.as_tensor(acc0.copy()), iteration=it0,
        health=torch.as_tensor(health0.copy()),
        sigma_sq_acc=torch.as_tensor(sq0.copy()))
    carry = runner.run_chunk(0, carry, 1)[0]
    tol = 1e-4 if compute_dtype == "f32" else 1e-3
    for name, ref0 in (("sigma_acc", acc0), ("sigma_sq_acc", sq0)):
        got = getattr(carry, name).numpy()
        want = np.asarray(getattr(jout, name))
        # the sweep's panels were added: the leaf moved off its start
        assert not np.array_equal(want, ref0), name
        step = want - ref0
        np.testing.assert_allclose(got - ref0, step, rtol=0,
                                   atol=tol * float(np.abs(step).max()),
                                   err_msg=name)
    assert carry.iteration == it0 + 1


def test_posterior_sd_off_carries_no_second_moment():
    """With the knob off nothing changes: no buffer, no leaf."""
    cfg = ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6)
    Yd = torch.as_tensor(preprocess(_data(), G, seed=0).data)
    runner = sampler.ChainRunner(dt.noise.TorchNoise(0, "cpu"), Yd, cfg,
                                 make_prior(cfg), burnin=0, thin=1)
    carry = runner.new_chain(0)
    assert carry.sigma_sq_acc is None
    assert len(sampler.carry_tensors(carry)) == 8
    assert "sigma_sq_acc" not in ck.carry_template(cfg, n=N, P=12,
                                                   num_chains=2)


# ---- the SD prep ----------------------------------------------------------

def _moment_sums(C, g, P, S=10, seed=0):
    """(acc, acc_sq) of S draws per chain: (C, Q, P, P) float32 sums."""
    rng = np.random.default_rng(seed)
    Q = num_padded_pairs(g)
    centre = rng.standard_normal((Q, P, P)).astype(np.float32)
    acc = np.zeros((C, Q, P, P), np.float32)
    sq = np.zeros_like(acc)
    for _ in range(S):
        d = centre + np.float32(0.3) * rng.standard_normal(
            (C, Q, P, P)).astype(np.float32)
        acc += d
        sq += d * d
    return acc, sq


def _pooled(a):
    out = torch.as_tensor(a[0].copy())
    for c in range(1, a.shape[0]):
        out += torch.as_tensor(a[c])
    return out


# link dtype: the relative size of one unit in its last place
_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16",
                                  "quant8"])
def test_the_sd_prep_is_fetch_sd_jit(C, mode):
    """fetch_prep then fetch_sd_prep on the chains' sums (pooled in chain
    order) against the JAX fetch_jit and fetch_sd_jit on the same sums.

    The mean is bitwise.  The SD is not: XLA:CPU rewrites the float32
    expression m2 - mean * mean (its scalar folds), so entries differ by a
    few ulps; measured over 20 draws at each C the worst is 2.9e-6 of the
    panels' largest SD, so 2e-5 of it is allowed (7x), plus one unit in
    the last place of the link dtype (the same float32 value on either
    side of a rounding boundary: measured once in float16, 4.7e-4 of the
    largest).  Under quant8 an int8 entry may move by one step and a
    panel's scale by the float32 tolerance (measured: no entry moved,
    scales within 7.3e-7)."""
    g, P = 3, 7
    acc, sq = _moment_sums(C, g, P, seed=C)
    _, inv, bessel = fetch.accumulator_window(20, 0, 2, 0, C)
    a, b = (acc, sq) if C > 1 else (acc[0], sq[0])
    jmean = jfetch.fetch_jit(g, C, mode)(a, inv)
    jsd = jfetch.fetch_sd_jit(g, C, mode)(a, b, inv, bessel)
    pa, pb = _pooled(acc), _pooled(sq)
    mean = fetch.fetch_prep(pa, C, g, inv, mode)
    sd = fetch.fetch_sd_prep(pb, pa[:num_upper_pairs(g)], C, inv, bessel,
                             mode)
    if mode == "quant8":
        for x, y in zip(mean, jmean, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        q, s = sd[0].numpy(), sd[1].numpy()
        jq, js = np.asarray(jsd[0]), np.asarray(jsd[1])
        assert np.abs(q.astype(np.int32) - jq.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, js, rtol=2e-5, atol=0)
        return
    np.testing.assert_array_equal(mean.float().numpy(),
                                  np.asarray(jmean, np.float32))
    got = sd.float().numpy()
    want = np.asarray(jsd, np.float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert sd.dtype == fetch.LINK_DTYPES[mode]
    top = float(np.abs(want).max())
    assert (np.abs(got - want)
            <= 2e-5 * top + _ULP[mode] * np.abs(want)).all()


# ---- whole fits -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _long(pkg_name: str, sd: bool = True):
    pkg = dcfm_tpu if pkg_name == "jax" else dt
    cfg = _cfg(pkg, 2, sd, burnin=200, mcmc=400, chunk_size=0)
    kw = {} if pkg is dcfm_tpu else {"device": "cpu"}
    return pkg.fit(_data(), cfg, **kw)


def test_a_fits_sd_is_within_the_jax_fits_monte_carlo_band():
    """The port's Sigma_sd against the JAX fit's (200 + 400 iterations, 2
    chains; different random streams, the same posterior).  Measured: two
    JAX seeds' SDs differ by 0.082-0.090 in rel. Frobenius, the port's two
    seeds from the JAX fits by 0.050-0.099; the band is 0.15.  The mean
    SD level agrees within 0.6% (band 5%).  The SD leaves the mean's chain
    alone: Sigma is bitwise the fit without posterior_sd."""
    port, jx = _long("port"), _long("jax")
    assert port.Sigma_sd.shape == jx.Sigma_sd.shape == (P_COLS, P_COLS)
    assert np.isfinite(port.Sigma_sd).all() and (port.Sigma_sd >= 0).all()
    rel = (np.linalg.norm(port.Sigma_sd - jx.Sigma_sd)
           / np.linalg.norm(jx.Sigma_sd))
    assert rel < 0.15, rel
    level = port.Sigma_sd.mean() / jx.Sigma_sd.mean()
    assert abs(level - 1) < 0.05, level
    np.testing.assert_array_equal(port.Sigma, _long("port", False).Sigma)


@pytest.mark.parametrize("mode", ["float32", "quant8"])
def test_fit_result_sd_panels_and_posterior_sd(mode):
    """posterior_sd() with both options on is Sigma_sd bit for bit (under
    quant8 assembled from the int8 panels), sd_upper_panels are the
    panels it came from; the packed result keeps the same panels; the
    quant8 SD is within its quant8 bound of the float32 SD."""
    res = _fit(mode=mode)
    np.testing.assert_array_equal(
        res.posterior_sd(destandardize=True, reinsert_zero_cols=True),
        res.Sigma_sd)
    assert res.sd_upper_panels.shape == res.upper_panels.shape
    assert res.sigma_sd_blocks.shape == (G, G) + res.upper_panels.shape[1:]
    packed = _fit(mode=mode, materialize="never")
    assert packed.Sigma is None and packed.Sigma_sd is None
    np.testing.assert_array_equal(packed.sd_upper_panels,
                                  res.sd_upper_panels)
    if mode == "quant8":
        f32 = _fit()
        bound = res._sd_q8_scales[:, None, None] / 254.0
        diff = np.abs(res.sd_upper_panels - f32.sd_upper_panels)
        assert (diff <= bound * (1 + 1e-5)).all()
    off = _fit(sd=False)
    assert off.Sigma_sd is None and off.sd_upper_panels is None
    with pytest.raises(ValueError, match="posterior_sd=True"):
        off.posterior_sd()


def test_the_sd_artifact_opens_in_the_jax_package(tmp_path):
    """export_artifact writes sd_q8.bin with has_sd; both packages'
    PosteriorArtifact assemble(kind="sd") the quant8 Sigma_sd bit for
    bit, and the panels' CRCs verify."""
    res = _fit(mode="quant8")
    path = str(tmp_path / "art")
    art = res.export_artifact(path)
    assert art.has_sd and art.meta["has_sd"]
    jx = jart.PosteriorArtifact.open(path)
    for a in (art, jx):
        np.testing.assert_array_equal(a.assemble(kind="sd"), res.Sigma_sd)
        np.testing.assert_array_equal(a.assemble(), res.Sigma)
        for pair in range(a.n_pairs):
            a.verify_panel("sd", pair)
    # a re-export without SD drops the stale SD panels
    art = _fit().export_artifact(path)
    assert art.has_sd
    art = _fit(sd=False).export_artifact(path)
    assert not art.has_sd and not (tmp_path / "art" / "sd_q8.bin").exists()


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("mode", ["full", "light"])
def test_the_jax_loader_reads_a_posterior_sd_port_file_leaf_for_leaf(
        tmp_path, C, mode):
    """sigma_sq_acc is the leaf after health, as in the JAX ChainCarry:
    the JAX loader with a posterior_sd template reads every leaf the port
    wrote (a light file drops both accumulators, which the JAX loader
    restores as zeros); acc_leaf_indices name both accumulators."""
    path = str(tmp_path / f"sd_{C}_{mode}.npz")
    cfg = dataclasses.replace(_cfg(dt, C), checkpoint_path=path,
                              checkpoint_mode=mode,
                              checkpoint_every_chunks=1)
    res = dt.fit(_data(), cfg, device="cpu")
    meta = jck.verify_checkpoint(path)
    assert meta["acc_leaf_indices"] == ([] if mode == "light" else [6, 9])
    m = dcfm_tpu.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6,
                             posterior_sd=True)
    init_fn = dcfm_tpu.api._local_fns(m, 4, C)[0]
    P = res.preprocess.data.shape[2]
    tpl = jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                         jax.ShapeDtypeStruct((G, N, P), np.float32))
    carry, _ = jck.load_checkpoint(path, tpl)
    got = jax.tree.leaves(carry)
    assert len(got) == 10
    leaves, _ = ck.load_checkpoint(path, ck.carry_template(
        dataclasses.replace(cfg.model, sse_mode="gram"), n=N, P=P,
        num_chains=C))
    for name, arr in zip(ck.FULL_LEAVES_SD, got, strict=True):
        if name in leaves:
            np.testing.assert_array_equal(leaves[name], np.asarray(arr))
        else:
            assert mode == "light" and not np.asarray(arr).any()
    if mode == "full":
        sq, acc = np.asarray(carry.sigma_sq_acc), np.asarray(carry.sigma_acc)
        # a sum of squares of the draws that summed to acc: >= acc^2 / n
        n_saved = 4
        assert (sq >= acc * acc / n_saved * (1 - 1e-5) - 1e-6).all()


def test_a_resumed_sd_fit_is_the_uninterrupted_one(tmp_path):
    """A full file at iteration 8 carries sigma_sq_acc; resuming it to 14
    gives the uninterrupted fit's Sigma and Sigma_sd bit for bit; a light
    file restarts both accumulators at its iteration."""
    path = str(tmp_path / "r.npz")
    dt.fit(_data(), dataclasses.replace(_cfg(dt, mcmc=2),
                                        checkpoint_path=path), device="cpu")
    res = dt.fit(_data(), dataclasses.replace(_cfg(dt), checkpoint_path=path,
                                              resume=True), device="cpu")
    assert res.traces.shape[1] == 6
    ref = _fit()
    np.testing.assert_array_equal(res.Sigma, ref.Sigma)
    np.testing.assert_array_equal(res.Sigma_sd, ref.Sigma_sd)
    light = str(tmp_path / "l.npz")
    dt.fit(_data(), dataclasses.replace(_cfg(dt, mcmc=2),
                                        checkpoint_path=light,
                                        checkpoint_mode="light"),
           device="cpu")
    lres = dt.fit(_data(), dataclasses.replace(
        _cfg(dt), checkpoint_path=light, checkpoint_mode="light",
        resume=True), device="cpu")
    # the restarted window (8, 14] holds 3 draws: its SD is that window's
    np.testing.assert_array_equal(
        lres.state.Lambda.numpy(), ref.state.Lambda.numpy())
    assert not np.array_equal(lres.Sigma_sd, ref.Sigma_sd)
    assert np.isfinite(lres.Sigma_sd).all() and (lres.Sigma_sd >= 0).all()


def test_write_artifact_with_sd_matches_jax_byte_for_byte(tmp_path):
    """Same mean and SD panels and maps: both packages' write_artifact
    give the same panel files, maps and meta."""
    from dcfm_tpu.utils import preprocess as jpre
    from dcfm_tpu_torch.utils import preprocess as tpre
    Y = _data()
    g, rng = 3, np.random.default_rng(9)
    tp = tpre.preprocess(Y, g, seed=0)
    jp = jpre.preprocess(Y, g, seed=0)
    P = tp.data.shape[2]
    u = rng.standard_normal((num_upper_pairs(g), P, P)).astype(np.float32)
    mq, ms = tart.quantize_panels(u)
    sq, ss = tart.quantize_panels(np.abs(u) * np.float32(0.1))
    prov = {"source": "fit", "seed": 0}
    tart.write_artifact(str(tmp_path / "t"), mean_q8=mq, mean_scale=ms,
                        pre=tp, sd_q8=sq, sd_scale=ss, provenance=prov)
    jart.write_artifact(str(tmp_path / "j"), mean_q8=mq, mean_scale=ms,
                        pre=jp, sd_q8=sq, sd_scale=ss, provenance=prov)
    for name in ("mean_q8.bin", "sd_q8.bin", "meta.json"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    with np.load(tmp_path / "t" / "maps.npz") as a, \
            np.load(tmp_path / "j" / "maps.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
