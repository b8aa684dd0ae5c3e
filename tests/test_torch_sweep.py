"""One Gibbs sweep of the PyTorch port against the JAX package's, leaf by
leaf, from the same state and on the JAX package's own random draws; the
combine panels and the host layer (preprocess, assembly) on identical
inputs.

The state is carried across with ``dcfm_tpu_torch.interop``.  The draws
come from :class:`JaxNoise`, a noise provider that replays the JAX
sweep's key discipline: the iteration key folded with the site id
(``conditionals.py:47``), then with the shard index for per-shard draws
(``_shard_keys``), then split where the JAX conditional splits
(``priors.py:100``, ``gamma.py:103``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dcfm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dcfm_tpu.models import conditionals as jcond  # noqa: E402
from dcfm_tpu.models import state as jstate  # noqa: E402
from dcfm_tpu.models.priors import make_prior as jmake_prior  # noqa: E402
from dcfm_tpu.utils import estimate as jest  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from dcfm_tpu_torch.config import ModelConfig  # noqa: E402
from dcfm_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from dcfm_tpu_torch.models import conditionals as tcond  # noqa: E402
from dcfm_tpu_torch.models import state as tstate  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.noise import SITE_X  # noqa: E402
from dcfm_tpu_torch.utils import estimate as test  # noqa: E402
from dcfm_tpu_torch.utils import preprocess as tpre  # noqa: E402


class JaxNoise:
    """The draws of the JAX sweep at iteration key ``key`` over G shards,
    as the port's ``Draws`` interface asks for them."""

    def __init__(self, key, G: int):
        self.key, self.G = key, G

    def _each(self, site, part, fn, lead_is_shard=True):
        site_key = jax.random.fold_in(self.key, site)
        if not lead_is_shard:
            keys = [site_key]
        else:
            keys = [jax.random.fold_in(site_key, g) for g in range(self.G)]
        if part is not None:
            keys = [jax.random.split(k)[part] for k in keys]
        out = [np.asarray(fn(k, g)) for g, k in enumerate(keys)]
        return torch.as_tensor(np.array(out[0] if not lead_is_shard
                                        else np.stack(out)))

    def normal(self, site, shape, *, part=None):
        if site == SITE_X:
            return self._each(site, part, lambda k, _: jax.random.normal(
                k, tuple(shape), jnp.float32), lead_is_shard=False)
        return self._each(site, part, lambda k, _: jax.random.normal(
            k, tuple(shape)[1:], jnp.float32))

    def exponential(self, site, shape, *, part=None):
        return self._each(site, part, lambda k, _: jax.random.exponential(
            k, tuple(shape)[1:], jnp.float32))

    def standard_gamma(self, site, alpha, *, part=None):
        a = alpha.numpy()
        return self._each(site, part, lambda k, g: jax.random.gamma(
            k, jnp.asarray(a[g], jnp.float32)))


G, N, P, K = 3, 24, 10, 4


def _jax_state_to_numpy(s):
    return {"Lambda": np.asarray(s.Lambda), "Z": np.asarray(s.Z),
            "X": np.asarray(s.X), "ps": np.asarray(s.ps),
            "prior": {k: np.asarray(v) for k, v in s.prior.items()}}


@functools.lru_cache(maxsize=None)
def _case(sse_mode: str, compute_dtype: str = "f32", lambda_kernel: str = ""):
    """(Y, JAX cfg, jitted JAX sweep, state after 6 JAX sweeps from init)
    - a mixed state, so every conditional is exercised.  The Lambda
    kernel defaults to "pallas-interpret" in Gram mode, "auto" otherwise."""
    rng = np.random.default_rng(11)
    L = rng.standard_normal((G * P, 2)) / 2
    Y = (rng.standard_normal((N, 2)) @ L.T
         + 0.3 * rng.standard_normal((N, G * P)))
    Y = jpre.preprocess(Y.astype(np.float32), G, seed=0).data
    kern = lambda_kernel or ("pallas-interpret" if sse_mode == "gram"
                             else "auto")
    cfg = JModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                       sse_mode=sse_mode, lambda_kernel=kern,
                       compute_dtype=compute_dtype)
    prior = jmake_prior(cfg)
    sweep = jax.jit(lambda k, y, s: jcond.gibbs_sweep(k, y, s, cfg, prior))
    state = jstate.init_state(jax.random.key(1), prior, num_local_shards=G,
                              n=N, P=P, K=K, as_=cfg.as_, bs=cfg.bs)
    Yj = jnp.asarray(Y)
    for i in range(6):
        state, _ = sweep(jax.random.key(100 + i), Yj, state)
    return Y, cfg, sweep, _jax_state_to_numpy(state)


def _sweep_pairs(key, sse_mode, compute_dtype="f32", lambda_kernel=""):
    """One sweep of each package from the same state on JAX's draws at
    iteration key ``key``: [(leaf, port, JAX)]."""
    Y, jcfg, jsweep, s0 = _case(sse_mode, compute_dtype, lambda_kernel)
    js = jax.tree.map(jnp.asarray, s0)
    jstate_new, jsse = jsweep(key, jnp.asarray(Y), jstate.SamplerState(
        Lambda=js["Lambda"], Z=js["Z"], X=js["X"], ps=js["ps"],
        prior=js["prior"]))
    j = _jax_state_to_numpy(jstate_new)

    cfg = ModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                      sse_mode=sse_mode, compute_dtype=compute_dtype,
                      lambda_kernel=lambda_kernel or "auto")
    ts, tsse = tcond.gibbs_sweep(JaxNoise(key, G), torch.as_tensor(Y),
                                 state_from_numpy(s0, "cpu"), cfg,
                                 make_prior(cfg))
    t = state_to_numpy(ts)
    pairs = [(leaf, t[leaf], j[leaf]) for leaf in ("Z", "X", "Lambda", "ps")]
    pairs += [(leaf, t["prior"][leaf], j["prior"][leaf])
              for leaf in ("psijh", "delta")]
    pairs.append(("sse", tsse.numpy(), np.asarray(jsse)))
    return pairs


@pytest.mark.parametrize("sse_mode", ["gram", "resid"])
def test_one_sweep_matches_jax_leaf_by_leaf(sse_mode):
    # Same state, same draws, same math: only float32 rounding differs
    # (LAPACK vs XLA triangular solves, matmul summation order, FMA), and
    # it compounds through Z -> X -> eta -> Lambda -> prior/psi.  Measured
    # over 20 iteration keys, the worst max |port - JAX| relative to the
    # leaf's largest entry is 7.1e-6 (gram ps; every other leaf of either
    # mode <= 9e-7), so 1e-4 of the leaf's scale keeps 14x headroom.
    for leaf, a, b in _sweep_pairs(jax.random.key(7), sse_mode):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.max(np.abs(b))),
                                   err_msg=leaf)


@pytest.mark.parametrize("sse_mode,compute_dtype,lambda_kernel", [
    ("gram", "bf16", "auto"), ("resid", "bf16", "auto"),
    ("gram", "f32", "pallas-fused"), ("resid", "f32", "pallas-fused"),
    ("gram", "bf16", "pallas-fused")])
def test_one_sweep_bf16_and_fused_match_jax_leaf_by_leaf(
        sse_mode, compute_dtype, lambda_kernel):
    """The bf16 sweep (K4 for the Lambda update) and the fused Lambda
    update (K2) against the JAX sweep, leaf by leaf on JAX's draws."""
    # f32 (fused): as the f32 test above, 1e-4 of the leaf's scale (worst
    # measured over 20 keys: 7.1e-6).  bf16: both packages round the same
    # float32 inputs to bf16, but an input that differs by an ulp upstream
    # can round to the neighbouring bf16 value (2^-8 relative) and move
    # what follows.  Measured over 20 keys, the worst leaf is 6.7e-5 of
    # its scale (Gram Lambda; resid <= 4.9e-6); 1e-3 keeps 15x headroom
    # and still fails a sweep that skips the rounding: bf16 and f32 sweeps
    # of either package differ by 2e-3 to 9e-3 of the scale.
    tol = 1e-4 if compute_dtype == "f32" else 1e-3
    for leaf, a, b in _sweep_pairs(jax.random.key(7), sse_mode,
                                   compute_dtype, lambda_kernel):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * float(np.max(np.abs(b))),
                                   err_msg=leaf)


def test_interop_round_trip_is_exact():
    _, _, _, s0 = _case("resid")
    back = state_to_numpy(state_from_numpy(s0, "cpu"))
    for leaf in ("Lambda", "Z", "X", "ps"):
        np.testing.assert_array_equal(back[leaf], s0[leaf])
    for leaf in ("psijh", "delta"):
        np.testing.assert_array_equal(back["prior"][leaf], s0["prior"][leaf])


def test_resolve_sse_mode_matches_jax():
    for mode, n, k in (("auto", 16, 16), ("auto", 15, 16), ("gram", 2, 9),
                       ("resid", 99, 2)):
        assert (tcond.resolve_sse_mode(mode, n=n, K=k)
                == jcond.resolve_sse_mode(mode, n=n, K=k))


@pytest.mark.parametrize("g", [1, 4, 5])
def test_packed_pair_layout_matches_jax(g):
    assert tstate.num_upper_pairs(g) == jstate.num_upper_pairs(g)
    assert tstate.num_padded_pairs(g) == jstate.num_padded_pairs(g)
    for a, b in zip(tstate.packed_pair_indices(g),
                    jstate.packed_pair_indices(g)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
def test_covariance_panels_match_jax(estimator):
    rng = np.random.default_rng(3)
    g, P_, K_, n = 4, 6, 3, 12
    Lam = rng.standard_normal((g, P_, K_)).astype(np.float32)
    ps = rng.gamma(2.0, 1.0, (g, P_)).astype(np.float32)
    eta = rng.standard_normal((g, n, K_)).astype(np.float32)
    rows, cols = tstate.packed_pair_indices(g)
    scaled = estimator == "scaled"
    out = tcond.covariance_panels(
        torch.as_tensor(Lam), torch.as_tensor(ps), 0.7,
        torch.as_tensor(rows, dtype=torch.long),
        torch.as_tensor(cols, dtype=torch.long),
        eta_all=torch.as_tensor(eta) if scaled else None).numpy()
    ref = np.asarray(jcond.covariance_panels(
        jnp.asarray(Lam), jnp.asarray(ps), 0.7, rows, cols,
        eta_all=jnp.asarray(eta) if scaled else None))
    # two K-term float32 contractions per entry in another summation order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("estimator", ["scaled", "plain"])
def test_covariance_panels_bf16_match_jax(estimator):
    """``compute_dtype=bf16``: bf16 block products with float32 output,
    H in float32 and Lam_r H rounded to bf16 again, as the JAX package."""
    rng = np.random.default_rng(4)
    g, P_, K_, n = 4, 6, 3, 12
    Lam = rng.standard_normal((g, P_, K_)).astype(np.float32)
    ps = rng.gamma(2.0, 1.0, (g, P_)).astype(np.float32)
    eta = rng.standard_normal((g, n, K_)).astype(np.float32)
    rows, cols = tstate.packed_pair_indices(g)
    scaled = estimator == "scaled"
    out = tcond.covariance_panels(
        torch.as_tensor(Lam), torch.as_tensor(ps), 0.7,
        torch.as_tensor(rows, dtype=torch.long),
        torch.as_tensor(cols, dtype=torch.long),
        eta_all=torch.as_tensor(eta) if scaled else None,
        compute_dtype=torch.bfloat16).numpy()
    ref, f32 = (np.asarray(jcond.covariance_panels(
        jnp.asarray(Lam), jnp.asarray(ps), 0.7, rows, cols,
        eta_all=jnp.asarray(eta) if scaled else None, compute_dtype=dt))
        for dt in (jnp.bfloat16, None))
    # the same bf16 roundings and exact products; only the K-term float32
    # sums differ in order (measured 0 over 20 seeds at this size).  The
    # band is 1e-5 of the scale: the float32 panels miss it by 1e-3.
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)
    assert np.max(np.abs(f32 - ref)) > 1e-5 * scale


@pytest.mark.parametrize("sa,sb", [((3, 40, 157), (3, 157, 8)),
                                   ((40, 8), (3, 8, 157)),
                                   ((3, 8, 40), (3, 40, 8)),
                                   ((24, 5), (5, 9))])
def test_mm_bf16_matches_jax_preferred_f32(sa, sb):
    """``mm_bf16`` against ``jnp.matmul`` of bf16 inputs with
    ``preferred_element_type=float32``: the sweep's products and their
    broadcast shapes (X @ Lam' over shards)."""
    rng = np.random.default_rng(len(sa) * 10 + sb[-1])
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    out = tcond.mm_bf16(torch.as_tensor(a), torch.as_tensor(b))
    assert out.dtype == torch.float32
    ref = np.asarray(jnp.matmul(jnp.asarray(a).astype(jnp.bfloat16),
                                jnp.asarray(b).astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    # exact products of bf16 values, float32 sums in another order: 1.5e-7
    # of the scale measured.  1e-5 fails an output rounded to bf16 (2e-3
    # of the scale) and a product of the unrounded inputs (2e-3).
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * scale)
    rounded = out.to(torch.bfloat16).float().numpy()
    assert np.max(np.abs(rounded - ref)) > 1e-5 * scale
    assert np.max(np.abs(a @ b - ref)) > 1e-5 * scale


# ---------------------------------------------------------------------------
# host layer: bitwise the JAX package's on the same Y
# ---------------------------------------------------------------------------

def _raw_y():
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((30, 23)).astype(np.float32) * 3 + 1
    Y[:, 4] = 0.0                                   # a dropped zero column
    return Y


@pytest.mark.parametrize("permute,standardize", [(True, True),
                                                 (False, False)])
def test_preprocess_matches_jax_bitwise(permute, standardize):
    Y = _raw_y()
    a = tpre.preprocess(Y, 4, permute=permute, standardize=standardize,
                        seed=3)
    b = jpre.preprocess(Y, 4, permute=permute, standardize=standardize,
                        seed=3)
    for f in ("data", "perm", "inv_perm", "col_mean", "col_scale",
              "kept_cols", "zero_cols"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_pad, a.p_original, a.p_used) == (b.n_pad, b.p_original,
                                                 b.p_used)


def test_assembly_matches_jax():
    Y = _raw_y()
    g = 4
    a, b = (tpre.preprocess(Y, g, seed=1), jpre.preprocess(Y, g, seed=1))
    P_ = a.shard_size
    rng = np.random.default_rng(9)
    upper = rng.standard_normal(
        (tstate.num_upper_pairs(g), P_, P_)).astype(np.float32)
    np.testing.assert_array_equal(test.full_blocks_from_upper(upper, g),
                                  jest.full_blocks_from_upper(upper, g))
    blocks = test.full_blocks_from_upper(upper, g)
    np.testing.assert_array_equal(test.stitch_blocks(blocks),
                                  jest.stitch_blocks(blocks))
    for reinsert in (False, True):
        out = test.assemble_from_upper(upper, a, reinsert_zero_cols=reinsert)
        ref = jest.assemble_from_upper(upper, b, reinsert_zero_cols=reinsert)
        # the JAX package may take its native one-pass assembler, which
        # repeats the NumPy path's per-entry arithmetic
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
        S = test.stitch_blocks(blocks, symmetrize=False)
        np.testing.assert_array_equal(
            out, tpre.restore_covariance(S, a, reinsert_zero_cols=reinsert))


def test_preprocess_refuses_missing_values():
    Y = _raw_y()
    Y[2, 3] = np.nan
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpre.preprocess(Y, 4)


def test_config_mirrors_jax_defaults():
    """A config written for one package reads the same in the other
    (``RunConfig.sweep_unroll`` among the fields compared)."""
    from dcfm_tpu import config as jc

    from dcfm_tpu_torch import config as tc
    assert "sweep_unroll" in {f.name for f in dataclasses.fields(tc.RunConfig)}
    for name in ("MGPConfig", "ModelConfig", "RunConfig", "BackendConfig",
                 "FitConfig"):
        tf = {f.name: f for f in dataclasses.fields(getattr(tc, name))}
        jf = {f.name: f for f in dataclasses.fields(getattr(jc, name))}
        for fname, f in tf.items():
            assert fname in jf, (name, fname)
            if f.default is not dataclasses.MISSING:
                a, b = f.default, jf[fname].default
                if dataclasses.is_dataclass(a):     # the port's fields only
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                    b = {k: b[k] for k in a}
                assert a == b, (name, fname)
