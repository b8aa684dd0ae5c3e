"""The horseshoe and Dirichlet-Laplace priors, their GIG and inverse-Gaussian
samplers and the column mask of adaptive rank truncation in the PyTorch
port, against the JAX package on the CPU.

The samplers and one Gibbs sweep are held against the JAX package on the
JAX package's own random draws: :class:`JaxNoise` extends
``tests/test_torch_sweep.JaxNoise`` with uniforms, key paths (noise.py
``part``: n-way splits, ``fold_in``, and the rejection loop's rounds) and
the candidate tables of Gamma draws whose shape follows the chain state.
Pallas paths run in interpret mode, as the JAX package's own tests run
them on the CPU.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import special  # noqa: E402

from dcfm_tpu.config import AdaptConfig as JAdaptConfig  # noqa: E402
from dcfm_tpu.config import MGPConfig as JMGPConfig  # noqa: E402
from dcfm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dcfm_tpu.models import conditionals as jcond  # noqa: E402
from dcfm_tpu.models import state as jstate  # noqa: E402
from dcfm_tpu.models.priors import make_prior as jmake_prior  # noqa: E402
from dcfm_tpu.ops import gig as jgig  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from dcfm_tpu_torch.config import AdaptConfig, MGPConfig, ModelConfig  # noqa: E402
from dcfm_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from dcfm_tpu_torch.models import conditionals as tcond  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.noise import SHARED_SITES, TorchNoise  # noqa: E402
from dcfm_tpu_torch.ops import gig as tgig  # noqa: E402


def _walk(key, steps):
    """The key at the end of a noise.py ``part`` path; a ``("rounds", R)``
    step makes a list of R keys (the JAX rejection loop's ``k, sub =
    split(k)`` per round, the rest of the path applied to each ``sub``)."""
    if not steps:
        return key
    st, rest = steps[0], steps[1:]
    if isinstance(st, int):
        return _walk(jax.random.split(key)[st], rest)
    if st[0] == "fold":
        return _walk(jax.random.fold_in(key, st[1]), rest)
    if st[0] == "rounds":
        out, k = [], key
        for _ in range(st[1]):
            k, sub = jax.random.split(k)
            out.append(_walk(sub, rest))
        return out
    n, i = st
    return _walk(jax.random.split(key, n)[i], rest)


def _draw(key, fn, shape):
    """``fn(key, shape)``, or the stack over a rounds list's keys (each
    drawing ``shape[1:]``)."""
    if isinstance(key, list):
        return np.stack([_draw(k, fn, shape[1:]) for k in key])
    return np.asarray(fn(key, shape))


class JaxNoise:
    """The JAX sweep's draws at iteration key ``key`` over G shards, as the
    port's ``Draws`` interface asks for them: the key folded with the site,
    then with the shard (at every site but the shared ones), then along the
    call's ``part`` path.  ``force(kind, site, part, array)`` may replace a
    draw (a test's forced rejection)."""

    def __init__(self, key, G: int, force=None):
        self.key, self.G, self.force = key, G, force

    def _base(self, site):
        site_key = jax.random.fold_in(self.key, site)
        if site in SHARED_SITES:
            return None, [site_key]
        return self.G, [jax.random.fold_in(site_key, g)
                        for g in range(self.G)]

    def _each(self, kind, site, part, shape, fn):
        lead, keys = self._base(site)
        steps = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        sub = tuple(shape) if lead is None else tuple(shape)[1:]
        out = [_draw(_walk(k, steps), lambda kk, s, g=g: fn(kk, s, g), sub)
               for g, k in enumerate(keys)]
        arr = out[0] if lead is None else np.stack(out)
        if self.force is not None:
            arr = self.force(kind, site, part, arr)
        return torch.as_tensor(np.array(arr, np.float32))

    def normal(self, site, shape, *, part=None):
        return self._each("normal", site, part, shape,
                          lambda k, s, g: jax.random.normal(k, s))

    def exponential(self, site, shape, *, part=None):
        return self._each("exponential", site, part, shape,
                          lambda k, s, g: jax.random.exponential(k, s))

    def uniform(self, site, shape, *, part=None):
        return self._each("uniform", site, part, shape,
                          lambda k, s, g: jax.random.uniform(k, s))

    def standard_gamma(self, site, alpha, *, part=None):
        a = alpha.numpy()
        return self._each("standard_gamma", site, part, alpha.shape,
                          lambda k, s, g: jax.random.gamma(
                              k, jnp.asarray(a[g], jnp.float32)))

    def gamma_candidates(self, site, alphas, *, part=None):
        a = alphas.numpy()
        return self._each(
            "gamma_candidates", site, part, alphas.shape,
            lambda k, s, g: np.stack(
                [np.asarray(jax.random.gamma(
                    k, jnp.asarray(a[g][..., c], jnp.float32)))
                 for c in range(a.shape[-1])], axis=-1))


class KeyNoise(JaxNoise):
    """Draws of one shard whose key IS ``key`` (no site or shard folding):
    a sampler called on its own, as the JAX sampler is called."""

    def _base(self, site):
        return 1, [self.key]


# ---------------------------------------------------------------------------
# the GIG and inverse-Gaussian samplers on JAX's variates
# ---------------------------------------------------------------------------

N_GIG = 2048


def _gig_params(case):
    rng = np.random.default_rng(len(case))
    p = {"neg": -1.7, "zero": 0.0, "pos": 2.5, "dl_phi": -0.5,
         "dl_tau": -4.0}[case]
    a = rng.uniform(0.2, 3.0, N_GIG).astype(np.float32)
    b = rng.uniform(0.05, 5.0, N_GIG).astype(np.float32)
    if case == "dl_phi":            # b -> 0: loadings at the |theta| clamp
        b[: N_GIG // 4] = 2e-8
        a[:] = 1.0
    return p, a, b


@pytest.mark.parametrize("case", ["neg", "zero", "pos", "dl_phi", "dl_tau"])
def test_gig_matches_jax_on_its_variates(case):
    """Orders p < 0, 0 and > 0, b -> 0, the DL conditionals' regimes:
    the port's 64 vectorised rounds give the JAX loop's value."""
    p, a, b = _gig_params(case)
    key = jax.random.key(3)
    ref = np.asarray(jgig.gig(key, jnp.full((N_GIG,), p), jnp.asarray(a),
                              jnp.asarray(b)))
    out = tgig.gig(KeyNoise(key, 1), 0, torch.full((1, N_GIG), p),
                   torch.as_tensor(a)[None], torch.as_tensor(b)[None])[0]
    # the same variates and the same arithmetic; XLA's and torch's cosh,
    # expm1 and log differ in the last bits, which moves the accepted
    # value by a few ulps (measured max rel. diff 1.04e-6 over five keys
    # of each case, 4.3e-7 but for b -> 0) and could flip an acceptance
    # that sits on its threshold (none did).  1e-5 keeps 10x headroom
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=0)


def test_gig_element_exhausting_every_round_matches_jax(monkeypatch):
    """An element no round accepts keeps the loop's initial zero in
    log-space: forced in both packages by W = 1 for element 5 in every
    round (W * hat <= exp(psi) then fails wherever psi(cand) < 0)."""
    p, a, b = _gig_params("neg")
    key = jax.random.key(4)
    real_uniform = jax.random.uniform
    calls = []

    def forced_uniform(k, shape=(), dtype=jnp.float32, minval=0.0,
                       maxval=1.0):
        u = real_uniform(k, shape, dtype, minval, maxval)
        calls.append(1)
        if len(calls) % 3 == 0:               # propose's third draw: W
            u = u.at[5].set(1.0)
        return u

    monkeypatch.setattr(jax.random, "uniform", forced_uniform)
    ref = np.asarray(jgig.gig(key, jnp.full((N_GIG,), p), jnp.asarray(a),
                              jnp.asarray(b)))
    monkeypatch.setattr(jax.random, "uniform", real_uniform)

    def force(kind, site, part, arr):
        if kind == "uniform" and part[-1] == (3, 2):
            arr = arr.copy()
            arr[0, :, 5] = 1.0
        return arr

    out = tgig.gig(KeyNoise(key, 1, force), 0, torch.full((1, N_GIG), p),
                   torch.as_tensor(a)[None], torch.as_tensor(b)[None])[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=0)
    # the element's value is the mode mapped back: exp(0) * mode, swapped
    lam, omega = abs(p), np.sqrt(float(a[5]) * float(b[5]))
    r = lam / omega
    mode = r + np.sqrt(1.0 + r * r)
    np.testing.assert_allclose(out[5].item(),
                               np.sqrt(b[5] / a[5]) / mode, rtol=1e-5)


@pytest.mark.parametrize("mu_scale", [1.0, 1e8])
def test_inverse_gaussian_matches_jax_on_its_variates(mu_scale):
    """Moderate means and huge ones (the DL psi update at the |theta|
    clamp): the cancellation-free root, finite and positive."""
    rng = np.random.default_rng(5)
    mu = (rng.uniform(0.1, 4.0, N_GIG) * mu_scale).astype(np.float32)
    key = jax.random.key(6)
    ref = np.asarray(jgig.inverse_gaussian(key, jnp.asarray(mu), 1.0))
    out = tgig.inverse_gaussian(KeyNoise(key, 1), 0,
                                torch.as_tensor(mu)[None], 1.0)[0].numpy()
    assert np.all(np.isfinite(out)) and np.all(out > 0)
    # elementwise float32 arithmetic in the same order: measured max rel.
    # diff 3.2e-7 over five keys of each scale; 3e-6 keeps 10x headroom
    np.testing.assert_allclose(out, ref, rtol=3e-6, atol=0)


def _gig_moment(p, a, b, k=1):
    w = np.sqrt(a * b)
    return (b / a) ** (k / 2) * special.kv(p + k, w) / special.kv(p, w)


@pytest.mark.parametrize("p,a,b", [(2.5, 3.0, 1.0), (-2.0, 1.0, 3.0),
                                   (-0.5, 1.0, 1e-4)])
def test_gig_matches_bessel_moments_on_torch_streams(p, a, b):
    """On the port's own Philox streams: E[X] and E[X^2] against the exact
    Bessel moments, within 6 Monte Carlo standard errors (as
    tests/test_gig.py holds the JAX sampler)."""
    n = 50_000
    draws = TorchNoise(7, "cpu").sweep(0, 0)
    x = tgig.gig(draws, 4, torch.full((1, n), p), a,  # dcfm-torch: ignore[DCFM301] - the Monte Carlo moments, in double on the host
                 torch.full((1, n), b))[0].double().numpy()
    assert np.all(x > 0) and np.all(np.isfinite(x))
    m1, m2, m4 = (_gig_moment(p, a, b, k) for k in (1, 2, 4))
    se1 = np.sqrt(max(m2 - m1 * m1, 1e-30) / n)
    se2 = np.sqrt(max(m4 - m2 * m2, 1e-30) / n)
    assert abs(x.mean() - m1) < max(6 * se1, 0.005 * abs(m1))
    assert abs(np.mean(x * x) - m2) < max(6 * se2, 0.01 * m2)


# ---------------------------------------------------------------------------
# one sweep, leaf by leaf, from the same state on JAX's draws
# ---------------------------------------------------------------------------

G, N, P, K = 3, 24, 10, 4
# shard 0 has column 2 dropped, shard 2 column 0; shard 1 keeps all four
MASK = np.array([[1, 1, 0, 1], [1, 1, 1, 1], [0, 1, 1, 1]], np.float32)


def _jax_state_to_numpy(s):
    return {"Lambda": np.asarray(s.Lambda), "Z": np.asarray(s.Z),
            "X": np.asarray(s.X), "ps": np.asarray(s.ps),
            "prior": {k: np.asarray(v) for k, v in s.prior.items()},
            "active": None if s.active is None else np.asarray(s.active)}


@functools.lru_cache(maxsize=None)
def _case(prior: str, sse_mode: str, masked: bool, lambda_kernel: str,
          df: float = 3.0):
    """(Y, JAX cfg, jitted JAX sweep, state after 6 JAX sweeps from init;
    with ``masked`` the last 4 of them under MASK; ``df`` the MGP's)."""
    rng = np.random.default_rng(11)
    L = rng.standard_normal((G * P, 2)) / 2
    Y = (rng.standard_normal((N, 2)) @ L.T
         + 0.3 * rng.standard_normal((N, G * P)))
    Y = jpre.preprocess(Y.astype(np.float32), G, seed=0).data
    cfg = JModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                       prior=prior, sse_mode=sse_mode,
                       lambda_kernel=lambda_kernel, rank_adapt=masked,
                       mgp=JMGPConfig(df=df))
    jprior = jmake_prior(cfg)
    sweep = jax.jit(lambda k, y, s: jcond.gibbs_sweep(k, y, s, cfg, jprior))
    state = jstate.init_state(jax.random.key(1), jprior, num_local_shards=G,
                              n=N, P=P, K=K, as_=cfg.as_, bs=cfg.bs,
                              rank_adapt=masked)
    Yj = jnp.asarray(Y)
    for i in range(6):
        if masked and i == 2:
            m = jnp.asarray(MASK)
            state = state.replace(active=m,
                                  Lambda=state.Lambda * m[:, None, :])
        state, _ = sweep(jax.random.key(100 + i), Yj, state)
    return Y, cfg, sweep, _jax_state_to_numpy(state)


def _sweep_pairs(key, prior, sse_mode, masked=False, lambda_kernel=None,
                 df=3.0):
    kern = lambda_kernel or ("pallas-interpret" if sse_mode == "gram"
                             else "auto")
    Y, jcfg, jsweep, s0 = _case(prior, sse_mode, masked, kern, df)
    js = jstate.SamplerState(
        Lambda=jnp.asarray(s0["Lambda"]), Z=jnp.asarray(s0["Z"]),
        X=jnp.asarray(s0["X"]), ps=jnp.asarray(s0["ps"]),
        prior={k: jnp.asarray(v) for k, v in s0["prior"].items()},
        active=None if s0["active"] is None else jnp.asarray(s0["active"]))
    jnew, jsse = jsweep(key, jnp.asarray(Y), js)
    j = _jax_state_to_numpy(jnew)
    cfg = ModelConfig(num_shards=G, factors_per_shard=K, rho=0.8,
                      prior=prior, sse_mode=sse_mode, rank_adapt=masked,
                      lambda_kernel=kern.replace("-interpret", ""),
                      mgp=MGPConfig(df=df))
    ts, tsse = tcond.gibbs_sweep(JaxNoise(key, G), torch.as_tensor(Y),
                                 state_from_numpy(s0, "cpu"), cfg,
                                 make_prior(cfg))
    t = state_to_numpy(ts)
    pairs = [(leaf, t[leaf], j[leaf]) for leaf in ("Z", "X", "Lambda", "ps")]
    pairs += [(leaf, t["prior"][leaf], j["prior"][leaf])
              for leaf in sorted(j["prior"])]
    pairs.append(("sse", tsse.numpy(), np.asarray(jsse)))
    if masked:
        pairs.append(("active", t["active"], j["active"]))
    return pairs


# Same state, same draws, same math: float32 rounding differs (LAPACK vs
# XLA solves, summation orders, XLA's vs torch's transcendentals) and
# compounds through Z -> X -> eta -> Lambda -> prior -> psi.  Measured over
# 20 iteration keys of each case below: every leaf within 9.3e-6 of its
# largest |entry| (nu, then ps), and the strictly positive prior leaves
# (horseshoe lam2, nu, tau2, xi; DL psi, tau; MGP delta, psijh) within
# 9.5e-6 elementwise relative - those span many decades (lam2 and nu run
# from 1e-30 to 1e30), so they are held elementwise, not by their scale.
# DL phi is held by its scale: its entries at the clamp follow |Lambda|
# entries that cancel to ~0, up to 3.7e-3 relative but 3.3e-6 of the
# scale.  1e-4 keeps 10x headroom both ways.
TOL = 1e-4
_ELEMENTWISE = {"lam2", "nu", "tau2", "xi", "psi", "tau", "delta", "psijh"}


def _assert_pairs(pairs):
    for leaf, a, b in pairs:
        if leaf == "active":
            np.testing.assert_array_equal(a, b, err_msg=leaf)
        elif leaf in _ELEMENTWISE:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=0, err_msg=leaf)
        else:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=TOL * float(np.max(np.abs(b))),
                err_msg=leaf)


@pytest.mark.parametrize("prior", ["horseshoe", "dl"])
@pytest.mark.parametrize("sse_mode", ["resid", "gram"])
def test_one_sweep_matches_jax_leaf_by_leaf(prior, sse_mode):
    _assert_pairs(_sweep_pairs(jax.random.key(7), prior, sse_mode))


@pytest.mark.parametrize("prior,df", [("mgp", 3.0), ("mgp", 2.5),
                                      ("horseshoe", 3.0), ("dl", 3.0)])
def test_one_masked_sweep_matches_jax_leaf_by_leaf(prior, df):
    """A column mask with dropped columns: eta masked before the Lambda
    moments (and the Gram SSE), Lambda zeroed after the solve, the
    priors' column-counting shapes from the candidate tables (the MGP
    delta's; at a non-integer df its psi shape df/2 + active/2 too), DL's
    prior redraws of inactive coordinates."""
    pairs = _sweep_pairs(jax.random.key(8), prior, "gram", masked=True,
                         df=df)
    _assert_pairs(pairs)
    lam = dict((leaf, a) for leaf, a, _ in pairs)["Lambda"]
    assert np.all(lam[MASK[:, None, :].repeat(P, 1) == 0] == 0)


def test_one_masked_fused_sweep_matches_jax_leaf_by_leaf():
    """The fused Lambda update (K2's plain version against the Pallas
    kernel in interpret mode) with a mask: the masked E enters the
    kernel's in-kernel Q."""
    _assert_pairs(_sweep_pairs(jax.random.key(9), "horseshoe", "gram",
                               masked=True,
                               lambda_kernel="pallas-fused-interpret"))


def test_interop_round_trip_is_exact_for_every_prior():
    for prior in ("horseshoe", "dl"):
        _, _, _, s0 = _case(prior, "gram", True, "pallas-interpret")
        back = state_to_numpy(state_from_numpy(s0, "cpu"))
        for leaf in ("Lambda", "Z", "X", "ps", "active"):
            np.testing.assert_array_equal(back[leaf], s0[leaf])
        for leaf in s0["prior"]:
            np.testing.assert_array_equal(back["prior"][leaf],
                                          s0["prior"][leaf])


def test_config_mirrors_jax_scenario_defaults():
    """The scenario configs have the JAX package's fields and defaults."""
    import dataclasses

    from dcfm_tpu import config as jc

    from dcfm_tpu_torch import config as tc
    for name in ("HorseshoeConfig", "DLConfig", "AdaptConfig"):
        assert (dataclasses.asdict(getattr(tc, name)())
                == dataclasses.asdict(getattr(jc, name)())), name
    assert AdaptConfig() == AdaptConfig(**dataclasses.asdict(JAdaptConfig()))
