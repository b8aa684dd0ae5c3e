"""Geweke joint-distribution test of the PyTorch port's Gibbs sweep.

The three cases of tests/test_reference_semantics.py's Geweke test (MGP,
horseshoe and Dirichlet-Laplace), run
through ``dcfm_tpu_torch.models.conditionals.gibbs_sweep``: moments of
independent prior draws (marginal-conditional) against the final states
of many short successive-conditional chains (Y | state, then state | Y by
the sweep), started from exact prior draws, so each chain is stationary
from its first step.  A wrong weighting, Cholesky orientation, shape or
rate, or cross-shard leakage in any conditional moves the successive
chains away from the prior and fails the z-test.  Same model, sizes,
statistics and z < 5 bound as the JAX test; the prior-state and Y
helpers are this file's own (NumPy), the sweep's draws the port's
TorchNoise streams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu_torch.config import ModelConfig  # noqa: E402
from dcfm_tpu_torch.models.conditionals import gibbs_sweep  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.models.state import SamplerState  # noqa: E402
from dcfm_tpu_torch.noise import TorchNoise  # noqa: E402

# the JAX test's tiny model: as=4 keeps E[1/ps] and Var[1/ps] finite
_G, _N, _P, _K, _RHO = 2, 6, 4, 2, 0.7
_AS, _BS = 4.0, 2.0


def _prior_state(rng, cfg) -> SamplerState:
    """A full state drawn from the prior (rate convention), with Lambda ~
    N(0, 1/row precision) instead of the chain's zero init."""
    c = cfg.mgp
    X = rng.standard_normal((_N, _K))
    ps = rng.gamma(_AS, 1.0 / _BS, (_G, _P))
    Z = rng.standard_normal((_G, _N, _K))
    psijh = rng.gamma(c.df / 2, 2.0 / c.df, (_G, _P, _K))
    delta = np.concatenate([rng.gamma(c.ad1, 1.0 / c.bd1, (_G, 1)),
                            rng.gamma(c.ad2, 1.0 / c.bd2, (_G, _K - 1))],
                           axis=1)
    plam = psijh * np.cumprod(delta, axis=1)[:, None, :]
    Lam = rng.standard_normal((_G, _P, _K)) / np.sqrt(plam)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return SamplerState(Lambda=f(Lam), Z=f(Z), X=f(X), ps=f(ps),
                        prior={"psijh": f(psijh), "delta": f(delta)})


def _sample_Y(rng, s: SamplerState) -> torch.Tensor:
    """Y | state: Y_m = eta_m Lam_m' + N(0, diag(1/ps_m))."""
    eta = np.sqrt(_RHO) * s.X.numpy()[None] + np.sqrt(1 - _RHO) * s.Z.numpy()
    mean = np.einsum("gnk,gpk->gnp", eta, s.Lambda.numpy())
    noise = rng.standard_normal(mean.shape) / np.sqrt(s.ps.numpy()[:, None])
    return torch.as_tensor(mean + noise, dtype=torch.float32)


_STATS = ("log_ps", "Z2", "X2", "log_psi", "log_delta", "lam2", "Y2")


def _stats(s: SamplerState, Y: torch.Tensor) -> list:
    return [float(torch.mean(torch.log(s.ps))), float(torch.mean(s.Z ** 2)),
            float(torch.mean(s.X ** 2)),
            float(torch.mean(torch.log(s.prior["psijh"]))),
            float(torch.mean(torch.log(s.prior["delta"]))),
            float(torch.mean(s.Lambda ** 2)), float(torch.mean(Y ** 2))]


@pytest.mark.slow
def test_port_geweke_joint_distribution():
    cfg = ModelConfig(num_shards=_G, factors_per_shard=_K, rho=_RHO,
                      as_=_AS, bs=_BS)
    prior = make_prior(cfg)
    M_MARG, R_CHAINS, T_STEPS = 6000, 3000, 40      # the JAX test's sizes
    torch.set_num_threads(1)

    rng = np.random.default_rng(0)
    marg = []
    for _ in range(M_MARG):
        s = _prior_state(rng, cfg)
        marg.append(_stats(s, _sample_Y(rng, s)))

    noise = TorchNoise(1, "cpu")
    succ = []
    for r in range(R_CHAINS):
        rng = np.random.default_rng([1, r])
        s = _prior_state(rng, cfg)
        for t in range(T_STEPS):
            s, _ = gibbs_sweep(noise.sweep(r, t), _sample_Y(rng, s), s, cfg,
                               prior)
        succ.append(_stats(s, _sample_Y(rng, s)))

    marg, succ = np.asarray(marg), np.asarray(succ)
    z = {}
    for i, name in enumerate(_STATS):
        se1 = marg[:, i].std(ddof=1) / np.sqrt(len(marg))
        se2 = succ[:, i].std(ddof=1) / np.sqrt(len(succ))
        z[name] = abs(marg[:, i].mean() - succ[:, i].mean()) / np.hypot(se1,
                                                                         se2)
    print("port Geweke z:", {k: round(v, 3) for k, v in z.items()})
    assert max(z.values()) < 5.0, z


def _scenario_prior_state(rng, cfg, prior) -> SamplerState:
    """A full state drawn from the horseshoe or DL prior (the JAX test's
    hierarchy draws: Makalic-Schmidt nu, xi ~ iG(1/2, 1), lam2 | nu ~
    iG(1/2, 1/nu), tau2 | xi ~ iG(1/2, 1/xi); DL psi ~ Exp(1/2), phi ~
    Dirichlet(a), tau ~ Gamma(K a, 1/2)), Lambda ~ N(0, 1/row precision)."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    X = rng.standard_normal((_N, _K))
    ps = rng.gamma(_AS, 1.0 / _BS, (_G, _P))
    Z = rng.standard_normal((_G, _N, _K))
    if cfg.prior == "horseshoe":
        nu = 1.0 / rng.gamma(0.5, 1.0, (_G, _P, _K))
        lam2 = 1.0 / rng.gamma(0.5, nu)
        xi = 1.0 / rng.gamma(0.5, 1.0, (_G,))
        tau2 = 1.0 / rng.gamma(0.5, xi)
        st = {"lam2": lam2, "nu": nu, "tau2": tau2, "xi": xi}
    else:
        a = cfg.dl.a
        d = rng.gamma(a, 1.0, (_G, _P, _K))
        st = {"psi": 2.0 * rng.exponential(1.0, (_G, _P, _K)),
              "phi": d / d.sum(axis=-1, keepdims=True),
              "tau": rng.gamma(_K * a, 2.0, (_G, _P))}
    st = {k: f(v) for k, v in st.items()}
    plam = prior.row_precision(st).double().numpy()
    Lam = rng.standard_normal((_G, _P, _K)) / np.sqrt(plam)
    return SamplerState(Lambda=f(Lam), Z=f(Z), X=f(X), ps=f(ps), prior=st)


def _scenario_stats(s: SamplerState, Y: torch.Tensor, prior: str) -> list:
    """The JAX test's functionals: the horseshoe's on the log scale (its
    half-Cauchy scales have no finite mean)."""
    m = lambda t: float(torch.mean(t.double()))  # noqa: E731
    out = [m(torch.log(s.ps)), m(s.Z ** 2), m(s.X ** 2)]
    if prior == "horseshoe":
        return out + [m(torch.log(s.prior[k]))
                      for k in ("lam2", "nu", "tau2", "xi")] + [
            m(torch.log(s.Lambda.double() ** 2)),
            m(torch.log(Y.double() ** 2))]
    return out + [m(torch.log(s.prior[k])) for k in ("psi", "phi", "tau")] \
        + [m(s.Lambda ** 2), m(Y ** 2)]


@pytest.mark.slow
@pytest.mark.parametrize("prior_name", ["horseshoe", "dl"])
def test_port_geweke_joint_distribution_scenario_priors(prior_name):
    """The horseshoe and DL cases of the JAX test through the port's
    sweep (its GIG rounds, inverse-Gaussian and inverse-gamma draws):
    the JAX test's sizes and z < 5 bound."""
    cfg = ModelConfig(num_shards=_G, factors_per_shard=_K, rho=_RHO,
                      as_=_AS, bs=_BS, prior=prior_name)
    prior = make_prior(cfg)
    M_MARG, R_CHAINS, T_STEPS = 6000, 3000, 40
    torch.set_num_threads(1)

    rng = np.random.default_rng(0)
    marg = []
    for _ in range(M_MARG):
        s = _scenario_prior_state(rng, cfg, prior)
        marg.append(_scenario_stats(s, _sample_Y(rng, s), prior_name))

    noise = TorchNoise(1, "cpu")
    succ = []
    for r in range(R_CHAINS):
        rng = np.random.default_rng([1, r])
        s = _scenario_prior_state(rng, cfg, prior)
        for t in range(T_STEPS):
            s, _ = gibbs_sweep(noise.sweep(r, t), _sample_Y(rng, s), s, cfg,
                               prior)
        succ.append(_scenario_stats(s, _sample_Y(rng, s), prior_name))

    marg, succ = np.asarray(marg), np.asarray(succ)
    z = []
    for i in range(marg.shape[1]):
        se1 = marg[:, i].std(ddof=1) / np.sqrt(len(marg))
        se2 = succ[:, i].std(ddof=1) / np.sqrt(len(succ))
        z.append(abs(marg[:, i].mean() - succ[:, i].mean())
                 / np.hypot(se1, se2))
    print(f"port Geweke z [{prior_name}]:", [round(float(v), 3) for v in z])
    assert max(z) < 5.0, z
