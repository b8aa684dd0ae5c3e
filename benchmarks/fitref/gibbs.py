"""The plain reference of a fit: the divide-and-conquer factor model's
Gibbs sampler (Sabnis et al., arXiv:1612.02875) written out in plain
PyTorch and NumPy, from the model's equations.

It imports nothing of the program and takes nothing the program made:
given the data ``Y``, the configuration's model and schedule and the run
seed, it preprocesses ``Y``, draws every variate from the seed
(:mod:`fitref.streams`, the documented recipe), runs the chains sweep by sweep
and accumulates the posterior-mean covariance panels of the saved draws.
Fed the same seed, its chains and the program's consume the same
variates, so the two posterior means differ by rounding alone, and a
precision or a step that departs shows as a gap far above it.

Per shard m: Y_m = eta_m Lambda_m' + eps_m, eps ~ N(0, diag(1/ps_m)),
eta_m = sqrt(rho) X + sqrt(1 - rho) Z_m with X shared by the shards.  A
sweep draws Z, X, Lambda (row by row, K x K Gaussian in precision form),
the shrinkage prior (a ``Prior`` record: MGP or horseshoe here, another
file's own), then ps from the Gram moments; under adaptive rank
truncation a coin decides after each burn-in sweep whether each shard
drops its redundant loading columns.  A saved draw
adds Lam_r H_rc Lam_c' (H_rc = eta_r' eta_c / n), plus diag(1/ps_r) on
the diagonal pairs, to every upper shard pair's panel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fitref.streams import (
    SITE_ADAPT, SITE_LAM, SITE_PRIOR, SITE_PS, SITE_X, SITE_Z, ChainStreams)

_HS_TINY, _HS_HUGE, _HS_MAX_PRECISION = 1e-30, 1e30, 1e12


@dataclasses.dataclass
class Prepared:
    """The data in shard coordinates and the maps back to the caller's."""
    data: np.ndarray        # (g, n, P) standardized float32
    perm: np.ndarray        # shard position -> kept column (>= p_kept: pad)
    col_scale: np.ndarray   # (g, P) float32
    kept_cols: np.ndarray
    p_original: int

    @property
    def p_kept(self) -> int:
        return int(self.kept_cols.size)

    def out_map(self) -> np.ndarray:
        """Shard position -> caller column, -1 for padding."""
        perm = self.perm
        out = np.full(perm.size, -1, np.int64)
        real = perm < self.p_kept
        out[real] = self.kept_cols[perm[real]]
        return out


def prepare(Y: np.ndarray, g: int, seed: int) -> Prepared:
    """Drop all-zero columns, pad to a multiple of g with standard normal
    columns, permute the columns (both from ``default_rng(seed)``, the
    pad first), split into g shards and standardize each column (mean 0,
    unit sample variance)."""
    n, p = Y.shape
    kept = np.flatnonzero(np.any(Y != 0, axis=0))
    Yk = Y[:, kept].astype(np.float32)
    rng = np.random.default_rng(seed)
    pad = (-kept.size) % g
    if pad:
        Yk = np.concatenate(
            [Yk, rng.standard_normal((n, pad)).astype(np.float32)], axis=1)
    P = Yk.shape[1] // g
    perm = rng.permutation(Yk.shape[1])
    data = np.ascontiguousarray(
        Yk[:, perm].reshape(n, g, P).transpose(1, 0, 2))
    mean = data.mean(axis=1)
    scale = np.sqrt(np.maximum(data.var(axis=1, ddof=1), 1e-12))
    data = (data - mean[:, None, :]) / scale[:, None, :]
    return Prepared(data.astype(np.float32), perm, scale.astype(np.float32),
                    kept, p)


# -- Gamma variates (rate convention) --------------------------------------

def gamma_static(st: ChainStreams, site: int, shape: float, out_shape):
    """Gamma(shape, 1) at a static shape: Exp(1) for shape 1, half a
    chi-square for the other half-integers up to 2, standard-Gamma
    variates otherwise."""
    tw = 2.0 * shape
    if float(tw).is_integer() and 0 < shape <= 2:
        if int(tw) == 2:
            return st.exponential(site, out_shape)
        z = st.normal(site, tuple(out_shape) + (int(tw),))
        return 0.5 * torch.sum(z * z, dim=-1)
    alpha = torch.full(tuple(out_shape), shape, dtype=torch.float32,
                       device=st.device)
    return st.standard_gamma(site, alpha)


def gamma_large(st: ChainStreams, site: int, shape: float, out_shape):
    """Gamma(shape, 1) at a large static shape m or m + 1/2 (m <= 1024):
    the sum of m Exp(1) variates plus z^2 / 2."""
    m = int(math.floor(shape + 1e-9))
    frac = shape - m
    half = abs(frac - 0.5) < 1e-9
    if (frac > 1e-9 and not half) or m > 1024:
        return gamma_static(st, site, shape, out_shape)
    g = torch.zeros(tuple(out_shape), dtype=st.dtype, device=st.device)
    if m:
        g = torch.sum(st.exponential(site, tuple(out_shape) + (m,)), dim=-1)
    if half:
        z = st.normal(site, out_shape)
        g = g + 0.5 * z * z
    return g


# -- Gaussians in precision form -------------------------------------------

def gaussian_rows(Q, B, Zn):
    """Rows x ~ N(Q^{-1} b, Q^{-1}), x = L^{-T} (L^{-1} b + z), Q = L L';
    Q (..., K, K), B and Zn (..., m, K)."""
    L = torch.linalg.cholesky(0.5 * (Q + Q.transpose(-1, -2)))
    v = torch.linalg.solve_triangular(L, B.transpose(-1, -2), upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2),
                                      v + Zn.transpose(-1, -2), upper=True)
    return x.transpose(-1, -2)


# -- priors ------------------------------------------------------------------
#
# Every state leaf carries a leading chain axis C, then the shard axis G;
# the draws (``ChainStreams``) stack each chain's variates on it.

@dataclasses.dataclass(frozen=True)
class Prior:
    """A shrinkage prior on the loadings, as the chain uses it:

    * ``init(model, st, G, P, K) -> dict``: the prior's initial state,
      drawn from the init streams;
    * ``update(model, st, pr, Lam, active) -> dict``: its state redrawn
      given the new loadings ``Lam`` (C, G, P, K) and the active columns
      (C, G, K), or None without adaptation;
    * ``row_precision(model, pr) -> Tensor``: the (C, G, P, K) prior
      precisions of the loadings, the diagonal of each row's precision.

    A reference for another prior defines its own record and hands it to
    :func:`posterior_mean`."""
    init: object
    update: object
    row_precision: object


def _mgp_init(model: dict, st: ChainStreams, G: int, P: int,
              K: int) -> dict:
    c = model["mgp"]
    psijh = gamma_static(st, SITE_PRIOR, c["df"] / 2,
                         (G, P, K)) / (c["df"] / 2)
    d1 = gamma_static(st, SITE_PRIOR, c["ad1"], (G, 1)) / c["bd1"]
    dh = gamma_static(st, SITE_PRIOR, c["ad2"], (G, K - 1)) / c["bd2"]
    return {"psijh": psijh, "delta": torch.cat([d1, dh], dim=-1)}


def _mgp_row_precision(model: dict, pr: dict) -> torch.Tensor:
    return pr["psijh"] * torch.cumprod(pr["delta"], dim=-1)[..., None, :]


def _mgp_update(model: dict, st: ChainStreams, pr: dict, Lam,
                active) -> dict:
    C, G, P, K = Lam.shape
    dev = Lam.device
    lam_sq = Lam * Lam
    c = model["mgp"]
    df = float(c["df"])
    if not (df.is_integer() and df <= 7):
        raise NotImplementedError("MGP df must be an integer <= 7")
    tau = torch.cumprod(pr["delta"], dim=-1)
    rate = df / 2 + 0.5 * tau[..., None, :] * lam_sq
    # Gamma((df + a_h) / 2): half the sum of df + a_h squared normals,
    # a_h = 1 for an active column, 0 for a dropped one
    z = st.normal(SITE_PRIOR, (G, P, K, int(df) + 1))
    used = torch.full(lam_sq.shape, int(df) + 1, device=dev)
    if active is not None:
        used = int(df) + active[..., None, :].expand_as(lam_sq).long()
    keep = torch.arange(int(df) + 1, device=dev) < used[..., None]
    psijh = 0.5 * torch.sum(torch.where(keep, z * z, 0.0), dim=-1) / rate
    s = torch.sum(psijh * lam_sq, dim=-2)                        # (C, G, K)
    hs = torch.arange(K, device=dev)
    base = torch.where(hs == 0, c["ad1"], c["ad2"]).float()
    rates0 = torch.where(hs == 0, c["bd1"], c["bd2"]).to(Lam.dtype)
    if active is None:
        n_ge = torch.arange(K, 0, -1, device=dev).float()
        g_std = st.standard_gamma(
            SITE_PRIOR, (base + 0.5 * P * n_ge).expand(G, K))
    else:
        n_ge = torch.flip(torch.cumsum(torch.flip(active, [-1]), -1), [-1])
        counts = torch.arange(K + 1, device=dev).float()
        table = st.standard_gamma(SITE_PRIOR, (
            base[:, None] + 0.5 * P * counts).expand(G, K, K + 1))
        g_std = torch.gather(table, -1, n_ge.long()[..., None])[..., 0]
    delta = pr["delta"].clone()
    for h in range(K):
        tau_minus = torch.cumprod(delta, dim=-1) / delta[..., h:h + 1]
        rate_h = rates0[h] + 0.5 * torch.sum(
            (hs >= h).to(Lam.dtype) * tau_minus * s, dim=-1)
        delta[..., h] = g_std[..., h] / rate_h
    return {"psijh": psijh, "delta": delta}


# horseshoe, Makalic & Schmidt's auxiliaries: every conditional is an
# inverse Gamma, 1 / Gamma(shape, rate)

def _hs_init(model: dict, st: ChainStreams, G: int, P: int,
             K: int) -> dict:
    def ones(*shape):
        return torch.ones((st.chains,) + shape, dtype=st.dtype,
                          device=st.device)
    return {"lam2": ones(G, P, K), "nu": ones(G, P, K), "tau2": ones(G),
            "xi": ones(G)}


def _hs_row_precision(model: dict, pr: dict) -> torch.Tensor:
    return 1.0 / torch.clamp(pr["lam2"] * pr["tau2"][..., None, None],
                             1.0 / _HS_MAX_PRECISION, _HS_MAX_PRECISION)


def _hs_update(model: dict, st: ChainStreams, pr: dict, Lam,
               active) -> dict:
    C, G, P, K = Lam.shape
    dev = Lam.device
    lam_sq = Lam * Lam
    s2 = float(model["horseshoe"]["global_scale"]) ** 2
    tau2 = pr["tau2"]
    lam2 = torch.clamp(
        (1.0 / pr["nu"] + 0.5 * lam_sq / tau2[..., None, None])
        / st.exponential(SITE_PRIOR, (G, P, K)), _HS_TINY, _HS_HUGE)
    nu = torch.clamp((1.0 + 1.0 / lam2)
                     / st.exponential(SITE_PRIOR, (G, P, K)),
                     _HS_TINY, _HS_HUGE)
    rate = 1.0 / pr["xi"] + 0.5 * torch.sum(lam_sq / lam2, dim=(-2, -1))
    if active is None:
        g = st.standard_gamma(SITE_PRIOR, torch.full(
            (G,), 0.5 * (P * K + 1), device=dev))
    else:
        counts = torch.arange(K + 1, device=dev).float()
        table = st.standard_gamma(SITE_PRIOR,
                                  (0.5 * (P * counts + 1)).expand(G, K + 1))
        g = torch.gather(table, -1,
                         torch.sum(active, dim=-1).long()[..., None])[..., 0]
    tau2 = torch.clamp(rate / g, _HS_TINY, _HS_HUGE)
    xi = torch.clamp((1.0 / s2 + 1.0 / tau2)
                     / st.exponential(SITE_PRIOR, (G,)), _HS_TINY, _HS_HUGE)
    return {"lam2": lam2, "nu": nu, "tau2": tau2, "xi": xi}


MGP = Prior(_mgp_init, _mgp_update, _mgp_row_precision)
HORSESHOE = Prior(_hs_init, _hs_update, _hs_row_precision)
PRIORS = {"mgp": MGP, "horseshoe": HORSESHOE}


# -- the chain -----------------------------------------------------------------

@dataclasses.dataclass
class State:
    Lam: torch.Tensor       # (C, G, P, K)
    Z: torch.Tensor         # (C, G, n, K)
    X: torch.Tensor         # (C, n, K)
    ps: torch.Tensor        # (C, G, P)
    prior: dict
    active: object          # (C, G, K) 0/1, or None without adaptation


def init_state(model: dict, prior: Prior, st: ChainStreams, G: int, n: int,
               P: int, K: int) -> State:
    X = st.normal(SITE_X, (n, K))
    ps = gamma_static(st, SITE_PS, model["as_"], (G, P)) / model["bs"]
    Z = st.normal(SITE_Z, (G, n, K))

    def full(value, *shape):
        return torch.full((st.chains,) + shape, value, dtype=st.dtype,
                          device=st.device)
    return State(full(0.0, G, P, K), Z, X, ps,
                 prior.init(model, st, G, P, K),
                 full(1.0, G, K) if model["rank_adapt"] else None)


def sweep(model: dict, prior: Prior, st: ChainStreams, Y: torch.Tensor,
          yty: torch.Tensor, s: State, it: int, burnin: int) -> State:
    """One Gibbs sweep of every chain, making 1-based iteration ``it``,
    then the rank adaptation after it."""
    G, n, P = Y.shape
    C, K = s.Lam.shape[0], s.Lam.shape[-1]
    rho = float(model["rho"])
    a, b = math.sqrt(rho), math.sqrt(1.0 - rho)
    eye = torch.eye(K, dtype=Y.dtype, device=Y.device)
    Lam, ps = s.Lam, s.ps
    W = Lam * ps[..., None]
    LtW = Lam.mT @ W                                         # (C, G, K, K)

    R = Y - a * (s.X[:, None] @ Lam.mT)
    Z = gaussian_rows(eye + (1.0 - rho) * LtW, b * (R @ W),
                      st.normal(SITE_Z, (G, n, K)))

    R = Y - b * (Z @ Lam.mT)
    Qx = float(model["x_prior_precision"]) * eye + rho * LtW.sum(dim=-3)
    X = gaussian_rows(Qx, a * (R @ W).sum(dim=-3), st.normal(SITE_X, (n, K)))

    eta = a * X[:, None] + b * Z                             # (C, G, n, K)
    if s.active is not None:
        eta = eta * s.active[..., None, :]
    E = eta.mT @ eta                                         # (C, G, K, K)
    EYt = (eta.mT @ Y).mT                                    # (C, G, P, K)
    Q = (torch.diag_embed(prior.row_precision(model, s.prior))
         + ps[..., None, None] * E[..., None, :, :])
    Lam = gaussian_rows(Q.reshape(-1, K, K),
                        (ps[..., None] * EYt).reshape(-1, 1, K),
                        st.normal(SITE_LAM, (G, P, K)).reshape(-1, 1, K)
                        ).reshape(C, G, P, K)
    if s.active is not None:
        Lam = Lam * s.active[..., None, :]

    pr = prior.update(model, st, s.prior, Lam, s.active)

    # ps_j ~ Gamma(as + n/2, bs + SSE_j / 2), SSE from the Gram moments
    sse = torch.clamp(yty - 2.0 * torch.sum(Lam * EYt, dim=-1)
                      + torch.sum(Lam * (Lam @ E), dim=-1), min=0.0)
    g = gamma_large(st, SITE_PS, model["as_"] + 0.5 * n, (G, P))
    ps = g / (model["bs"] + 0.5 * sse)
    out = State(Lam, Z, X, ps, pr, s.active)
    if s.active is not None:
        out = adapt(model, st, out, it, burnin)
    return out


def adapt(model: dict, st: ChainStreams, s: State, it: int, burnin: int):
    """Bhattacharya and Dunson's adaptive truncation: with probability
    exp(a0 + a1 it) - one coin a chain - during burn-in, each shard drops
    the active columns with at least ``prop`` of their |loadings| below
    ``eps`` (never below ``min_active``), or with none redundant restores
    its first dropped column."""
    c = model["adapt"]
    K = s.active.shape[-1]
    dtype = s.Lam.dtype
    # the coin in float32, as drawn
    u = st.uniform(SITE_ADAPT, ()).float()                   # (C,)
    t = torch.full((), float(it), device=s.Lam.device)
    do = (u < torch.exp(c["a0"] + c["a1"] * t)) & (it <= burnin)
    act = s.active > 0
    small = (torch.abs(s.Lam) < c["eps"]).to(dtype).mean(dim=-2)
    red = (small >= c["prop"]) & act
    n_red, n_act = red.sum(dim=-1), act.sum(dim=-1)          # (C, G)
    dropped = torch.where(((n_act - n_red) >= c["min_active"])[..., None],
                          s.active * (~red).to(dtype), s.active)
    first = torch.argmax((~act).to(torch.uint8), dim=-1)
    one = (torch.arange(K, device=act.device) == first[..., None]).to(dtype)
    grown = torch.clamp(s.active + one * (n_act < K)[..., None].to(dtype),
                        0.0, 1.0)
    active = torch.where((n_red > 0)[..., None], dropped, grown)
    active = torch.where(do[:, None, None], active, s.active)
    return dataclasses.replace(s, active=active,
                               Lam=s.Lam * active[..., None, :])


def upper_pairs(g: int) -> tuple:
    r, c = np.triu_indices(g)
    return r, c


def add_panels(acc: torch.Tensor, s: State, rho: float, rows, cols,
               block: int) -> None:
    """acc[q] += Lam_r H_rc Lam_c' (+ diag(1/ps_r) where r == c) for every
    upper pair q = (r, c) and every chain, H_rc = eta_r' eta_c / n."""
    n = s.X.shape[-2]
    for ch in range(s.Lam.shape[0]):
        Lam, ps = s.Lam[ch], s.ps[ch]
        eta = math.sqrt(rho) * s.X[ch][None] + math.sqrt(1.0 - rho) * s.Z[ch]
        H = torch.einsum("rnk,cnj->rckj", eta, eta) / n
        for q0 in range(0, rows.numel(), block):
            r, c = rows[q0:q0 + block], cols[q0:q0 + block]
            part = acc[q0:q0 + block]
            part.baddbmm_(Lam[r] @ H[r, c], Lam[c].mT)
            part.diagonal(dim1=-2, dim2=-1).add_(
                (r == c).to(ps.dtype)[:, None] / ps[r])


def check_supported(model: dict, n: int) -> None:
    """The model this reference writes out: the scaled combine, the Gram
    SSE, float32 products and no knob that changes the chain; anything
    else is refused by name rather than answered wrongly."""
    want = {"estimator": "scaled", "compute_dtype": "f32",
            "combine_dtype": "float32", "posterior_sd": False,
            "impute_missing": False, "ridge_jitter": 0.0}
    for key, value in want.items():
        if model.get(key, value) != value:
            raise NotImplementedError(f"the reference has no {key}="
                                      f"{model[key]!r}")
    mode = model.get("sse_mode", "gram")
    if not (mode == "gram" or (mode == "auto"
                               and n >= int(model["factors_per_shard"]))):
        raise NotImplementedError("the reference draws ps from the Gram "
                                  "moments only (sse_mode gram, or auto "
                                  "with n >= K)")


def posterior_mean(Y: np.ndarray, model: dict, schedule: dict, seed: int,
                   chains: int, device, *, dtype=torch.float32,
                   block: int = 4096, prior: Prior | None = None):
    """The fit's posterior-mean panels: ``(panels, prepared)`` with panels
    (g(g+1)/2, P, P) on ``device``, upper shard pairs in
    ``np.triu_indices`` order, standardized shard coordinates, computed
    in ``dtype`` (the variates drawn in float32 either way).  ``prior``
    is the shrinkage prior's record; None picks the one of ``PRIORS``
    that ``model["prior"]`` names, and refuses any other name."""
    check_supported(model, Y.shape[0])
    if prior is None:
        if model["prior"] not in PRIORS:
            raise NotImplementedError(f"prior {model['prior']!r}")
        prior = PRIORS[model["prior"]]
    g, K = int(model["num_shards"]), int(model["factors_per_shard"])
    burnin, mcmc, thin = (int(schedule[k]) for k in ("burnin", "mcmc",
                                                     "thin"))
    prep = prepare(Y, g, seed)
    Yd = torch.as_tensor(prep.data, device=device).to(dtype)
    G, n, P = Yd.shape
    yty = torch.sum(Yd * Yd, dim=1)
    r, c = upper_pairs(g)
    rows = torch.as_tensor(r, device=device)
    cols = torch.as_tensor(c, device=device)
    acc = torch.zeros((r.size, P, P), dtype=dtype, device=device)
    s = init_state(model, prior,
                   ChainStreams.init(seed, chains, device, dtype), G, n, P, K)
    saved = 0
    for i in range(burnin + mcmc):
        it = i + 1
        s = sweep(model, prior,
                  ChainStreams.sweep(seed, chains, i, device, dtype), Yd, yty,
                  s, it, burnin)
        if it > burnin and (it - burnin) % thin == 0:
            add_panels(acc, s, float(model["rho"]), rows, cols, block)
            saved += chains
    acc /= max(saved, 1)
    return acc, prep
