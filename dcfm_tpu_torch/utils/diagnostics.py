"""Cross-chain convergence diagnostics: split-R-hat and effective sample size.

The port's copy of ``dcfm_tpu/utils/diagnostics.py`` (NumPy only): the
standard diagnostics (Gelman et al., BDA3 / Vehtari et al. 2021 split-R-hat;
Geyer initial-monotone-sequence ESS) on the scalar chain summaries of
``FitResult.traces``.  The inputs are tiny (num_chains x num_draws scalars)
and the diagnostics are post-processing, not chain work.
"""

from __future__ import annotations

import numpy as np


def split_rhat(draws: np.ndarray) -> float:
    """Split-R-hat of scalar draws, shape (num_chains, num_draws).

    Each chain is split in half (2C half-chains), then the classic
    potential-scale-reduction statistic sqrt((W(n-1)/n + B/n) / W) is
    computed over the half-chains.  Values near 1 indicate the chains agree;
    > ~1.01 (Vehtari et al. 2021) flags non-convergence.  NaN if fewer than
    4 draws per chain or zero variance everywhere.
    """
    x = np.asarray(draws, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    C, T = x.shape
    if T < 4:
        return float("nan")
    half = T // 2
    halves = np.concatenate([x[:, :half], x[:, T - half:]], axis=0)  # (2C, half)
    m, n = halves.shape
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    # W pools the 2C half-chain variances: the reduction IS the statistic
    W = chain_vars.mean()          # dcfm: ignore[DCFM1401]
    B = n * chain_means.var(ddof=1)
    if W <= 0:
        return float("nan") if B > 0 else 1.0
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W))


def _autocovariance(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance of a 1-D series at all lags, via FFT."""
    n = x.size
    xc = x - x.mean()
    m = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n].real / n
    return acov


def ess(draws: np.ndarray) -> float:
    """Effective sample size of scalar draws, shape (num_chains, num_draws).

    Multi-chain ESS per BDA3: combines within-chain autocovariances with the
    between-chain variance, truncating the correlation sum by Geyer's
    initial-monotone positive-pair-sum rule.  Returns C*T when draws are
    i.i.d.-like; small values flag slow mixing.
    """
    x = np.asarray(draws, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    C, T = x.shape
    if T < 4:
        return float("nan")
    acov = np.stack([_autocovariance(x[c]) for c in range(C)])  # (C, T)
    chain_means = x.mean(axis=1)
    mean_var = acov[:, 0].mean() * T / (T - 1)       # mean within-chain var
    var_plus = mean_var * (T - 1) / T
    if C > 1:
        var_plus += chain_means.var(ddof=1)
    if var_plus <= 0:
        return float(C * T)

    # rho_t = 1 - (W - mean autocov_t) / var_plus (BDA3 eq. 11.7)
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    # Geyer: sum consecutive pairs while the pair sums stay positive and
    # non-increasing (initial monotone sequence estimator).
    max_pairs = (T - 1) // 2
    tau = 0.0
    prev_pair = np.inf
    used_pairs = 0
    for k in range(max_pairs):
        pair = rho[2 * k] + rho[2 * k + 1]
        if pair <= 0:
            break
        pair = min(pair, prev_pair)
        tau += pair
        prev_pair = pair
        used_pairs += 1
    tau = max(2.0 * tau - 1.0, 1.0 / np.log10(max(C * T, 10)))
    return float(min(C * T / tau, C * T))
