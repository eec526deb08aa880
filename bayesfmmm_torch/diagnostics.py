"""MCMC diagnostics: effective sample size, split-R-hat, acceptance tracking.

The reference has no diagnostics beyond the rolling log-likelihood print
(BFMMM.h:870-875); ESS/R-hat are computed externally in R (coda/posterior).
Here they are first-class, NumPy host-side: they run on stacked trace
outputs, not in the device hot path.

The port's own copy of ``bayesfmmm_tpu/diagnostics.py`` (NumPy and SciPy
only); ``tests/test_torch_api.py`` holds the two equal on shared inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "split_rhat", "rank_normalize",
           "rank_normalized_ess", "rank_normalized_rhat", "summarize_chains"]


def _autocov(x):
    """Biased autocovariance per lag via FFT.  x: (draws,)."""
    n = len(x)
    x = x - x.mean()
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def effective_sample_size(draws: np.ndarray) -> float:
    """ESS with Geyer's initial monotone positive sequence.

    draws: (n_chains, n_draws) or (n_draws,) for one chain.
    Matches the estimator used by posterior::ess_basic up to the
    multi-chain variance correction.
    """
    draws = np.atleast_2d(np.asarray(draws, dtype=np.float64))
    m, n = draws.shape
    if n < 4:
        return float(m * n)
    acov = np.stack([_autocov(draws[i]) for i in range(m)])
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += draws.mean(axis=1).var(ddof=1)
    if var_plus == 0:
        return float(m * n)

    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus
    # Geyer pairs
    t = 1
    pair_sums = []
    while t + 1 < n:
        s = rho[t] + rho[t + 1]
        if s < 0:
            break
        pair_sums.append(s)
        t += 2
    # enforce monotone decrease
    for i in range(1, len(pair_sums)):
        pair_sums[i] = min(pair_sums[i], pair_sums[i - 1])
    tau = 1.0 + 2.0 * sum(pair_sums)
    return float(m * n / max(tau, 1e-12))


def split_rhat(draws: np.ndarray) -> float:
    """Split-chain potential scale reduction factor (Gelman-Rubin)."""
    draws = np.atleast_2d(np.asarray(draws, dtype=np.float64))
    m, n = draws.shape
    half = n // 2
    splits = np.concatenate([draws[:, :half], draws[:, half:2 * half]], axis=0)
    sm, sn = splits.shape
    chain_means = splits.mean(axis=1)
    chain_vars = splits.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = sn * chain_means.var(ddof=1)
    var_plus = (sn - 1.0) / sn * W + B / sn
    if W == 0:
        return 1.0
    return float(np.sqrt(var_plus / W))


def rank_normalize(draws: np.ndarray) -> np.ndarray:
    """Rank-normalize pooled draws (Vehtari et al. 2021): replace values by
    normal quantiles of their fractional ranks, making ESS/R-hat robust to
    heavy tails and nonlinear scale."""
    from scipy.special import ndtri
    draws = np.asarray(draws, dtype=np.float64)
    flat = draws.ravel()
    ranks = np.argsort(np.argsort(flat)) + 1.0
    z = ndtri((ranks - 0.375) / (flat.size + 0.25))
    return z.reshape(draws.shape)


def rank_normalized_ess(draws: np.ndarray) -> float:
    return effective_sample_size(rank_normalize(draws))


def rank_normalized_rhat(draws: np.ndarray) -> float:
    """Max of rank-normalized split-Rhat on draws and on folded draws
    (|x - median|), per the posterior package's rhat."""
    draws = np.atleast_2d(draws)
    z = rank_normalize(draws)
    folded = rank_normalize(np.abs(draws - np.median(draws)))
    return max(split_rhat(z), split_rhat(folded))


def summarize_chains(trace: np.ndarray, max_params: int = 64) -> dict:
    """ESS / R-hat over a (n_chains, n_draws, ...) parameter trace.

    Returns min/median ESS and max R-hat over a subsample of scalar
    components (capped at `max_params` for speed).
    """
    trace = np.asarray(trace)
    m, n = trace.shape[0], trace.shape[1]
    flat = trace.reshape(m, n, -1)
    k = flat.shape[2]
    idx = np.linspace(0, k - 1, min(k, max_params)).astype(int)
    ess = np.array([effective_sample_size(flat[:, :, j]) for j in idx])
    rhat = np.array([split_rhat(flat[:, :, j]) for j in idx])
    return {
        "ess_min": float(ess.min()),
        "ess_median": float(np.median(ess)),
        "rhat_max": float(rhat.max()),
    }
