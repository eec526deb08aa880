"""Rank-normalised effective sample size and split R-hat, for the ESS/s
metric that a later benchmark PR adds (PERF.md, Open questions); no
metric reads them yet.

A frozen copy of ``_autocov``, ``effective_sample_size``, ``split_rhat``,
``rank_normalize``, ``rank_normalized_ess`` and ``rank_normalized_rhat``
of ``bayesfmmm_torch/diagnostics.py`` at commit 29f7e3a7 (NumPy and
SciPy).
"""

from __future__ import annotations

import numpy as np


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
