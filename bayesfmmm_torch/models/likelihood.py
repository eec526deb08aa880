"""Model log-likelihood (port of ``bayesfmmm_tpu/models/likelihood.py``).

Reference: calcLikelihood (CalculateLikelihood.h:19-44).  Every function
returns one value per chain.
"""

from __future__ import annotations

import math

import torch

from bayesfmmm_torch.ops.mean import (compute_mu, effective_coeffs,
                                      rss_from_coeffs)

_LOG_2PI = math.log(2.0 * math.pi)


def model_mean(state, data):
    """Full model mean mu (C, N, L), zero at padded points."""
    return compute_mu(data, state)


def log_likelihood(state, data):
    """Total Gaussian log likelihood per chain (C,); the RSS is taken in
    residual space (kernel K2 on CUDA)."""
    rss = rss_from_coeffs(data, effective_coeffs(state, data.X))
    return (-0.5 * data.n_obs * (_LOG_2PI + torch.log(state.sigma2))
            - 0.5 * rss / state.sigma2)
