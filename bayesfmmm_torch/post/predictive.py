"""Posterior predictive sample paths.

Reference: FSamplePaths (PostProcessing.cpp:6599-6860): per observation and
post-burn-in draw, the fitted mean at the observation's own time points
(including eta/xi covariate adjustments when present) plus N(0, sigma2)
noise; pointwise CIs of the noisy paths; the mean-only paths returned too.

The port's own copy of ``bayesfmmm_tpu/post/predictive.py``: the same
``default_rng(seed)`` stream, so both packages give the same paths from the
same traces (``tests/test_torch_post.py``).
"""

from __future__ import annotations

import numpy as np

from bayesfmmm_torch.post import host
from bayesfmmm_torch.post.model_selection import _means_all_draws, _tail

__all__ = ["sample_paths"]


def sample_paths(traces, data, *, alpha=0.05, burnin_prop=0.1, X=None,
                 seed=0):
    """Returns dict with SampPaths (draws, N, L), SampPaths_mean_only,
    CI_Lower/CI_50/CI_Upper (N, L), all masked on the padded grid."""
    tr = _tail(traces, burnin_prop)
    mu = _means_all_draws(tr, data, X)                  # (d, N, L)
    sig = host(tr["sigma2"]).reshape(-1, 1, 1)
    rng = np.random.default_rng(seed)
    mask = host(data.mask)[None]
    paths = (mu + np.sqrt(sig) * rng.normal(size=mu.shape)) * mask
    lo, med, hi = np.quantile(paths, [alpha / 2, 0.5, 1 - alpha / 2], axis=0)
    return {
        "SampPaths": paths,
        "SampPaths_mean_only": mu * mask,
        "CI_Lower": lo, "CI_50": med, "CI_Upper": hi,
    }
