"""Posterior summaries: credible intervals for means, covariances, Z, sigma.

Reference: src/PostProcessing.cpp — FMeanCI (:99), FCovCI (:1781),
ZCI (:3505), SigmaCI (:3435), and the MV*/HDF* mirrors (which collapse here:
the family only changes the basis matrix handed in; pass B = I for the
multivariate model).

All functions operate on iteration-major in-memory traces (as produced by
samplers/drivers.py or io/armaio.load_trace_dir), vectorized NumPy on host —
summaries are IO-bound, not accelerator work.

The port's own copy of ``bayesfmmm_tpu/post/summaries.py``; traces and
bases may also be tensors on any device, which are moved to the host first.
``tests/test_torch_post.py`` holds the two equal on shared inputs.
"""

from __future__ import annotations

import numpy as np

from bayesfmmm_torch.post import host

__all__ = [
    "keep_tail", "rescale_transforms", "apply_transforms",
    "mean_ci", "cov_ci", "z_ci", "sigma_ci",
]


def keep_tail(arr: np.ndarray, burnin_prop: float) -> np.ndarray:
    """Keep the last round(total*(1-burnin_prop)) draws.

    Matches PostProcessing.cpp:158-163 (subcube from the end).
    """
    n = arr.shape[0]
    keep = int(round(n * (1.0 - burnin_prop)))
    return arr[n - keep:]


def rescale_transforms(Z_samp: np.ndarray) -> np.ndarray:
    """Per-draw identifiability transform from max-membership rows.

    PostProcessing.cpp:203-220: row i of T is the Z row of the observation
    with maximal membership in feature i — mapping the fit onto a
    parameterization where some observation belongs fully to each feature.
    The reference only allows this for K = 2 (:165-169); the same guard is
    enforced by callers here.

    Z_samp: (draws, N, K).  Returns (draws, K, K).
    """
    max_idx = np.argmax(Z_samp, axis=1)                  # (draws, K)
    d_idx = np.arange(Z_samp.shape[0])[:, None]
    return Z_samp[d_idx, max_idx, :]                     # (draws, K, K)


def apply_transforms(param_samp: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Apply per-draw transforms T to the feature axis (axis 1).

    nu: (draws, K, P) -> T @ nu per draw; Phi: (draws, K, P, M) -> applied
    per eigen-slice (PostProcessing.cpp:1922-1925).
    """
    if param_samp.ndim == 3:
        return np.einsum("dkj,djp->dkp", T, param_samp)
    if param_samp.ndim == 4:
        return np.einsum("dkj,djpm->dkpm", T, param_samp)
    raise ValueError("expected (draws, K, P[, M]) parameter trace")


def _resolve_transform(nu_or_phi, Z_samp, rescale, trans_mats):
    K = nu_or_phi.shape[1]
    if rescale and K > 2:
        # PostProcessing.cpp:165-169: rescale property only for K = 2; the
        # reference prints a console notice — warn rather than silently
        # disable.
        import warnings
        warnings.warn("Rescale property cannot be used for K > 2",
                      UserWarning, stacklevel=3)
        rescale = False
    if rescale:
        if Z_samp is None:
            raise ValueError("rescale=True requires the Z trace")
        T = rescale_transforms(Z_samp)
        return apply_transforms(nu_or_phi, T)
    if trans_mats is not None:
        T = host(trans_mats)
        if T.ndim == 2:  # stacked (draws*K, K) as the reference accepts
            T = T.reshape(-1, K, K)
        return apply_transforms(nu_or_phi, T)
    return nu_or_phi


def _pointwise_ci(samples: np.ndarray, alpha: float):
    """Quantiles [alpha/2, .5, 1-alpha/2] along the draw axis."""
    lo, med, hi = np.quantile(samples, [alpha / 2, 0.5, 1 - alpha / 2], axis=0)
    return {"CI_Lower": lo, "CI_50": med, "CI_Upper": hi}


def _simultaneous_ci(samples: np.ndarray, alpha: float):
    """Sup-t simultaneous band (PostProcessing.cpp:287-307):
    C_d = max_t |f_d(t) - fbar(t)| / sd(t);  band = fbar +- q_{1-a}(C) * sd.
    """
    mean = samples.mean(axis=0)
    sd = samples.std(axis=0, ddof=1)
    sd_safe = np.where(sd > 0, sd, 1.0)
    flat = samples.reshape(samples.shape[0], -1)
    C = np.max(np.abs((flat - mean.ravel()) / sd_safe.ravel()), axis=1)
    q = np.quantile(C, 1 - alpha)
    return {"CI_Lower": mean - q * sd, "CI_50": mean, "CI_Upper": mean + q * sd}


def mean_ci(nu_samp, B, k, *, alpha=0.05, rescale=True, simultaneous=False,
            burnin_prop=0.1, Z_samp=None, trans_mats=None,
            eta_samp=None, x=None):
    """Credible interval for feature k's mean function at query points.

    nu_samp: (draws, K, P); B: (T, P) basis at query time points; k is
    1-indexed as in the reference API.  For covariate-adjusted means pass
    eta_samp (draws, K, P, D) and a covariate vector x (D,): the feature
    mean becomes B (nu_k + eta_k x) (PostProcessing.cpp CovAdj branch).
    """
    nu_samp = keep_tail(host(nu_samp), burnin_prop)
    if Z_samp is not None:
        Z_samp = keep_tail(host(Z_samp), burnin_prop)
    nu_eff = nu_samp
    if eta_samp is not None and x is not None:
        eta_samp = keep_tail(host(eta_samp), burnin_prop)
        nu_eff = nu_samp + np.einsum("dkpc,c->dkp", eta_samp, host(x))
    nu_eff = _resolve_transform(nu_eff, Z_samp, rescale, trans_mats)
    f = np.einsum("tp,dp->dt", host(B), nu_eff[:, k - 1])
    ci = (_simultaneous_ci if simultaneous else _pointwise_ci)(f, alpha)
    return ci


def cov_ci(phi_samp, B1, B2, k, l, *, alpha=0.05, rescale=True,
           simultaneous=False, burnin_prop=0.1, Z_samp=None, trans_mats=None,
           xi_samp=None, x=None):
    """Credible interval for the (k, l) cross-covariance surface.

    phi_samp: (draws, K, P, M); covariance draw =
    sum_m (B1 phi_km)(B2 phi_lm)' (PostProcessing.cpp:1938-1943).  For the
    covariate-adjusted covariance pass xi_samp (draws, K, P, D, M) and x.
    """
    phi_samp = keep_tail(host(phi_samp), burnin_prop)
    if Z_samp is not None:
        Z_samp = keep_tail(host(Z_samp), burnin_prop)
    phi_eff = phi_samp
    if xi_samp is not None and x is not None:
        xi_samp = keep_tail(host(xi_samp), burnin_prop)
        phi_eff = phi_samp + np.einsum("dkpcm,c->dkpm", xi_samp, host(x))
    phi_eff = _resolve_transform(phi_eff, Z_samp, rescale, trans_mats)
    u = np.einsum("tp,dpm->dtm", host(B1), phi_eff[:, k - 1])
    v = np.einsum("sp,dpm->dsm", host(B2), phi_eff[:, l - 1])
    cov = np.einsum("dtm,dsm->dts", u, v)
    return (_simultaneous_ci if simultaneous else _pointwise_ci)(cov, alpha)


def z_ci(Z_samp, *, alpha=0.05, burnin_prop=0.1):
    """Pointwise credible intervals for the membership matrix
    (PostProcessing.cpp:3505; returns the trimmed trace too)."""
    Z_samp = host(Z_samp)
    n = Z_samp.shape[0]
    Z_tail = Z_samp[int(round(n * burnin_prop)):]
    ci = _pointwise_ci(Z_tail, alpha)
    ci["Z_trace"] = Z_tail
    return ci


def sigma_ci(sigma_samp, *, alpha=0.05, burnin_prop=0.1):
    """Credible interval for sigma^2 (PostProcessing.cpp:3435)."""
    sigma_samp = keep_tail(host(sigma_samp).ravel(), burnin_prop)
    lo, med, hi = np.quantile(sigma_samp, [alpha / 2, 0.5, 1 - alpha / 2])
    return {"CI_Lower": lo, "CI_50": med, "CI_Upper": hi,
            "trace": sigma_samp}
