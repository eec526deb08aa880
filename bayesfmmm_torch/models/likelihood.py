"""Model log-likelihood and pointwise densities (port of
``bayesfmmm_tpu/models/likelihood.py``).

Reference: CalculateLikelihood.h — calcLikelihood (:19-44), the pointwise
DIC densities (:59-125, :172-238), and the chi-integrated observation-level
marginal used by CPO (:344-386).  Every function leads with the chain axis.
"""

from __future__ import annotations

import math

import torch

from bayesfmmm_torch.ops.mean import (compute_mu, effective_coeffs,
                                      rss_from_coeffs)
from bayesfmmm_torch.utils.observability import traced

_LOG_2PI = math.log(2.0 * math.pi)


def model_mean(state, data):
    """Full model mean mu (C, N, L), zero at padded points."""
    return compute_mu(data, state)


@traced("models.likelihood.log_likelihood")
def log_likelihood(state, data):
    """Total Gaussian log likelihood per chain (C,); the RSS is taken in
    residual space (kernel K2 on CUDA)."""
    rss = rss_from_coeffs(data, effective_coeffs(state, data.X))
    return (-0.5 * data.n_obs * (_LOG_2PI + torch.log(state.sigma2))
            - 0.5 * rss / state.sigma2)


def pointwise_log_density(state, data):
    """(C, N, L) masked pointwise Gaussian log densities (DIC2 inputs)."""
    r = data.y - model_mean(state, data)
    s2 = state.sigma2[:, None, None]
    ll = -0.5 * (_LOG_2PI + torch.log(s2)) - 0.5 * r * r / s2
    return ll * data.mask


def marginal_covariance(state, data, i):
    """chi-integrated covariance of observation i, per chain (C, L, L).

    Reference CPO assembly (CalculateLikelihood.h:361-372):
      cov_i = sum_{k,k'} Z_ik Z_ik' sum_m B_i (phi_km + xi_km x_i)
              (phi_k'm + xi_k'm x_i)' B_i' + sigma2 I,
    dense on the padded grid (rows and columns beyond the mask are sigma2
    on the diagonal only)."""
    Bi = data.B[i]                                          # (L, P)
    V = state.Phi + torch.einsum("ckpdm,d->ckpm", state.xi, data.X[i])
    # u[c, m, l] = sum_k Z_ik B_i phi^eff_km
    u = torch.einsum("ck,lp,ckpm->cml", state.Z[:, i], Bi, V)
    cov = torch.einsum("cml,cmo->clo", u, u)
    eye = torch.eye(Bi.shape[0], dtype=cov.dtype, device=cov.device)
    return cov + state.sigma2[:, None, None] * eye


def observation_marginal_loglik(state, data, i):
    """log N(y_i | mean_i, cov_i) with chi integrated out (the CPO
    integrand), per chain (C,)."""
    mean_coef = state.nu + torch.einsum("ckpd,d->ckp", state.eta, data.X[i])
    mu = torch.einsum("ck,lp,ckp->cl", state.Z[:, i], data.B[i], mean_coef)
    cov = marginal_covariance(state, data, i)
    m = data.mask[i]
    # padded points are pinned to independent standard normal dimensions
    r = (data.y[i] - mu) * m
    cov = cov * (m[:, None] * m[None, :]) + torch.diag(torch.where(
        m > 0, 0.0, 1.0).to(cov.dtype))
    logdet = torch.linalg.slogdet(cov)[1]
    sol = torch.linalg.solve(cov, r[..., None])[..., 0]
    return -0.5 * (m.sum() * _LOG_2PI + logdet + (r * sol).sum(-1))
