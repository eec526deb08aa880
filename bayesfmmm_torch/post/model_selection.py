"""Model selection: DIC, AIC, BIC, log-likelihood traces, CPO.

Reference: PostProcessing.cpp FDIC (:3762-3784), FAIC (:4166-4179),
FBIC (:4458/4597), FLLik (:4892), ConditionalPredictiveOrdinates (:6339)
with the chi-integrated marginal from CalculateLikelihood.h:344-386.

Vectorized over draws and observations; operates on iteration-major traces
plus the padded data container (the family distinction lives in data.B).

The port's own copy of ``bayesfmmm_tpu/post/model_selection.py``, in NumPy
on the host: the data's tensors (on the card, as a rule) and any trace
tensors are moved there first.  ``cpo`` runs the port's ``cpo_fast`` on the
data's device.  ``tests/test_torch_post.py`` holds every function equal to
the original on shared inputs.
"""

from __future__ import annotations

import numpy as np

from bayesfmmm_torch.post import host
from bayesfmmm_torch.post.cpo_fast import cpo_fast

__all__ = ["pointwise_densities", "loglik_trace", "dic", "aic", "bic", "cpo",
           "param_count"]


def _means_all_draws(traces, data, X=None):
    """Fitted mean for every draw: (draws, N, L) on the padded grid.

    mu_d[i,l] = sum_k Z_ik (B_il . (nu_k + eta_k x_i))
                + sum_km Z_ik chi_im (B_il . (Phi_km + xi_km x_i)).
    """
    B = host(data.B)
    Z = host(traces["Z"])          # (d, N, K)
    nu = host(traces["nu"])        # (d, K, P)
    Phi = host(traces["Phi"])      # (d, K, P, M)
    chi = host(traces["chi"])      # (d, N, M)
    nu_eff = np.einsum("nlp,dkp->dnlk", B, nu)
    Phi_eff = np.einsum("nlp,dkpm->dnlkm", B, Phi)
    if X is not None and "eta" in traces and traces["eta"].shape[-1] > 0:
        X = host(X)
        nu_eff = nu_eff + np.einsum("nlp,dkpc,nc->dnlk", B,
                                    host(traces["eta"]), X)
        if "xi" in traces and traces["xi"].shape[-2] > 0:
            Phi_eff = Phi_eff + np.einsum("nlp,dkpcm,nc->dnlkm", B,
                                          host(traces["xi"]), X)
    mu = np.einsum("dnk,dnlk->dnl", Z, nu_eff)
    mu = mu + np.einsum("dnk,dnm,dnlkm->dnl", Z, chi, Phi_eff)
    return mu


def pointwise_densities(traces, data, X=None):
    """(draws, N, L) Gaussian densities at each observed point (calcDIC2)."""
    mu = _means_all_draws(traces, data, X)
    y = host(data.y)[None]
    sig = host(traces["sigma2"]).reshape(-1, 1, 1)
    dens = np.exp(-0.5 * (y - mu) ** 2 / sig) / np.sqrt(2 * np.pi * sig)
    return dens * host(data.mask)[None]


def loglik_trace(traces, data, X=None):
    """Per-draw total log-likelihood (FLLik, PostProcessing.cpp:4892)."""
    mu = _means_all_draws(traces, data, X)
    y = host(data.y)[None]
    mask = host(data.mask)[None]
    sig = host(traces["sigma2"]).reshape(-1, 1, 1)
    ll = -0.5 * (np.log(2 * np.pi * sig) + (y - mu) ** 2 / sig) * mask
    return ll.sum(axis=(1, 2))


def _tail(traces, burnin_prop):
    n = traces["sigma2"].shape[0]
    keep = int(round(n * (1.0 - burnin_prop)))
    return {k: host(v)[n - keep:] for k, v in traces.items()}


def dic(traces, data, *, burnin_prop=0.1, X=None):
    """DIC = 2 * f_hat - 4 * E[log f]  (PostProcessing.cpp:3762-3784):
    f_hat = sum_ij log( (1/D) sum_d density_d(y_ij) ),
    E[log f] = (1/D) sum_d loglik_d.
    """
    tr = _tail(traces, burnin_prop)
    expected_log_f = loglik_trace(tr, data, X).mean()
    dens = pointwise_densities(tr, data, X)         # (d, N, L)
    mask = host(data.mask) > 0
    mean_dens = dens.mean(axis=0)
    f_hat = np.log(np.where(mask, mean_dens, 1.0)).sum()
    return float(2 * f_hat - 4 * expected_log_f)


def param_count(traces, data, X=None, cov_adj=False):
    """Closed-form parameter count (FAIC, PostProcessing.cpp:4176-4179):
    p = (N + P) K + 2 P M K + 2 + 4 K + N M + M K
    CovAdj (FBIC :4790 structure) adds eta/tau_eta and optionally the xi
    tower."""
    d, N, K = traces["Z"].shape
    P, M = traces["Phi"].shape[2], traces["Phi"].shape[3]
    p = (N + P) * K + 2 * P * M * K + 2 + 4 * K + N * M + M * K
    if X is not None and "eta" in traces and traces["eta"].shape[-1] > 0:
        D = traces["eta"].shape[-1]
        p += P * D * K + K * D          # eta + tau_eta
        if cov_adj and "xi" in traces and traces["xi"].shape[-2] > 0:
            # xi + gamma_xi + delta_xi + A_xi
            p += 2 * P * D * K * M + K * M * D + 2 * K * D
    return p


def _plugin_loglik(traces, data, *, burnin_prop, X=None):
    """Log-lik at the posterior-mean fitted curves and mean sigma^2
    (FAIC's plug-in, PostProcessing.cpp:4143-4175)."""
    tr = _tail(traces, burnin_prop)
    mu_bar = _means_all_draws(tr, data, X).mean(axis=0)
    sig_bar = host(tr["sigma2"]).mean()
    y = host(data.y)
    mask = host(data.mask)
    ll = -0.5 * (np.log(2 * np.pi * sig_bar) + (y - mu_bar) ** 2 / sig_bar)
    return float((ll * mask).sum())


def aic(traces, data, *, burnin_prop=0.1, X=None, cov_adj=False):
    """AIC = 2p - 2 log_lik(plug-in)  (PostProcessing.cpp:4176-4179)."""
    ll = _plugin_loglik(traces, data, burnin_prop=burnin_prop, X=X)
    return float(2 * param_count(traces, data, X, cov_adj) - 2 * ll)


def bic(traces, data, *, burnin_prop=0.1, X=None, cov_adj=False):
    """BIC = 2 log_lik - log(Ntilde) p, Ntilde = total observed points
    (PostProcessing.cpp:4591-4600).  NOTE the reference's sign convention:
    larger is better."""
    ll = _plugin_loglik(traces, data, burnin_prop=burnin_prop, X=X)
    n_tilde = float(host(data.mask).sum())
    return float(2 * ll - np.log(n_tilde) * param_count(traces, data, X,
                                                        cov_adj))


def cpo(traces, data, *, burnin_prop=0.1, X=None):
    """CPO by the Woodbury path on the data's device (post/cpo_fast.py)."""
    return cpo_fast(traces, data, burnin_prop=burnin_prop, X=X)


def cpo_dense(traces, data, *, burnin_prop=0.1, X=None):
    """Conditional predictive ordinates via the chi-integrated marginal.

    CalculateLikelihood.h:344-386: per observation, per draw compute
    log N(y_i | B(nu + eta x), B Phi_eff Phi_eff' B' + sigma2 I) with chi
    integrated out; CPO_i = harmonic mean over draws, log-sum-exp
    stabilized exactly as the reference (:377-382).
    """
    tr = _tail(traces, burnin_prop)
    D = tr["sigma2"].shape[0]
    B = host(data.B)
    y = host(data.y)
    mask = host(data.mask)
    N = y.shape[0]
    have_x = X is not None and "eta" in tr and tr["eta"].shape[-1] > 0
    Xa = host(X) if have_x else None

    logl = np.zeros((N, D))
    for i in range(N):
        m = mask[i] > 0
        Bi = B[i][m]
        yi = y[i][m]
        n_i = Bi.shape[0]
        for d in range(D):
            nu_eff = tr["nu"][d]
            phi_eff = tr["Phi"][d]
            if have_x:
                nu_eff = nu_eff + np.einsum("kpc,c->kp", tr["eta"][d], Xa[i])
                if "xi" in tr and tr["xi"].shape[-2] > 0:
                    phi_eff = phi_eff + np.einsum("kpcm,c->kpm",
                                                  tr["xi"][d], Xa[i])
            z = tr["Z"][d, i]
            mean = Bi @ (z @ nu_eff)
            u = np.einsum("k,lp,kpm->lm", z, Bi, phi_eff)
            cov = u @ u.T + tr["sigma2"][d] * np.eye(n_i)
            sign, logdet = np.linalg.slogdet(cov)
            r = yi - mean
            logl[i, d] = -0.5 * (n_i * np.log(2 * np.pi) + logdet
                                 + r @ np.linalg.solve(cov, r))
    # stabilized harmonic mean (CalculateLikelihood.h:377-382)
    lmin = logl.min(axis=1, keepdims=True)
    cpo_vals = np.log(D) + lmin[:, 0] - np.log(
        np.exp(lmin - logl).sum(axis=1))
    return cpo_vals
