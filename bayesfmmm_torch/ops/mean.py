"""Mean-structure assembly for the mixed-membership likelihood.

Port of ``bayesfmmm_tpu/ops/mean.py`` with a leading chain axis C on every
state tensor.  The model mean of observation n collapses to one P-vector

    w_n = sum_k Z_nk [ nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n ],

so mu_n = B_n w_n.  Linear terms of the sweep stay in Gram space
(B_n' r_n = u_n - G_n w_n); squared residual norms go through the length-L
residual, because the Gram identity yy - 2 u.w + w'Gw cancels in f32.
For CUDA tensors that residual pass is kernel K2 (ops/kernels.py), which
forms mu and the RSS in one pass over B for all chains, and whose backward
kernel gives the RSS's gradient with respect to w (the log-joint's).  With
the identity basis of the multivariate family mu is w itself and the RSS
needs no pass over an (N, P, P) identity, so K2 is not launched there.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesfmmm_torch.ops import kernels
from bayesfmmm_torch.parallel.mesh import data_sum
from bayesfmmm_torch.utils.observability import traced


@dataclasses.dataclass(frozen=True)
class SweepCache:
    """Running effective mean coefficients w (C, N, P), maintained through a
    sweep: each blocked updater removes its own contribution, redraws and
    adds it back, all in P-dimensional Gram space."""
    w: torch.Tensor

    def replace(self, **changes) -> "SweepCache":
        return dataclasses.replace(self, **changes)


def effective_coeffs(state, X):
    """w[c, n, p] — per-observation basis coefficients of the model mean."""
    w = torch.einsum("cnk,ckp->cnp", state.Z, state.nu)
    w = w + torch.einsum("cnk,ckpm,cnm->cnp", state.Z, state.Phi, state.chi)
    if X.shape[1] > 0:
        w = w + torch.einsum("cnk,ckpd,nd->cnp", state.Z, state.eta, X)
        w = w + torch.einsum("cnk,ckpdm,nd,cnm->cnp", state.Z, state.xi, X,
                             state.chi)
    return w


def compute_mu(data, state):
    """Model mean mu (C, N, L)."""
    w = effective_coeffs(state, data.X)
    if data.identity_basis:
        return w                                   # B = I, L = P
    return kernels.mean_rss(data.B, data.y, w, want_mu=True)[1]


@traced("ops.mean.build_cache")
def build_cache(data, state) -> SweepCache:
    return SweepCache(w=effective_coeffs(state, data.X))


def rss_from_coeffs(data, w):
    """Per-chain sum_n ||y_n - B_n w_n||^2 (C,), in residual space, over
    every rank's rows under a mesh that splits the data: ``rank_rss``
    added over the data group (``data_sum`` refuses a w that needs a
    gradient there, where the gradient would not cross the ranks)."""
    return data_sum(rank_rss(data, w))


def rank_rss(data, w):
    """Per-chain sum over this rank's rows of ||y_n - B_n w_n||^2 (C,); K2
    on CUDA.  B rows and y are zero at padded points, so no mask is
    needed.  When w needs a gradient the RSS goes through
    ``kernels.MeanRSS``, whose backward is K2's backward kernel on the
    card."""
    if data.identity_basis:
        r = data.y - w
        return (r * r).sum((1, 2))
    w = w.contiguous()
    if torch.is_grad_enabled() and w.requires_grad:
        return kernels.MeanRSS.apply(data.B, data.y, w)
    return kernels.mean_rss(data.B, data.y, w)[0]


def rss_rows_from_coeffs(data, w):
    """Per-observation ||y_n - B_n w_n||^2 (C, N), in residual space."""
    r = data.y - apply_basis(data, w)
    return (r * r).sum(-1)


def apply_basis(data, w):
    """B_n w_n for coefficients w (..., N, P) -> (..., N, L); w itself
    under the identity basis."""
    if data.identity_basis:
        return w
    return torch.einsum("nlp,...np->...nl", data.B, w)


def gram_vec(data, w):
    """G_n w_n for coefficients w (..., N, P); w itself under the identity
    basis (G_n = I)."""
    if data.identity_basis:
        return w
    return torch.einsum("npq,...nq->...np", data.G, w)


def gram_dirs(data, U):
    """G_n U_n for eigen directions U (..., N, P, M); U itself under the
    identity basis."""
    if data.identity_basis:
        return U
    return torch.einsum("npq,...nqm->...npm", data.G, U)


def feature_offsets(state, X):
    """T[c, n, k, p] = nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n — the
    per-feature mean coefficients seen by observation n (Z-independent)."""
    T = state.nu[:, None] + torch.einsum("ckpm,cnm->cnkp", state.Phi,
                                         state.chi)
    if X.shape[1] > 0:
        T = T + torch.einsum("ckpd,nd->cnkp", state.eta, X)
        T = T + torch.einsum("ckpdm,nd,cnm->cnkp", state.xi, X, state.chi)
    return T


def eigen_directions(state, X):
    """U[c, n, p, m] = sum_k Z_nk (Phi_k + xi_k x_n) — the effective
    eigen-directions of observation n."""
    U = torch.einsum("cnk,ckpm->cnpm", state.Z, state.Phi)
    if X.shape[1] > 0:
        U = U + torch.einsum("cnk,ckpdm,nd->cnpm", state.Z, state.xi, X)
    return U
