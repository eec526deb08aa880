"""Mean-structure assembly for the mixed-membership likelihood.

Port of ``bayesfmmm_tpu/ops/mean.py`` with a leading chain axis C on every
state tensor.  The model mean of observation n collapses to one P-vector

    w_n = sum_k Z_nk [ nu_k + eta_k x_n + (Phi_k + xi_k x_n) chi_n ],

so mu_n = B_n w_n.  Linear terms of the sweep stay in Gram space
(B_n' r_n = u_n - G_n w_n); squared residual norms go through the length-L
residual, because the Gram identity yy - 2 u.w + w'Gw cancels in f32.
For CUDA tensors that residual pass is kernel K2 (ops/kernels.py), which
forms mu and the RSS in one pass over B for all chains.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesfmmm_torch.ops import kernels


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
    return kernels.mean_rss(data.B, data.y, w, want_mu=True)[1]


def build_cache(data, state) -> SweepCache:
    return SweepCache(w=effective_coeffs(state, data.X))


def rss_from_coeffs(data, w):
    """Per-chain sum_n ||y_n - B_n w_n||^2 (C,), in residual space.  B rows
    and y are zero at padded points, so no mask is needed."""
    return kernels.mean_rss(data.B, data.y, w.contiguous())[0]


def rss_rows_from_coeffs(data, w):
    """Per-observation ||y_n - B_n w_n||^2 (C, N), in residual space."""
    r = data.y - torch.einsum("nlp,cnp->cnl", data.B, w)
    return (r * r).sum(-1)


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
