"""Spectral (archetypal) initialization of the mixed-membership structure.

The algorithm of ``bayesfmmm_tpu.utils.init_strategies.spectral_init``,
restated so that the port loads nothing of the JAX package;
``tests/test_torch_state.py`` holds the two equal on the same data.

  1. ridge-project each observation onto the basis,
  2. pick K archetypes by furthest-point traversal of the coefficients,
  3. set nu to the archetypes and Z by simplex-constrained least squares,
  4. initialize (chi, Phi) from an SVD of the residual coefficients.

All NumPy f64 on the host, O(N P^2) — negligible next to one sweep.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["spectral_init", "spectral_ensemble", "simplex_lsq"]


def _host(x):
    """Host float64 copy of a tensor or array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _project_coefficients(B, y, G, ridge):
    """Per-observation ridge basis projections c (N, P)."""
    P = B.shape[2]
    eye = np.eye(P)
    c = np.zeros((B.shape[0], P))
    rhs = np.einsum("nlp,nl->np", B, y)
    for i in range(B.shape[0]):
        scale = np.trace(G[i]) / P + 1.0
        c[i] = np.linalg.solve(G[i] + ridge * scale * eye, rhs[i])
    return c


def _furthest_point_archetypes(c, K):
    """Greedy convex-hull extreme selection (k-means++-style traversal)."""
    mean = c.mean(axis=0)
    idx = [int(np.argmax(np.linalg.norm(c - mean, axis=1)))]
    for _ in range(K - 1):
        d = np.min(
            np.stack([np.linalg.norm(c - c[j], axis=1) for j in idx]), axis=0)
        idx.append(int(np.argmax(d)))
    return np.array(idx)


def simplex_lsq(C, V, n_iter=200, lr=None):
    """Rows of Z solve min ||C - Z V||^2 s.t. Z rows on the simplex, by
    projected gradient with the simplex projection of Duchi et al."""
    N, P = C.shape
    K = V.shape[0]
    Z = np.full((N, K), 1.0 / K)
    G = V @ V.T
    lip = np.linalg.eigvalsh(G).max() + 1e-9
    lr = lr or 1.0 / lip
    CVt = C @ V.T

    def project_rows(Y):
        u = np.sort(Y, axis=1)[:, ::-1]
        css = np.cumsum(u, axis=1) - 1.0
        ind = np.arange(1, K + 1)
        cond = u - css / ind > 0
        rho = K - np.argmax(cond[:, ::-1], axis=1) - 1
        theta = css[np.arange(N), rho] / (rho + 1.0)
        return np.maximum(Y - theta[:, None], 0.0)

    for _ in range(n_iter):
        grad = Z @ G - CVt
        Z = project_rows(Z - lr * grad)
    return Z


def spectral_init(data, K, M, *, ridge=1e-6, jitter=1e-3, seed=0):
    """Initial values {Z, nu, chi, Phi, sigma2} as host NumPy arrays.

    ``data`` is a port ModelData (tensors on any device).  Z rows are
    floored and renormalized strictly inside the simplex; sigma2 > 0.
    """
    rng = np.random.default_rng(seed)
    B, y, G, mask = (_host(data.B), _host(data.y), _host(data.G),
                     _host(data.mask))
    c = _project_coefficients(B, y, G, ridge)
    P = c.shape[1]
    idx = _furthest_point_archetypes(c, K)
    nu = c[idx].copy()
    Z = simplex_lsq(c, nu)
    Z = np.clip(Z, 1e-4, None)
    Z = Z / Z.sum(axis=1, keepdims=True)

    resid = c - Z @ nu
    U, s, Vt = np.linalg.svd(resid, full_matrices=False)
    m_eff = min(M, len(s))
    chi = np.zeros((c.shape[0], M))
    chi[:, :m_eff] = U[:, :m_eff] * np.sqrt(c.shape[0])
    Phi = jitter * rng.normal(size=(K, P, M))
    for m in range(m_eff):
        Phi[:, :, m] += (s[m] / np.sqrt(c.shape[0])) * Vt[m][None, :]

    fit = np.einsum("nlp,np->nl", B, Z @ nu)
    rss = np.sum(((y - fit) * mask) ** 2)
    sigma2 = max(rss / max(mask.sum(), 1.0), 1e-6)
    return {"Z": Z, "nu": nu, "chi": chi, "Phi": Phi, "sigma2": sigma2}


def spectral_ensemble(g, state, data, K, M, *, z_jitter=0.02):
    """``state`` (C chains) with every chain at the spectral init, as the
    bench seeds its ensemble: Z jittered per chain by ``z_jitter`` times a
    normal draw from ``g``, floored at 1e-4 and renormalized."""
    dev = state.Z.device
    sp = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
          for k, v in spectral_init(data, K, M).items()}
    Z0 = (sp["Z"] + z_jitter * torch.randn(
        state.Z.shape, generator=g, device=dev)).clamp_min(1e-4)
    return state.replace(
        Z=Z0 / Z0.sum(-1, keepdim=True),
        nu=sp["nu"].expand_as(state.nu).contiguous(),
        chi=sp["chi"].expand_as(state.chi).contiguous(),
        Phi=sp["Phi"].expand_as(state.Phi).contiguous(),
        sigma2=sp["sigma2"].expand_as(state.sigma2).contiguous())
