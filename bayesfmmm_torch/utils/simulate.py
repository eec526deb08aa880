"""Functional mixed-membership data simulator (port of
``bayesfmmm_tpu/utils/simulate.py::simulate_functional``).

All NumPy with ``default_rng(seed)`` and the same float32 truth and design,
so for one seed it gives the JAX package's y, mask and B bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesfmmm_torch.models.state import (STATE_FIELDS, default_device,
                                          make_functional_data)


def _numpy_mu(B, X, truth):
    """Host-side model mean from the float32 design and truth."""
    Z, chi = truth["Z"], truth["chi"]
    w = np.einsum("nk,kp->np", Z, truth["nu"])
    w += np.einsum("nk,kpm,nm->np", Z, truth["Phi"], chi)
    if X.shape[1] > 0:
        w += np.einsum("nk,kpd,nd->np", Z, truth["eta"], X)
        w += np.einsum("nk,kpdm,nd,nm->np", Z, truth["xi"], X, chi)
    return np.einsum("nlp,np->nl", B, w)


def _truth_state(rng, N, K, P, M, D, *, nu_scale, phi_scale, sigma2,
                 with_eta, with_xi):
    """Ground-truth parameters of one chain, as float32 NumPy arrays in the
    field order of the state (the draw order is the JAX package's)."""
    nu = nu_scale * rng.normal(size=(K, P))
    Phi = phi_scale * rng.normal(size=(K, P, M))
    Z = rng.dirichlet(np.full(K, 1.0), size=N)
    chi = rng.normal(size=(N, M))
    eta = rng.normal(size=(K, P, D)) if with_eta else np.zeros((K, P, D))
    xi = (0.5 * rng.normal(size=(K, P, D, M))) if with_xi \
        else np.zeros((K, P, D, M))
    truth = dict(
        Z=Z, pi=np.full(K, 1.0 / K), alpha3=2.0, nu=nu, tau=np.ones(K),
        sigma2=sigma2, chi=chi, Phi=Phi, gamma=np.ones((K, P, M)),
        delta=np.ones((K, M)), A=np.ones((K, 2)), eta=eta,
        tau_eta=np.ones((K, D)), xi=xi, gamma_xi=np.ones((K, P, D, M)),
        delta_xi=np.ones((K, M, D)), A_xi=np.ones((K, 2, D)))
    return {f: np.asarray(truth[f], np.float32) for f in STATE_FIELDS}


def simulate_functional(seed=1, *, N=40, K=3, P=8, M=2, D=0, n_time=(80, 100),
                        sigma2=0.01, nu_scale=3.0, phi_scale=0.5,
                        with_eta=False, with_xi=False, dtype=torch.float32,
                        device=None):
    """Simulate functional MM data on [0, 1] with a cubic B-spline basis.

    Returns (data, truth): data a ModelData on ``device`` (the CUDA card
    when None; ``device="cpu"`` asks for the CPU), truth a dict of
    float32 NumPy arrays of one chain (``convert.state_from_numpy`` turns it
    into a state).  P = n_internal + 4 fixes the internal knot count.
    """
    device = default_device(device)
    rng = np.random.default_rng(seed)
    degree = 3
    n_internal = P - degree - 1
    if n_internal < 0:
        raise ValueError("P must be >= 4 for a cubic basis")
    internal = np.linspace(0, 1, n_internal + 2)[1:-1]
    boundary = np.array([0.0, 1.0])

    t_list = [np.sort(rng.uniform(0, 1,
                                  rng.integers(n_time[0], n_time[1] + 1)))
              for _ in range(N)]
    X = rng.normal(size=(N, D)) if D else None

    # design first (float32, on the host), then the observations
    data0 = make_functional_data([np.zeros_like(t) for t in t_list], t_list,
                                 basis_degree=degree, internal_knots=internal,
                                 boundary_knots=boundary, X=X, dtype=dtype,
                                 device="cpu")
    truth = _truth_state(rng, N, K, P, M, D, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi)
    mu = _numpy_mu(data0.B.numpy(), data0.X.numpy(), truth)
    mask = data0.mask.numpy()
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    y_list = [y[i][mask[i] > 0] for i in range(N)]
    data = make_functional_data(y_list, t_list, basis_degree=degree,
                                internal_knots=internal,
                                boundary_knots=boundary, X=X, dtype=dtype,
                                device=device)
    return data, truth
