"""Functional mixed-membership data from a seed: the raw curves, their time
points and covariates, and the truth they were drawn from.

A frozen copy of ``simulate_functional`` and ``_truth_state`` of
``bayesfmmm_torch/utils/simulate.py`` at commit 29f7e3a7 (the functional
family with covariates; the hd and multivariate simulators are not
copied).  The draws are made in the same order, and the curves' means from
the float32 basis and truth as there, so for one seed the values equal that
simulator's bit for bit; the basis is the benchmark's own
(``reference/bspline.py``).  It returns raw inputs that the program builds
its data from with ``api.build_data`` and the reference its own.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.bspline import design

FIELDS = ("Z", "pi", "alpha3", "nu", "tau", "sigma2", "chi", "Phi", "gamma",
          "delta", "A", "eta", "tau_eta", "xi", "gamma_xi", "delta_xi",
          "A_xi")


def _truth(rng, N, K, P, M, D, *, nu_scale, phi_scale, sigma2, with_eta,
           with_xi):
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
    return {f: np.asarray(truth[f], np.float32) for f in FIELDS}


def _mean(S, X, truth):
    """(N, L) curve means from the float32 basis, covariates and truth."""
    Z, chi = truth["Z"], truth["chi"]
    w = np.einsum("nk,kp->np", Z, truth["nu"])
    w += np.einsum("nk,kpm,nm->np", Z, truth["Phi"], chi)
    if X.shape[1] > 0:
        w += np.einsum("nk,kpd,nd->np", Z, truth["eta"], X)
        w += np.einsum("nk,kpdm,nd,nm->np", Z, truth["xi"], X, chi)
    return np.einsum("nlp,np->nl", S, w)


def knots(P, degree=3):
    """(internal, boundary) knots of a cubic basis of P functions on [0, 1]
    with equally spaced internal knots."""
    n_internal = P - degree - 1
    if n_internal < 0:
        raise ValueError("P must be >= degree + 1")
    return np.linspace(0, 1, n_internal + 2)[1:-1], np.array([0.0, 1.0])


def simulate(seed, *, N, K, P, M, D=0, n_time=(100, 100), sigma2=0.01,
             nu_scale=3.0, phi_scale=0.5, with_eta=False, with_xi=False):
    """dict(y=list of (n_i,) values, t=list of (n_i,) time points, X=(N, D)
    or None, truth=dict of float32 arrays, degree, internal, boundary)."""
    rng = np.random.default_rng(seed)
    degree = 3
    internal, boundary = knots(P, degree)
    t_list = [np.sort(rng.uniform(0, 1, rng.integers(n_time[0],
                                                     n_time[1] + 1)))
              for _ in range(N)]
    X = rng.normal(size=(N, D)) if D else None
    L = max(len(t) for t in t_list)
    S = np.zeros((N, L, P), np.float32)
    mask = np.zeros((N, L), np.float32)
    for n, t in enumerate(t_list):
        S[n, :len(t)] = design(t, degree, internal, boundary)
        mask[n, :len(t)] = 1.0
    X32 = (np.zeros((N, 0)) if X is None else X).astype(np.float32)
    truth = _truth(rng, N, K, P, M, D, nu_scale=nu_scale,
                   phi_scale=phi_scale, sigma2=sigma2, with_eta=with_eta,
                   with_xi=with_xi)
    mu = _mean(S, X32, truth)
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    return dict(y=[y[n][mask[n] > 0] for n in range(N)], t=t_list, X=X,
                truth=truth, degree=degree, internal=internal,
                boundary=boundary)


def from_config(config, seed):
    """``simulate`` at a configuration file's sizes."""
    keys = ("N", "K", "P", "M", "D", "sigma2", "nu_scale", "phi_scale",
            "with_eta", "with_xi")
    return simulate(seed, n_time=tuple(config["n_time"]),
                    **{k: config[k] for k in keys})
