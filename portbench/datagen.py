"""Mixed-membership data from a seed: the raw curves or surfaces, their
points and covariates, and the truth they were drawn from.

``simulate`` (the functional family) is a frozen copy of
``simulate_functional`` and ``_truth_state`` of
``bayesfmmm_torch/utils/simulate.py`` at commit 29f7e3a7, with covariates.
The draws are made in the same order, and the curves' means from the
float32 basis and truth as there, so for one seed the values equal that
simulator's bit for bit.  ``simulate_hd`` (the hd family, surfaces on a
tensor-product basis) is the benchmark's own: each surface is seen at a
number of points uniform over ``n_time``, drawn uniformly in the box of the
boundary knots, with the same truth.  The bases are the benchmark's own
(``reference/bspline.py``).  Both return raw inputs that the program builds
its data from with ``api.build_data`` and the reference its own.

A configuration file's ``family`` picks the simulator (``from_config``),
"functional" where it has none.  Its keys, beside the sizes N, K, P, M, D
and ``n_time`` = [min, max] points an observation, which the FLOP counts
and the kernels' readers take with the same meaning in every family:

  * functional: P cubic B-splines on [0, 1], internal knots equally
    spaced (``knots``);
  * hd: ``basis_degrees`` (one an axis), ``internal_knots`` (a list an
    axis), ``boundary_knots`` ([lo, hi] an axis), and P, which has to equal
    the tensor basis's columns, prod(len(internal) + degree + 1).

Any other family (the multivariate one among them) is refused.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.bspline import basis_sizes, design, tensor_design

FAMILIES = ("functional", "hd")
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


def _observe(rng, t_list, X, rows, *, K, P, M, D, sigma2, nu_scale,
             phi_scale, with_eta, with_xi):
    """(each observation's values, truth): the truth drawn, then each
    observation's mean at its points ``t`` from the float32 basis rows
    ``rows(t)``, plus noise."""
    N = len(t_list)
    L = max(len(t) for t in t_list)
    S = np.zeros((N, L, P), np.float32)
    mask = np.zeros((N, L), np.float32)
    for n, t in enumerate(t_list):
        S[n, :len(t)] = rows(t)
        mask[n, :len(t)] = 1.0
    X32 = (np.zeros((N, 0)) if X is None else X).astype(np.float32)
    truth = _truth(rng, N, K, P, M, D, nu_scale=nu_scale,
                   phi_scale=phi_scale, sigma2=sigma2, with_eta=with_eta,
                   with_xi=with_xi)
    mu = _mean(S, X32, truth)
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    return [y[n][mask[n] > 0] for n in range(N)], truth


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
    y, truth = _observe(
        rng, t_list, X, lambda t: design(t, degree, internal, boundary),
        K=K, P=P, M=M, D=D, sigma2=sigma2, nu_scale=nu_scale,
        phi_scale=phi_scale, with_eta=with_eta, with_xi=with_xi)
    return dict(y=y, t=t_list, X=X, truth=truth, degree=degree,
                internal=internal, boundary=boundary)


def simulate_hd(seed, *, N, K, P, M, basis_degrees, internal_knots,
                boundary_knots, n_time, D=0, sigma2=0.01, nu_scale=3.0,
                phi_scale=0.5, with_eta=False, with_xi=False):
    """dict(family="hd", y=list of (n_i,) values, t=list of (n_i, dim)
    points, X=(N, D) or None, truth=dict of float32 arrays, degrees,
    internal, boundary): surfaces seen at points drawn uniformly in the box
    of the boundary knots, their means from the float32 tensor basis."""
    rng = np.random.default_rng(seed)
    degrees = [int(d) for d in basis_degrees]
    internal = [np.asarray(k, np.float64) for k in internal_knots]
    boundary = np.asarray(boundary_knots, np.float64)
    t_list = [rng.uniform(boundary[:, 0], boundary[:, 1],
                          (rng.integers(n_time[0], n_time[1] + 1),
                           len(degrees)))
              for _ in range(N)]
    X = rng.normal(size=(N, D)) if D else None
    y, truth = _observe(
        rng, t_list, X,
        lambda t: tensor_design(t, degrees, internal, boundary),
        K=K, P=P, M=M, D=D, sigma2=sigma2, nu_scale=nu_scale,
        phi_scale=phi_scale, with_eta=with_eta, with_xi=with_xi)
    return dict(family="hd", y=y, t=t_list, X=X, truth=truth,
                degrees=degrees, internal=internal, boundary=boundary)


def family_of(config):
    """The configuration's family, checked: ValueError for a family the
    benchmark does not take, or for hd keys that disagree."""
    family = config.get("family", "functional")
    if family not in FAMILIES:
        raise ValueError(f"configuration family {family!r}: the benchmark "
                         f"takes {', '.join(FAMILIES)}")
    if family == "hd":
        degrees, internal, boundary = (config[k] for k in (
            "basis_degrees", "internal_knots", "boundary_knots"))
        if not len(degrees) == len(internal) == len(boundary) >= 1:
            raise ValueError("basis_degrees, internal_knots and "
                             "boundary_knots need one entry an axis")
        if any(len(b) != 2 or not b[0] < b[1] for b in boundary):
            raise ValueError("boundary_knots: one [lo, hi] an axis")
        P = int(np.prod(basis_sizes(degrees, internal)))
        if config["P"] != P:
            raise ValueError(f"P = {config['P']}, the tensor basis of "
                             f"these knots has {P} columns")
    return family


def from_config(config, seed):
    """The simulator of the configuration's family at its sizes."""
    family = family_of(config)
    keys = ("N", "K", "P", "M", "D", "sigma2", "nu_scale", "phi_scale",
            "with_eta", "with_xi")
    kw = {k: config[k] for k in keys}
    if family == "hd":
        return simulate_hd(seed, n_time=tuple(config["n_time"]),
                           basis_degrees=config["basis_degrees"],
                           internal_knots=config["internal_knots"],
                           boundary_knots=config["boundary_knots"], **kw)
    return simulate(seed, n_time=tuple(config["n_time"]), **kw)
