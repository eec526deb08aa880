"""Mixed-membership data simulators of the three families (port of
``bayesfmmm_tpu/utils/simulate.py``): ``simulate_functional``,
``simulate_hd_functional``, ``simulate_multivariate``; and, for the
reference-named API, ``functional_lists`` (the raw lists a functional data
set was built from) and ``simulate_draws`` (synthetic traces around a truth,
for post-processing checks).

All NumPy with ``default_rng(seed)`` and the same truth and design in the
data's dtype, so for one seed each gives the JAX package's y, mask, B and X
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesfmmm_torch.models.state import (STATE_FIELDS, default_device,
                                          make_functional_data,
                                          make_hd_functional_data,
                                          make_multivariate_data)


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
                 with_eta, with_xi, dtype=torch.float32):
    """Ground-truth parameters of one chain, as NumPy arrays of the data's
    dtype in the field order of the state (the draw order is the JAX
    package's)."""
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
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return {f: np.asarray(truth[f], np_dtype) for f in STATE_FIELDS}


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

    t_list = _time_points(rng, N, n_time)
    X = rng.normal(size=(N, D)) if D else None

    # design first (float32, on the host), then the observations
    data0 = make_functional_data([np.zeros_like(t) for t in t_list], t_list,
                                 basis_degree=degree, internal_knots=internal,
                                 boundary_knots=boundary, X=X, dtype=dtype,
                                 device="cpu")
    truth = _truth_state(rng, N, K, P, M, D, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi, dtype=dtype)
    mu = _numpy_mu(data0.B.numpy(), data0.X.numpy(), truth)
    mask = data0.mask.numpy()
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    y_list = [y[i][mask[i] > 0] for i in range(N)]
    data = make_functional_data(y_list, t_list, basis_degree=degree,
                                internal_knots=internal,
                                boundary_knots=boundary, X=X, dtype=dtype,
                                device=device)
    return data, truth


def _time_points(rng, N, n_time):
    return [np.sort(rng.uniform(0, 1, rng.integers(n_time[0], n_time[1] + 1)))
            for _ in range(N)]


def functional_lists(data, *, seed, n_time):
    """(Y, time): each curve's observed values and time points, the ragged
    lists the reference's R names take, of the data
    ``simulate_functional(seed=seed, N=data.N, n_time=n_time, ...)`` made
    (its time points are the first draws of its generator)."""
    t_list = _time_points(np.random.default_rng(seed), data.N, n_time)
    y, mask = data.y.cpu().numpy(), data.mask.cpu().numpy()
    return [y[i][mask[i] > 0] for i in range(data.N)], t_list


def simulate_draws(truth, n_draws, *, seed=0, spread=0.05):
    """``n_draws`` synthetic draws of every state field scattered around
    ``truth`` (a dict of one chain's NumPy arrays, as the simulators return
    it), as float64 traces with the draws first: nu, Phi, chi, eta, xi
    with N(0, spread^2) noise, Z from a Dirichlet centred on the truth's
    rows, sigma2 with log-normal noise of sd ``spread``, the rest constant.
    They stand in for a fit's traces where post-processing is checked."""
    rng = np.random.default_rng(seed)
    out = {f: np.broadcast_to(np.asarray(truth[f], np.float64),
                              (n_draws,) + np.shape(truth[f])).copy()
           for f in STATE_FIELDS}
    for f in ("nu", "Phi", "chi", "eta", "xi"):
        out[f] += spread * rng.normal(size=out[f].shape)
    Z = rng.gamma(200.0 * out["Z"] + 0.5)
    out["Z"] = Z / Z.sum(axis=-1, keepdims=True)
    out["sigma2"] = out["sigma2"] * np.exp(spread
                                           * rng.normal(size=n_draws))
    return out


def simulate_hd_functional(seed=1, *, N=20, K=2, M=2, D=0, n_points=(40, 50),
                           sigma2=0.01, nu_scale=3.0, phi_scale=0.5,
                           basis_degrees=(2, 2), n_internal=(1, 1),
                           with_eta=False, with_xi=False,
                           dtype=torch.float32, device=None):
    """Simulate surface (2-D domain) MM data with a tensor B-spline basis
    (BHDFMMM, BFMMM.h:2892): surface i is observed at n_i random points of
    [0, 1]^dim.  Returns (data, truth) as ``simulate_functional`` does."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    dim = len(basis_degrees)
    internal = [np.linspace(0, 1, n + 2)[1:-1] for n in n_internal]
    boundary = np.tile(np.array([0.0, 1.0]), (dim, 1))
    t_list = [rng.uniform(0, 1, (int(rng.integers(n_points[0],
                                                  n_points[1] + 1)), dim))
              for _ in range(N)]
    X = rng.normal(size=(N, D)) if D else None
    kw = dict(basis_degrees=basis_degrees, internal_knots_list=internal,
              boundary_knots=boundary, X=X, dtype=dtype)
    data0 = make_hd_functional_data([np.zeros(t.shape[0]) for t in t_list],
                                    t_list, device="cpu", **kw)
    truth = _truth_state(rng, N, K, int(data0.P), M, D, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi, dtype=dtype)
    mu = _numpy_mu(data0.B.numpy(), data0.X.numpy(), truth)
    mask = data0.mask.numpy()
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape) * mask
    y_list = [y[i][mask[i] > 0] for i in range(N)]
    return make_hd_functional_data(y_list, t_list, device=device, **kw), truth


def simulate_multivariate(seed=1, *, N=200, K=2, P=6, M=2, D=0, sigma2=0.01,
                          nu_scale=3.0, phi_scale=0.5, with_eta=False,
                          with_xi=False, dtype=torch.float32, device=None):
    """Simulate multivariate MM data (identity basis).  Returns (data,
    truth) as ``simulate_functional`` does."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)) if D else None
    data0 = make_multivariate_data(np.zeros((N, P)), X=X, dtype=dtype,
                                   device="cpu")
    truth = _truth_state(rng, N, K, P, M, D, nu_scale=nu_scale,
                         phi_scale=phi_scale, sigma2=sigma2,
                         with_eta=with_eta, with_xi=with_xi, dtype=dtype)
    mu = _numpy_mu(data0.B.numpy(), data0.X.numpy(), truth)
    y = mu + np.sqrt(sigma2) * rng.normal(size=mu.shape)
    return make_multivariate_data(y, X=X, dtype=dtype, device=device), truth
