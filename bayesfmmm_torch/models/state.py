"""Model data and sampler state, with an explicit chain axis.

Port of ``bayesfmmm_tpu/models/state.py``.  Ragged functional data becomes
padded dense tensors plus a mask; the Gram statistics u = B'y, G = B'B and
yy = ||y||^2 are computed once on the host in float64 and moved to the
device in float32.  Data is shared by every chain.  The sampler state holds
the current draw of every parameter for C chains: each tensor has a leading
chain axis (the JAX package writes per-chain code and vmaps it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bayesfmmm_torch import basis as basis_mod
from bayesfmmm_torch.config import ModelConfig
from bayesfmmm_torch.ops.distributions import rdirichlet


@dataclasses.dataclass(frozen=True)
class ModelData:
    """Observation data and design constants, on one device.  The family
    is carried by the design: functional (B-spline basis, RW(1) penalty),
    hd (tensor basis, graph penalty), multivariate (identity basis and
    penalty; the stored tau is then a precision whose reciprocal is
    exported, UpdateTau.h:47-63).  Covariate adjustment is D > 0.

    Shapes: N observations, L padded points/obs, P basis dim, D covariates.
    """
    y: torch.Tensor       # (N, L) padded observations (zero where masked)
    mask: torch.Tensor    # (N, L) 1.0 where observed
    B: torch.Tensor       # (N, L, P) basis design (zero rows where masked)
    X: torch.Tensor       # (N, D) covariates (D may be 0)
    G: torch.Tensor       # (N, P, P) Gram matrices B_i' B_i
    pen: torch.Tensor     # (P, P) smoothness penalty
    u: torch.Tensor       # (N, P) B_i' y_i
    yy: torch.Tensor      # (N,) ||y_i||^2
    n_obs: float          # number of observed points, kept on the host so
                          # the sigma2 shape needs no device read
    identity_basis: bool = False   # B_n = I: the updaters skip B and G
    family: str = "functional"
    pen_rank: int | None = None    # rank of pen, taken once on the host
                                   # (the log-joint's normalizing power)
    n_whole: int | None = None     # the whole data set's N once the rows
                                   # are split over a mesh's data axis
                                   # (parallel/mesh.py::shard_data)

    @property
    def N(self):
        """This tensor's rows: the rank's share under a data split."""
        return self.y.shape[0]

    @property
    def N_whole(self):
        """The whole data set's number of observations."""
        return self.N if self.n_whole is None else self.n_whole

    @property
    def L(self):
        return self.y.shape[1]

    @property
    def P(self):
        return self.B.shape[2]

    @property
    def D(self):
        return self.X.shape[1]

    @property
    def device(self):
        return self.y.device


# Field order of the JAX GibbsState; with each field's number of axes for
# ONE chain (the port's tensors have one more, the leading chain axis).
STATE_FIELDS = {
    "Z": 2, "pi": 1, "alpha3": 0, "nu": 2, "tau": 1, "sigma2": 0, "chi": 2,
    "Phi": 3, "gamma": 3, "delta": 2, "A": 2, "eta": 3, "tau_eta": 2,
    "xi": 4, "gamma_xi": 4, "delta_xi": 3, "A_xi": 3,
}


@dataclasses.dataclass(frozen=True)
class GibbsState:
    """Current draw of every model parameter for C chains.

    Shapes are the JAX package's per-chain shapes with a leading C.
    ``tau`` is a precision scale (prior precision = tau_k * pen).
    """
    Z: torch.Tensor        # (C, N, K) simplex rows — mixed membership
    pi: torch.Tensor       # (C, K)    simplex — population allocation
    alpha3: torch.Tensor   # (C,)      Dirichlet concentration
    nu: torch.Tensor       # (C, K, P) feature means (basis coords)
    tau: torch.Tensor      # (C, K)    mean smoothness precisions
    sigma2: torch.Tensor   # (C,)      residual variance
    chi: torch.Tensor      # (C, N, M) per-observation eigen scores
    Phi: torch.Tensor      # (C, K, P, M) pseudo-eigenfunction coords
    gamma: torch.Tensor    # (C, K, P, M) local t-scale precisions (MGP)
    delta: torch.Tensor    # (C, K, M) MGP column multipliers
    A: torch.Tensor        # (C, K, 2) MGP hyperparameters (a1, a2)
    eta: torch.Tensor      # (C, K, P, D) covariate-adjusted mean coords
    tau_eta: torch.Tensor  # (C, K, D)
    xi: torch.Tensor       # (C, K, P, D, M)
    gamma_xi: torch.Tensor  # (C, K, P, D, M)
    delta_xi: torch.Tensor  # (C, K, M, D)
    A_xi: torch.Tensor     # (C, K, 2, D)

    def replace(self, **changes) -> "GibbsState":
        return dataclasses.replace(self, **changes)

    @property
    def K(self):
        return self.pi.shape[1]

    @property
    def M(self):
        return self.chi.shape[2]


def take_chains(state: GibbsState, index) -> GibbsState:
    """The chains ``index`` (an integer tensor on the state's device) of
    every field, in that order: parallel tempering's swap permutation and
    SMC's ancestors.  An index past the last chain is clamped to it, as
    JAX's gather clamps (systematic resampling can yield C when a float32
    cumulative sum ends below the last position; on the card an
    out-of-range index would be a device assert)."""
    index = index.clamp(0, state.Z.shape[0] - 1)
    return GibbsState(**{f: getattr(state, f).index_select(0, index)
                         for f in STATE_FIELDS})


def default_device(device=None) -> torch.device:
    """The device an entry point places its tensors on: ``device`` when one
    is given, else the CUDA card.  Without a card it raises; there is no
    fallback to the CPU, which has to be asked for by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bayesfmmm_torch places data and state on the CUDA card unless "
            "told otherwise, and torch.cuda.is_available() is false; pass "
            'device="cpu" to run on the CPU')
    return torch.device("cuda")


def make_functional_data(y_list, t_list, *, basis_degree, internal_knots,
                         boundary_knots, X=None, dtype=torch.float32,
                         device=None) -> ModelData:
    """Pad ragged functional observations and precompute design constants.

    Each function i is observed at t_list[i] (n_i points).  The tensors go
    to ``device``: the CUDA card when None (see ``default_device``).
    """
    device = default_device(device)
    N = len(y_list)
    lengths = [len(np.asarray(t)) for t in t_list]
    L = max(lengths)
    P = len(np.asarray(internal_knots).ravel()) + int(basis_degree) + 1

    y = np.zeros((N, L))
    mask = np.zeros((N, L))
    B = np.zeros((N, L, P))
    for i, (yi, ti) in enumerate(zip(y_list, t_list)):
        ni = lengths[i]
        y[i, :ni] = np.asarray(yi).ravel()
        mask[i, :ni] = 1.0
        B[i, :ni] = basis_mod.bspline_basis(
            np.asarray(ti).ravel(), int(basis_degree),
            np.asarray(internal_knots), np.asarray(boundary_knots))
    pen = basis_mod.rw1_penalty(P)
    return _finalize_data(y, mask, B, X, pen, dtype, device)


def make_hd_functional_data(y_list, t_list, *, basis_degrees,
                            internal_knots_list, boundary_knots, X=None,
                            dtype=torch.float32, device=None) -> ModelData:
    """Functional data on a multi-dimensional domain (surfaces, volumes):
    observation i is seen at the points t_list[i] (n_i, dim).  Tensor basis
    via TensorBSpline (BSplines.h:18-62), graph penalty via GetP
    (BSplines.h:70-120)."""
    device = default_device(device)
    N = len(y_list)
    lengths = [np.asarray(t).shape[0] for t in t_list]
    L = max(lengths)
    Bs = [basis_mod.tensor_bspline_basis(np.asarray(t), basis_degrees,
                                         internal_knots_list, boundary_knots)
          for t in t_list]
    P = Bs[0].shape[1]
    y = np.zeros((N, L))
    mask = np.zeros((N, L))
    B = np.zeros((N, L, P))
    for i, (yi, Bi) in enumerate(zip(y_list, Bs)):
        ni = lengths[i]
        y[i, :ni] = np.asarray(yi).ravel()
        mask[i, :ni] = 1.0
        B[i, :ni] = Bi
    pen = basis_mod.tensor_penalty(basis_degrees, internal_knots_list)
    return _finalize_data(y, mask, B, X, pen, dtype, device, family="hd")


def make_multivariate_data(y, X=None, dtype=torch.float32,
                           device=None) -> ModelData:
    """Multivariate observations y (N, P): identity basis, identity
    penalty (BMVMMM, BFMMM.h:2183).  The family's inverse-Gamma tau
    (UpdateTau.h:47-63) is the functional Gamma update on the precision
    scale with pen = I."""
    device = default_device(device)
    y = np.asarray(y, dtype=np.float64)
    N, P = y.shape
    B = np.broadcast_to(np.eye(P), (N, P, P)).copy()
    return _finalize_data(y, np.ones((N, P)), B, X, np.eye(P), dtype, device,
                          identity_basis=True, family="multivariate")


def _finalize_data(y, mask, B, X, pen, dtype, device, identity_basis=False,
                   family="functional") -> ModelData:
    N = y.shape[0]
    X = np.zeros((N, 0)) if X is None else np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    Bm = B * mask[:, :, None]
    ym = y * mask
    # Gram statistics in f64 on the host: every linear term of the sweep
    # works in P-space through them (ops/mean.py).
    G = np.einsum("nlp,nlq->npq", Bm, Bm)
    u = np.einsum("nlp,nl->np", Bm, ym)
    yy = np.einsum("nl,nl->n", ym, ym)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ModelData(y=dev(y), mask=dev(mask), B=dev(Bm), X=dev(X), G=dev(G),
                     pen=dev(pen), u=dev(u), yy=dev(yy),
                     n_obs=float(mask.sum()), identity_basis=identity_basis,
                     family=family, pen_rank=penalty_rank(pen, dtype))


def penalty_rank(pen, dtype=torch.float32) -> int:
    """Rank of the penalty as the data holds it (``pen`` in ``dtype``), on
    the host: the power of the smoothness prior's normalizer."""
    if isinstance(pen, torch.Tensor):
        pen = pen.detach().cpu()
    return int(np.linalg.matrix_rank(
        torch.as_tensor(np.array(pen), dtype=dtype).numpy()))


def init_state(generator, cfg: ModelConfig, data: ModelData, chains: int,
               c=None, dtype=torch.float32) -> GibbsState:
    """Random initial state for ``chains`` chains, with the reference
    driver's init distribution (BFMMM.h:1414-1442): nu, chi, Phi ~ N(0,1);
    gamma, delta, A, sigma2, tau, alpha3 = 1; pi ~ Dir(c); Z rows ~
    Dir(100 pi)."""
    K, P, M, D, N, C = cfg.K, data.P, cfg.M, data.D, data.N, chains
    kw = dict(dtype=dtype, device=data.device)
    c = (torch.full((K,), 10.0, **kw) if c is None
         else torch.as_tensor(c, **kw))
    pi = rdirichlet(generator, c.expand(C, K).contiguous())
    Z = rdirichlet(generator,
                   (100.0 * pi)[:, None, :].expand(C, N, K).contiguous())

    def normal(*shape):
        return torch.randn((C,) + shape, generator=generator, **kw)

    def ones(*shape):
        return torch.ones((C,) + shape, **kw)

    return GibbsState(
        Z=Z, pi=pi, alpha3=ones(), nu=normal(K, P), tau=ones(K),
        sigma2=ones(), chi=normal(N, M), Phi=normal(K, P, M),
        gamma=ones(K, P, M), delta=ones(K, M), A=ones(K, 2),
        eta=torch.zeros((C, K, P, D), **kw), tau_eta=ones(K, D),
        xi=torch.zeros((C, K, P, D, M), **kw), gamma_xi=ones(K, P, D, M),
        delta_xi=ones(K, M, D), A_xi=ones(K, 2, D),
    )
