"""Whole-model log-joint on unconstrained parameters (gradient-based path).

Port of ``bayesfmmm_tpu/models/logjoint.py`` with a leading chain axis C on
every tensor: the log-joint returns one value per chain, and the chains are
independent, so ``torch.autograd.grad(lp.sum(), q)`` gives each chain its
own gradient.  Transforms:

  * Z rows, pi       — additive-log-ratio softmax (last coordinate pinned),
                       with the Dirichlet prior density + ALR Jacobian
  * alpha3, sigma2, tau, gamma, delta, A (+ xi towers) — log transform
  * Phi, xi          — NON-CENTERED: Phi = raw / sqrt(tilde_tau * gamma);
                       raw ~ N(0,1), which cures the MGP funnel geometry
                       (UpdateDelta.h:33-41) that defeats centered HMC.

Priors follow the reference (citations inline): the functional smoothness
prior nu_k ~ N(0, (tau_k * pen)^-1) uses the penalty's rank for its
normalizing power, since RW(1)/graph penalties are singular (rank P-1;
BFMMM.h:1402-1412, BSplines.h:70-120).

The likelihood's RSS goes through ``ops/mean.py::rss_from_coeffs``: on the
card kernel K2, whose backward is a kernel too (``ops/kernels.py::
MeanRSS``), so the gradient reaches the likelihood there.

A sampler moves a flat position (C, dim): ``flatten`` and ``unflatten``
follow JAX's ``ravel_pytree`` order (the dataclass field order, empty
fields giving nothing), so a JAX position maps across bit for bit.  With
``covariate_cov=False`` the xi tower is held out of the position and keeps
its value (xi = 0): the JAX package samples it whenever X has columns
(ROADMAP F13), which the port does not copy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bayesfmmm_torch.models.state import GibbsState
from bayesfmmm_torch.ops.distributions import log_multi_beta
from bayesfmmm_torch.ops.mean import feature_offsets, rss_from_coeffs

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class UncState:
    """Unconstrained parameters of C chains (leading axis C)."""
    z_raw: torch.Tensor         # (C, N, K-1)
    pi_raw: torch.Tensor        # (C, K-1)
    log_alpha3: torch.Tensor    # (C,)
    nu: torch.Tensor            # (C, K, P)
    log_tau: torch.Tensor       # (C, K)
    log_sigma2: torch.Tensor    # (C,)
    chi: torch.Tensor           # (C, N, M)
    Phi_raw: torch.Tensor       # (C, K, P, M) non-centered
    log_gamma: torch.Tensor     # (C, K, P, M)
    log_delta: torch.Tensor     # (C, K, M)
    log_A: torch.Tensor         # (C, K, 2)
    eta: torch.Tensor           # (C, K, P, D)
    log_tau_eta: torch.Tensor   # (C, K, D)
    xi_raw: torch.Tensor        # (C, K, P, D, M) non-centered
    log_gamma_xi: torch.Tensor  # (C, K, P, D, M)
    log_delta_xi: torch.Tensor  # (C, K, M, D)
    log_A_xi: torch.Tensor      # (C, K, 2, D)

    def replace(self, **changes) -> "UncState":
        return dataclasses.replace(self, **changes)


UNC_FIELDS = tuple(f.name for f in dataclasses.fields(UncState))
XI_TOWER = ("xi_raw", "log_gamma_xi", "log_delta_xi", "log_A_xi")


def position_fields(covariate_cov=True):
    """The fields a sampler moves, in ``ravel_pytree`` order; the xi tower
    only with ``covariate_cov``."""
    return tuple(f for f in UNC_FIELDS if covariate_cov or f not in XI_TOWER)


def flatten(unc: UncState, covariate_cov=True) -> torch.Tensor:
    """(C, dim) position: each of ``position_fields`` flattened per chain,
    one after another (an empty field gives nothing)."""
    C = unc.log_sigma2.shape[0]
    return torch.cat([getattr(unc, f).reshape(C, -1)
                      for f in position_fields(covariate_cov)], dim=1)


def unflatten(q: torch.Tensor, like: UncState,
              covariate_cov=True) -> UncState:
    """The UncState whose ``position_fields`` are read from q (R, dim), in
    ``like``'s per-chain shapes; a field held out of the position is
    ``like``'s, whose chain axis must then be R or 1."""
    R = q.shape[0]
    moved = position_fields(covariate_cov)
    shapes = {f: getattr(like, f).shape[1:] for f in UNC_FIELDS}
    dim = sum(math.prod(shapes[f]) for f in moved)
    if dim != q.shape[1]:
        raise ValueError(f"position of {q.shape[1]} coordinates, the layout "
                         f"has {dim}")
    # one split, whose backward is one concatenation of the fields' grads
    parts = dict(zip(moved, q.split([math.prod(shapes[f]) for f in moved],
                                    dim=1)))
    return UncState(**{
        f: parts[f].reshape((R,) + shapes[f]) if f in parts
        else getattr(like, f).expand((R,) + shapes[f]) for f in UNC_FIELDS})


def _alr_forward(raw):
    """softmax([raw, 0]) along the last axis; returns (simplex, its log,
    log|J|).  The log is one log_softmax (z - logsumexp(z), as the JAX
    package writes it, in one kernel and one backward kernel)."""
    logp = torch.log_softmax(torch.nn.functional.pad(raw, (0, 1)), dim=-1)
    # Jacobian of ALR^-1: |J| = prod_k simplex_k
    return torch.exp(logp), logp, logp.sum(-1)


def _alr_inverse(simplex, eps=1e-8):
    s = simplex.clamp(eps, 1.0)
    return torch.log(s[..., :-1]) - torch.log(s[..., -1:])


def _xi_scale(gamma_xi, delta_xi):
    """sqrt(gamma_xi * tilde_tau_xi) (C, K, P, D, M): tilde_tau_xi the
    cumulative product of delta_xi (C, K, M, D) over M."""
    tt_xi = torch.cumprod(delta_xi, dim=2)                  # (C, K, M, D)
    return torch.sqrt(gamma_xi * tt_xi.transpose(2, 3)[:, :, None])


def _constrained(unc: UncState):
    """to_state's map, with what the log-joint also reads of the two
    simplex transforms: (state, log Z, log|J| of Z's rows, log pi, log|J|
    of pi)."""
    Z, log_Z, jac_z = _alr_forward(unc.z_raw)
    pi, log_pi, jac_pi = _alr_forward(unc.pi_raw)
    gamma = torch.exp(unc.log_gamma)
    delta = torch.exp(unc.log_delta)
    tilde_tau = torch.cumprod(delta, dim=2)                 # (C, K, M)
    Phi = unc.Phi_raw / torch.sqrt(gamma * tilde_tau[:, :, None, :])
    gamma_xi = torch.exp(unc.log_gamma_xi)
    delta_xi = torch.exp(unc.log_delta_xi)
    if unc.xi_raw.shape[3] > 0:
        xi = unc.xi_raw / _xi_scale(gamma_xi, delta_xi)
    else:
        xi = unc.xi_raw
    state = GibbsState(
        Z=Z, pi=pi, alpha3=torch.exp(unc.log_alpha3), nu=unc.nu,
        tau=torch.exp(unc.log_tau), sigma2=torch.exp(unc.log_sigma2),
        chi=unc.chi, Phi=Phi, gamma=gamma, delta=delta,
        A=torch.exp(unc.log_A), eta=unc.eta,
        tau_eta=torch.exp(unc.log_tau_eta), xi=xi, gamma_xi=gamma_xi,
        delta_xi=delta_xi, A_xi=torch.exp(unc.log_A_xi))
    return state, log_Z, jac_z, log_pi, jac_pi


def to_state(unc: UncState) -> GibbsState:
    """Map unconstrained coordinates to the natural parameterization."""
    return _constrained(unc)[0]


def from_state(state: GibbsState) -> UncState:
    """Inverse map (for warm-starting HMC from a Gibbs state)."""
    tilde_tau = torch.cumprod(state.delta, dim=2)
    Phi_raw = state.Phi * torch.sqrt(state.gamma * tilde_tau[:, :, None, :])
    if state.xi.shape[3] > 0:
        xi_raw = state.xi * _xi_scale(state.gamma_xi, state.delta_xi)
    else:
        xi_raw = state.xi
    return UncState(
        z_raw=_alr_inverse(state.Z), pi_raw=_alr_inverse(state.pi),
        log_alpha3=torch.log(state.alpha3), nu=state.nu,
        log_tau=torch.log(state.tau), log_sigma2=torch.log(state.sigma2),
        chi=state.chi, Phi_raw=Phi_raw, log_gamma=torch.log(state.gamma),
        log_delta=torch.log(state.delta), log_A=torch.log(state.A),
        eta=state.eta, log_tau_eta=torch.log(state.tau_eta), xi_raw=xi_raw,
        log_gamma_xi=torch.log(state.gamma_xi),
        log_delta_xi=torch.log(state.delta_xi),
        log_A_xi=torch.log(state.A_xi))


def init_unc(generator, cfg, data, chains, dtype=torch.float32) -> UncState:
    """Random unconstrained start of ``chains`` chains (JAX ``init_unc``):
    z_raw ~ 0.1 N(0, 1); nu, chi, Phi_raw ~ N(0, 1); everything else 0."""
    N, P, D, K, M, C = data.N, data.P, data.D, cfg.K, cfg.M, chains
    kw = dict(dtype=dtype, device=data.device)

    def normal(*shape):
        return torch.randn((C,) + shape, generator=generator, **kw)

    def zeros(*shape):
        return torch.zeros((C,) + shape, **kw)

    return UncState(
        z_raw=0.1 * normal(N, K - 1), pi_raw=zeros(K - 1),
        log_alpha3=zeros(), nu=normal(K, P), log_tau=zeros(K),
        log_sigma2=zeros(), chi=normal(N, M), Phi_raw=normal(K, P, M),
        log_gamma=zeros(K, P, M), log_delta=zeros(K, M), log_A=zeros(K, 2),
        eta=zeros(K, P, D), log_tau_eta=zeros(K, D), xi_raw=zeros(K, P, D, M),
        log_gamma_xi=zeros(K, P, D, M), log_delta_xi=zeros(K, M, D),
        log_A_xi=zeros(K, 2, D))


def make_log_joint(data, hp, c, pen_rank=None, temperature=1.0):
    """Returns log_joint(unc) -> (C,), one value per chain.

    ``temperature`` multiplies only the data likelihood (the reference's
    tempering semantics, e.g. UpdateNu.h:134-136).  The terms are the JAX
    package's; a few that share a factor are summed together (the Gamma
    prior of tau with nu's, of tau_eta with eta's; the two columns of A),
    and the model mean is formed as Z times ``ops/mean.py::
    feature_offsets``, with products of two operands.
    """
    if pen_rank is None:        # once, on the host
        pen_rank = int(np.linalg.matrix_rank(data.pen.detach().cpu().numpy()))
    n_obs = data.n_obs
    N, D = data.N, data.D
    kw = dict(dtype=data.y.dtype, device=data.device)
    # A ~ Gamma(alpha_l, beta_l) (UpdateA.h:17-44), A's two columns at once
    alpha_l = torch.tensor([hp.alpha1l, hp.alpha2l], **kw)
    beta_l = torch.tensor([hp.beta1l, hp.beta2l], **kw)

    def delta_prior(A, log_delta, delta):
        """MGP delta: delta_1 ~ Ga(a1, 1), delta_j ~ Ga(a2, 1) along axis 2
        (UpdateDelta.h:29,44 prior structure), (a1, a2) on A's axis 2."""
        a = A[:, :, :1]
        if delta.shape[2] > 1:
            a = torch.cat([a, A[:, :, 1:].expand_as(delta[:, :, 1:])], 2)
        return a * log_delta - delta - torch.lgamma(a)

    def log_joint(unc: UncState):
        state, log_Z, jac_z, log_pi, jac_pi = _constrained(unc)

        # --- likelihood (CalculateLikelihood.h:19-44), residual-space RSS
        w = torch.einsum("cnk,cnkp->cnp", state.Z,
                         feature_offsets(state, data.X))
        rss = rss_from_coeffs(data, w)
        ll = -0.5 * n_obs * (_LOG_2PI + unc.log_sigma2) \
            - 0.5 * rss / state.sigma2
        terms = [temperature * ll]

        # --- Z | pi, alpha3 ~ Dir(alpha3 * pi) + ALR jacobian ---
        a3pi = state.alpha3[:, None] * state.pi                  # (C, K)
        terms.append(((a3pi[:, None, :] - 1.0) * log_Z).sum((1, 2))
                     - N * log_multi_beta(a3pi) + jac_z.sum(1))
        # --- pi ~ Dir(c) ---
        terms.append(((c - 1.0) * log_pi).sum(1) + jac_pi)
        # --- alpha3 ~ Exp(b) (UpdateAlpha3.h:16) ---
        terms.append(unc.log_alpha3 - hp.b * state.alpha3)
        # --- nu_k | tau_k ~ N(0, (tau_k pen)^-1) (UpdateNu.h:66) and
        #     tau ~ Gamma(alpha_nu, beta_nu) (UpdateTau.h:18-36) ---
        quad = ((state.nu @ data.pen) * state.nu).sum(-1)       # (C, K)
        terms.append(((0.5 * pen_rank + hp.alpha_nu) * unc.log_tau
                      - state.tau * (0.5 * quad + hp.beta_nu)).sum(1))
        # --- sigma2 ~ IG(alpha_0, beta_0) (UpdateSigma.h:53) ---
        terms.append(-hp.alpha_0 * unc.log_sigma2 - hp.beta_0 / state.sigma2)
        # --- chi ~ N(0, 1) (UpdateChi.h:56-58); Phi non-centered: raw ~
        #     N(0, 1) ---
        terms.append(-0.5 * ((unc.chi ** 2).sum((1, 2))
                             + (unc.Phi_raw ** 2).sum((1, 2, 3))))
        # --- gamma ~ Gamma(nu1/2, nu1/2) (UpdateGamma.h:29) ---
        terms.append(0.5 * hp.nu_1 * (unc.log_gamma - state.gamma)
                     .sum((1, 2, 3)))
        # --- MGP delta and A ---
        terms.append(delta_prior(state.A, unc.log_delta, state.delta)
                     .sum((1, 2)))
        terms.append((alpha_l * unc.log_A - beta_l * state.A).sum((1, 2)))

        if D > 0:
            # eta | tau_eta (UpdateEta.h:84) and tau_eta's Gamma prior
            quad_e = (torch.einsum("pq,ckqd->ckpd", data.pen, state.eta)
                      * state.eta).sum(2)                       # (C, K, D)
            terms.append(((0.5 * pen_rank + hp.alpha_eta) * unc.log_tau_eta
                          - state.tau_eta * (0.5 * quad_e + hp.beta_eta))
                         .sum((1, 2)))
            # xi tower (non-centered) mirrors Phi's
            terms.append(-0.5 * (unc.xi_raw ** 2).sum((1, 2, 3, 4))
                         + 0.5 * hp.nu_1 * (unc.log_gamma_xi - state.gamma_xi)
                         .sum((1, 2, 3, 4)))
            terms.append(delta_prior(state.A_xi, unc.log_delta_xi,
                                     state.delta_xi).sum((1, 2, 3)))
            terms.append((alpha_l[:, None] * unc.log_A_xi
                          - beta_l[:, None] * state.A_xi).sum((1, 2, 3)))
        return torch.stack(terms).sum(0)

    return log_joint
