"""Conditional updaters of the sweep, with a chain axis.

Port of ``bayesfmmm_tpu/ops/gibbs.py``.  Every updater is a function
``(generator, state, ...) -> state`` over C chains at once: each state
tensor leads with the chain axis, data is shared, and the JAX package's
per-chain code plus vmap becomes batched tensor code.  Linear terms stay in
Gram space through the running coefficients ``cache.w`` (ops/mean.py);
squared residual norms go through the residual.

Masking: ``data.B`` rows and ``data.y`` are zero at padded points, so
u/G/yy absorb the mask; only the observation count reads it.

Two kernel censuses make up ``sweep_full``:

  * the reference order (BFMMM.h:1500-1554): Z, pi, alpha3, Phi, delta, A,
    gamma, nu, tau, sigma, chi;
  * the production census the JAX bench runs (``collapsed_z``, ``gauge``,
    ``phi_mala_steps``): the chi-marginal (Z, chi) block, the joint chi
    draw, the gauge moves, the MGP- and noise-scale interweaves and
    preconditioned MALA on Phi.  None of these is a reference kernel; the
    JAX package's block comments derive each and its exactness.

A scalar draw per chain in the JAX package (a feature pair, a step, a
uniform) is a (C,) draw here, and its "which feature / which column" picks
are gathers and one-hot masks per chain; an MH accept is a per-chain
``torch.where`` over every state field it moved.

Covariate terms (eta in the mean, xi in the eigen directions) vanish at
D = 0; with the identity basis of the multivariate family G_n = I, so the
Gram sums need neither kernel K3 nor K2 and skip them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from bayesfmmm_torch.models import logjoint
from bayesfmmm_torch.ops import kernels
from bayesfmmm_torch.ops.distributions import (
    chol_precision,
    dirichlet_logpdf_unnormalized,
    log_multi_beta,
    mvn_from_chol,
    normal,
    randint,
    rdirichlet,
    standard_gamma,
    truncnorm_logpdf,
    truncnorm_sample,
    uniform,
)
from bayesfmmm_torch.ops.linalg import (
    mvn_from_precision_fused,
    small_chol,
    small_chol_logdet,
    small_solve_lower,
)
from bayesfmmm_torch.ops.mean import (
    SweepCache,
    apply_basis,
    build_cache,
    eigen_directions,
    feature_offsets,
    gram_dirs,
    gram_vec,
    rss_from_coeffs,
)
from bayesfmmm_torch.samplers.hmc import _leapfrog, value_and_grad

# Joint draw of a whole blocked family (all K*M(*D) blocks of Phi or xi) up
# to this dimension, as in the JAX package; above it the dense joint
# precision outgrows its use and the blocks are drawn one after another.
_JOINT_MAX_DIM = 4096


def use_full_f32():
    """Float32 products in full precision (TF32 off), matching the JAX
    package's precision="highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _uniform(generator, like, shape, chain_dim=0):
    return uniform(generator, shape, dtype=like.dtype, device=like.device,
                   chain_dim=chain_dim)


def _tempered_precision(beta, sigma2):
    """beta / sigma2 (C,), the tempered likelihood's precision.  PyTorch
    takes a float over a tensor as the reciprocal times the float, so a
    tensor beta takes the same two steps and equal entries give the
    float's bits."""
    return sigma2.reciprocal() * beta


def _check_beta(beta, state):
    """A sweep's temperature: a float for every chain, or a (C,) tensor on
    the state's device, one per chain (shape and device only: nothing is
    read on the host)."""
    if torch.is_tensor(beta):
        C = state.Z.shape[0]
        if beta.shape != (C,) or beta.device != state.Z.device:
            raise ValueError(f"beta must be a float or a ({C},) tensor on "
                             f"{state.Z.device}; got {tuple(beta.shape)} on "
                             f"{beta.device}")


def _mh_accept(log_acc, u):
    """MH decision: NaN -> reject (gibbs.py:211 of the JAX package)."""
    return torch.where(torch.isnan(log_acc), False, torch.log(u) < log_acc)


def _gram_bvec(data, wt, w_excl):
    """sum_n wt[c, n] (u_n - G_n w_excl[c, n]) -> (C, P)."""
    return torch.einsum("cn,cnp->cp", wt, data.u - gram_vec(data, w_excl))


def _weighted_gram(data, W):
    """sum_n W[..., n] G_n -> (..., P, P); the leading axes of W are
    flattened into the rows of kernel K3 (ops/kernels.py::weighted_gram).
    With the identity basis every G_n is I and the sum is sum_n W_n times
    I: no kernel."""
    N, P = data.G.shape[0], data.G.shape[-1]
    if data.identity_basis:
        return W.sum(-1)[..., None, None] * torch.eye(
            P, dtype=W.dtype, device=W.device)
    out = kernels.weighted_gram(W.reshape(-1, N).contiguous(), data.G)
    return out.reshape(W.shape[:-1] + (P, P))


def _joint_blocked_draw(generator, data, s, W, prior_diag, blocks_cur, w):
    """Exact joint MVN draw of ALL blocks of one blocked-Gibbs family.

    Per chain, the stacked conditional of the B blocks is Gaussian with

        A[(a,p),(b,q)] = s * sum_n W_an W_bn G_n[p,q]
                         + delta_ab delta_pq prior_diag[a,p]
        b[(a,p)]       = s * sum_n W_an (u_n - G_n w_excl_n)[p]

    and one (B*P)-dimensional factor-and-solve (kernel K1 on CUDA) draws it.
    W (C, B, N) block weights, prior_diag and blocks_cur (C, B, P), s (C,).
    Returns (blocks_new, w_new).
    """
    C, Bn, N = W.shape
    P = blocks_cur.shape[2]
    w_excl = w - torch.einsum("cbn,cbp->cnp", W, blocks_cur)
    resid = data.u - gram_vec(data, w_excl)
    if data.identity_basis:                     # A = (W W') kron I
        A = torch.einsum("can,cbn->cab", W, W)[:, :, None, :, None] \
            * torch.eye(P, dtype=W.dtype, device=W.device)[:, None, :]
    else:
        A = torch.einsum("can,cbn,npq->capbq", W, W, data.G)
    bvec = s[:, None] * torch.einsum("cbn,cnp->cbp", W,
                                     resid).reshape(C, Bn * P)
    A = s[:, None, None] * A.reshape(C, Bn * P, Bn * P) \
        + torch.diag_embed(prior_diag.reshape(C, Bn * P))
    new, _ = mvn_from_precision_fused(generator, A, bvec)
    blocks_new = new.reshape(C, Bn, P)
    w_new = w_excl + torch.einsum("cbn,cbp->cnp", W, blocks_new)
    return blocks_new, w_new


# ---------------------------------------------------------------------------
# Z — mixed membership rows (MH with a Dirichlet random-walk proposal)
# Reference: updateZ_PM (UpdateMixedMembership.h:131-261); all rows of all
# chains are conditionally independent and move in one batch.
# ---------------------------------------------------------------------------

def update_z(generator, state, data, hp, cache: SweepCache, beta=1.0):
    # Row log-likelihoods in residual space (the Gram quadratic cancels in
    # f32); both endpoints stacked into one pass over B.
    T = feature_offsets(state, data.X)                       # (C, N, K, P)
    Z_new = rdirichlet(generator, hp.a_Z_PM * state.Z)
    Z2 = torch.stack([state.Z, Z_new])                        # (2, C, N, K)
    w2 = torch.einsum("ecnk,cnkp->ecnp", Z2, T)
    r = data.y - apply_basis(data, w2)
    # a (C,) beta meets the (2, C, N) row sums on their chain axis
    b = beta[:, None] if torch.is_tensor(beta) else beta
    ll = -b * (r * r).sum(-1) / (2.0 * state.sigma2[:, None])
    lpr = ((state.alpha3[:, None] * state.pi - 1.0)[:, None, :]
           * torch.log(Z2)).sum(-1)
    lp = ll + lpr
    # Hastings correction, both directions in one density call
    q2 = dirichlet_logpdf_unnormalized(
        torch.stack([Z_new, state.Z]),
        hp.a_Z_PM * torch.stack([state.Z, Z_new]))
    log_acc = lp[1] - lp[0] + q2[1] - q2[0]
    # auto-accept when the current row touched the boundary
    # (UpdateMixedMembership.h:170-174)
    boundary = (state.Z <= 0.0).any(-1)
    u = _uniform(generator, state.Z, log_acc.shape)
    accept = _mh_accept(log_acc, u) | boundary
    Z = torch.where(accept[..., None], Z_new, state.Z)
    w = torch.einsum("cnk,cnkp->cnp", Z, T)
    return state.replace(Z=Z), cache.replace(w=w)


# ---------------------------------------------------------------------------
# pi — population allocation (MH with a Dirichlet proposal)
# Reference: updatePi_PM / lpdf_pi_PM (UpdatePi.h:39-116)
# ---------------------------------------------------------------------------

def update_pi(generator, state, hp, c):
    logZ_colsum = torch.log(state.Z).sum(1)                   # (C, K)
    N = state.Z.shape[1]
    a3 = state.alpha3[:, None]

    def lpdf(pi):
        return (((c - 1.0) * torch.log(pi)).sum(-1)
                + ((a3 * pi - 1.0) * logZ_colsum).sum(-1)
                - N * log_multi_beta(a3 * pi))

    pi_new = rdirichlet(generator, hp.a_pi_PM * state.pi)
    log_acc = (lpdf(pi_new) - lpdf(state.pi)
               + dirichlet_logpdf_unnormalized(state.pi, hp.a_pi_PM * pi_new)
               - dirichlet_logpdf_unnormalized(pi_new,
                                               hp.a_pi_PM * state.pi))
    accept = _mh_accept(log_acc, _uniform(generator, state.pi,
                                          log_acc.shape))
    return state.replace(pi=torch.where(accept[:, None], pi_new, state.pi))


# ---------------------------------------------------------------------------
# alpha_3 — Dirichlet concentration (truncated-normal MH)
# Reference: updateAlpha3 (UpdateAlpha3.h:10-63), with the JAX package's
# documented deviation: the standard Hastings term q(old|new) - q(new|old)
# replaces the reference's sign slip (gibbs.py:526-533).
# ---------------------------------------------------------------------------

def update_alpha3(generator, state, hp):
    logZ_colsum = torch.log(state.Z).sum(1)
    N = state.Z.shape[1]

    def lpdf(a3):
        return (-hp.b * a3
                + ((a3[:, None] * state.pi - 1.0) * logZ_colsum).sum(-1)
                - N * log_multi_beta(a3[:, None] * state.pi))

    sd = hp.var_alpha3
    a_new = truncnorm_sample(generator, state.alpha3, sd)
    log_acc = (lpdf(a_new) - lpdf(state.alpha3)
               + truncnorm_logpdf(state.alpha3, a_new, sd)
               - truncnorm_logpdf(a_new, state.alpha3, sd))
    accept = _mh_accept(log_acc, _uniform(generator, a_new, a_new.shape))
    return state.replace(alpha3=torch.where(accept, a_new, state.alpha3))


# ---------------------------------------------------------------------------
# nu — feature mean coordinates (blocked Gibbs, one K-row at a time)
# Reference: updateNu (UpdateNu.h:24-74).  Row j ~ MVN with
#   precision = (beta/sigma2) sum_i Z_ij^2 B_i'B_i + tau_j pen
#   linear    = (beta/sigma2) sum_i Z_ij B_i' r_ij
# ---------------------------------------------------------------------------

def update_nu(generator, state, data, hp, cache: SweepCache, beta=1.0):
    s = _tempered_precision(beta, state.sigma2)               # (C,)
    # every row's precision depends only on (Z, tau, sigma2): factor all K
    # in one batched Cholesky before the sequential loop
    prec = s[:, None, None, None] \
        * _weighted_gram(data, (state.Z * state.Z).transpose(1, 2)) \
        + state.tau[..., None, None] * data.pen
    Lc = chol_precision(prec)                                 # (C, K, P, P)
    w = cache.w
    rows = []
    for j in range(state.K):
        zj = state.Z[:, :, j]                                 # (C, N)
        w_excl = w - zj[..., None] * state.nu[:, None, j]
        bvec = s[:, None] * _gram_bvec(data, zj, w_excl)
        nu_j, _ = mvn_from_chol(generator, Lc[:, j], bvec)
        w = w_excl + zj[..., None] * nu_j[:, None]
        rows.append(nu_j)
    return state.replace(nu=torch.stack(rows, 1)), cache.replace(w=w)


def _sequential_blocked_draw(generator, data, s, W, prior_diag, blocks_cur,
                             w):
    """The blocks of one family drawn one after another, each from its
    conditional given the rest (the reference's order, UpdatePhi.h:23-89,
    UpdateXi.h:26-93): the path above ``_JOINT_MAX_DIM``.  Same arguments
    and returns as ``_joint_blocked_draw``.  Every block's precision
    s sum_n W_bn^2 G_n + diag(prior) depends on no block, so all are summed
    by one K3 launch and factored in one batched Cholesky; the loop keeps
    the linear term and two P-dimensional solves a block."""
    prec = s[:, None, None, None] * _weighted_gram(data, W * W) \
        + torch.diag_embed(prior_diag)
    Lc = chol_precision(prec)                                 # (C, B, P, P)
    new = []
    for b in range(W.shape[1]):
        wt = W[:, b]                                          # (C, N)
        w_excl = w - wt[..., None] * blocks_cur[:, None, b]
        bvec = s[:, None] * _gram_bvec(data, wt, w_excl)
        blk, _ = mvn_from_chol(generator, Lc[:, b], bvec)
        w = w_excl + wt[..., None] * blk[:, None]
        new.append(blk)
    return torch.stack(new, 1), w


def _blocked_draw(generator, data, s, W, prior_diag, blocks_cur, w):
    """Joint draw of all blocks up to ``_JOINT_MAX_DIM``, else the
    sequential scan."""
    joint = W.shape[1] * blocks_cur.shape[2] <= _JOINT_MAX_DIM
    draw = _joint_blocked_draw if joint else _sequential_blocked_draw
    return draw(generator, data, s, W, prior_diag, blocks_cur, w)


# ---------------------------------------------------------------------------
# eta — covariate-adjusted mean coordinates (blocked Gibbs over (d, j))
# Reference: updateEta (UpdateEta.h:28-94); loop order d outer, j inner.
# All D*K precisions come from one K3 launch (R = C*D*K rows) and one
# batched Cholesky; the draws use the generator in loop order.
# ---------------------------------------------------------------------------

def update_eta(generator, state, data, hp, cache: SweepCache, beta=1.0):
    K, D = state.K, data.D
    if D == 0:
        return state, cache
    s = _tempered_precision(beta, state.sigma2)
    Z2X2 = torch.einsum("nd,cnj->cdjn", data.X * data.X, state.Z * state.Z)
    prec = s[:, None, None, None, None] * _weighted_gram(data, Z2X2) \
        + state.tau_eta.transpose(1, 2)[..., None, None] * data.pen
    Lc = chol_precision(prec)                                 # (C, D, K, P, P)
    w = cache.w
    cols = [[None] * D for _ in range(K)]
    for d in range(D):
        for j in range(K):
            wt = state.Z[:, :, j] * data.X[:, d]              # (C, N)
            w_excl = w - wt[..., None] * state.eta[:, None, j, :, d]
            bvec = s[:, None] * _gram_bvec(data, wt, w_excl)
            new, _ = mvn_from_chol(generator, Lc[:, d, j], bvec)
            w = w_excl + wt[..., None] * new[:, None]
            cols[j][d] = new
    eta = torch.stack([torch.stack(c, -1) for c in cols], 1)  # (C, K, P, D)
    return state.replace(eta=eta), cache.replace(w=w)


# ---------------------------------------------------------------------------
# Phi — pseudo-eigenfunction coordinates: one joint draw of all (j, m)
# blocks.  Reference: updatePhi (UpdatePhi.h:23-89); prior precision
# tilde_tau(j,m) * gamma(j,:,m) with tilde_tau = cumprod(delta).
# ---------------------------------------------------------------------------

def update_phi(generator, state, data, hp, cache: SweepCache, beta=1.0):
    C, K, P, M = state.Phi.shape
    tilde_tau = torch.cumprod(state.delta, dim=2)             # (C, K, M)
    s = _tempered_precision(beta, state.sigma2)
    prior_diag = tilde_tau[..., None] * state.gamma.transpose(2, 3)
    W = torch.einsum("cnj,cnm->cjmn", state.Z, state.chi).reshape(
        C, K * M, -1)
    blocks = state.Phi.transpose(2, 3).reshape(C, K * M, P)
    new, w = _blocked_draw(generator, data, s, W,
                           prior_diag.reshape(C, K * M, P), blocks, cache.w)
    Phi = new.reshape(C, K, M, P).transpose(2, 3)
    return state.replace(Phi=Phi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# xi — covariate-adjusted eigen coordinates: one joint draw of all
# (j, m, d) blocks.  Reference: updateXiCovariateAdj (UpdateXi.h:26-93);
# prior precision tilde_tau_xi(j,m,d) * gamma_xi(j,:,d,m).  Blocks are
# ordered (j, m, d), so xi (C, K, P, D, M) is read and written through the
# transpose (0, 1, 4, 3, 2).
# ---------------------------------------------------------------------------

def update_xi(generator, state, data, hp, cache: SweepCache, beta=1.0):
    D = data.D
    if D == 0:
        return state, cache
    C, K, P, _, M = state.xi.shape
    tilde_tau_xi = torch.cumprod(state.delta_xi, dim=2)       # (C, K, M, D)
    s = _tempered_precision(beta, state.sigma2)
    prior_diag = tilde_tau_xi[..., None] \
        * state.gamma_xi.permute(0, 1, 4, 3, 2)               # (C, K, M, D, P)
    B = K * M * D
    W = torch.einsum("cnj,cnm,nd->cjmdn", state.Z, state.chi,
                     data.X).reshape(C, B, -1)
    blocks = state.xi.permute(0, 1, 4, 3, 2).reshape(C, B, P)
    new, w = _blocked_draw(generator, data, s, W,
                           prior_diag.reshape(C, B, P), blocks, cache.w)
    xi = new.reshape(C, K, M, D, P).permute(0, 1, 4, 3, 2)
    return state.replace(xi=xi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# chi — per-observation eigen scores (scalar Gibbs over m, batched over n)
# Reference: updateChi (UpdateChi.h:19-64): posterior precision 1 + W/sigma2.
# ---------------------------------------------------------------------------

def update_chi(generator, state, data, hp, cache: SweepCache, beta=1.0):
    s = _tempered_precision(beta, state.sigma2)[:, None]      # (C, 1)
    U = eigen_directions(state, data.X)                       # (C, N, P, M)
    GU = gram_dirs(data, U)
    Wden = 1.0 + s[..., None] * (U * GU).sum(2)               # (C, N, M)
    uU = torch.einsum("np,cnpm->cnm", data.u, U)
    w = cache.w
    cols = list(state.chi.unbind(-1))
    for m in range(state.M):
        Um, GUm = U[..., m], GU[..., m]                       # (C, N, P)
        w_excl = w - cols[m][..., None] * Um
        fr = uU[..., m] - (GUm * w_excl).sum(-1)              # F_m' r
        Wm = Wden[..., m]
        z = normal(generator, fr.shape, dtype=fr.dtype, device=fr.device)
        new = s * fr / Wm + z / torch.sqrt(Wm)
        w = w_excl + new[..., None] * Um
        cols[m] = new
    return state.replace(chi=torch.stack(cols, -1)), cache.replace(w=w)


# ---------------------------------------------------------------------------
# sigma^2 — conjugate inverse-Gamma (UpdateSigma.h:22-58; tempered: shape
# and rate scale by beta, :101-103).  The RSS is kernel K2 on CUDA.
# ---------------------------------------------------------------------------

def sigma_shape_rate(state, data, hp, cache: SweepCache, beta=1.0):
    """The inverse-Gamma shape and rate of sigma^2 | rest, each (C,).  A
    tensor beta takes the shape in float64, as the host does for a float
    one, so that equal entries give the float's bits."""
    rss = rss_from_coeffs(data, cache.w)                      # (C,)
    if torch.is_tensor(beta):
        a = (hp.alpha_0 + beta.double() * data.n_obs / 2.0).to(rss.dtype)
    else:
        a = torch.full_like(rss, hp.alpha_0 + beta * data.n_obs / 2.0)
    return a, hp.beta_0 + beta * rss / 2.0


def update_sigma(generator, state, data, hp, cache: SweepCache, beta=1.0):
    a, b = sigma_shape_rate(state, data, hp, cache, beta)
    return state.replace(sigma2=b / standard_gamma(generator, a))


# ---------------------------------------------------------------------------
# tau — mean smoothness precisions (conjugate Gamma, UpdateTau.h:18-36)
# ---------------------------------------------------------------------------

def update_tau(generator, state, data, hp):
    P = state.nu.shape[2]
    quad = torch.einsum("ckp,pq,ckq->ck", state.nu, data.pen, state.nu)
    rate = hp.beta_nu + 0.5 * quad
    g = standard_gamma(generator, torch.full_like(quad, hp.alpha_nu + P / 2))
    return state.replace(tau=g / rate)


def update_tau_eta(generator, state, data, hp):
    """Reference: updateTauEta (UpdateTau.h:75-95) / MV (:106-124)."""
    if data.D == 0:
        return state
    P = state.eta.shape[2]
    quad = torch.einsum("ckpd,pq,ckqd->ckd", state.eta, data.pen, state.eta)
    rate = hp.beta_eta + 0.5 * quad
    g = standard_gamma(generator,
                       torch.full_like(quad, hp.alpha_eta + P / 2))
    return state.replace(tau_eta=g / rate)


# ---------------------------------------------------------------------------
# delta — MGP column multipliers (UpdateDelta.h:17-64):
#   shape_i = a(k, i==0 ? 0 : 1) + P*(M-i)/2
#   rate_i  = 1 + 0.5 sum_{m>=i} S_m prod_{n<=m, n!=i} delta_n
# All M standard-Gamma variates come from one batched draw (the shapes do
# not depend on delta); only the rates are sequential, through the
# prefix (new) x suffix (old) split of the product.
# ---------------------------------------------------------------------------

def _mgp_delta_draw(generator, S, delta, a1, a2, P):
    """The delta tower for S, delta (C, K, M, ...) with the column axis at
    2 and a1, a2 (C, K, ...): returns the new delta."""
    M = S.shape[2]
    tail = (1,) * (S.dim() - 3)
    m_idx = torch.arange(M, device=S.device).view((M,) + tail)
    shapes = torch.where(m_idx == 0, a1[:, :, None], a2[:, :, None]) \
        + P * (M - m_idx) / 2.0
    G = standard_gamma(generator, shapes)
    O = torch.cumprod(delta, dim=2)
    T = torch.flip(torch.cumsum(torch.flip(S * O, [2]), 2), [2])
    pref = torch.ones_like(S[:, :, 0])
    cols = []
    for i in range(M):
        d_i = G[:, :, i] / (1.0 + 0.5 * pref * T[:, :, i] / O[:, :, i])
        cols.append(d_i)
        pref = pref * d_i
    return torch.stack(cols, 2)


def update_delta(generator, state, hp):
    P = state.Phi.shape[2]
    S = (state.gamma * state.Phi ** 2).sum(2)                 # (C, K, M)
    return state.replace(delta=_mgp_delta_draw(
        generator, S, state.delta, state.A[..., 0], state.A[..., 1], P))


def update_delta_xi(generator, state, hp):
    """Reference: updateDeltaXi (UpdateDelta.h:76-125): one MGP tower per
    covariate, the same shapes and rates as ``update_delta``."""
    if state.delta_xi.shape[3] == 0:
        return state
    P = state.xi.shape[2]
    S = (state.gamma_xi * state.xi ** 2).sum(2).transpose(2, 3)  # (C,K,M,D)
    return state.replace(delta_xi=_mgp_delta_draw(
        generator, S, state.delta_xi, state.A_xi[:, :, 0],
        state.A_xi[:, :, 1], P))


# ---------------------------------------------------------------------------
# gamma — local t-scale precisions (UpdateGamma.h:17-37):
#   gamma_kjm ~ Gamma((nu1+1)/2, rate = (nu1 + tilde_tau_km phi_kjm^2)/2)
# ---------------------------------------------------------------------------

def update_gamma(generator, state, hp):
    tilde_tau = torch.cumprod(state.delta, dim=2)             # (C, K, M)
    rate = (hp.nu_1 + tilde_tau[:, :, None, :] * state.Phi ** 2) / 2.0
    g = standard_gamma(generator, torch.full_like(rate,
                                                  (hp.nu_1 + 1.0) / 2.0))
    return state.replace(gamma=g / rate)


def update_gamma_xi(generator, state, hp):
    """Reference: updateGammaXi (UpdateGamma.h:48-73)."""
    if state.gamma_xi.shape[3] == 0:
        return state
    tilde = torch.cumprod(state.delta_xi, dim=2).transpose(2, 3)  # (C,K,D,M)
    rate = (hp.nu_1 + tilde[:, :, None] * state.xi ** 2) / 2.0
    g = standard_gamma(generator, torch.full_like(rate,
                                                  (hp.nu_1 + 1.0) / 2.0))
    return state.replace(gamma_xi=g / rate)


# ---------------------------------------------------------------------------
# A — MGP hyperparameters (truncated-normal MH, UpdateA.h:17-123)
# ---------------------------------------------------------------------------

def _lpdf_a1(a, delta0, hp):
    return (-torch.lgamma(a) + (a - 1.0) * torch.log(delta0)
            + (hp.alpha1l - 1.0) * torch.log(a) - a * hp.beta1l)


def _lpdf_a2(a, delta_tail_logsum, M_minus_1, hp):
    return (-M_minus_1 * torch.lgamma(a) + (hp.alpha2l - 1.0) * torch.log(a)
            - a * hp.beta2l + (a - 1.0) * delta_tail_logsum)


def _mh_truncnorm(generator, a_cur, sd, lpdf):
    a_new = truncnorm_sample(generator, a_cur, sd)
    log_acc = (lpdf(a_new) + truncnorm_logpdf(a_cur, a_new, sd)
               - lpdf(a_cur) - truncnorm_logpdf(a_new, a_cur, sd))
    accept = _mh_accept(log_acc, _uniform(generator, a_cur, a_cur.shape))
    return torch.where(accept, a_new, a_cur)


def update_a(generator, state, hp):
    M = state.delta.shape[2]
    a1 = _mh_truncnorm(generator, state.A[..., 0], hp.var_epsilon1 / hp.beta1l,
                       lambda a: _lpdf_a1(a, state.delta[..., 0], hp))
    tail = torch.log(state.delta[..., 1:]).sum(-1)
    a2 = _mh_truncnorm(generator, state.A[..., 1], hp.var_epsilon2 / hp.beta2l,
                       lambda a: _lpdf_a2(a, tail, M - 1.0, hp))
    return state.replace(A=torch.stack([a1, a2], -1))


def update_a_xi(generator, state, hp):
    """Reference: updateAXi (UpdateA.h:137-205), over (K, D) at once."""
    if state.A_xi.shape[3] == 0:
        return state
    M = state.delta_xi.shape[2]
    a1 = _mh_truncnorm(generator, state.A_xi[:, :, 0],
                       hp.var_epsilon1 / hp.beta1l,
                       lambda a: _lpdf_a1(a, state.delta_xi[:, :, 0], hp))
    tail = torch.log(state.delta_xi[:, :, 1:]).sum(2)         # (C, K, D)
    a2 = _mh_truncnorm(generator, state.A_xi[:, :, 1],
                       hp.var_epsilon2 / hp.beta2l,
                       lambda a: _lpdf_a2(a, tail, M - 1.0, hp))
    return state.replace(A_xi=torch.stack([a1, a2], 2))


# ---------------------------------------------------------------------------
# Production census: shared pieces
# ---------------------------------------------------------------------------

def _mean_only_offsets(state, X):
    """T[c, n, k, p] = nu_k + eta_k x_n: the features' mean coefficients
    without the chi terms (the chi-marginal kernels' mean structure)."""
    T = state.nu[:, None].expand(-1, X.shape[0], -1, -1)
    if X.shape[1] > 0:
        T = T + torch.einsum("ckpd,nd->cnkp", state.eta, X)
    return T


def _feature_eigendirs(state, X):
    """V[c, n, k, p, m] = Phi_k + xi_k x_n: each feature's eigen directions
    as observation n sees them (Z-independent)."""
    V = state.Phi[:, None].expand(-1, X.shape[0], -1, -1, -1)
    if X.shape[1] > 0:
        V = V + torch.einsum("ckpdm,nd->cnkpm", state.xi, X)
    return V


def _mean_only_coeffs(state, X):
    """a[c, n, p] = sum_k Z_nk (nu_k + eta_k x_n): the mean coefficients
    without the chi terms."""
    a = torch.einsum("cnk,ckp->cnp", state.Z, state.nu)
    if X.shape[1] > 0:
        a = a + torch.einsum("cnk,ckpd,nd->cnp", state.Z, state.eta, X)
    return a


def _where_rows(ok, new, old):
    """new where ok else old; ok's axes lead those of new and old."""
    return torch.where(ok.view(ok.shape + (1,) * (new.dim() - ok.dim())),
                       new, old)


def select_state(ok, new, old):
    """Per-chain MH accept of a whole state: every field that ``new`` holds
    as another tensor than ``old`` is taken where ok (C,) is True."""
    changes = {}
    for f in dataclasses.fields(old):
        n, o = getattr(new, f.name), getattr(old, f.name)
        if n is not o:
            changes[f.name] = _where_rows(ok, n, o)
    return old.replace(**changes)


def _ordered_pair(generator, shape, K, device):
    """A uniform ordered pair (a, b) of distinct indices < K, each of the
    given shape."""
    idx = randint(generator, 0, K * (K - 1), shape, device=device)
    a = idx // (K - 1)
    rem = idx % (K - 1)
    return a, torch.where(rem >= a, rem + 1, rem)


def _chi_factor(U, GU, s):
    """Cholesky factor of the chi-row precision I + s U'G U, per row:
    U and GU (..., C, N, P, M), s (C,) -> (..., C, N, M, M)."""
    M = U.shape[-1]
    prec = s[:, None, None, None] * torch.einsum("...pi,...pj->...ij", U, GU)
    return small_chol(prec + torch.eye(M, dtype=U.dtype, device=U.device))


def _chi_draw(generator, L, b):
    """chi rows ~ N(Q^-1 b, Q^-1) for Q = L L' (C, N, M, M), b (C, N, M):
    mean and noise through one pair of triangular solves."""
    z = normal(generator, b.shape, dtype=b.dtype, device=b.device)
    x = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    out = torch.linalg.solve_triangular(
        L.mT, torch.cat([x, z[..., None]], -1), upper=True)
    return out[..., 0] + out[..., 1]


# ---------------------------------------------------------------------------
# (Z, chi) — partially collapsed block update (JAX gibbs.py:218-498).
# Z rows move by MH against the chi-marginal row likelihood
#   y_i | Z_i ~ N(B_i a_i, sigma2/beta I + F_i F_i'),  a_i = sum_k Z_ik nu_k,
#   F_i = B_i U_i,  U_i = sum_k Z_ik Phi_k,
# evaluated in M-space through Q_i = I + s U_i'G_i U_i (determinant lemma
# and Woodbury), then every chi row is redrawn from its exact conditional.
# ---------------------------------------------------------------------------

def _row_stats(state, data, Z2, s):
    """Chi-marginal row statistics at stacked endpoints Z2 (E, C, N, K):
    a (E, C, N, P), U (E, C, N, P, M), L = chol(Q) (E, C, N, M, M),
    Fr = U'(u - G a) (E, C, N, M) and rr = ||y - B a||^2 (E, C, N).

    rr is a per-row RSS in residual space (f32-stable), so it stays plain
    PyTorch: kernel K2 sums per chain only."""
    if data.D > 0:
        a = torch.einsum("ecnk,cnkp->ecnp", Z2,
                         _mean_only_offsets(state, data.X))
        U = torch.einsum("ecnk,cnkpm->ecnpm", Z2,
                         _feature_eigendirs(state, data.X))
    else:
        a = torch.einsum("ecnk,ckp->ecnp", Z2, state.nu)
        U = torch.einsum("ecnk,ckpm->ecnpm", Z2, state.Phi)
    L = _chi_factor(U, gram_dirs(data, U), s)
    ur = data.u - gram_vec(data, a)
    Fr = torch.einsum("ecnpm,ecnp->ecnm", U, ur)
    r = data.y - apply_basis(data, a)
    return a, U, L, Fr, (r * r).sum(-1)


def _marg_loglik(s, L, Fr, rr):
    """Chi-marginal row log-likelihood, up to a constant: (E, C, N)."""
    v = small_solve_lower(L, Fr)
    s = s[:, None]
    quad = s * rr - s * s * (v * v).sum(-1)
    return -0.5 * (small_chol_logdet(L) + quad)


def _row_lprior(state, Z2):
    return ((state.alpha3[:, None] * state.pi - 1.0)[:, None, :]
            * torch.log(Z2)).sum(-1)


def _categorical(generator, logits):
    """One draw per column of an unnormalized log-probability table
    (K, C, ...) -> (C, ...), by the Gumbel maximum (as
    jax.random.categorical)."""
    u = _uniform(generator, logits, logits.shape, chain_dim=1)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=0)


def update_z_chi(generator, state, data, hp, cache: SweepCache, beta=1.0,
                 p_indep=0.3, anchor_prop=False, anchor_conc=300.0):
    """Collapsed (Z, chi) block update.

    Proposal per row: with probability ``p_indep`` an independence draw
    from Dir(alpha3 pi), else the Dirichlet random walk Dir(a_Z_PM Z_i);
    the Hastings ratio uses the mixture density both ways.  Then a
    label-swap stage proposes exchanging two coordinates of each row (a
    symmetric involution); with ``anchor_prop`` an anchor-guided
    independence stage follows (below); and finally chi | Z is drawn
    jointly."""
    s = _tempered_precision(beta, state.sigma2)
    Z = state.Z
    C, N, K = Z.shape
    alpha_ind = (state.alpha3[:, None] * state.pi)[:, None, :].expand_as(Z)
    Z_rw = rdirichlet(generator, hp.a_Z_PM * Z)
    Z_ind = rdirichlet(generator, alpha_ind)
    use_ind = _uniform(generator, Z, (C, N)) < p_indep
    Z_new = torch.where(use_ind[..., None], Z_ind, Z_rw)

    # both mixture densities q(new|old), q(old|new) in one density call
    ld = dirichlet_logpdf_unnormalized(
        torch.stack([Z_new, Z, Z_new, Z]),
        torch.cat([hp.a_Z_PM * torch.stack([Z, Z_new]),
                   torch.stack([alpha_ind, alpha_ind])]))
    if p_indep <= 0.0:
        q_fwd, q_bwd = ld[0], ld[1]
    else:
        li, lr = math.log(p_indep), math.log1p(-p_indep)
        q_fwd = torch.logaddexp(li + ld[2], lr + ld[0])
        q_bwd = torch.logaddexp(li + ld[3], lr + ld[1])

    Z2 = torch.stack([Z, Z_new])
    a2, U2, L2, Fr2, rr2 = _row_stats(state, data, Z2, s)
    lpr = _row_lprior(state, Z2)
    ml = _marg_loglik(s, L2, Fr2, rr2)
    log_acc = ml[1] + lpr[1] - ml[0] - lpr[0] + q_bwd - q_fwd
    # auto-accept when the current row touched the boundary
    boundary = (Z <= 0.0).any(-1)
    acc = _mh_accept(log_acc, _uniform(generator, Z, (C, N))) | boundary
    Z, a, U, L, Fr, ml_cur, lpr_cur = (
        _where_rows(acc, n_, o_) for n_, o_ in zip(
            (Z_new, a2[1], U2[1], L2[1], Fr2[1], ml[1], lpr[1]),
            (Z, a2[0], U2[0], L2[0], Fr2[0], ml[0], lpr[0])))

    # label swap: exchange two coordinates of each row (an involution)
    i1, i2 = _ordered_pair(generator, (C, N), K, Z.device)
    cols = torch.arange(K, device=Z.device)
    sel1 = cols == i1[..., None]
    sel2 = cols == i2[..., None]
    z1 = torch.where(sel1, Z, 0.0).sum(-1, keepdim=True)
    z2 = torch.where(sel2, Z, 0.0).sum(-1, keepdim=True)
    Z_swap = torch.where(sel1, z2, torch.where(sel2, z1, Z))
    a_s, U_s, L_s, Fr_s, rr_s = _row_stats(state, data, Z_swap[None], s)
    ml_s = _marg_loglik(s, L_s, Fr_s, rr_s)[0]
    lpr_s = _row_lprior(state, Z_swap[None])[0]
    acc_s = _mh_accept((ml_s + lpr_s) - (ml_cur + lpr_cur),
                       _uniform(generator, Z, (C, N)))
    Z, a, U, L, Fr = (
        _where_rows(acc_s, n_, o_) for n_, o_ in zip(
            (Z_swap, a_s[0], U_s[0], L_s[0], Fr_s[0]), (Z, a, U, L, Fr)))

    if anchor_prop:
        # anchor-guided independence stage (JAX gibbs.py:429-480): each
        # row's chi-marginal log-likelihood at the K corners e_k (state-
        # independent points, so the anchor weights P(a) serve both
        # directions) picks an anchor a, and z' ~ Dir(conc e_a + 1/2); the
        # Hastings ratio uses the mixture q(z) = sum_a P(a) Dir(z; conc e_a
        # + 1/2) both ways (the shared normalizer cancels).  Rows on the
        # simplex boundary are excluded (q is improper at exact zeros).
        ml_cur = torch.where(acc_s, ml_s, ml_cur)
        lpr_cur = torch.where(acc_s, lpr_s, lpr_cur)
        corners = torch.eye(K, dtype=Z.dtype, device=Z.device)
        _, _, L_c, Fr_c, rr_c = _row_stats(
            state, data, corners[:, None, None, :].expand(K, C, N, K), s)
        ml_c = _marg_loglik(s, L_c, Fr_c, rr_c)                # (K, C, N)
        log_pa = torch.log(torch.softmax(ml_c, 0) + 1e-38)
        a_sel = _categorical(generator, ml_c)                  # (C, N)
        Z_anchor = rdirichlet(generator, anchor_conc * corners[a_sel] + 0.5)

        def log_q_anchor(z):
            """log sum_a P(a) Dir_unnorm(z; conc e_a + 1/2) per row: the
            exponent at anchor a is -1/2 sum_k log z_k + conc log z_a."""
            lz = torch.log(z)                                  # (C, N, K)
            per_a = -0.5 * lz.sum(-1) + anchor_conc * lz.permute(2, 0, 1)
            return torch.logsumexp(per_a + log_pa, 0)          # (C, N)

        a_a, U_a, L_a, Fr_a, rr_a = _row_stats(state, data, Z_anchor[None], s)
        ml_a = _marg_loglik(s, L_a, Fr_a, rr_a)[0]
        lpr_a = _row_lprior(state, Z_anchor[None])[0]
        log_acc_a = ((ml_a + lpr_a) - (ml_cur + lpr_cur)
                     + log_q_anchor(Z) - log_q_anchor(Z_anchor))
        acc_a = (Z > 0.0).all(-1) & _mh_accept(
            log_acc_a, _uniform(generator, Z, (C, N)))
        Z, a, U, L, Fr = (
            _where_rows(acc_a, n_, o_) for n_, o_ in zip(
                (Z_anchor, a_a[0], U_a[0], L_a[0], Fr_a[0]), (Z, a, U, L, Fr)))

    # exact joint chi | Z draw: precision Q = I + s U'GU, linear s U'(u - Ga)
    chi = _chi_draw(generator, L, s[:, None, None] * Fr)
    w = a + torch.einsum("cnpm,cnm->cnp", U, chi)
    return state.replace(Z=Z, chi=chi), cache.replace(w=w)


def _redraw_chi(generator, data, s, U, a):
    """Exact joint chi | rest draw for eigen directions U (C, N, P, M) and
    chi-free coefficients a (C, N, P): precision I + s U'GU and linear term
    s U'(u - G a) per row.  Returns (chi, w = a + U chi)."""
    L = _chi_factor(U, gram_dirs(data, U), s)
    ur = data.u - gram_vec(data, a)
    chi = _chi_draw(generator, L, s[:, None, None]
                    * torch.einsum("cnpm,cnp->cnm", U, ur))
    return chi, a + torch.einsum("cnpm,cnm->cnp", U, chi)


def update_chi_joint(generator, state, data, hp, cache: SweepCache,
                     beta=1.0):
    """Exact joint draw of every chi row (JAX gibbs.py:759-797): one
    batched M x M Cholesky in place of update_chi's sequential scan over
    m."""
    U = eigen_directions(state, data.X)                       # (C, N, P, M)
    a = cache.w - torch.einsum("cnpm,cnm->cnp", U, state.chi)
    chi, w = _redraw_chi(generator, data,
                         _tempered_precision(beta, state.sigma2), U, a)
    return state.replace(chi=chi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# Gauge moves — MH along the mean's exact invariances (JAX gibbs.py:
# 1000-1190): (a) feature mixing T = I + (1 - e^-eps) e_a (e_b - e_a)'
# applied to (nu, Phi) with Z <- Z T^-1; (b) eigen rescale chi_m / s,
# Phi_m * s; (c) Givens rotation of an eigen pair.  The likelihood is
# untouched, so the ratio is the prior ratio plus the map's log-Jacobian.
# ---------------------------------------------------------------------------

def _gauge_logprior(state, data, hp):
    """Prior terms that gauge maps can change, per chain (C,)."""
    lp = _row_lprior(state, state.Z).sum(-1)
    quad_nu = torch.einsum("ckp,pq,ckq->ck", state.nu, data.pen, state.nu)
    lp = lp - 0.5 * (state.tau * quad_nu).sum(-1)
    tilde = torch.cumprod(state.delta, dim=2)                 # (C, K, M)
    lp = lp - 0.5 * (tilde[:, :, None, :] * state.gamma
                     * state.Phi ** 2).sum((1, 2, 3))
    lp = lp - 0.5 * (state.chi ** 2).sum((1, 2))
    if data.D > 0:
        quad_eta = torch.einsum("ckpd,pq,ckqd->ckd", state.eta, data.pen,
                                state.eta)
        lp = lp - 0.5 * (state.tau_eta * quad_eta).sum((1, 2))
        pri = torch.cumprod(state.delta_xi, dim=2).transpose(2, 3)
        lp = lp - 0.5 * (pri[:, :, None] * state.gamma_xi
                         * state.xi ** 2).sum((1, 2, 3, 4))
    return lp


def _mix_features(state, data, ea, eb, eps):
    """The feature-mixing map per chain: ea, eb (C, K) one-hot, eps (C,)."""
    c = 1.0 - torch.exp(-eps)
    cp = 1.0 - torch.exp(eps)

    def rowmap(x):                                            # (C, K, ...)
        tail = (1,) * (x.dim() - 2)
        xa = torch.einsum("ck,ck...->c...", ea, x)
        xb = torch.einsum("ck,ck...->c...", eb, x)
        return x + ea.view(ea.shape + tail) \
            * (c.view((-1,) + tail) * (xb - xa))[:, None]

    za = torch.einsum("cnk,ck->cn", state.Z, ea)
    Z = state.Z + cp[:, None, None] * za[..., None] * (eb - ea)[:, None, :]
    new = dict(Z=Z, nu=rowmap(state.nu), Phi=rowmap(state.Phi))
    if data.D > 0:
        new.update(eta=rowmap(state.eta), xi=rowmap(state.xi))
    return state.replace(**new)


def _rescale_eigen(state, data, em, log_s):
    """The eigen-rescale map per chain: em (C, M) component mask, log_s
    (C,)."""
    scale_m = 1.0 + (torch.exp(log_s) - 1.0)[:, None] * em    # (C, M)
    new = dict(chi=state.chi / scale_m[:, None, :],
               Phi=state.Phi * scale_m[:, None, None, :])
    if data.D > 0:
        new["xi"] = state.xi * scale_m[:, None, None, None, :]
    return state.replace(**new)


def _rotate_eigen(state, data, m1, m2, theta):
    """The Givens rotation of eigen columns (m1, m2) by theta, per chain:
    m1, m2 (C,) indices, theta (C,)."""
    M = state.M
    dt = state.chi.dtype
    c = (torch.cos(theta) - 1.0)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    e1 = torch.nn.functional.one_hot(m1, M).to(dt)
    e2 = torch.nn.functional.one_hot(m2, M).to(dt)

    def outer(u, v):
        return u[:, :, None] * v[:, None, :]

    R = (torch.eye(M, dtype=dt, device=theta.device)
         + c * (outer(e1, e1) + outer(e2, e2))
         + s * (outer(e2, e1) - outer(e1, e2)))               # (C, M, M)
    new = dict(chi=torch.einsum("cnm,cml->cnl", state.chi, R),
               Phi=torch.einsum("ckpm,cml->ckpl", state.Phi, R))
    if data.D > 0:
        new["xi"] = torch.einsum("ckpdm,cml->ckpdl", state.xi, R)
    return state.replace(**new)


def update_gauge(generator, state, data, hp):
    """One feature-mixing, one eigen-rescale and (M >= 2) one
    eigen-rotation MH proposal, with the JAX package's default steps 0.3,
    0.3 and 0.5; each chain draws its own pair, step and uniform."""
    C, K, M = state.Z.shape[0], state.K, state.M
    P = state.nu.shape[2]
    dt, dev = state.nu.dtype, state.nu.device
    D = data.D
    jac_mix = data.N - P * (1.0 + M + D + D * M)
    jac_scale = K * P * (1.0 + D) - data.N
    eyeK = torch.eye(K, dtype=dt, device=dev)
    eyeM = torch.eye(M, dtype=dt, device=dev)

    def gauss():
        return normal(generator, (C,), dtype=dt, device=dev)

    def mh(st, lp, prop, log_jac):
        lp_new = _gauge_logprior(prop, data, hp)
        ok = _mh_accept(lp_new - lp + log_jac,
                        _uniform(generator, lp, lp.shape))
        return select_state(ok, prop, st), torch.where(ok, lp_new, lp)

    lp = _gauge_logprior(state, data, hp)
    a, b = _ordered_pair(generator, (C,), K, dev)
    eps = 0.3 * gauss()
    state, lp = mh(state, lp,
                   _mix_features(state, data, eyeK[a], eyeK[b], eps),
                   eps * jac_mix)
    m = randint(generator, 0, M, (C,), device=dev)
    log_s = 0.3 * gauss()
    state, lp = mh(state, lp, _rescale_eigen(state, data, eyeM[m], log_s),
                   log_s * jac_scale)
    if M >= 2:
        m1, m2 = _ordered_pair(generator, (C,), M, dev)
        theta = 0.5 * gauss()
        state, lp = mh(state, lp, _rotate_eigen(state, data, m1, m2, theta),
                       0.0)
    return state


# ---------------------------------------------------------------------------
# MGP scale interweave (JAX gibbs.py:1195-1277): delta_{k,i} -> delta e^eps
# with the non-centred Phi * sqrt(tilde_tau gamma) held fixed, i.e. Phi
# columns m >= i of feature k scale by e^(-eps/2);
#   log a = beta dloglik + (a_i - 1) eps - delta_ki (e^eps - 1) + eps.
# The two RSS endpoints go through kernel K2 stacked on the chain axis.
# ---------------------------------------------------------------------------

def update_mgp_scale(generator, state, data, hp, cache: SweepCache, beta=1.0):
    """Four interweaved MGP-scale moves of step 0.03 (the JAX package's
    defaults), each at a random (feature, column) per chain."""
    C, K, P, M = state.Phi.shape
    dt, dev = state.Phi.dtype, state.Phi.device
    ar = torch.arange(C, device=dev)
    m_idx = torch.arange(M, device=dev)
    w = cache.w
    for _ in range(4):
        idx = randint(generator, 0, K * M, (C,), device=dev)
        kf = idx // M
        col = idx % M
        eps = 0.03 * normal(generator, (C,), dtype=dt, device=dev)
        fmask = torch.nn.functional.one_hot(kf, K).to(dt)        # (C, K)
        cmask = (m_idx >= col[:, None]).to(dt)                   # (C, M)
        smul = 1.0 + (torch.exp(-eps / 2.0) - 1.0)[:, None, None, None] \
            * fmask[:, :, None, None] * cmask[:, None, None, :]  # (C,K,1,M)
        Phi_new = state.Phi * smul
        dw = torch.einsum("cnk,ckpm,cnm->cnp", state.Z,
                          Phi_new - state.Phi, state.chi)
        rss = rss_from_coeffs(data, torch.cat([w, w + dw]))      # (2C,)
        dll = -beta * (rss[C:] - rss[:C]) / (2.0 * state.sigma2)
        a_i = torch.where(col == 0, state.A[ar, kf, 0], state.A[ar, kf, 1])
        d_ki = state.delta[ar, kf, col]
        log_acc = dll + (a_i - 1.0) * eps - d_ki * (torch.exp(eps) - 1.0) \
            + eps
        ok = _mh_accept(log_acc, _uniform(generator, eps, (C,)))
        dmul = 1.0 + (torch.exp(eps) - 1.0)[:, None, None] \
            * fmask[:, :, None] \
            * torch.nn.functional.one_hot(col, M).to(dt)[:, None, :]
        state = state.replace(
            Phi=_where_rows(ok, Phi_new, state.Phi),
            delta=_where_rows(ok, state.delta * dmul, state.delta))
        w = _where_rows(ok, w + dw, w)
    return state, cache.replace(w=w)


# ---------------------------------------------------------------------------
# Noise/eigen-scale interweave (JAX gibbs.py:1280-1397): the joint slide
#   sigma2 -> sigma2 e^eps,  Phi -> Phi e^(eps/2),  delta[:, 0] -> e^-eps
# with (Z, chi, nu, gamma, A) fixed.  The move rescales only the eigen part
# e = B U chi of the mean, so RSS at cumulative scale s is the quadratic
# rr0 - 2 s re + s^2 ee, formed once; the chained moves are scalar math.
# ---------------------------------------------------------------------------

def _noise_scale_log_acc(eps, s, sig2, d0, d0xi, rss_coeffs, n_tot, sumA,
                         hp, beta):
    """Closed-form MH log-acceptance of one slide at cumulative eigen scale
    ``s`` (elementwise over chains)."""
    rr0, re, ee = rss_coeffs

    def rss(sc):
        return rr0 - 2.0 * sc * re + sc * sc * ee

    em = torch.exp(-eps)
    dll = -beta * (n_tot * eps / 2.0
                   + (rss(s * torch.exp(eps / 2.0)) * em - rss(s))
                   / (2.0 * sig2))
    return (dll - hp.alpha_0 * eps - hp.beta_0 / sig2 * (em - 1.0)
            - sumA * eps - (em - 1.0) * (d0 + d0xi))


def update_noise_scale(generator, state, data, hp, cache: SweepCache,
                       beta=1.0):
    """Eight chained joint (sigma2, MGP/eigen-scale) slide moves of step
    0.015 (the JAX package's defaults)."""
    dt = state.Phi.dtype
    C = state.Phi.shape[0]
    U = eigen_directions(state, data.X)                       # (C, N, P, M)
    ec = torch.einsum("cnpm,cnm->cnp", U, state.chi)
    ac = cache.w - ec
    r0 = data.y - apply_basis(data, ac)
    e = apply_basis(data, ec)
    coeffs = ((r0 * r0).sum((1, 2)), (r0 * e).sum((1, 2)),
              (e * e).sum((1, 2)))
    sumA = state.A[:, :, 0].sum(-1)
    d0 = state.delta[:, :, 0].sum(-1)
    if data.D > 0:
        sumA = sumA + state.A_xi[:, :, 0].sum((1, 2))
        d0xi = state.delta_xi[:, :, 0].sum((1, 2))
    else:
        d0xi = torch.zeros_like(d0)
    s = torch.ones_like(d0)
    sig2 = state.sigma2
    for _ in range(8):
        eps = 0.015 * normal(generator, (C,), dtype=dt, device=d0.device)
        log_acc = _noise_scale_log_acc(eps, s, sig2, d0, d0xi, coeffs,
                                       data.n_obs, sumA, hp, beta)
        ok = _mh_accept(log_acc, _uniform(generator, eps, (C,)))
        gr = torch.where(ok, torch.exp(eps), 1.0)
        s, sig2, d0, d0xi = s * torch.sqrt(gr), sig2 * gr, d0 / gr, d0xi / gr
    inv_s2 = 1.0 / (s * s)
    delta = state.delta.clone()
    delta[:, :, 0] = delta[:, :, 0] * inv_s2[:, None]
    new = dict(sigma2=sig2, Phi=state.Phi * s[:, None, None, None],
               delta=delta)
    if data.D > 0:
        delta_xi = state.delta_xi.clone()
        delta_xi[:, :, 0] = delta_xi[:, :, 0] * inv_s2[:, None, None]
        new.update(xi=state.xi * s[:, None, None, None, None],
                   delta_xi=delta_xi)
    return state.replace(**new), cache.replace(w=ac + s[:, None, None] * ec)


# ---------------------------------------------------------------------------
# Phi MALA under the chi-marginal target (JAX gibbs.py:1561-1677):
# preconditioned Langevin steps on the whole Phi, the diagonal
# preconditioner per column (||Phi_k[:, m]|| + 0.1)/sqrt(N) frozen at entry,
# then one exact joint chi | Phi redraw.  The gradient of the potential is
# autograd's, per chain (the chains' potentials are independent, so the
# gradient of their sum is each chain's own).
# ---------------------------------------------------------------------------

def _chi_marginal_ll(Phi, Z, data, s, ur, sum_rr0, U_xi=None):
    """beta-tempered chi-marginal log-likelihood per chain (C,), up to a
    constant; ur = u - G a and sum_rr0 = ||y - B a||^2 for the mean-only
    coefficients a, U_xi the covariate part sum_k Z_nk xi_k x_n of the
    eigen directions (a constant of the Phi moves; None at D = 0)."""
    U = torch.einsum("cnk,ckpm->cnpm", Z, Phi)
    if U_xi is not None:
        U = U + U_xi
    L = _chi_factor(U, gram_dirs(data, U), s)
    v = small_solve_lower(L, torch.einsum("cnpm,cnp->cnm", U, ur))
    return -0.5 * (small_chol_logdet(L).sum(-1) + s * sum_rr0
                   - s * s * (v * v).sum((1, 2)))


def _phi_move_terms(state, data, beta):
    """What the Phi moves hold fixed: (s, a, ur, sum_rr0, U_xi) for the
    mean-only coefficients a (kernel K2 for sum_rr0 on CUDA)."""
    s = _tempered_precision(beta, state.sigma2)
    a = _mean_only_coeffs(state, data.X)
    ur = data.u - gram_vec(data, a)
    sum_rr0 = rss_from_coeffs(data, a)                        # kernel K2
    # xi is held fixed by the moves: its part of U enters as a constant
    # that carries no graph
    U_xi = (torch.einsum("cnk,ckpdm,nd->cnpm", state.Z, state.xi,
                         data.X).detach() if data.D > 0 else None)
    return s, a, ur, sum_rr0, U_xi


def _mala_potential(Phi, Z, data, s, ur, sum_rr0, pri, U_xi=None):
    """-(beta-tempered chi-marginal loglik + MGP log prior of Phi) per
    chain (C,)."""
    ll = _chi_marginal_ll(Phi, Z, data, s, ur, sum_rr0, U_xi)
    return -(ll - 0.5 * (pri * Phi * Phi).sum((1, 2, 3)))


# ---------------------------------------------------------------------------
# Phi column moves under the chi-marginal target (JAX gibbs.py:1435-1558):
# MH on single columns (k, m) of Phi with chi integrated out, the MGP prior
# term of the column, then one exact joint chi | Phi redraw.  Each chain
# draws its own column each move: gathers and one-hot masks per chain.
# ---------------------------------------------------------------------------

def update_phi_chi(generator, state, data, hp, cache: SweepCache, beta=1.0,
                   *, sigma_rw=0.1, n_moves=6):
    """``n_moves`` chi-marginal MH column moves on Phi, then the joint chi
    redraw.

    Proposal: a uniform column (k, m); step N(0, sigma_rw^2 col_scale^2 I)
    with col_scale = (||Phi_k[:, m]|| + 0.1) / sqrt(N).  The scale depends
    on the column's norm, so the proposal is not symmetric and the Hastings
    ratio evaluates both directions' Gaussian densities."""
    C, K, P, M = state.Phi.shape
    dt, dev = state.Phi.dtype, state.Phi.device
    s, a, ur, sum_rr0, U_xi = _phi_move_terms(state, data, beta)

    def cols(x):
        """(C, K, P, M) -> (C, K M, P): column j = k M + m."""
        return x.permute(0, 1, 3, 2).reshape(C, K * M, P)

    pri_cols = torch.cumprod(state.delta, dim=2).reshape(C, K * M, 1) \
        * cols(state.gamma)
    rows = torch.arange(C, device=dev)
    j_all = torch.arange(K * M, device=dev)
    sqrt_n = math.sqrt(data.N)
    Phi = state.Phi
    ll = _chi_marginal_ll(Phi, state.Z, data, s, ur, sum_rr0, U_xi)
    for _ in range(n_moves):
        j = randint(generator, 0, K * M, (C,), device=dev)
        noise = normal(generator, (C, P), dtype=dt, device=dev)
        u = _uniform(generator, Phi, (C,))
        col = cols(Phi)[rows, j]                               # (C, P)
        sc = (torch.linalg.vector_norm(col, dim=1) + 0.1) / sqrt_n
        step = sigma_rw * sc[:, None] * noise
        col_new = col + step
        sc_new = (torch.linalg.vector_norm(col_new, dim=1) + 0.1) / sqrt_n
        ss = (step * step).sum(1)
        lq_fwd = -P * torch.log(sc) - ss / (2.0 * (sigma_rw * sc) ** 2)
        lq_bwd = -P * torch.log(sc_new) - ss / (2.0 * (sigma_rw * sc_new) ** 2)
        sel = (j_all == j[:, None]).view(C, K, 1, M)
        Phi_new = torch.where(sel, col_new[:, None, :, None], Phi)
        ll_new = _chi_marginal_ll(Phi_new, state.Z, data, s, ur, sum_rr0,
                                  U_xi)
        dpri = -0.5 * (pri_cols[rows, j] * (col_new ** 2 - col ** 2)).sum(1)
        ok = _mh_accept(ll_new - ll + dpri + lq_bwd - lq_fwd, u)
        Phi = _where_rows(ok, Phi_new, Phi)
        ll = torch.where(ok, ll_new, ll)

    U = torch.einsum("cnk,ckpm->cnpm", state.Z, Phi)
    if U_xi is not None:
        U = U + U_xi
    chi, w = _redraw_chi(generator, data, s, U, a)
    return state.replace(Phi=Phi, chi=chi), cache.replace(w=w)


def update_phi_mala(generator, state, data, hp, cache: SweepCache, beta=1.0,
                    *, step=0.05, n_steps=4):
    """``n_steps`` preconditioned MALA steps on Phi, then the joint chi
    redraw.  Nothing leaves this function attached to a graph."""
    C, K, P, M = state.Phi.shape
    dt, dev = state.Phi.dtype, state.Phi.device
    pri = torch.cumprod(state.delta, dim=2)[:, :, None, :] * state.gamma
    s, a, ur, sum_rr0, U_xi = _phi_move_terms(state, data, beta)

    def pot_grad(x):
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            pot = _mala_potential(x, state.Z, data, s, ur, sum_rr0, pri,
                                  U_xi)
            grad, = torch.autograd.grad(pot.sum(), x)
        return pot.detach(), grad

    # frozen diagonal preconditioner: per-column marginal width scale
    W = ((state.Phi ** 2).sum(2, keepdim=True).sqrt() + 0.1) \
        / math.sqrt(data.N)                                   # (C, K, 1, M)
    V = W * W
    e2 = step * step
    x = state.Phi
    pot, grad = pot_grad(x)
    for _ in range(n_steps):
        xi = normal(generator, x.shape, dtype=dt, device=dev)
        x_new = x - 0.5 * e2 * V * grad + step * W * xi
        pot_new, grad_new = pot_grad(x_new)
        lq_fwd = -0.5 * (xi * xi).sum((1, 2, 3))
        db = x - (x_new - 0.5 * e2 * V * grad_new)
        lq_bwd = -(db * db / V).sum((1, 2, 3)) / (2.0 * e2)
        ok = _mh_accept(pot - pot_new + lq_bwd - lq_fwd,
                        _uniform(generator, pot, (C,)))
        x = _where_rows(ok, x_new, x)
        pot = torch.where(ok, pot_new, pot)
        grad = _where_rows(ok, grad_new, grad)

    U = torch.einsum("cnk,ckpm->cnpm", state.Z, x)
    if U_xi is not None:
        U = U + U_xi
    chi, w = _redraw_chi(generator, data, s, U, a)
    return state.replace(Phi=x, chi=chi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# Whole-model HMC inside the sweep (JAX gibbs.py:1680-1747): one jittered-
# length trajectory on the unconstrained log-joint (models/logjoint.py) per
# chain.  The target is the same posterior, so the composition with the
# Gibbs kernels is invariant.  Every chain draws its own length in
# [1, n_leapfrog]; the batch runs n_leapfrog masked steps with no host read,
# a chain past its length frozen.  A rejected chain gets its ORIGINAL state
# back, not the round trip through the unconstrained space (whose clipping
# would nudge exact-zero Z entries).  The xi tower is moved only with
# ``covariate_cov``; otherwise it keeps its value, where the JAX package
# moves it whenever X has columns (ROADMAP F14).
# ---------------------------------------------------------------------------

def update_hmc_joint(generator, state, data, hp, c, beta=1.0, *, eps=0.01,
                     n_leapfrog=8, inv_mass=None, covariate_cov=False):
    """One jittered-length HMC trajectory of every chain on the whole
    unconstrained model.  ``inv_mass``: a flat diagonal inverse mass (dim,)
    in ``logjoint.flatten`` order, shared by every chain (say warm-frozen
    posterior variances); ones when None.  The gradient goes through
    ``kernels.MeanRSS``: K2 forward and backward once an evaluation on the
    card, 1 + n_leapfrog evaluations; the penalty's rank is the data's
    (``ModelData.pen_rank``), so nothing is read on the host."""
    lj = logjoint.make_log_joint(data, hp, c, temperature=beta)
    unc = logjoint.from_state(state)
    q0 = logjoint.flatten(unc, covariate_cov)
    C, dim = q0.shape
    kw = dict(dtype=q0.dtype, device=q0.device)
    inv_mass = (torch.ones(dim, **kw) if inv_mass is None
                else torch.as_tensor(inv_mass, **kw))

    def vg(q):
        return value_and_grad(
            lambda x: lj(logjoint.unflatten(x, unc, covariate_cov)), q)

    logp0, grad0 = vg(q0)
    p0 = normal(generator, (C, dim), **kw) / torch.sqrt(inv_mass)
    n = randint(generator, 1, n_leapfrog + 1, (C,), device=q0.device)
    q, p, _, logp1 = _leapfrog(vg, q0, p0, grad0, logp0,
                               torch.full((C,), eps, **kw), inv_mass, n,
                               n_max=n_leapfrog)
    ke0 = 0.5 * (inv_mass * p0 * p0).sum(1)
    ke1 = 0.5 * (inv_mass * p * p).sum(1)
    ok = _mh_accept((logp1 - ke1) - (logp0 - ke0), _uniform(generator, q0,
                                                           (C,)))
    with torch.no_grad():
        new = logjoint.to_state(logjoint.unflatten(q, unc, covariate_cov))
    if not covariate_cov:       # the held-out tower keeps its very bits
        new = new.replace(xi=state.xi, gamma_xi=state.gamma_xi,
                          delta_xi=state.delta_xi, A_xi=state.A_xi)
    return select_state(ok, new, state)


# ---------------------------------------------------------------------------
# The sweeps of the three phases (JAX gibbs.py:1754-1866; BFMMM.h:1073-1100
# phase 1, :1253-1298 phase 2, :1500-1554 phase 3)
# ---------------------------------------------------------------------------

def _covariate_tail(generator, state, data, hp, cache, beta, covariate_mean,
                    covariate_cov, *, eta=True):
    """The covariate-adjusted updaters that close a sweep, in the JAX
    package's order (BFMMM.h:4810-4893): eta, tau_eta, then xi and its MGP
    tower.  ``eta=False`` keeps eta pinned (phase 2)."""
    if covariate_mean:
        if eta:
            state, cache = update_eta(generator, state, data, hp, cache,
                                      beta)
        state = update_tau_eta(generator, state, data, hp)
    if covariate_cov:
        state, cache = update_xi(generator, state, data, hp, cache, beta)
        state = update_delta_xi(generator, state, hp)
        state = update_a_xi(generator, state, hp)
        state = update_gamma_xi(generator, state, hp)
    return state, cache


def sweep_nu_z(generator, state, data, hp, c, *, covariate_mean=False,
               beta=1.0):
    """One phase-1 sweep of every chain: Z, pi, alpha3, nu, tau, sigma
    [, eta, tau_eta].

    Phi is held at zero in this phase (BFMMM.h:1063), so the likelihood is
    chi-free by construction; Phi, chi and the Phi tower are not touched.
    ``beta`` as in ``sweep_full``."""
    _check_beta(beta, state)
    use_full_f32()
    cache = build_cache(data, state)
    state, cache = update_z(generator, state, data, hp, cache, beta)
    state = update_pi(generator, state, hp, c)
    state = update_alpha3(generator, state, hp)
    state, cache = update_nu(generator, state, data, hp, cache, beta)
    state = update_tau(generator, state, data, hp)
    state = update_sigma(generator, state, data, hp, cache, beta)
    return _covariate_tail(generator, state, data, hp, cache, beta,
                           covariate_mean, False)[0]


def sweep_theta(generator, state, data, hp, *, covariate_mean=False,
                covariate_cov=False, beta=1.0):
    """One phase-2 sweep of every chain: Phi, delta, A, gamma, tau, sigma,
    chi [, tau_eta, xi and its tower], with (Z, nu, eta, pi, alpha3)
    pinned.  ``beta`` as in ``sweep_full``."""
    _check_beta(beta, state)
    use_full_f32()
    cache = build_cache(data, state)
    state, cache = update_phi(generator, state, data, hp, cache, beta)
    state = update_delta(generator, state, hp)
    state = update_a(generator, state, hp)
    state = update_gamma(generator, state, hp)
    state = update_tau(generator, state, data, hp)
    state = update_sigma(generator, state, data, hp, cache, beta)
    state, cache = update_chi(generator, state, data, hp, cache, beta)
    return _covariate_tail(generator, state, data, hp, cache, beta,
                           covariate_mean, covariate_cov, eta=False)[0]


def sweep_full(generator, state, data, hp, c, *, covariate_mean=False,
               covariate_cov=False, beta=1.0, collapsed_z=False,
               gauge=False, p_indep=0.3, phi_chi_moves=0,
               phi_chi_sigma=0.1, phi_mala_steps=0, phi_mala_step=0.05,
               z_anchor=False, hmc_steps=0, hmc_eps=0.01,
               hmc_inv_mass=None):
    """One phase-3 sweep of every chain.

    Reference order (BFMMM.h:1500-1554): Z, pi, alpha3, Phi, delta, A,
    gamma, nu, tau, sigma, chi; the covariate-adjusted models append eta,
    tau_eta, xi, delta_xi, A_xi, gamma_xi.  ``collapsed_z`` swaps Z for the
    collapsed (Z, chi) block and chi for its joint draw; ``gauge`` appends the gauge
    moves and the MGP- and noise-scale interweaves, and with
    ``phi_mala_steps`` > 0 the Phi MALA.  The bench's production sweep is
    collapsed_z=True, gauge=True, p_indep=0.3, phi_mala_steps=4,
    phi_mala_step=0.05.  MALA is off by default here, where the JAX
    package turns it on for every gauge caller (ROADMAP F3).

    The default-off kernels, as in the JAX package: ``z_anchor`` adds the
    anchor-guided stage to the collapsed (Z, chi) block (``collapsed_z``
    only); under ``gauge``, ``phi_chi_moves`` > 0 runs that many Phi column
    moves (``phi_chi_sigma``) before MALA, and ``hmc_steps`` > 0 one
    whole-model HMC trajectory of up to that many steps (``hmc_eps``,
    ``hmc_inv_mass``) after it.  The HMC step moves the xi tower only with
    ``covariate_cov`` (ROADMAP F14).

    ``beta`` < 1 tempers the data-likelihood kernels, as in the JAX
    package: a float tempers every chain alike, a (C,) tensor on the
    state's device gives each chain its own temperature (parallel
    tempering's ladder, SMC's stage), and is never read on the host.  Each
    chain's draw is then the one a float at its entry would give: the
    random numbers drawn do not depend on beta's values, except sigma^2's
    gamma variate, whose shape beta sets.  A tensor whose entries all equal
    a float32 value b gives the bits of the float b."""
    _check_beta(beta, state)
    use_full_f32()
    cache = build_cache(data, state)
    if collapsed_z:
        state, cache = update_z_chi(generator, state, data, hp, cache, beta,
                                    p_indep=p_indep, anchor_prop=z_anchor)
    else:
        state, cache = update_z(generator, state, data, hp, cache, beta)
    state = update_pi(generator, state, hp, c)
    state = update_alpha3(generator, state, hp)
    state, cache = update_phi(generator, state, data, hp, cache, beta)
    state = update_delta(generator, state, hp)
    state = update_a(generator, state, hp)
    state = update_gamma(generator, state, hp)
    state, cache = update_nu(generator, state, data, hp, cache, beta)
    state = update_tau(generator, state, data, hp)
    state = update_sigma(generator, state, data, hp, cache, beta)
    if collapsed_z:
        state, cache = update_chi_joint(generator, state, data, hp, cache,
                                        beta)
    else:
        state, cache = update_chi(generator, state, data, hp, cache, beta)
    state, cache = _covariate_tail(generator, state, data, hp, cache, beta,
                                   covariate_mean, covariate_cov)
    if gauge:
        state = update_gauge(generator, state, data, hp)
        # the gauge moves change Z, nu, Phi and chi without a cache
        state, cache = update_mgp_scale(generator, state, data, hp,
                                        build_cache(data, state), beta)
        state, cache = update_noise_scale(generator, state, data, hp, cache,
                                          beta)
        if phi_chi_moves > 0:
            state, cache = update_phi_chi(generator, state, data, hp, cache,
                                          beta, sigma_rw=phi_chi_sigma,
                                          n_moves=phi_chi_moves)
        if phi_mala_steps > 0:
            state, cache = update_phi_mala(generator, state, data, hp, cache,
                                           beta, step=phi_mala_step,
                                           n_steps=phi_mala_steps)
        if hmc_steps > 0:
            state = update_hmc_joint(generator, state, data, hp, c, beta,
                                     eps=hmc_eps, n_leapfrog=hmc_steps,
                                     inv_mass=hmc_inv_mass,
                                     covariate_cov=covariate_cov)
    return state
