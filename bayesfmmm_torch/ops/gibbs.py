"""Conditional updaters of the reference kernel census, with a chain axis.

Port of the reference-census part of ``bayesfmmm_tpu/ops/gibbs.py``.  Every
updater is a function ``(generator, state, ...) -> state`` over C chains at
once: each state tensor leads with the chain axis, data is shared, and the
JAX package's per-chain code plus vmap becomes batched tensor code.  Linear
terms stay in Gram space through the running coefficients ``cache.w``
(ops/mean.py); squared residual norms go through the residual.

Masking: ``data.B`` rows and ``data.y`` are zero at padded points, so
u/G/yy absorb the mask; only the observation count reads it.

The sweep is the reference order (BFMMM.h:1500-1554): Z, pi, alpha3, Phi,
delta, A, gamma, nu, tau, sigma, chi.  The production census
(collapsed_z / gauge) and the covariate-adjusted kernels are later slices
of the port and raise NotImplementedError here; so far only the
functional family's data exists in the port (the identity-basis
shortcuts of the multivariate family come with it).
"""

from __future__ import annotations

import torch

from bayesfmmm_torch.ops.distributions import (
    chol_precision,
    dirichlet_logpdf_unnormalized,
    log_multi_beta,
    mvn_from_chol,
    rdirichlet,
    standard_gamma,
    truncnorm_logpdf,
    truncnorm_sample,
)
from bayesfmmm_torch.ops.linalg import mvn_from_precision_fused
from bayesfmmm_torch.ops.mean import (
    SweepCache,
    build_cache,
    eigen_directions,
    feature_offsets,
    rss_from_coeffs,
)

# Joint draw of a whole blocked family (all K*M blocks of Phi) up to this
# dimension, as in the JAX package; the sequential blocked scan above it
# is not ported yet.
_JOINT_MAX_DIM = 4096


def use_full_f32():
    """Float32 products in full precision (TF32 off), matching the JAX
    package's precision="highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _uniform(generator, like, shape):
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def _mh_accept(log_acc, u):
    """MH decision: NaN -> reject (gibbs.py:211 of the JAX package)."""
    return torch.where(torch.isnan(log_acc), False, torch.log(u) < log_acc)


def _gram_bvec(data, wt, w_excl):
    """sum_n wt[c, n] (u_n - G_n w_excl[c, n]) -> (C, P)."""
    Gw = torch.einsum("npq,cnq->cnp", data.G, w_excl)
    return torch.einsum("cn,cnp->cp", wt, data.u - Gw)


def _weighted_gram(data, W):
    """sum_n W[..., n] G_n -> (..., P, P)."""
    return torch.einsum("...n,npq->...pq", W, data.G)


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
    resid = data.u - torch.einsum("npq,cnq->cnp", data.G, w_excl)
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
    r = data.y - torch.einsum("nlp,ecnp->ecnl", data.B, w2)
    ll = -beta * (r * r).sum(-1) / (2.0 * state.sigma2[:, None])
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
    s = beta / state.sigma2                                   # (C,)
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


# ---------------------------------------------------------------------------
# Phi — pseudo-eigenfunction coordinates: one joint draw of all (j, m)
# blocks.  Reference: updatePhi (UpdatePhi.h:23-89); prior precision
# tilde_tau(j,m) * gamma(j,:,m) with tilde_tau = cumprod(delta).
# ---------------------------------------------------------------------------

def update_phi(generator, state, data, hp, cache: SweepCache, beta=1.0):
    C, K, P, M = state.Phi.shape
    if K * M * P > _JOINT_MAX_DIM:
        raise NotImplementedError(
            f"update_phi: K*M*P = {K * M * P} > {_JOINT_MAX_DIM} needs the "
            f"sequential blocked Phi scan (ROADMAP: covariate-adjusted "
            f"models and the other families)")
    tilde_tau = torch.cumprod(state.delta, dim=2)             # (C, K, M)
    s = beta / state.sigma2
    prior_diag = tilde_tau[..., None] * state.gamma.transpose(2, 3)
    W = torch.einsum("cnj,cnm->cjmn", state.Z, state.chi).reshape(
        C, K * M, -1)
    blocks = state.Phi.transpose(2, 3).reshape(C, K * M, P)
    new, w = _joint_blocked_draw(generator, data, s, W,
                                 prior_diag.reshape(C, K * M, P), blocks,
                                 cache.w)
    Phi = new.reshape(C, K, M, P).transpose(2, 3)
    return state.replace(Phi=Phi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# chi — per-observation eigen scores (scalar Gibbs over m, batched over n)
# Reference: updateChi (UpdateChi.h:19-64): posterior precision 1 + W/sigma2.
# ---------------------------------------------------------------------------

def update_chi(generator, state, data, hp, cache: SweepCache, beta=1.0):
    s = (beta / state.sigma2)[:, None]                        # (C, 1)
    U = eigen_directions(state, data.X)                       # (C, N, P, M)
    GU = torch.einsum("npq,cnqm->cnpm", data.G, U)
    Wden = 1.0 + s[..., None] * (U * GU).sum(2)               # (C, N, M)
    uU = torch.einsum("np,cnpm->cnm", data.u, U)
    w = cache.w
    cols = list(state.chi.unbind(-1))
    for m in range(state.M):
        Um, GUm = U[..., m], GU[..., m]                       # (C, N, P)
        w_excl = w - cols[m][..., None] * Um
        fr = uU[..., m] - (GUm * w_excl).sum(-1)              # F_m' r
        Wm = Wden[..., m]
        z = torch.randn(fr.shape, generator=generator, dtype=fr.dtype,
                        device=fr.device)
        new = s * fr / Wm + z / torch.sqrt(Wm)
        w = w_excl + new[..., None] * Um
        cols[m] = new
    return state.replace(chi=torch.stack(cols, -1)), cache.replace(w=w)


# ---------------------------------------------------------------------------
# sigma^2 — conjugate inverse-Gamma (UpdateSigma.h:22-58; tempered: shape
# and rate scale by beta, :101-103).  The RSS is kernel K2 on CUDA.
# ---------------------------------------------------------------------------

def update_sigma(generator, state, data, hp, cache: SweepCache, beta=1.0):
    rss = rss_from_coeffs(data, cache.w)                      # (C,)
    a = hp.alpha_0 + beta * data.n_obs / 2.0
    b = hp.beta_0 + beta * rss / 2.0
    g = standard_gamma(generator, torch.full_like(rss, a))
    return state.replace(sigma2=b / g)


# ---------------------------------------------------------------------------
# tau — mean smoothness precisions (conjugate Gamma, UpdateTau.h:18-36)
# ---------------------------------------------------------------------------

def update_tau(generator, state, data, hp):
    P = state.nu.shape[2]
    quad = torch.einsum("ckp,pq,ckq->ck", state.nu, data.pen, state.nu)
    rate = hp.beta_nu + 0.5 * quad
    g = standard_gamma(generator, torch.full_like(quad, hp.alpha_nu + P / 2))
    return state.replace(tau=g / rate)


# ---------------------------------------------------------------------------
# delta — MGP column multipliers (UpdateDelta.h:17-64):
#   shape_i = a(k, i==0 ? 0 : 1) + P*(M-i)/2
#   rate_i  = 1 + 0.5 sum_{m>=i} S_m prod_{n<=m, n!=i} delta_n
# All M standard-Gamma variates come from one batched draw (the shapes do
# not depend on delta); only the rates are sequential, through the
# prefix (new) x suffix (old) split of the product.
# ---------------------------------------------------------------------------

def update_delta(generator, state, hp):
    C, K, P, M = state.Phi.shape
    S = (state.gamma * state.Phi ** 2).sum(2)                 # (C, K, M)
    m_idx = torch.arange(M, device=S.device)
    shapes = torch.where(m_idx == 0, state.A[..., :1], state.A[..., 1:2]) \
        + P * (M - m_idx) / 2.0
    G = standard_gamma(generator, shapes)
    O = torch.cumprod(state.delta, dim=2)
    T = torch.flip(torch.cumsum(torch.flip(S * O, [2]), 2), [2])
    pref = torch.ones_like(S[..., 0])
    cols = []
    for i in range(M):
        d_i = G[..., i] / (1.0 + 0.5 * pref * T[..., i] / O[..., i])
        cols.append(d_i)
        pref = pref * d_i
    return state.replace(delta=torch.stack(cols, -1))


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


# ---------------------------------------------------------------------------
# The phase-3 sweep, reference order (BFMMM.h:1500-1554)
# ---------------------------------------------------------------------------

def sweep_full(generator, state, data, hp, c, *, covariate_mean=False,
               covariate_cov=False, beta=1.0, collapsed_z=False,
               gauge=False):
    """One phase-3 sweep of every chain, in the reference kernel census:
    Z, pi, alpha3, Phi, delta, A, gamma, nu, tau, sigma, chi.

    ``beta`` < 1 tempers the data-likelihood kernels, as in the JAX
    package.  The production census and the covariate-adjusted kernels are
    not ported yet and raise."""
    if collapsed_z or gauge:
        raise NotImplementedError(
            "collapsed_z / gauge: ROADMAP item 'production census'")
    if covariate_mean or covariate_cov:
        raise NotImplementedError(
            "covariate-adjusted kernels: ROADMAP item 'covariate-adjusted "
            "models and the other families'")
    use_full_f32()
    cache = build_cache(data, state)
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
    state, cache = update_chi(generator, state, data, hp, cache, beta)
    return state
