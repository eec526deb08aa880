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

The covariate-adjusted kernels and the identity-basis (multivariate)
shortcuts are later slices of the port and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from bayesfmmm_torch.ops import kernels
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
from bayesfmmm_torch.ops.linalg import (
    mvn_from_precision_fused,
    small_chol,
    small_chol_logdet,
    small_solve_lower,
)
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
    """sum_n W[..., n] G_n -> (..., P, P); the leading axes of W are
    flattened into the rows of kernel K3 (ops/kernels.py::weighted_gram)."""
    N, P = data.G.shape[0], data.G.shape[-1]
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
# Production census: shared pieces
# ---------------------------------------------------------------------------

def _no_covariates(data, what):
    if data.D > 0:
        raise NotImplementedError(
            f"{what} with covariates (D > 0): ROADMAP item 11 "
            f"'covariate-adjusted models and the other families'")


def _where_rows(ok, new, old):
    """new where ok else old; ok's axes lead those of new and old."""
    return torch.where(ok.view(ok.shape + (1,) * (new.dim() - ok.dim())),
                       new, old)


def _select(ok, new, old):
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
    idx = torch.randint(0, K * (K - 1), shape, generator=generator,
                        device=device)
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
    z = torch.randn(b.shape, generator=generator, dtype=b.dtype,
                    device=b.device)
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
    a = torch.einsum("ecnk,ckp->ecnp", Z2, state.nu)
    U = torch.einsum("ecnk,ckpm->ecnpm", Z2, state.Phi)
    GU = torch.einsum("npq,ecnqm->ecnpm", data.G, U)
    L = _chi_factor(U, GU, s)
    ur = data.u - torch.einsum("npq,ecnq->ecnp", data.G, a)
    Fr = torch.einsum("ecnpm,ecnp->ecnm", U, ur)
    r = data.y - torch.einsum("nlp,ecnp->ecnl", data.B, a)
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


def update_z_chi(generator, state, data, hp, cache: SweepCache, beta=1.0,
                 p_indep=0.3, anchor_prop=False):
    """Collapsed (Z, chi) block update.

    Proposal per row: with probability ``p_indep`` an independence draw
    from Dir(alpha3 pi), else the Dirichlet random walk Dir(a_Z_PM Z_i);
    the Hastings ratio uses the mixture density both ways.  Then a
    label-swap stage proposes exchanging two coordinates of each row (a
    symmetric involution), and finally chi | Z is drawn jointly."""
    if anchor_prop:
        raise NotImplementedError(
            "update_z_chi(anchor_prop=True): ROADMAP item 13 'gradient "
            "samplers and default-off kernels'")
    _no_covariates(data, "update_z_chi")
    s = beta / state.sigma2
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

    # exact joint chi | Z draw: precision Q = I + s U'GU, linear s U'(u - Ga)
    chi = _chi_draw(generator, L, s[:, None, None] * Fr)
    w = a + torch.einsum("cnpm,cnm->cnp", U, chi)
    return state.replace(Z=Z, chi=chi), cache.replace(w=w)


def _redraw_chi(generator, data, s, U, a):
    """Exact joint chi | rest draw for eigen directions U (C, N, P, M) and
    chi-free coefficients a (C, N, P): precision I + s U'GU and linear term
    s U'(u - G a) per row.  Returns (chi, w = a + U chi)."""
    L = _chi_factor(U, torch.einsum("npq,cnqm->cnpm", data.G, U), s)
    ur = data.u - torch.einsum("npq,cnq->cnp", data.G, a)
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
    chi, w = _redraw_chi(generator, data, beta / state.sigma2, U, a)
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
    _no_covariates(data, "gauge moves")
    lp = _row_lprior(state, state.Z).sum(-1)
    quad_nu = torch.einsum("ckp,pq,ckq->ck", state.nu, data.pen, state.nu)
    lp = lp - 0.5 * (state.tau * quad_nu).sum(-1)
    tilde = torch.cumprod(state.delta, dim=2)                 # (C, K, M)
    lp = lp - 0.5 * (tilde[:, :, None, :] * state.gamma
                     * state.Phi ** 2).sum((1, 2, 3))
    return lp - 0.5 * (state.chi ** 2).sum((1, 2))


def _mix_features(state, data, ea, eb, eps):
    """The feature-mixing map per chain: ea, eb (C, K) one-hot, eps (C,)."""
    _no_covariates(data, "gauge moves")
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
    return state.replace(Z=Z, nu=rowmap(state.nu), Phi=rowmap(state.Phi))


def _rescale_eigen(state, data, em, log_s):
    """The eigen-rescale map per chain: em (C, M) component mask, log_s
    (C,)."""
    _no_covariates(data, "gauge moves")
    scale_m = 1.0 + (torch.exp(log_s) - 1.0)[:, None] * em    # (C, M)
    return state.replace(chi=state.chi / scale_m[:, None, :],
                         Phi=state.Phi * scale_m[:, None, None, :])


def _rotate_eigen(state, data, m1, m2, theta):
    """The Givens rotation of eigen columns (m1, m2) by theta, per chain:
    m1, m2 (C,) indices, theta (C,)."""
    _no_covariates(data, "gauge moves")
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
    return state.replace(chi=torch.einsum("cnm,cml->cnl", state.chi, R),
                         Phi=torch.einsum("ckpm,cml->ckpl", state.Phi, R))


def update_gauge(generator, state, data, hp):
    """One feature-mixing, one eigen-rescale and (M >= 2) one
    eigen-rotation MH proposal, with the JAX package's default steps 0.3,
    0.3 and 0.5; each chain draws its own pair, step and uniform."""
    C, K, M = state.Z.shape[0], state.K, state.M
    P = state.nu.shape[2]
    dt, dev = state.nu.dtype, state.nu.device
    jac_mix = data.N - P * (1.0 + M)
    jac_scale = K * P - data.N
    eyeK = torch.eye(K, dtype=dt, device=dev)
    eyeM = torch.eye(M, dtype=dt, device=dev)

    def normal():
        return torch.randn(C, generator=generator, dtype=dt, device=dev)

    def mh(st, lp, prop, log_jac):
        lp_new = _gauge_logprior(prop, data, hp)
        ok = _mh_accept(lp_new - lp + log_jac,
                        _uniform(generator, lp, lp.shape))
        return _select(ok, prop, st), torch.where(ok, lp_new, lp)

    lp = _gauge_logprior(state, data, hp)
    a, b = _ordered_pair(generator, (C,), K, dev)
    eps = 0.3 * normal()
    state, lp = mh(state, lp,
                   _mix_features(state, data, eyeK[a], eyeK[b], eps),
                   eps * jac_mix)
    m = torch.randint(0, M, (C,), generator=generator, device=dev)
    log_s = 0.3 * normal()
    state, lp = mh(state, lp, _rescale_eigen(state, data, eyeM[m], log_s),
                   log_s * jac_scale)
    if M >= 2:
        m1, m2 = _ordered_pair(generator, (C,), M, dev)
        theta = 0.5 * normal()
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
        idx = torch.randint(0, K * M, (C,), generator=generator, device=dev)
        kf = idx // M
        col = idx % M
        eps = 0.03 * torch.randn(C, generator=generator, dtype=dt,
                                 device=dev)
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
    _no_covariates(data, "update_noise_scale")
    dt = state.Phi.dtype
    C = state.Phi.shape[0]
    U = eigen_directions(state, data.X)                       # (C, N, P, M)
    ec = torch.einsum("cnpm,cnm->cnp", U, state.chi)
    ac = cache.w - ec
    r0 = data.y - torch.einsum("nlp,cnp->cnl", data.B, ac)
    e = torch.einsum("nlp,cnp->cnl", data.B, ec)
    coeffs = ((r0 * r0).sum((1, 2)), (r0 * e).sum((1, 2)),
              (e * e).sum((1, 2)))
    sumA = state.A[:, :, 0].sum(-1)
    d0 = state.delta[:, :, 0].sum(-1)
    d0xi = torch.zeros_like(d0)
    s = torch.ones_like(d0)
    sig2 = state.sigma2
    for _ in range(8):
        eps = 0.015 * torch.randn(C, generator=generator, dtype=dt,
                                  device=d0.device)
        log_acc = _noise_scale_log_acc(eps, s, sig2, d0, d0xi, coeffs,
                                       data.n_obs, sumA, hp, beta)
        ok = _mh_accept(log_acc, _uniform(generator, eps, (C,)))
        gr = torch.where(ok, torch.exp(eps), 1.0)
        s, sig2, d0 = s * torch.sqrt(gr), sig2 * gr, d0 / gr
    delta = state.delta.clone()
    delta[:, :, 0] = delta[:, :, 0] * (1.0 / (s * s))[:, None]
    new = state.replace(sigma2=sig2, Phi=state.Phi * s[:, None, None, None],
                        delta=delta)
    return new, cache.replace(w=ac + s[:, None, None] * ec)


# ---------------------------------------------------------------------------
# Phi MALA under the chi-marginal target (JAX gibbs.py:1561-1677):
# preconditioned Langevin steps on the whole Phi, the diagonal
# preconditioner per column (||Phi_k[:, m]|| + 0.1)/sqrt(N) frozen at entry,
# then one exact joint chi | Phi redraw.  The gradient of the potential is
# autograd's, per chain (the chains' potentials are independent, so the
# gradient of their sum is each chain's own).
# ---------------------------------------------------------------------------

def _mala_potential(Phi, Z, data, s, ur, sum_rr0, pri):
    """-(beta-tempered chi-marginal loglik + MGP log prior of Phi) per
    chain (C,); ur = u - G a and sum_rr0 = ||y - B a||^2 for the mean-only
    coefficients a."""
    U = torch.einsum("cnk,ckpm->cnpm", Z, Phi)
    GU = torch.einsum("npq,cnqm->cnpm", data.G, U)
    L = _chi_factor(U, GU, s)
    v = small_solve_lower(L, torch.einsum("cnpm,cnp->cnm", U, ur))
    ll = -0.5 * (small_chol_logdet(L).sum(-1) + s * sum_rr0
                 - s * s * (v * v).sum((1, 2)))
    return -(ll - 0.5 * (pri * Phi * Phi).sum((1, 2, 3)))


def update_phi_mala(generator, state, data, hp, cache: SweepCache, beta=1.0,
                    *, step=0.05, n_steps=4):
    """``n_steps`` preconditioned MALA steps on Phi, then the joint chi
    redraw.  Nothing leaves this function attached to a graph."""
    _no_covariates(data, "update_phi_mala")
    C, K, P, M = state.Phi.shape
    dt, dev = state.Phi.dtype, state.Phi.device
    s = beta / state.sigma2
    pri = torch.cumprod(state.delta, dim=2)[:, :, None, :] * state.gamma
    a = torch.einsum("cnk,ckp->cnp", state.Z, state.nu)
    ur = data.u - torch.einsum("npq,cnq->cnp", data.G, a)
    sum_rr0 = rss_from_coeffs(data, a)                        # kernel K2

    def pot_grad(x):
        x = x.detach().requires_grad_()
        with torch.enable_grad():
            pot = _mala_potential(x, state.Z, data, s, ur, sum_rr0, pri)
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
        xi = torch.randn(x.shape, generator=generator, dtype=dt, device=dev)
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

    chi, w = _redraw_chi(generator, data, s,
                         torch.einsum("cnk,ckpm->cnpm", state.Z, x), a)
    return state.replace(Phi=x, chi=chi), cache.replace(w=w)


# ---------------------------------------------------------------------------
# The phase-3 sweep (JAX gibbs.py:1796-1866)
# ---------------------------------------------------------------------------

def sweep_full(generator, state, data, hp, c, *, covariate_mean=False,
               covariate_cov=False, beta=1.0, collapsed_z=False,
               gauge=False, p_indep=0.3, phi_mala_steps=0,
               phi_mala_step=0.05, phi_chi_moves=0, z_anchor=False,
               hmc_steps=0):
    """One phase-3 sweep of every chain.

    Reference order (BFMMM.h:1500-1554): Z, pi, alpha3, Phi, delta, A,
    gamma, nu, tau, sigma, chi.  ``collapsed_z`` swaps Z for the collapsed
    (Z, chi) block and chi for its joint draw; ``gauge`` appends the gauge
    moves and the MGP- and noise-scale interweaves, and with
    ``phi_mala_steps`` > 0 the Phi MALA.  The bench's production sweep is
    collapsed_z=True, gauge=True, p_indep=0.3, phi_mala_steps=4,
    phi_mala_step=0.05.  MALA is off by default here, where the JAX
    package turns it on for every gauge caller (ROADMAP F3).

    ``beta`` < 1 tempers the data-likelihood kernels, as in the JAX
    package.  The flags of kernels not ported yet raise."""
    if covariate_mean or covariate_cov:
        raise NotImplementedError(
            "covariate-adjusted kernels: ROADMAP item 11 'covariate-adjusted "
            "models and the other families'")
    for flag, on in (("z_anchor", z_anchor), ("phi_chi_moves", phi_chi_moves),
                     ("hmc_steps", hmc_steps)):
        if on:
            raise NotImplementedError(
                f"{flag}: ROADMAP item 13 'gradient samplers and default-off "
                f"kernels'")
    use_full_f32()
    cache = build_cache(data, state)
    if collapsed_z:
        state, cache = update_z_chi(generator, state, data, hp, cache, beta,
                                    p_indep=p_indep)
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
    if gauge:
        state = update_gauge(generator, state, data, hp)
        # the gauge moves change Z, nu, Phi and chi without a cache
        state, cache = update_mgp_scale(generator, state, data, hp,
                                        build_cache(data, state), beta)
        state, cache = update_noise_scale(generator, state, data, hp, cache,
                                          beta)
        if phi_mala_steps > 0:
            state, cache = update_phi_mala(generator, state, data, hp, cache,
                                           beta, step=phi_mala_step,
                                           n_steps=phi_mala_steps)
    return state
