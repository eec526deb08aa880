"""Legacy binary (overlapping-clustering) membership kernels.

Port of ``bayesfmmm_tpu/ops/legacy_binary.py`` with a leading chain axis.
Reference: UpdateClassMembership.h (545 LoC) and the conjugate Beta pi
update (UpdatePi.h:17-29), the 0/1-membership ancestor of the mixed
membership model.  In the reference these are dead code (reachable only
from the unexported BFMMM/BFMMM_Templadder drivers), but they are part of
the component inventory:

  * ``update_z_binary`` — per-observation MH with independent Bernoulli
    flip proposals at stickiness rho (UpdateClassMembership.h:127-132);
    target = Bernoulli(pi) prior x Gaussian likelihood with beta tempering
    (lpdf_z, :29-48; tempered :234).
  * ``update_pi_binary`` — conjugate Beta draw
    pi_l ~ Beta(alpha/K + sum_i Z_il, N - sum_i Z_il + 1) (UpdatePi.h:17-29).
"""

from __future__ import annotations

import torch

from bayesfmmm_torch.ops.distributions import standard_gamma
from bayesfmmm_torch.ops.gibbs import _uniform
from bayesfmmm_torch.ops.mean import apply_basis, feature_offsets


def _rbeta(generator, a, b):
    """Beta(a, b) draws, elementwise, from two Gamma draws."""
    x = standard_gamma(generator, a)
    return x / (x + standard_gamma(generator, b))


def update_z_binary(generator, state, data, rho=0.9, beta=1.0):
    """MH sweep over all rows of every chain with Bernoulli flip proposals.

    Returns the state with a new 0/1-valued Z.  All rows are conditionally
    independent, so the reference's sequential i-loop vectorizes.  ``beta``
    a float or a (C,) tensor."""
    Z, sigma2 = state.Z, state.sigma2
    # per-feature mean curves mu_k = B_n T_nk: (C, K, N, L)
    Cm = apply_basis(data, feature_offsets(state, data.X).transpose(1, 2))
    s = sigma2.reciprocal() * beta                                # (C,)
    log_pi, log_1m_pi = torch.log(state.pi), torch.log1p(-state.pi)

    def row_lpdf(Zb):
        r = data.y - torch.einsum("cnk,cknl->cnl", Zb, Cm)
        lik = -0.5 * s[:, None] * (r * r).sum(-1)
        prior = (Zb * log_pi[:, None] + (1.0 - Zb) * log_1m_pi[:, None]).sum(-1)
        return lik + prior

    # propose: keep each bit with probability rho (flip with 1 - rho)
    keep_prob = Z * rho + (1.0 - Z) * (1.0 - rho)
    Z_new = (_uniform(generator, Z, Z.shape) < keep_prob).to(Z.dtype)
    log_acc = row_lpdf(Z_new) - row_lpdf(Z)
    accept = torch.log(_uniform(generator, Z, Z.shape[:2])) < log_acc
    return state.replace(Z=torch.where(accept[..., None], Z_new, Z))


def update_pi_binary(generator, state, alpha=1.0):
    """Conjugate Beta update for binary memberships (UpdatePi.h:17-29)."""
    N, K = state.Z.shape[1:]
    counts = state.Z.sum(1)                                       # (C, K)
    return state.replace(pi=_rbeta(generator, alpha / K + counts,
                                   N - counts + 1.0))
