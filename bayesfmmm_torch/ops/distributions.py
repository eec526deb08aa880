"""Sampling and density primitives for the Gibbs kernels.

Port of ``bayesfmmm_tpu/ops/distributions.py``.  Every sampler takes an
explicit ``torch.Generator``; batch axes (the chain axis first) broadcast
as in the JAX package's vmapped code.

  * ``standard_gamma`` / ``rdirichlet`` — gamma-normalize, with the
    reference's floor-at-10 guard (Distributions.h:22-44).
  * ``log_multi_beta`` — calc_lB (Distributions.h:51-60).
  * ``truncnorm_*``    — the positive-half-line truncated normal of the
    alpha_3 and A MH kernels; torch has no sampler, so inverse CDF.
  * ``mvn_from_precision`` / ``chol_precision`` / ``mvn_from_chol`` —
    jittered-Cholesky draws from N(P^-1 b, P^-1), in plain PyTorch as the
    JAX package leaves them to XLA (the joint draws of the sweep take
    linalg.mvn_from_precision_fused, which reaches K1).
"""

from __future__ import annotations

import math

import torch

from bayesfmmm_torch.ops import linalg

__all__ = [
    "standard_gamma", "rdirichlet", "dirichlet_logpdf_unnormalized",
    "log_multi_beta", "truncnorm_sample", "truncnorm_logpdf",
    "mvn_from_precision", "chol_precision", "mvn_from_chol",
]


def standard_gamma(generator, alpha):
    """Gamma(alpha, 1) draws, elementwise.

    torch clamps a draw that underflows up to the smallest normal float;
    jax.random.gamma returns 0.  Tiny Dirichlet concentrations (a_Z_PM * Z
    with Z near 0) underflow routinely, and the Z kernel's boundary
    auto-accept and NaN-reject rules key off that exact 0, so the clamp is
    undone here."""
    g = torch._standard_gamma(alpha, generator=generator)
    return torch.where(g <= torch.finfo(g.dtype).tiny, 0.0, g)


def rdirichlet(generator, alpha):
    """Dirichlet draw over the last axis, with the reference's guard:
    alpha <= 0 is floored at 10 (Distributions.h:24-28)."""
    alpha = torch.where(alpha <= 0, 10.0, alpha)
    g = standard_gamma(generator, alpha)
    return g / g.sum(-1, keepdim=True)


def log_multi_beta(alpha):
    """log B(alpha) = sum(lgamma(alpha)) - lgamma(sum(alpha))."""
    return torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))


def dirichlet_logpdf_unnormalized(x, alpha):
    """sum((alpha-1) * log x) - log B(alpha)  (UpdateMixedMembership.h:
    102-113, UpdatePi.h:60-71)."""
    return ((alpha - 1.0) * torch.log(x)).sum(-1) - log_multi_beta(alpha)


def _ndtr(x):
    """Standard normal CDF as 0.5 erfc(-x/sqrt 2), accurate in the lower
    tail (torch.special.ndtr loses it: 4 % off at x = -5 in float32, 0 at
    x = -8), like jax.scipy.special.ndtr."""
    return 0.5 * torch.special.erfc(-x * math.sqrt(0.5))


def truncnorm_sample(generator, mean, sd):
    """Draw from N(mean, sd^2) truncated to (0, inf), shaped like ``mean``.

    Inverse CDF on the mirrored variable: with lower = -mean/sd and
    q = Phi(-lower) = P(Z > lower), z = -ndtri(v q) for v ~ U(0, 1] is
    N(0,1) truncated to (lower, inf).  Working in the lower tail keeps the
    inverse accurate when the truncated mass q is tiny; the special
    functions run in float64 so q does not underflow before lower ~ 37."""
    mean = torch.as_tensor(mean)
    dt = mean.dtype
    mean64 = mean.double()
    q = _ndtr(mean64 / sd)
    v = 1.0 - torch.rand(mean.shape, generator=generator, device=mean.device,
                         dtype=torch.float64)
    z = -torch.special.ndtri(v * q)
    return (mean64 + sd * z).to(dt)


def truncnorm_logpdf(x, mean, sd):
    """log density of N(mean, sd^2) truncated to (0, inf) at x
    (RcppDist d_truncnorm(x, mean, sd, 0, inf, log=1))."""
    z = (x - mean) / sd
    log_phi = -0.5 * z * z - 0.5 * math.log(2.0 * math.pi) - math.log(sd)
    return log_phi - torch.log(_ndtr(mean / sd))


def mvn_from_precision(generator, prec, b, *, jitter=1e-6):
    """Sample N(prec^-1 b, prec^-1) (distributions.py:85-96): the jittered
    Cholesky ``chol_precision``, then ``mvn_from_chol``; (sample, mean)."""
    return mvn_from_chol(generator, chol_precision(prec, jitter=jitter), b)


def chol_precision(prec, *, jitter=1e-6):
    """Jittered batched Cholesky of a precision: chol(prec + eps*scale*I)
    with scale = tr(prec)/P + 1 (distributions.py:110-111)."""
    P = prec.shape[-1]
    scale = prec.diagonal(dim1=-2, dim2=-1).sum(-1) / P + 1.0
    eye = torch.eye(P, dtype=prec.dtype, device=prec.device)
    return linalg.small_chol(prec + (jitter * scale)[..., None, None] * eye)


def mvn_from_chol(generator, L, b):
    """Sample N(prec^-1 b, prec^-1) given L = chol(prec); (sample, mean)."""
    z = torch.randn(b.shape, generator=generator, dtype=b.dtype,
                    device=b.device)
    mean = linalg.small_solve_upper_t(L, linalg.small_solve_lower(L, b))
    noise = linalg.small_solve_upper_t(L, z)
    return mean + noise, mean
