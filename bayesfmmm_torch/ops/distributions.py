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
  * ``normal`` / ``uniform`` / ``randint`` and ``standard_gamma`` — the
    draws every sampler of the sweep takes, with the chain axis named and,
    for a draw on the data's rows, the data axis.  Outside a ``with
    mesh:`` block (``parallel/mesh.py``), or on a 1 x 1 mesh, each is the
    plain torch call.  Inside one that splits the chains or the data over
    ranks, each rank draws at the whole ensemble's and the whole data's
    shape from its copy of the one generator and keeps its own chains and
    rows, so every rank's generator stays in step with the others' and its
    draws are those the one-process run draws.  A gamma's shape parameter
    is gathered over both axes first: torch's CPU gamma sampler spends a
    number of uniforms that depends on the shape's value, so the draw
    needs every chain's and row's shape, not this rank's alone.
"""

from __future__ import annotations

import math

import torch

from bayesfmmm_torch.ops import linalg

__all__ = [
    "normal", "uniform", "randint", "standard_gamma", "rdirichlet",
    "dirichlet_logpdf_unnormalized", "log_multi_beta", "truncnorm_sample",
    "truncnorm_logpdf", "mvn_from_precision", "chol_precision",
    "mvn_from_chol", "jitter_eps",
]


# The mesh whose ``with`` block runs while it splits the chains or the data
# over ranks (parallel/mesh.py::Mesh.__enter__), else None.
_MESH = None


def _whole(shape, chain_dim, data_dim=None):
    """(shape to draw, [(dim, first index, length) to keep])."""
    if _MESH is None:
        return shape, ()
    return _MESH.whole(shape, chain_dim, data_dim)


def _keep(x, keep):
    for dim, lo, n in keep:
        x = x.narrow(dim, lo, n)
    return x


def normal(generator, shape, *, dtype, device, chain_dim=0, data_dim=None):
    """Standard normal draws of ``shape``, whose chain axis is
    ``chain_dim`` (None: a draw shared by every chain) and whose axis over
    the data's rows is ``data_dim`` (None: no such axis)."""
    whole, keep = _whole(shape, chain_dim, data_dim)
    return _keep(torch.randn(whole, generator=generator, dtype=dtype,
                             device=device), keep)


def uniform(generator, shape, *, dtype, device, chain_dim=0, data_dim=None):
    """U[0, 1) draws of ``shape``, axes as in ``normal``."""
    whole, keep = _whole(shape, chain_dim, data_dim)
    return _keep(torch.rand(whole, generator=generator, dtype=dtype,
                            device=device), keep)


def randint(generator, low, high, shape, *, device, chain_dim=0,
            data_dim=None):
    """Integers uniform in [low, high) of ``shape``, axes as in
    ``normal``."""
    whole, keep = _whole(shape, chain_dim, data_dim)
    return _keep(torch.randint(low, high, whole, generator=generator,
                               device=device), keep)


def standard_gamma(generator, alpha, chain_dim=0, data_dim=None):
    """Gamma(alpha, 1) draws, elementwise; ``alpha``'s axes as in
    ``normal``, and under a split mesh it is gathered over the chains and
    the data's rows before the draw.

    torch clamps a draw that underflows up to the smallest normal float;
    jax.random.gamma returns 0.  Tiny Dirichlet concentrations (a_Z_PM * Z
    with Z near 0) underflow routinely, and the Z kernel's boundary
    auto-accept and NaN-reject rules key off that exact 0, so the clamp is
    undone here."""
    keep = ()
    if _MESH is not None:
        _, keep = _MESH.whole(alpha.shape, chain_dim, data_dim)
        alpha = _MESH.gather_axes(alpha, chain_dim, data_dim)
    g = torch._standard_gamma(alpha, generator=generator)
    return _keep(torch.where(g <= torch.finfo(g.dtype).tiny, 0.0, g), keep)


def rdirichlet(generator, alpha, data_dim=None):
    """Dirichlet draw over the last axis (the chain axis first; the data's
    rows on ``data_dim`` when it has them), with the reference's guard:
    alpha <= 0 is floored at 10 (Distributions.h:24-28)."""
    alpha = torch.where(alpha <= 0, 10.0, alpha)
    g = standard_gamma(generator, alpha, data_dim=data_dim)
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
    v = 1.0 - uniform(generator, mean.shape, dtype=torch.float64,
                      device=mean.device)
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


# The ridge a jittered factor adds is jitter * (s + 1) * I, s the mean of the
# precision's diagonal (the JAX package's contract, distributions.py:110-111
# and linalg.py:325-326) capped at JITTER_SPREAD times its smallest entry.
# An MGP prior can spread a joint draw's diagonal over tens of orders of
# magnitude; the uncapped mean then swamps the weakly penalised coordinates
# and draws them towards zero, the tower answers with more shrinkage, and
# the chain collapses (xi at the covariate-covariance model within ~2,000
# sweeps).  Below that spread the cap does not bind and the ridge is the
# JAX package's, bit for bit.
JITTER_SPREAD = 1e3


def jitter_eps(diag, jitter):
    """The ridge jitter * (min(mean, JITTER_SPREAD * min) + 1) of a
    precision whose diagonal is ``diag`` (..., P), one a matrix (...)."""
    P = diag.shape[-1]
    scale = torch.minimum(diag.sum(-1) / P, JITTER_SPREAD * diag.amin(-1))
    return jitter * (scale + 1.0)


def chol_precision(prec, *, jitter=1e-6):
    """Jittered batched Cholesky of a precision: chol(prec + eps * I) with
    eps = ``jitter_eps`` of its diagonal (distributions.py:110-111, the
    scale capped)."""
    P = prec.shape[-1]
    eps = jitter_eps(prec.diagonal(dim1=-2, dim2=-1), jitter)
    eye = torch.eye(P, dtype=prec.dtype, device=prec.device)
    return linalg.small_chol(prec + eps[..., None, None] * eye)


def mvn_from_chol(generator, L, b):
    """Sample N(prec^-1 b, prec^-1) given L = chol(prec); (sample, mean)."""
    z = normal(generator, b.shape, dtype=b.dtype, device=b.device)
    mean = linalg.small_solve_upper_t(L, linalg.small_solve_lower(L, b))
    noise = linalg.small_solve_upper_t(L, z)
    return mean + noise, mean
