"""Adaptive tempered Sequential Monte Carlo over the mixed-membership
posterior.

Port of ``bayesfmmm_tpu/samplers/smc.py``.  The likelihood is annealed from
beta = 0 (the prior) to 1 through an adaptive schedule; at each stage

  1. reweight the particles by (beta_new - beta_old) * loglik,
  2. resample systematically when the ESS falls under a threshold,
  3. mutate every particle by tempered Gibbs sweeps (ops/gibbs.py) at the
     stage's beta, a posterior-invariant mutation kernel.

Particles are the chain axis of one batch.  The next beta is the bisection
of the JAX package, run as 30 masked steps on the device; the stage loop
reads one scalar a stage (whether beta has reached 1).  The resampling
uniform is drawn every stage, as the JAX package draws it, and a stage
that does not resample keeps its particles through the identity index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesfmmm_torch.models.state import take_chains
from bayesfmmm_torch.ops import gibbs
from bayesfmmm_torch.ops.distributions import refuse_chain_shard
from bayesfmmm_torch.ops.mean import effective_coeffs, rss_from_coeffs

_BISECTION_STEPS = 30
_BISECTION_TOL = 1e-5


def _loglik(state, data):
    """The data log-likelihood (C,) in the JAX package's form; the RSS is
    kernel K2 on CUDA."""
    rss = rss_from_coeffs(data, effective_coeffs(state, data.X))
    return -0.5 * data.n_obs * (math.log(2 * math.pi)
                                + torch.log(state.sigma2)) \
        - rss / (2.0 * state.sigma2)


def ess_from_log_weights(log_w):
    w = torch.softmax(log_w, 0)
    return 1.0 / (w * w).sum()


def resample_from_uniform(u, log_weights):
    """Systematic resampling's ancestor indices (N,) for the uniform u: the
    first cumulative weight at or above each position (u + i) / N.  Where
    the float32 cumulative sum ends below the last position the index is
    N, as in the JAX package; ``take_chains`` clamps it to N - 1 as JAX's
    gather does."""
    N = log_weights.shape[0]
    w = torch.softmax(log_weights, 0)
    positions = (u + torch.arange(N, dtype=w.dtype, device=w.device)) / N
    return torch.searchsorted(torch.cumsum(w, 0), positions)


def systematic_resample(generator, log_weights):
    """Systematic resampling; returns ancestor indices (N,)."""
    u = torch.rand((), generator=generator, dtype=log_weights.dtype,
                   device=log_weights.device)
    return resample_from_uniform(u, log_weights)


def _next_beta(beta, logliks, target_frac, n_particles):
    """The largest beta' <= 1 whose incremental weights keep the relative
    conditional ESS >= target_frac, by the JAX package's bisection: 30
    steps, stopping once hi - lo <= 1e-5.  Here every step runs and the
    stopped ones leave (lo, hi) as they are: the condition, once false,
    stays false, so the result is the JAX while_loop's with no host read.
    ``beta`` a () tensor on the device.

    The log-likelihoods are centred before they are scaled (the ESS does
    not depend on a shift): at |loglik| ~ 1e4 a float32 product rounds by
    ~5e-4, enough to move the bisection, and XLA fuses the JAX package's
    product into the softmax's subtraction, rounding once."""
    centred = logliks - logliks.max()

    def cess(b_new):
        return ess_from_log_weights((b_new - beta) * centred) / n_particles

    one = torch.ones_like(beta)
    ok_full = cess(one) >= target_frac
    lo, hi = beta, one
    for _ in range(_BISECTION_STEPS):
        active = hi - lo > _BISECTION_TOL
        mid = 0.5 * (lo + hi)
        ok = cess(mid) >= target_frac
        lo, hi = (torch.where(active & ok, mid, lo),
                  torch.where(active & ~ok, mid, hi))
    return torch.where(ok_full, one, lo)


class SMCResult(NamedTuple):
    particles: object          # particle-stacked GibbsState
    log_weights: torch.Tensor  # (N,)
    n_stages: int
    log_evidence: torch.Tensor
    final_beta: torch.Tensor


def smc_stage(generator, particles, log_w, beta, log_Z, data, hp, c, *,
              n_mutation_sweeps, target_cess, ess_threshold, **sweep_flags):
    """One stage: the next beta, reweighting, the evidence increment,
    resampling when the ESS is under ``ess_threshold`` N, and the mutation
    sweeps at the new beta.  Returns (particles, log_w, beta, log_Z)."""
    N = log_w.shape[0]
    ll = _loglik(particles, data)
    beta_new = _next_beta(beta, ll, target_cess, N)
    inc = (beta_new - beta) * ll
    # the evidence increment: log mean of the incremental weights under the
    # current normalised weights
    log_Z = log_Z + torch.logsumexp(torch.log(torch.softmax(log_w, 0)) + inc,
                                    0)
    log_w = log_w + inc
    do_res = ess_from_log_weights(log_w) < ess_threshold * N
    anc = systematic_resample(generator, log_w)
    idx = torch.where(do_res, anc, torch.arange(N, device=anc.device))
    particles = take_chains(particles, idx)
    log_w = torch.where(do_res, torch.zeros_like(log_w), log_w)
    betas = beta_new.expand(N)
    for _ in range(n_mutation_sweeps):
        particles = gibbs.sweep_full(generator, particles, data, hp, c,
                                     beta=betas, **sweep_flags)
    return particles, log_w, beta_new, log_Z


def run_smc(generator, init_particles, data, hp, c, *, n_mutation_sweeps=2,
            target_cess=0.7, ess_threshold=0.5, max_stages=200,
            **sweep_flags):
    """Adaptive tempered SMC.  ``init_particles``: particle-stacked
    GibbsState; ``sweep_flags`` go to ``sweep_full`` (covariate flags and
    the kernel census)."""
    refuse_chain_shard("run_smc")
    gibbs.use_full_f32()
    N = init_particles.Z.shape[0]
    kw = dict(dtype=data.y.dtype, device=init_particles.Z.device)
    particles, log_w = init_particles, torch.zeros(N, **kw)
    beta, log_Z = torch.zeros((), **kw), torch.zeros((), **kw)
    it = 0
    while it < max_stages and bool(beta < 1.0):   # one host read a stage
        particles, log_w, beta, log_Z = smc_stage(
            generator, particles, log_w, beta, log_Z, data, hp, c,
            n_mutation_sweeps=n_mutation_sweeps, target_cess=target_cess,
            ess_threshold=ess_threshold, **sweep_flags)
        it += 1
    return SMCResult(particles, log_w, it, log_Z, beta)
