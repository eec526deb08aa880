"""ADVI: mean-field Gaussian variational inference on the unconstrained space.

Port of ``bayesfmmm_tpu/samplers/advi.py``: the fast initializer, a few
hundred Adam steps on the reparameterized ELBO, after which Gibbs, HMC, PT
or SMC start from the variational mean or from draws of q.

The position is ``models/logjoint.py::flatten`` of a one-chain UncState, in
``ravel_pytree`` order, so the JAX package's ``log_sd_flat`` carries across
index for index; with ``covariate_cov=False`` the xi tower is held out of it
(ROADMAP F14).  The n_mc draws mu + exp(log_sd) * eps of a step are one
batch of n_mc rows through the batched log-joint, so one gradient
evaluation launches K2 forward and its backward once each on the card
(``kernels.MeanRSS``).  optax's ``adam(lr)`` is ``torch.optim.Adam`` with
optax's defaults (betas 0.9 and 0.999, eps 1e-8): the same update rule.
The ELBO trace stays on the device and is read once, at the end.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesfmmm_torch.models import logjoint
from bayesfmmm_torch.ops.distributions import refuse_chain_shard


class ADVIResult(NamedTuple):
    mean: logjoint.UncState    # variational mean, one chain
    log_sd_flat: torch.Tensor  # (dim,)
    elbo_trace: torch.Tensor   # (n_steps,)
    like: logjoint.UncState    # one chain: the fields held out of q
    covariate_cov: bool        # whether the xi tower is part of q


def _advi_step(log_joint_flat, params, opt, eps):
    """One Adam step on -ELBO with the draws eps (n_mc, dim); returns the
    ELBO (a 0-d tensor on the device, detached)."""
    mu, log_sd = params
    dim = mu.shape[0]
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        qs = mu + torch.exp(log_sd) * eps
        entropy = log_sd.sum() + 0.5 * dim * (1.0 + math.log(2 * math.pi))
        loss = -(log_joint_flat(qs).mean() + entropy)
        loss.backward()
    opt.step()
    return -loss.detach()


def run_advi(generator, log_joint, init_unc, *, n_steps=500, n_mc=4,
             learning_rate=0.02, init_log_sd=-2.0, covariate_cov=True,
             draws=None):
    """Optimize a mean-field Gaussian q from ``init_unc`` (a one-chain
    UncState); returns the means and the ELBO trace.  ``log_joint`` maps a
    batched UncState to (R,) log densities (models/logjoint.py::
    make_log_joint).  ``draws`` (n_steps, n_mc, dim), if given, replaces the
    generator's standard normals."""
    refuse_chain_shard("run_advi")
    like = logjoint.UncState(**{f: t.detach()
                                for f, t in vars(init_unc).items()})
    flat0 = logjoint.flatten(like, covariate_cov)[0]
    dim = flat0.shape[0]

    def lj_flat(q):
        return log_joint(logjoint.unflatten(q, like, covariate_cov))

    mu = flat0.clone().requires_grad_()
    log_sd = torch.full_like(flat0, init_log_sd).requires_grad_()
    opt = torch.optim.Adam([mu, log_sd], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    elbos = []
    for i in range(n_steps):
        eps = draws[i] if draws is not None else torch.randn(
            (n_mc, dim), generator=generator, dtype=mu.dtype,
            device=mu.device)
        elbos.append(_advi_step(lj_flat, (mu, log_sd), opt, eps))
    mu, log_sd = mu.detach(), log_sd.detach()
    return ADVIResult(logjoint.unflatten(mu[None], like, covariate_cov),
                      log_sd, torch.stack(elbos) if elbos
                      else mu.new_empty(0), like, covariate_cov)


def sample_from_advi(generator, result: ADVIResult, n_samples=1, draws=None):
    """``n_samples`` draws of q as an UncState of ``n_samples`` chains;
    ``draws`` (n_samples, dim), if given, replaces the standard normals."""
    covc = result.covariate_cov
    flat_mu = logjoint.flatten(result.mean, covc)[0]
    eps = draws if draws is not None else torch.randn(
        (n_samples, flat_mu.shape[0]), generator=generator,
        dtype=flat_mu.dtype, device=flat_mu.device)
    qs = flat_mu + torch.exp(result.log_sd_flat) * eps
    return logjoint.unflatten(qs, result.like, covc)
