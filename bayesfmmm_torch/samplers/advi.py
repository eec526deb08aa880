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

Under ``with mesh:`` (``parallel/mesh.py``) ADVI has no chain axis: its
draws are shared by every chain (``chain_dim=None``), so every rank runs
the one-process optimisation.  Under a split of the data ``mu`` and
``log_sd`` hold the rank's slots of the position (its rows of Z and chi,
``models/logjoint.py::rank_slots``), the draws are taken at the whole
position and cut to them, and the loss's row part (the log-joint's row
terms and the entropy's row slots) is differentiated apart from its global
part: the row part's value and its gradient's global slots are added over
the data group before the global part's are added once, so the global
slots' ``.grad`` is the one-process gradient on every rank of the group
when Adam steps (elementwise).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesfmmm_torch.models import logjoint


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
    slots = logjoint.position_slots(log_joint_flat, dim)
    opt.zero_grad(set_to_none=True)
    if slots.keep is None:
        with torch.enable_grad():
            qs = mu + torch.exp(log_sd) * eps
            entropy = log_sd.sum() + 0.5 * dim * (1.0 + math.log(2 * math.pi))
            loss = -(log_joint_flat(qs).mean() + entropy)
            loss.backward()
        opt.step()
        return -loss.detach()
    with torch.enable_grad():
        qs = mu + torch.exp(log_sd) * eps
        rows, glob = log_joint_flat.parts(qs)
        row_elbo = rows.mean() + log_sd[slots.rows].sum()
        glob_elbo = glob.mean() + log_sd[slots.glob].sum() \
            + 0.5 * slots.dim * (1.0 + math.log(2 * math.pi))
        g_rows = torch.autograd.grad(row_elbo, (mu, log_sd),
                                     retain_graph=True)
        g_glob = torch.autograd.grad(glob_elbo, (mu, log_sd))
    value, g = slots.reduce(row_elbo.detach()[None], torch.stack(g_rows))
    mu.grad, log_sd.grad = (-(a + b) for a, b in zip(g, g_glob))
    opt.step()
    return value[0] + glob_elbo.detach()


def run_advi(generator, log_joint, init_unc, *, n_steps=500, n_mc=4,
             learning_rate=0.02, init_log_sd=-2.0, covariate_cov=True,
             draws=None):
    """Optimize a mean-field Gaussian q from ``init_unc`` (a one-chain
    UncState; under a mesh that splits the data, its rows of Z and chi
    this rank's); returns the means and the ELBO trace.  ``log_joint``
    maps a batched UncState to (R,) log densities (models/logjoint.py::
    make_log_joint).  ``draws`` (n_steps, n_mc, dim), if given, replaces
    the generator's standard normals (at the whole position's dim)."""
    like = logjoint.UncState(**{f: t.detach()
                                for f, t in vars(init_unc).items()})
    lj_flat = logjoint.FlatLogJoint(log_joint, like, covariate_cov)
    slots = lj_flat.slots()
    flat0 = logjoint.flatten(like, covariate_cov)[0]

    mu = flat0.clone().requires_grad_()
    log_sd = torch.full_like(flat0, init_log_sd).requires_grad_()
    opt = torch.optim.Adam([mu, log_sd], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    elbos = []
    for i in range(n_steps):
        eps = slots.take(draws[i]) if draws is not None else slots.normal(
            generator, n_mc, dtype=mu.dtype, device=mu.device,
            chain_dim=None)
        elbos.append(_advi_step(lj_flat, (mu, log_sd), opt, eps))
    mu, log_sd = mu.detach(), log_sd.detach()
    return ADVIResult(logjoint.unflatten(mu[None], like, covariate_cov),
                      log_sd, torch.stack(elbos) if elbos
                      else mu.new_empty(0), like, covariate_cov)


def sample_from_advi(generator, result: ADVIResult, n_samples=1, draws=None):
    """``n_samples`` draws of q as an UncState of ``n_samples`` chains;
    ``draws`` (n_samples, dim), if given, replaces the standard normals.
    The draws are shared by every rank (``chain_dim=None``); under a mesh
    that splits the data each rank keeps its slots of them."""
    covc = result.covariate_cov
    flat_mu = logjoint.flatten(result.mean, covc)[0]
    slots = logjoint.rank_slots(result.like, covc)
    eps = slots.take(draws) if draws is not None else slots.normal(
        generator, n_samples, dtype=flat_mu.dtype, device=flat_mu.device,
        chain_dim=None)
    qs = flat_mu + torch.exp(result.log_sd_flat) * eps
    return logjoint.unflatten(qs, result.like, covc)
