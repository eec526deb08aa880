"""Gradient-based whole-model sampler: jittered HMC with adaptation.

Port of ``bayesfmmm_tpu/samplers/hmc.py``.  Whole-model leapfrog on the
unconstrained log-joint (models/logjoint.py), with fixed-length
trajectories whose length is jittered uniformly in [1, n_leapfrog].

The JAX package writes one chain's program and vmaps it; here all C chains
are one batch: positions (C, dim), step sizes (C,), diagonal inverse masses
(C, dim) and the Welford state are per chain, and the log density maps
(C, dim) to (C,).  Under ``vmap`` JAX runs the jittered loop to the longest
length with a mask; so does the port (``_leapfrog``): it reads the longest
of the C drawn lengths once an iteration, runs that many steps for the
batch, and a chain past its own length keeps its q, p, grad and logp.  The
last step's log density is kept, so the evaluation JAX repeats at the
trajectory's end is not made again (it gives the same numbers).

Warmup: dual-averaging step size (Nesterov/Hoffman-Gelman schedule, target
acceptance 0.8) + Welford diagonal mass estimation, two phases: phase 1
adapts eps under identity mass, phase 2 freezes the estimated mass and
re-adapts eps.

Under ``with mesh:`` (``parallel/mesh.py``) a rank holds its chains of the
ensemble, and under a split of the data its rows of Z and chi in each
position (``models/logjoint.py::rank_slots``).  Every draw is taken at the
whole ensemble's and the whole position's shape and cut to the rank's
(``Slots.normal``), the longest trajectory is read over every rank
(``mesh_max``), every sum over the position adds its row slots over the
data group (``Slots.sum``), and a gradient of the log-joint is reduced
beside its value (``value_and_grad``): the rank's run is its part of the
one-process run, and every rank's generator stays in step.  The traces and
diagnostics are the rank's (``Slots.gather`` puts positions together).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesfmmm_torch.models.logjoint import position_slots
from bayesfmmm_torch.ops.distributions import randint, uniform
from bayesfmmm_torch.parallel.mesh import mesh_max

class HMCState(NamedTuple):
    position: torch.Tensor     # (C, dim)
    logp: torch.Tensor         # (C,)
    grad: torch.Tensor         # (C, dim)


class AdaptState(NamedTuple):
    log_eps: torch.Tensor      # (C,)
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    step: torch.Tensor
    mean: torch.Tensor         # (C, dim) Welford
    m2: torch.Tensor
    count: torch.Tensor        # (C,)


def value_and_grad(log_joint_flat, q):
    """(logp (C,), grad (C, dim)) of a batched log density at q (C, dim);
    the chains are independent, so the gradient of the sum is each chain's
    own.  Nothing returned is attached to a graph.  Under a mesh that
    splits the data (a ``FlatLogJoint``'s positions there) autograd takes
    the row terms over this rank's rows and the global terms apart: the
    row terms' value and their gradient's global slots are added over the
    data group in one collective, then the global terms' value and
    gradient are added once."""
    slots = position_slots(log_joint_flat, q.shape[1])
    q = q.detach().requires_grad_()
    if slots.keep is None:
        with torch.enable_grad():
            lp = log_joint_flat(q)
            grad, = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), grad
    with torch.enable_grad():
        rows, glob = log_joint_flat.parts(q)
        g_rows, = torch.autograd.grad(rows.sum(), q, retain_graph=True)
        g_glob, = torch.autograd.grad(glob.sum(), q)
    lp, grad = slots.reduce(rows.detach(), g_rows)
    return lp + glob.detach(), grad + g_glob


def _rows(mask, a, b):
    """a where mask (C,) else b, for (C,) or (C, dim) tensors."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _leapfrog(grad_fn, q, p, grad, logp, eps, inv_mass, n_steps,
              n_max=None):
    """Chain c takes ``n_steps[c]`` leapfrog steps of size eps[c] (C,);
    ``grad_fn(q) -> (logp, grad)``.  The batch runs the longest length,
    read once (over every rank of a split mesh), or ``n_max`` steps
    without a read when it is given (a bound on every length); a chain
    past its own keeps its state.  Returns (q, p, grad, logp)."""
    half_e = 0.5 * eps[:, None]
    e_im = eps[:, None] * inv_mass
    for i in range(mesh_max(n_steps) if n_max is None else n_max):
        p1 = torch.addcmul(p, half_e, grad)
        q1 = torch.addcmul(q, e_im, p1)
        logp1, grad1 = grad_fn(q1)
        p1 = torch.addcmul(p1, half_e, grad1)
        live = n_steps > i
        q, p = _rows(live, q1, q), _rows(live, p1, p)
        grad, logp = _rows(live, grad1, grad), _rows(live, logp1, logp)
    return q, p, grad, logp


def hmc_kernel(log_joint_flat):
    """Returns step(generator, state, eps, inv_mass, n_steps) -> (state,
    accept_p (C,), lengths (C,)): one jittered-length HMC transition of
    every chain."""

    def grad_fn(q):
        return value_and_grad(log_joint_flat, q)

    def step(generator, state: HMCState, eps, inv_mass, n_steps):
        q0 = state.position
        C = q0.shape[0]
        sl = position_slots(log_joint_flat, q0.shape[1])
        kw = dict(dtype=q0.dtype, device=q0.device)

        p0 = sl.normal(generator, C, **kw) / torch.sqrt(inv_mass)
        # jitter trajectory length in [1, n_steps]
        n = randint(generator, 1, n_steps + 1, (C,), device=q0.device)
        q, p, grad, logp_new = _leapfrog(grad_fn, q0, p0, state.grad,
                                         state.logp, eps, inv_mass, n)
        ke0, ke1 = sl.sum(inv_mass * p0 * p0, inv_mass * p * p)
        ke0, ke1 = 0.5 * ke0, 0.5 * ke1
        log_acc = (logp_new - ke1) - (state.logp - ke0)
        log_acc = torch.where(torch.isnan(log_acc), -math.inf, log_acc)
        accept = torch.log(uniform(generator, (C,), **kw)) < log_acc
        new = HMCState(position=_rows(accept, q, q0),
                       logp=_rows(accept, logp_new, state.logp),
                       grad=_rows(accept, grad, state.grad))
        return new, torch.exp(log_acc).clamp(max=1.0), n

    return step


def _dual_avg_update(adapt: AdaptState, accept_p, target=0.8, t0=10.0,
                     gamma=0.05, kappa=0.75, mu=None):
    step = adapt.step + 1.0
    h = target - accept_p
    h_avg = (1.0 - 1.0 / (step + t0)) * adapt.h_avg + h / (step + t0)
    log_eps = (mu if mu is not None else 0.0) - torch.sqrt(step) / gamma \
        * h_avg
    w = step ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * adapt.log_eps_avg
    return adapt._replace(log_eps=log_eps, log_eps_avg=log_eps_avg,
                          h_avg=h_avg, step=step)


def _fresh_adapt(log_eps, dim):
    """Adaptation state at step 0 from log step sizes (C,)."""
    z = torch.zeros_like(log_eps)
    zd = log_eps.new_zeros(log_eps.shape + (dim,))
    return AdaptState(log_eps, log_eps, z, z, zd, zd.clone(), z)


def _welford(ad: AdaptState, position):
    """One Welford update of the mass estimate with every chain's
    position."""
    cnt = ad.count + 1.0
    delta = position - ad.mean
    mean = ad.mean + delta / cnt.clamp(min=1.0)[:, None]
    m2 = ad.m2 + delta * (position - mean)
    return ad._replace(mean=mean, m2=m2, count=cnt)


def run_adapted(transition, init_positions, logp0, grad0, *,
                n_warmup, n_samples, target_accept, init_step_size):
    """The two-phase warmup and the sampling loop that ``run_hmc`` and
    ``samplers/nuts.py::run_nuts`` share (JAX writes it in each).
    ``transition(state, eps, inv_mass) -> (state, accept_p, info)`` with
    ``info`` a (C,) tensor recorded each iteration.  Returns (positions
    (C, n_samples, dim), accept_p of the samples (C, n_samples), infos
    (C, n_warmup + n_samples), eps (C,), warm_accept (C,))."""
    if n_warmup < 4:
        raise ValueError("'n_warmup' must be an integer >= 4 (two adaptation "
                         "phases need at least 2 steps each)")
    n_warm1 = n_warmup // 2
    n_warm2 = n_warmup - n_warm1
    C, dim = init_positions.shape
    st = HMCState(init_positions, logp0, grad0)
    log_eps0 = torch.full((C,), math.log(init_step_size),
                          dtype=init_positions.dtype,
                          device=init_positions.device)
    mu = math.log(10.0 * init_step_size)
    ad = _fresh_adapt(log_eps0, dim)
    inv_mass = torch.ones_like(init_positions)
    infos = []

    for it in range(n_warm1):
        st, ap, info = transition(st, torch.exp(ad.log_eps), inv_mass)
        infos.append(info)
        ad = _dual_avg_update(ad, ap, target_accept, mu=mu)
        # Welford on the second half
        if it + 1 > n_warmup // 4:
            ad = _welford(ad, st.position)

    var = ad.m2 / (ad.count - 1.0).clamp(min=1.0)[:, None]
    inv_mass2 = torch.where(var > 1e-8, var, 1.0)
    ad2 = _fresh_adapt(ad.log_eps_avg, dim)
    mu2 = ad.log_eps_avg + math.log(10.0)
    aps2 = []
    for _ in range(n_warm2):
        st, ap, info = transition(st, torch.exp(ad2.log_eps), inv_mass2)
        infos.append(info)
        aps2.append(ap)
        ad2 = _dual_avg_update(ad2, ap, target_accept, mu=mu2)
    eps_final = torch.exp(ad2.log_eps_avg)

    qs = init_positions.new_empty((C, n_samples, dim))
    aps = []
    for s in range(n_samples):
        st, ap, info = transition(st, eps_final, inv_mass2)
        infos.append(info)
        aps.append(ap)
        qs[:, s] = st.position
    empty = init_positions.new_empty((C, 0))
    return (qs, torch.stack(aps, 1) if aps else empty,
            torch.stack(infos, 1), eps_final, torch.stack(aps2, 1).mean(1))


def run_hmc(generator, log_joint, init_positions, *, n_warmup=500,
            n_samples=500, n_leapfrog=32, target_accept=0.8,
            init_step_size=0.01):
    """Run C chains of jittered HMC as one batch.

    log_joint: (C, dim) positions -> (C,) log densities (under a mesh that
    splits the data a ``FlatLogJoint``); init_positions (C, dim).  Returns
    (positions (C, n_samples, dim), diagnostics): the JAX package's
    per-chain ``accept_mean``, ``eps`` and ``warm_accept``, and ``n_steps``
    (C, n_warmup + n_samples), every trajectory's length.  Under a split
    mesh each is this rank's chains (and position slots).
    """
    step = hmc_kernel(log_joint)
    logp0, grad0 = value_and_grad(log_joint, init_positions)

    def transition(st, eps, inv_mass):
        return step(generator, st, eps, inv_mass, n_leapfrog)

    qs, aps, n_steps, eps, warm = run_adapted(
        transition, init_positions, logp0, grad0,
        n_warmup=n_warmup, n_samples=n_samples, target_accept=target_accept,
        init_step_size=init_step_size)
    return qs, {"accept_mean": aps.mean(1), "eps": eps, "warm_accept": warm,
                "n_steps": n_steps}
