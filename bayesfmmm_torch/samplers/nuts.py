"""Iterative NUTS (No-U-Turn Sampler), all chains in one batch.

Port of ``bayesfmmm_tpu/samplers/nuts.py``.  Hoffman & Gelman's recursive
tree doubling is replaced by the *iterative* formulation (Phan & Pradhan,
"Iterative NUTS"; the scheme NumPyro uses): a subtree of 2^d leaves is
built by a loop that detects every internal sub-subtree U-turn with a
checkpoint stack of ``max_depth + 1`` slots.

Algorithmic choices (all standard modern NUTS), line for line the JAX
package's:
  * multinomial progressive sampling within and across subtrees
    (Betancourt's "biased progressive" scheme), not slice sampling;
  * generalized U-turn criterion on the momentum sum rho:
    stop when  v_left . rho <= 0  or  v_right . rho <= 0,  v = M^{-1} p;
  * divergence at energy error > 1000;
  * warmup = dual-averaging step size + Welford diagonal mass, the
    two-phase schedule of samplers/hmc.py.

The JAX package vmaps one chain's ``lax.while_loop``s, which run until no
chain's condition holds and leave a finished chain's carry as it is.  The
port keeps every chain in one batch: a chain whose tree has ended is masked
and keeps its values; inside a subtree a chain that turned or diverged
runs on unmasked, and what the merge reads of that subtree (its flags,
acceptance sum, leaf count and proposal) stops where JAX's stops.  A
subtree of depth d always runs its 2^d steps for the batch: which
checkpoint levels open and close at leaf i is the same for every chain, so
the stack is a list of (C, dim) tensors indexed on the host, and no step
reads the device.  The device is read once a tree doubling from the second
on, to stop when no chain's tree is still growing.

The reference has no gradient-based kernel at all (its sampler is
Gibbs-within-Metropolis); the JAX package is the only reference here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesfmmm_torch.ops.distributions import refuse_chain_shard
from bayesfmmm_torch.samplers.hmc import (_rows, run_adapted,
                                          value_and_grad)

_MAX_DELTA_ENERGY = 1000.0


class _Tree(NamedTuple):
    """One NUTS trajectory tree per chain (endpoints + stats)."""
    q_left: torch.Tensor       # (C, dim)
    p_left: torch.Tensor
    grad_left: torch.Tensor
    q_right: torch.Tensor
    p_right: torch.Tensor
    grad_right: torch.Tensor
    q_prop: torch.Tensor       # multinomial proposal drawn from the tree
    logp_prop: torch.Tensor    # (C,)
    grad_prop: torch.Tensor
    log_weight: torch.Tensor   # (C,) log sum_leaves exp(H0 - H(leaf))
    p_sum: torch.Tensor        # (C, dim) rho = sum of leaf momenta
    turning: torch.Tensor      # (C,) bool
    diverging: torch.Tensor    # (C,) bool
    sum_accept: torch.Tensor   # (C,) sum of min(1, exp(H0 - H_leaf))
    n_leaves: torch.Tensor     # (C,) int


def _where_tree(mask, a: _Tree, b: _Tree) -> _Tree:
    return _Tree(*(_rows(mask, x, y) for x, y in zip(a, b)))


def _is_turning(inv_mass, p_first, p_last, rho):
    v_first = inv_mass * p_first
    v_last = inv_mass * p_last
    return ((v_first * rho).sum(-1) <= 0.0) | ((v_last * rho).sum(-1) <= 0.0)


def _uniform(generator, like):
    return torch.rand(like.shape[:1], generator=generator, dtype=like.dtype,
                      device=like.device)


def _build_subtree(generator, vg, q0, p0, grad0, eps_signed, depth,
                   inv_mass, energy0, max_depth, live):
    """2^depth new leapfrog leaves starting one step past (q0, p0), for the
    chains ``live`` (C,) bool; eps_signed (C,).

    Returns a _Tree whose left endpoint is the FIRST new leaf (closest to
    the main tree) and right endpoint the LAST (farthest), in trajectory
    order of this subtree's own direction.  Its proposal, flags,
    acceptance sum and leaf count are the JAX package's for every chain;
    its endpoints, momentum sum and weight only where the subtree neither
    turned nor diverged, the only place the caller reads them.
    """
    C, dim = q0.shape
    kw = dict(dtype=q0.dtype, device=q0.device)
    # checkpoint stack: slot k holds the starting momentum and the momentum
    # prefix-sum *before* the currently open level-k range (slot 0 unused)
    ckpt_p = [None] * (max_depth + 1)
    ckpt_psum = [None] * (max_depth + 1)
    half_e = 0.5 * eps_signed[:, None]
    e_im = eps_signed[:, None] * inv_mass
    # the leaves' uniforms for the multinomial proposal, drawn at once
    log_u = torch.log(torch.rand((1 << depth, C), generator=generator, **kw))

    q, p, grad = q0, p0, grad0
    first_q, first_p, first_grad = q0, p0, grad0
    q_prop, grad_prop = q0, grad0
    logp_prop = torch.full((C,), -math.inf, **kw)
    log_weight = torch.full((C,), -math.inf, **kw)
    p_sum = torch.zeros((C, dim), **kw)
    turning = torch.zeros((C,), dtype=torch.bool, device=q0.device)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros((C,), **kw)
    n_done = torch.zeros((C,), dtype=torch.int32, device=q0.device)

    for i in range(1 << depth):
        go = live & ~turning & ~diverging
        p1 = torch.addcmul(p, half_e, grad)
        q1 = torch.addcmul(q, e_im, p1)
        logp, grad1 = vg(q1)
        p1 = torch.addcmul(p1, half_e, grad1)

        # open level-k ranges starting at leaf i: i % 2^k == 0, 1 <= k <=
        # depth.  Store leaf i's OWN momentum (post-leapfrog) and the
        # prefix sum *before* leaf i, so a range's rho includes its first
        # leaf and the U-turn velocity is that first leaf's — the
        # time-reversible criterion (NumPyro's iterative bookkeeping).
        for k in range(1, depth + 1):
            if i % (1 << k) == 0:
                ckpt_p[k], ckpt_psum[k] = p1, p_sum
        v1 = inv_mass * p1
        neg_delta = logp - 0.5 * (v1 * p1).sum(1) + energy0  # H0 - H(leaf)
        div = ~torch.isfinite(neg_delta) | (neg_delta < -_MAX_DELTA_ENERGY)
        lw_leaf = torch.where(div, -math.inf, neg_delta)

        # progressive multinomial sampling within the subtree
        lw_new = torch.logaddexp(log_weight, lw_leaf)
        take = go & (log_u[i] < (lw_leaf - lw_new))
        q_prop = _rows(take, q1, q_prop)
        logp_prop = _rows(take, logp, logp_prop)
        grad_prop = _rows(take, grad1, grad_prop)
        p_sum_new = p_sum + p1
        if i == 0:
            first_q, first_p, first_grad = q1, p1, grad1

        # close level-k ranges ending at leaf i: (i+1) % 2^k == 0 (none at
        # an even leaf)
        turn = None
        for k in range(1, depth + 1):
            if (i + 1) % (1 << k) == 0:
                rho = p_sum_new - ckpt_psum[k]
                t = ((inv_mass * ckpt_p[k] * rho).sum(1) <= 0.0) \
                    | ((v1 * rho).sum(1) <= 0.0)
                turn = t if turn is None else turn | t
        if turn is not None:
            turning = turning | (go & turn)

        alpha = torch.exp(neg_delta).clamp(max=1.0)
        alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)

        # a chain whose subtree has ended runs on unmasked: its endpoints,
        # momentum sum and weight are then never read (the merge takes a
        # subtree only where it neither turned nor diverged, and the
        # subtree of a chain that is not live not at all)
        q, p, grad, log_weight, p_sum = q1, p1, grad1, lw_new, p_sum_new
        diverging = diverging | (go & div)
        sum_accept = sum_accept + torch.where(go, alpha, 0.0)
        n_done = n_done + go

    return _Tree(
        q_left=first_q, p_left=first_p, grad_left=first_grad,
        q_right=q, p_right=p, grad_right=grad,
        q_prop=q_prop, logp_prop=logp_prop, grad_prop=grad_prop,
        log_weight=log_weight, p_sum=p_sum, turning=turning,
        diverging=diverging, sum_accept=sum_accept, n_leaves=n_done)


def nuts_kernel(log_joint_flat, max_depth=8):
    """Returns step(generator, (q, logp, grad), eps, inv_mass) ->
    ((q, logp, grad), info dict of (C,) tensors)."""

    def vg(q):
        return value_and_grad(log_joint_flat, q)

    def step(generator, state, eps, inv_mass):
        q0, logp0, grad0 = state
        C = q0.shape[0]
        p0 = torch.randn(q0.shape, generator=generator, dtype=q0.dtype,
                         device=q0.device) / torch.sqrt(inv_mass)
        energy0 = -logp0 + 0.5 * (inv_mass * p0 * p0).sum(1)
        no = torch.zeros((C,), dtype=torch.bool, device=q0.device)
        tree = _Tree(
            q_left=q0, p_left=p0, grad_left=grad0,
            q_right=q0, p_right=p0, grad_right=grad0,
            q_prop=q0, logp_prop=logp0, grad_prop=grad0,
            log_weight=torch.zeros_like(logp0), p_sum=p0, turning=no,
            diverging=no, sum_accept=torch.zeros_like(logp0),
            n_leaves=torch.ones((C,), dtype=torch.int32, device=q0.device))
        depth = torch.zeros((C,), dtype=torch.int32, device=q0.device)

        for d in range(max_depth):
            active = ~tree.turning & ~tree.diverging
            # every tree grows at d = 0; later, one read a doubling
            if d > 0 and not bool(active.any()):
                break
            go_right = _uniform(generator, logp0) < 0.5
            sub = _build_subtree(
                generator, vg, _rows(go_right, tree.q_right, tree.q_left),
                _rows(go_right, tree.p_right, tree.p_left),
                _rows(go_right, tree.grad_right, tree.grad_left),
                torch.where(go_right, eps, -eps), d, inv_mass, energy0,
                max_depth, active)

            ok = ~sub.turning & ~sub.diverging
            # biased progressive sampling across the doubling
            p_take = torch.exp((sub.log_weight - tree.log_weight)
                               .clamp(max=0.0))
            take = ok & (_uniform(generator, logp0) < p_take)

            # merge endpoints / rho only when the doubling is kept
            new_right = ok & go_right
            new_left = ok & ~go_right
            merged = _Tree(
                q_left=_rows(new_left, sub.q_right, tree.q_left),
                p_left=_rows(new_left, sub.p_right, tree.p_left),
                grad_left=_rows(new_left, sub.grad_right, tree.grad_left),
                q_right=_rows(new_right, sub.q_right, tree.q_right),
                p_right=_rows(new_right, sub.p_right, tree.p_right),
                grad_right=_rows(new_right, sub.grad_right, tree.grad_right),
                q_prop=_rows(take, sub.q_prop, tree.q_prop),
                logp_prop=_rows(take, sub.logp_prop, tree.logp_prop),
                grad_prop=_rows(take, sub.grad_prop, tree.grad_prop),
                log_weight=torch.logaddexp(
                    tree.log_weight,
                    torch.where(ok, sub.log_weight, -math.inf)),
                p_sum=tree.p_sum + _rows(ok, sub.p_sum,
                                         torch.zeros_like(sub.p_sum)),
                turning=no, diverging=sub.diverging,
                sum_accept=tree.sum_accept + sub.sum_accept,
                n_leaves=tree.n_leaves + sub.n_leaves)
            full_turn = _is_turning(inv_mass, merged.p_left, merged.p_right,
                                    merged.p_sum)
            merged = merged._replace(turning=sub.turning | (ok & full_turn))
            tree = _where_tree(active, merged, tree)
            depth = depth + active.to(depth.dtype)

        accept_stat = tree.sum_accept / (
            tree.n_leaves.to(q0.dtype) - 1.0).clamp(min=1.0)
        info = {"accept_p": accept_stat, "depth": depth,
                "n_leaves": tree.n_leaves, "diverging": tree.diverging}
        return (tree.q_prop, tree.logp_prop, tree.grad_prop), info

    return step


def run_nuts(generator, log_joint, init_positions, *, n_warmup=500,
             n_samples=500, max_depth=8, target_accept=0.8,
             init_step_size=0.01):
    """Run C NUTS chains as one batch with the two-phase warmup of
    ``samplers/hmc.py::run_hmc``.

    log_joint: (C, dim) positions -> (C,) log densities; init_positions
    (C, dim).  Returns (positions (C, n_samples, dim), diagnostics): the
    JAX package's per-chain ``accept_mean``, ``eps``, ``warm_accept``,
    ``mean_depth`` and ``n_divergent`` (over the samples), and ``depth``
    (C, n_warmup + n_samples), every tree's depth.
    """
    refuse_chain_shard("run_nuts")
    step = nuts_kernel(log_joint, max_depth=max_depth)
    logp0, grad0 = value_and_grad(log_joint, init_positions)
    divs = []

    def transition(st, eps, inv_mass):
        (q, logp, grad), info = step(generator, st, eps, inv_mass)
        divs.append(info["diverging"])
        return st._replace(position=q, logp=logp, grad=grad), \
            info["accept_p"], info["depth"]

    qs, aps, depth, eps, warm = run_adapted(
        transition, init_positions, logp0, grad0, n_warmup=n_warmup,
        n_samples=n_samples, target_accept=target_accept,
        init_step_size=init_step_size)
    kept = depth[:, n_warmup:]
    n_div = torch.stack(divs[n_warmup:], 1).sum(1) if n_samples \
        else torch.zeros_like(eps)
    return qs, {"accept_mean": aps.mean(1), "eps": eps, "warm_accept": warm,
                "mean_depth": kept.to(qs.dtype).mean(1), "n_divergent": n_div,
                "depth": depth}
