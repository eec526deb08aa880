"""Parallel tempering (replica exchange) over the chain axis.

Port of ``bayesfmmm_tpu/parallel/tempering.py``.  R replicas sit on a
temperature ladder [1, ..., beta_min]; each round runs the same tempered
Gibbs sweep on all of them as one batch of R chains (``sweep_full`` with a
(R,) ``beta``, one temperature per chain), then adjacent replicas propose
to swap states with probability

    min(1, exp((beta_i - beta_j) * (E_j - E_i))),   E = data log-likelihood

the replica-exchange acceptance for the likelihood-only tempering of the
reference (UpdateNu.h:134-136 etc.).  A swap is a permutation of the chain
axis (``models/state.py::take_chains``).  The cold chain (replica 0, beta =
1) gives the posterior draws.  The JAX package vmaps a per-replica sweep
with a traced beta; here the batch is the chain axis itself.

Nothing in the round loop reads the device: the swap decisions, counters
and the cold chain's draws stay there until the run ends.

Under ``with mesh:`` (``parallel/mesh.py``) the replicas are split over the
ranks of the chains axis, each rank holding rows [lo, hi) of the ladder.
Every rank gathers the R energies, draws the R swap uniforms from its copy
of the generator and so computes the same permutation and counts; a swap
only crosses ranks at a pair (lo - 1, lo), and then the two edge replicas
of every rank are exchanged.  The cold chain's trace is broadcast from the
rank that holds replica 0, so every rank returns what the one-process run
returns.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesfmmm_torch.models.state import (STATE_FIELDS, GibbsState,
                                          take_chains)
from bayesfmmm_torch.ops import gibbs
from bayesfmmm_torch.ops.distributions import uniform
from bayesfmmm_torch.ops.mean import effective_coeffs, rss_from_coeffs
from bayesfmmm_torch.parallel import mesh as pmesh


def geometric_ladder(n_replicas: int, beta_min: float, *,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, ..., beta_min] geometric: replica 0 is the cold chain."""
    if n_replicas == 1:
        return torch.ones(1, dtype=dtype, device=device)
    i = torch.arange(n_replicas, device=device).to(dtype)
    return beta_min ** (i / (n_replicas - 1))


def auto_ladder(sd_E: float, beta_min: float, *, target_accept=0.4,
                max_replicas=64, dtype=torch.float32, device=None):
    """Size a PT ladder from a measured energy sd.

    For likelihood-only tempering the swap log-acceptance of an adjacent
    pair is dbeta * (E_j - E_i); with E fluctuating by sd(E) in each
    replica, the mean acceptance is about 2 Phi(-dbeta sd(E)) (Predescu et
    al. 2004), so ``target_accept`` needs dbeta = z / sd(E) with
    z = -Phi^-1(target / 2).  Returns (ladder [1 ... >= beta_min], feasible):
    when the rungs needed exceed ``max_replicas`` the ladder is clamped to
    that many, spanning only the reachable range, and ``feasible`` is
    False.

    Unlike the JAX package's (ROADMAP F4), a ladder to ``beta_min`` = 1 (one
    rung, no tempering) and a non-finite ``sd_E`` (a diverged pilot) raise
    ValueError."""
    sd_E = float(sd_E)
    if not math.isfinite(sd_E):
        raise ValueError(f"auto_ladder: the measured energy sd is {sd_E}, "
                         f"not finite (did the pilot sweeps diverge, or run "
                         f"fewer than 4?)")
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f"auto_ladder: beta_min={beta_min} gives a ladder "
                         f"of one rung at beta 1, no tempering; it must lie "
                         f"in (0, 1)")
    z = -torch.special.ndtri(torch.tensor(target_accept / 2.0,
                                          dtype=torch.float64)).item()
    dbeta = z / max(sd_E, 1e-12)
    n_needed = int(-(-(1.0 - beta_min) // dbeta)) + 1
    feasible = n_needed <= max_replicas
    n = min(n_needed, max_replicas)
    lo = beta_min if feasible else 1.0 - (n - 1) * dbeta
    return torch.linspace(1.0, lo, n, dtype=dtype, device=device), feasible


def _loglik_portion(state, data):
    """E(state) (C,): the tempered factor (calculatePZeta:46-47 at beta =
    1); the RSS is kernel K2 on CUDA."""
    rss = rss_from_coeffs(data, effective_coeffs(state, data.X))
    return -0.5 * data.n_obs * torch.log(state.sigma2) \
        - rss / (2.0 * state.sigma2)


class PTState(NamedTuple):
    states: GibbsState            # replica-stacked (R chains)
    swap_accepts: torch.Tensor    # () on the device
    swap_attempts: torch.Tensor


def pt_init(states):
    zero = torch.zeros((), dtype=states.sigma2.dtype,
                       device=states.sigma2.device)
    return PTState(states, zero, zero)


def swap_phase(E, ladder, parity, u):
    """The swap decisions of one round, a plain function of the replicas'
    energies E (R,), the ladder (R,), the parity (0 pairs (0,1), (2,3), ...;
    1 pairs (1,2), (3,4), ...) and R uniforms u, of which each pair uses its
    lower member's.  Returns (perm, accepted, attempted): the chain
    permutation that carries out the accepted swaps and this round's two
    counts, all on the device (JAX tempering.py:120-141)."""
    R = E.shape[0]
    idx = torch.arange(R, device=E.device)
    partner = torch.where((idx - parity) % 2 == 0,
                          (idx + 1).clamp(0, R - 1), (idx - 1).clamp(0, R - 1))
    # pairs at the ladder's edge point to themselves: no move
    valid = partner != idx
    log_acc = (ladder - ladder[partner]) * (E[partner] - E)
    # both members of a pair compute the same quantity from the same
    # uniform, so the decision is symmetric
    pair_lo = torch.minimum(idx, partner)
    accept = (torch.log(u[pair_lo]) < log_acc) & valid
    perm = torch.where(accept, partner, idx)
    attempted = valid.to(E.dtype).sum() / 2.0
    accepted = (accept & (idx < partner)).to(E.dtype).sum()
    return perm, accepted, attempted


def _split_take(mesh, states, perm, parity):
    """This rank's replicas after the permutation ``perm`` of all R: the
    pair (lo - 1, lo) of each rank boundary lo is the only one that can
    cross ranks, and only at the parity that pairs it; then every rank's
    first and last replica are gathered, and each rank takes its
    neighbours'."""
    n = states.Z.shape[0]
    lo, hi = mesh.chain_rows(n)
    local = perm[lo:hi] - lo
    crossing = any((b - 1 - parity) % 2 == 0
                   for b in range(n, mesh.n_chains, n))
    if not crossing:
        return take_chains(states, local)
    edges = mesh.gather_fields({f: getattr(states, f)[[0, -1]]
                                for f in STATE_FIELDS})
    k, ranks = mesh.coords[pmesh.CHAIN_AXIS], mesh.shape[pmesh.CHAIN_AXIS]
    # [the last replica of rank k - 1, this rank's, the first of rank
    # k + 1]; at the ends a row that no index reaches stands in
    prev, nxt = max(2 * k - 1, 0), min(2 * k + 2, 2 * ranks - 1)
    wide = GibbsState(**{f: torch.cat([edges[f][prev:prev + 1],
                                       getattr(states, f),
                                       edges[f][nxt:nxt + 1]])
                         for f in STATE_FIELDS})
    return take_chains(wide, local + 1)


def pt_step(generator, pt: PTState, data, hp, c, ladder, *, parity,
            n_sweeps_between=1, **sweep_flags):
    """One PT round: ``n_sweeps_between`` tempered sweeps of every replica
    (one batched ``sweep_full`` at beta = ladder), then one swap phase.
    ``sweep_flags`` go to ``sweep_full`` (covariate flags and the kernel
    census).  Under a split mesh ``ladder`` is the whole ladder and
    ``pt.states`` this rank's replicas."""
    mesh = pmesh.active_mesh()
    states = pt.states
    beta = ladder
    if mesh is not None:
        beta = ladder[slice(*mesh.chain_rows(states.Z.shape[0]))]
    for _ in range(n_sweeps_between):
        states = gibbs.sweep_full(generator, states, data, hp, c,
                                  beta=beta, **sweep_flags)
    E = _loglik_portion(states, data)
    if mesh is not None:
        E = mesh.gather(E)
    u = uniform(generator, E.shape, dtype=E.dtype, device=E.device,
                chain_dim=None)
    perm, accepted, attempted = swap_phase(E, ladder, parity, u)
    states = (take_chains(states, perm) if mesh is None
              else _split_take(mesh, states, perm, parity))
    return PTState(states, pt.swap_accepts + accepted,
                   pt.swap_attempts + attempted)


def run_parallel_tempering(generator, init_states, data, hp, c, *, n_rounds,
                           beta_min=0.3, n_sweeps_between=1, ladder=None,
                           **sweep_flags):
    """Run PT; returns (cold trace, PTState, swap rate).

    ``init_states``: replica-stacked GibbsState (R chains; under a split
    mesh this rank's rows of them, ``mesh.shard_chain_states``'s).
    ``ladder`` overrides the geometric spacing (e.g. an ``auto_ladder``
    result); its length must be R.  The cold trace is a GibbsState whose
    leading axis is the round (one draw of replica 0 after each round's
    swaps), on the device; the swap rate is a () tensor there."""
    mesh = pmesh.active_mesh()
    R = init_states.Z.shape[0]
    if mesh is not None:
        mesh.chain_rows(R)
        R = mesh.n_chains
    dev, dt = init_states.Z.device, data.y.dtype
    if ladder is None:
        ladder = geometric_ladder(R, beta_min, dtype=dt, device=dev)
    ladder = torch.as_tensor(ladder, dtype=dt, device=dev)
    if ladder.shape != (R,):
        raise ValueError(f"ladder length {tuple(ladder.shape)} != replica "
                         f"count {R}")
    gibbs.use_full_f32()
    pt = pt_init(init_states)
    cold = {f: [] for f in STATE_FIELDS}
    for i in range(n_rounds):
        pt = pt_step(generator, pt, data, hp, c, ladder, parity=i % 2,
                     n_sweeps_between=n_sweeps_between, **sweep_flags)
        for f in STATE_FIELDS:
            # a copy, so the trace does not hold every replica's tensors
            cold[f].append(getattr(pt.states, f)[0].clone())
    trace = {f: torch.stack(v) for f, v in cold.items()}
    if mesh is not None:
        trace = mesh.broadcast_fields(trace)
    trace = GibbsState(**trace)
    rate = pt.swap_accepts / pt.swap_attempts.clamp(min=1.0)
    return trace, pt, rate
