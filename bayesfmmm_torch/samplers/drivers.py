"""MCMC drivers: run a sweep over C chains and stack the traces.

Port of the phase-3 part of ``bayesfmmm_tpu/samplers/drivers.py``.
The JAX package scans a jitted per-chain sweep and vmaps it over chains;
here a Python loop runs the batched sweep of ops/gibbs.py, and the traces
stack on the host-visible device with the chain axis first.  Tempered
transitions are a later slice of the port.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import STATE_FIELDS
from bayesfmmm_torch.ops import gibbs


class TraceResult(NamedTuple):
    traces: dict          # parameter name -> (C, n_saved, ...) draws
    loglik: torch.Tensor  # (C, n_saved)
    final_state: object


def run_chain(generator, state, data, hp, c, *, sweep, n_iters, thin=1,
              betas=None, n_temp_trans=0):
    """Run ``n_iters`` sweeps of every chain, keeping every ``thin``-th
    draw and its log-likelihood.

    ``betas``: optional per-sweep temperatures (length n_iters), e.g. an
    annealed warmup; default 1 throughout."""
    if n_temp_trans:
        raise NotImplementedError(
            "tempered transitions: ROADMAP item 'drivers, fit API and "
            "reference API'")
    if betas is not None and len(betas) != n_iters:
        raise ValueError(f"betas has {len(betas)} entries for {n_iters} "
                         f"sweeps")
    gibbs.use_full_f32()
    traces = {f: [] for f in STATE_FIELDS}
    loglik = []
    for i in range(n_iters):
        beta = 1.0 if betas is None else float(betas[i])
        state = sweep(generator, state, data, hp, c, beta=beta)
        if (i + 1) % thin == 0:
            for f in STATE_FIELDS:
                traces[f].append(getattr(state, f))
            loglik.append(log_likelihood(state, data))
    return TraceResult({f: torch.stack(v, 1) for f, v in traces.items()},
                       torch.stack(loglik, 1), state)


def phase_warm_start(generator, state, data, hp, c, *, n_iters, thin=1,
                     betas=None, n_temp_trans=0, **sweep_flags):
    """Phase 3 (BFMMM_MTT_warm_start, BFMMM.h:1346-1762): the production
    sampler.  ``sweep_flags`` are keyword flags of ops/gibbs.py::sweep_full
    (the reference census without any; the bench's production census with
    collapsed_z=True, gauge=True, p_indep=0.3, phi_mala_steps=4,
    phi_mala_step=0.05)."""
    sweep = functools.partial(gibbs.sweep_full, **sweep_flags)
    return run_chain(generator, state, data, hp, c, sweep=sweep,
                     n_iters=n_iters, thin=thin, betas=betas,
                     n_temp_trans=n_temp_trans)
