"""MCMC drivers: the three-phase fitting pipeline over C chains at once.

Port of ``bayesfmmm_tpu/samplers/drivers.py``.  The JAX package scans a
jitted per-chain sweep and vmaps it over chains; here a Python loop runs the
batched sweeps of ops/gibbs.py, and the traces stack on the device with the
chain axis first.  Restarts ("n_try", UserFunctions.cpp:302-325) and
production chains are the chain axis.

Tempered transitions (BFMMM.h:1556-1669) are a Python loop over the 2*N_t
ladder rungs in place of one iteration's sweep; each chain accepts or
rejects its own excursion wholesale (CalculateTTAcceptance.h:65-97).
Nothing in the loops reads a device value on the host.  Under
torch.profiler ``run_chain`` (with its sweeps), ``tempered_excursion`` and
the stacking of the traces are spans (utils/observability.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import STATE_FIELDS
from bayesfmmm_torch.ops import gibbs
from bayesfmmm_torch.ops.distributions import uniform
from bayesfmmm_torch.ops.mean import effective_coeffs, rss_from_coeffs
from bayesfmmm_torch.utils.observability import span, traced


class TraceResult(NamedTuple):
    traces: dict          # parameter name -> (C, n_saved, ...) draws
    loglik: torch.Tensor  # (C, n_saved)
    final_state: object
    # (C, n_excursions) bool, which chains accepted each tempered excursion
    # (the reference prints this, BFMMM.h:831-835); None without excursions
    tt_accept: torch.Tensor | None = None


def make_temperature_ladder(beta_N_t: float, N_t: int) -> np.ndarray:
    """Geometric temperature ladder, reference-exact (BFMMM.h:661-670), as a
    host float32 array.

    The reference builds ones(N_t), pre-sets the last entry to beta_N_t,
    then overwrites entries 1..N_t-1 with cumulative powers of
    g = beta_N_t^(1/N_t) — so the ladder actually used is
    [1, g, g^2, ..., g^(N_t-1)] for N_t > 1, and [beta_N_t] for N_t == 1
    (only then does the pre-set survive).  The excursion's temp_ind walks
    0..N_t-1..0 over this array; the first/last rung sweeps therefore run
    at beta = 1 (untempered) for N_t > 1, exactly as the reference does.
    """
    if N_t == 1:
        return np.asarray([beta_N_t], dtype=np.float32)
    g = np.float32(beta_N_t ** (1.0 / N_t))
    return g ** np.arange(N_t, dtype=np.float32)


def _excursion_weight(ladder, s):
    """Delta-beta multiplying pz_unit of state index s (0..2 N_t): a host
    float that depends on the rung index only."""
    N_t = len(ladder)
    if s <= N_t - 2:
        return float(ladder[s + 1] - ladder[s])
    if s >= N_t + 2:
        i = 2 * N_t - s
        return -float(ladder[i + 1] - ladder[i])
    return 0.0


@traced("samplers.drivers.tempered_excursion")
def tempered_excursion(generator, state, data, hp, c, ladder, *,
                       sweep_fn=None):
    """One tempered-transition excursion of every chain, accepted or
    rejected wholesale per chain.

    Reference: BFMMM.h:1556-1669.  2*N_t tempered sweeps run at ladder
    temperatures walking 0..N_t-1..0 (BFMMM.h:1623-1629); one MH decision
    per chain accepts its entire excursion with log-probability
    (CalculateTTAcceptance.h:65-97):

        logA = sum_{i=0}^{N_t-2} [ pz(S_i, b_{i+1}) - pz(S_i, b_i)
                                   - pz(S_{2N_t-i}, b_{i+1}) + pz(S_{2N_t-i}, b_i) ]

    where S_l is the state after l rung-sweeps and
    pz(S, b) = -b/2 * (n log sigma2 + rss/sigma2)  (calculatePZeta:46-47).
    pz is linear in b, so each state contributes (delta-beta) * pz_unit(S).

    ``sweep_fn(generator, state, data, hp, c, beta=...)`` defaults to the
    reference census of ``sweep_full``.  Returns (state, accept, logA) with
    accept and logA of shape (C,), on the state's device.
    """
    N_t = len(ladder)
    sweep = sweep_fn or gibbs.sweep_full

    def pz_unit(st):
        rss = rss_from_coeffs(data, effective_coeffs(st, data.X))  # K2
        return (-0.5 * data.n_obs * torch.log(st.sigma2)
                - rss / (2.0 * st.sigma2))

    st = state
    logA = torch.zeros_like(state.sigma2)
    for rung in range(1, 2 * N_t + 1):
        temp_ind = rung - 1 if rung <= N_t else 2 * N_t - rung
        logA = logA + _excursion_weight(ladder, rung - 1) * pz_unit(st)
        st = sweep(generator, st, data, hp, c, beta=float(ladder[temp_ind]))
    logA = logA + _excursion_weight(ladder, 2 * N_t) * pz_unit(st)
    logu = torch.log(uniform(generator, logA.shape, dtype=logA.dtype,
                             device=logA.device))
    accept = logu < logA
    return gibbs.select_state(accept, st, state), accept, logA


def run_chain(generator, state, data, hp, c, *, sweep, n_iters, thin=1,
              betas=None, n_temp_trans=0, ladder=None, start_iter=0):
    """Run ``n_iters`` sweeps of every chain, keeping every ``thin``-th
    draw and its log-likelihood.

    ``betas``: optional per-sweep temperatures (length n_iters), e.g. an
    annealed warmup; default 1 throughout.  With ``n_temp_trans`` and a
    ``ladder``, a tempered excursion replaces the sweep of every iteration
    i > 0 with i % n_temp_trans == 0, where i counts from ``start_iter``:
    a run continued from iteration ``start_iter`` keeps the schedule of the
    unbroken run."""
    if betas is not None and len(betas) != n_iters:
        raise ValueError(f"betas has {len(betas)} entries for {n_iters} "
                         f"sweeps")
    use_tt = bool(n_temp_trans) and ladder is not None
    gibbs.use_full_f32()
    traces = {f: [] for f in STATE_FIELDS}
    loglik, tt_accept = [], []
    with span("samplers.drivers.run_chain", sweeps=n_iters):
        for i in range(n_iters):
            it = start_iter + i
            if use_tt and it > 0 and it % n_temp_trans == 0:
                state, accept, _ = tempered_excursion(
                    generator, state, data, hp, c, ladder, sweep_fn=sweep)
                tt_accept.append(accept)
            else:
                beta = 1.0 if betas is None else float(betas[i])
                state = sweep(generator, state, data, hp, c, beta=beta)
            if (i + 1) % thin == 0:
                for f in STATE_FIELDS:
                    traces[f].append(getattr(state, f))
                loglik.append(log_likelihood(state, data))
        with span("samplers.drivers.stack_traces"):
            return TraceResult(
                {f: torch.stack(v, 1) for f, v in traces.items()},
                torch.stack(loglik, 1), state,
                torch.stack(tt_accept, 1) if tt_accept else None)


# ---------------------------------------------------------------------------
# Phase drivers
# ---------------------------------------------------------------------------

def phase_nu_z(generator, state, data, hp, c, *, n_iters,
               covariate_mean=False):
    """Phase 1 (BFMMM_Nu_Z, BFMMM.h:989-1155): find mean/allocation structure.

    Phi is pinned at zero so the likelihood is chi-free (BFMMM.h:1063).
    """
    state = state.replace(Phi=torch.zeros_like(state.Phi),
                          xi=torch.zeros_like(state.xi))
    sweep = functools.partial(gibbs.sweep_nu_z, covariate_mean=covariate_mean)
    return run_chain(generator, state, data, hp, c, sweep=sweep,
                     n_iters=n_iters)


def phase_theta(generator, state, data, hp, c, *, n_iters,
                covariate_mean=False, covariate_cov=False):
    """Phase 2 (BFMMM_Theta, BFMMM.h:1157-1345): covariance structure given
    pinned (Z, nu[, eta]) point estimates."""
    def sweep(g, st, d, h, cvec, beta=1.0):
        return gibbs.sweep_theta(g, st, d, h, covariate_mean=covariate_mean,
                                 covariate_cov=covariate_cov, beta=beta)

    return run_chain(generator, state, data, hp, c, sweep=sweep,
                     n_iters=n_iters)


def phase_warm_start(generator, state, data, hp, c, *, n_iters, thin=1,
                     betas=None, n_temp_trans=0, beta_N_t=1.0, N_t=1,
                     start_iter=0, **sweep_flags):
    """Phase 3 (BFMMM_MTT_warm_start, BFMMM.h:1346-1762): the production
    sampler, with optional tempered-transition excursions every
    ``n_temp_trans`` iterations.  ``sweep_flags`` are keyword flags of
    ops/gibbs.py::sweep_full (the reference census without any; the bench's
    production census with collapsed_z=True, gauge=True, p_indep=0.3,
    phi_mala_steps=4, phi_mala_step=0.05); the excursions' rungs run the
    same sweep."""
    sweep = functools.partial(gibbs.sweep_full, **sweep_flags)
    ladder = make_temperature_ladder(beta_N_t, N_t) if n_temp_trans else None
    return run_chain(generator, state, data, hp, c, sweep=sweep,
                     n_iters=n_iters, thin=thin, betas=betas,
                     n_temp_trans=n_temp_trans, ladder=ladder,
                     start_iter=start_iter)


def posterior_median_state(traces, burnin_prop=0.8):
    """Per-element posterior medians of one chain's post-burn-in draws, as
    host arrays, with Z rows and pi re-normalized to the simplex
    (UserFunctions.cpp:1557-1650).

    ``traces`` maps a field to (n_saved, ...) draws.  An even number of
    kept draws averages the two middle ones (numpy.median, as jnp.median
    does; torch.median would return the lower)."""
    def med(x):
        x = np.asarray(x)
        start = int(burnin_prop * x.shape[0])
        return np.asarray(np.median(x[start:], axis=0), dtype=x.dtype)

    est = {k: med(v) for k, v in traces.items()}
    est["Z"] = est["Z"] / np.sum(est["Z"], axis=-1, keepdims=True)
    est["pi"] = est["pi"] / np.sum(est["pi"])
    return est


def best_chain(loglik_batch, window=100) -> int:
    """Restart selection: argmax of mean loglik over the last ``window``
    draws of a host (C, n_saved) array, the first chain on a tie
    (UserFunctions.cpp:308-325)."""
    tail = np.asarray(loglik_batch)[:, -window:]
    return int(np.argmax(np.mean(tail, axis=1)))
