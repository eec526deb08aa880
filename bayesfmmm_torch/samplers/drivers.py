"""MCMC drivers: the three-phase fitting pipeline over C chains at once.

Port of ``bayesfmmm_tpu/samplers/drivers.py``.  The JAX package scans a
jitted per-chain sweep and vmaps it over chains; here a Python loop runs the
batched sweeps of ops/gibbs.py, and the traces stack on the device with the
chain axis first.  Restarts ("n_try", UserFunctions.cpp:302-325) and
production chains are the chain axis.

On the card ``phase_warm_start`` runs ``sweep_full``, in the reference or
the production census, as replays of a CUDA graph instead
(``replay_chain``; ``replays_sweep`` says when): one sweep, its
log-likelihood and the copy of the new state into the graph's buffers,
captured once.  A process keeps one graph, so later runs on the same data,
flags and shapes replay without a capture; a run that needs another
captures it in its place.  The replays draw what the eager sweeps
draw, bit for bit: the graph's generator takes the run's generator state
before them and gives it back after.  Both loops keep their draws the same
way (``_run``).  ``SWEEP_GRAPHS`` counts captures, replays and the
iterations run eagerly.

Tempered transitions (BFMMM.h:1556-1669) are a Python loop over the 2*N_t
ladder rungs in place of one iteration's sweep; each chain accepts or
rejects its own excursion wholesale (CalculateTTAcceptance.h:65-97).
Nothing in the loops reads a device value on the host.  Under
torch.profiler ``run_chain`` (with its sweeps), ``tempered_excursion``, the
stacking of the traces and a graph's capture (``capture_sweep``) are spans
(utils/observability.py); a replay is a span ``ops.gibbs.sweep_full``
without updater spans inside.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.models.state import STATE_FIELDS, GibbsState
from bayesfmmm_torch.ops import gibbs
from bayesfmmm_torch.ops.distributions import uniform
from bayesfmmm_torch.ops.mean import effective_coeffs, rss_from_coeffs
from bayesfmmm_torch.parallel.mesh import active_mesh
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


# ---------------------------------------------------------------------------
# The run's loop
# ---------------------------------------------------------------------------

def _run(step, state, data, *, n_iters, thin, betas, hold=None):
    """The loop of a run: ``step(i, state, beta)`` gives iteration i's
    state, its log-likelihood where the step takes one (None where not) and
    a tempered excursion's acceptance (None after a sweep).  Every
    ``thin``-th state and its log-likelihood are kept, and the traces stack
    on the device at the end; ``hold`` copies what the step gives where it
    overwrites it later (a captured sweep's buffers)."""
    if betas is not None and len(betas) != n_iters:
        raise ValueError(f"betas has {len(betas)} entries for {n_iters} "
                         f"sweeps")
    keep = hold or (lambda t: t)
    traces = {f: [] for f in STATE_FIELDS}
    loglik, tt_accept = [], []
    with span("samplers.drivers.run_chain", sweeps=n_iters):
        for i in range(n_iters):
            beta = 1.0 if betas is None else float(betas[i])
            state, ll, accept = step(i, state, beta)
            if accept is not None:
                tt_accept.append(accept)
            if (i + 1) % thin == 0:
                for f in STATE_FIELDS:
                    traces[f].append(keep(getattr(state, f)))
                loglik.append(log_likelihood(state, data) if ll is None
                              else keep(ll))
        if hold:
            state = GibbsState(**{f: hold(getattr(state, f))
                                  for f in STATE_FIELDS})
        with span("samplers.drivers.stack_traces"):
            return TraceResult(
                {f: torch.stack(v, 1) for f, v in traces.items()},
                torch.stack(loglik, 1), state,
                torch.stack(tt_accept, 1) if tt_accept else None)


def run_chain(generator, state, data, hp, c, *, sweep, n_iters, thin=1,
              betas=None, n_temp_trans=0, ladder=None, start_iter=0):
    """Run ``n_iters`` sweeps of every chain, keeping every ``thin``-th
    draw and its log-likelihood.

    ``betas``: optional per-sweep temperatures (length n_iters), e.g. an
    annealed warmup; default 1 throughout.  With ``n_temp_trans`` and a
    ``ladder``, a tempered excursion replaces the sweep of every iteration
    i > 0 with i % n_temp_trans == 0, where i counts from ``start_iter``:
    a run continued from iteration ``start_iter`` keeps the schedule of the
    unbroken run.  Every iteration runs eagerly; ``phase_warm_start``
    replays a captured sweep instead where it can (``replay_chain``)."""
    use_tt = bool(n_temp_trans) and ladder is not None
    gibbs.use_full_f32()

    def step(i, st, beta):
        SWEEP_GRAPHS["eager"] += 1
        it = start_iter + i
        if use_tt and it > 0 and it % n_temp_trans == 0:
            st, accept, _ = tempered_excursion(
                generator, st, data, hp, c, ladder, sweep_fn=sweep)
            return st, None, accept
        return sweep(generator, st, data, hp, c, beta=beta), None, None

    return _run(step, state, data, n_iters=n_iters, thin=thin, betas=betas)


# ---------------------------------------------------------------------------
# The captured sweep
# ---------------------------------------------------------------------------

# Events of the captured sweep, each counted once: a graph captured, a sweep
# replayed, an iteration run eagerly (a warm-up sweep before a capture, or an
# iteration of a run that replays nothing).
SWEEP_GRAPHS = {"captures": 0, "replays": 0, "eager": 0}

# Eager sweeps of a run before it captures its graph: they load every
# kernel and library the sweep uses, which a capture cannot do.
WARMUP_SWEEPS = 1

# sweep_full's default-off switches, which no run replays: the Phi column
# moves, the anchor stage and the whole-model HMC step (with its own
# autograd Function and an inverse mass that may come from the host).
_DEFAULT_OFF_SWITCHES = ("phi_chi_moves", "z_anchor", "hmc_steps")

# The process's one captured sweep (a SweepGraph), replaced by the next
# capture.
_GRAPH = None


def replays_sweep(device, mesh, flags, n_temp_trans):
    """Whether a run of ``sweep_full(**flags)`` replays a captured sweep:
    only on CUDA, outside a mesh (whose draws broadcast over the host's
    collectives), without tempered excursions, and without a default-off
    switch.  The reference and the production census replay (the collapsed
    (Z, chi) block, the gauge block and the Phi MALA, whose autograd
    gradient is captured with the rest), covariate flags allowed."""
    return (torch.device(device).type == "cuda" and mesh is None
            and not n_temp_trans
            and not any(flags.get(k) for k in _DEFAULT_OFF_SWITCHES))


class SweepBuffers(NamedTuple):
    """What a captured sweep reads and writes, at fixed addresses."""
    state: GibbsState     # the chains' state, updated in place
    c: torch.Tensor       # pi's Dirichlet prior (K,)
    beta: torch.Tensor    # (C,) temperature
    loglik: torch.Tensor  # (C,) log-likelihood of the new state


def buffered_sweep(generator, buf, data, hp, flags):
    """One ``sweep_full`` of ``buf.state`` at ``buf.beta`` and the new
    state's log-likelihood, both written into ``buf``: the step a captured
    graph replays."""
    new = gibbs.sweep_full(generator, buf.state, data, hp, buf.c,
                           beta=buf.beta, **flags)
    for f in STATE_FIELDS:
        getattr(buf.state, f).copy_(getattr(new, f))
    buf.loglik.copy_(log_likelihood(new, data))


def sweep_graph_key(data, hp, flags, state, c):
    """What a captured sweep bakes in: the data object (by identity), the
    priors and flags by value, the state's shapes and dtypes, c's shape,
    the device, the matmul TF32 switch, and the sweep and log-likelihood
    functions the step calls as they are now."""
    return (id(data), repr(hp), tuple(sorted(flags.items())),
            tuple((tuple(getattr(state, f).shape), getattr(state, f).dtype)
                  for f in STATE_FIELDS),
            tuple(c.shape), c.dtype, state.Z.device,
            torch.backends.cuda.matmul.allow_tf32, gibbs.sweep_full,
            log_likelihood)


class SweepGraph:
    """``buffered_sweep`` captured once, with its buffers and a generator of
    its own; ``load`` gives it a run's state, c and generator state before
    the replays.  It holds its data, whose tensors the graph reads."""

    def __init__(self, key, data, hp, flags, state, c):
        self.key, self.data, self.hp, self.flags = key, data, hp, flags
        self.generator = torch.Generator(device=state.Z.device)
        self.buf = SweepBuffers(
            GibbsState(**{f: getattr(state, f).clone()
                          for f in STATE_FIELDS}),
            c.clone(), torch.ones_like(state.sigma2),
            torch.empty_like(state.sigma2))
        self.beta = 1.0
        with span("samplers.drivers.capture_sweep"):
            self.graph = self._capture()
        SWEEP_GRAPHS["captures"] += 1

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.device(self.buf.c.device):
            # captured on a stream of the graph's own device; a replay
            # launches on that device's current stream.  The Phi MALA's
            # backward runs on autograd's device thread, on this stream:
            # its kernels join the capture and its allocations the graph's
            # pool, which follow the stream's capture, not the thread
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                                  capture_error_mode="thread_local"):
                self.step()
        return graph

    def step(self):
        buffered_sweep(self.generator, self.buf, self.data, self.hp,
                       self.flags)

    def replay(self):
        self.graph.replay()

    def load(self, generator, state, c):
        self.generator.set_state(generator.get_state())
        for f in STATE_FIELDS:
            getattr(self.buf.state, f).copy_(getattr(state, f))
        self.buf.c.copy_(c)

    def set_beta(self, beta):
        if beta != self.beta:
            self.buf.beta.fill_(beta)
            self.beta = beta


def _capture(key, data, hp, flags, state, c):
    """The process's graph for ``key``, captured from ``state``; the graph
    held before is dropped first, and its memory pool with it."""
    global _GRAPH
    _GRAPH = None
    _GRAPH = SweepGraph(key, data, hp, flags, state, c)
    return _GRAPH


def replay_chain(generator, state, data, hp, c, flags, *, n_iters, thin=1,
                 betas=None):
    """``run_chain`` of ``sweep_full(**flags)`` as replays of the process's
    captured sweep, which also takes the new state's log-likelihood; for
    the runs ``replays_sweep`` allows, in either census.  Where the process
    holds no graph for this key (``sweep_graph_key``), the run's first
    ``WARMUP_SWEEPS`` sweeps run eagerly and the next is captured, in place
    of the graph held before.  The graph's generator takes ``generator``'s
    state before the replays and gives it back after, so the draws,
    log-likelihoods, final state and generator state are those of the eager
    loop, bit for bit; the kept draws are copies of the graph's buffers."""
    gibbs.use_full_f32()
    key = sweep_graph_key(data, hp, flags, state, c)
    graph = _GRAPH if _GRAPH is not None and _GRAPH.key == key else None
    n_eager = 0 if graph is not None else min(WARMUP_SWEEPS, n_iters)

    def step(i, st, beta):
        nonlocal graph
        if i < n_eager:
            SWEEP_GRAPHS["eager"] += 1
            return (gibbs.sweep_full(generator, st, data, hp, c, beta=beta,
                                     **flags), None, None)
        if i == n_eager:
            graph = graph or _capture(key, data, hp, flags, st, c)
            graph.load(generator, st, c)
        graph.set_beta(beta)
        with span("ops.gibbs.sweep_full"):
            graph.replay()
        SWEEP_GRAPHS["replays"] += 1
        return graph.buf.state, graph.buf.loglik, None

    res = _run(step, state, data, n_iters=n_iters, thin=thin, betas=betas,
               hold=torch.clone)
    if n_iters > n_eager:
        generator.set_state(graph.generator.get_state())
    return res


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
    same sweep.  Where ``replays_sweep`` allows (the card, no mesh, no
    excursions, no default-off switch: the reference and the production
    census), the run replays a captured sweep (``replay_chain``) with the
    eager loop's bits; elsewhere it is ``run_chain``'s eager loop."""
    if replays_sweep(state.Z.device, active_mesh(), sweep_flags,
                     n_temp_trans):
        return replay_chain(generator, state, data, hp, c, sweep_flags,
                            n_iters=n_iters, thin=thin, betas=betas)
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
