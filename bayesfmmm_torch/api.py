"""User-facing fitting API mirroring the reference pipeline semantics.

Port of ``bayesfmmm_tpu/api.py``.  Reference L4/L5: UserFunctions.cpp's
nine fitting functions (B{F,HDF,MV}MMM_{Nu_Z_multiple_try, Theta_est,
warm_start}, :166, :684, :1341, :2519, :3030, :3676, :4579, :4995, :5540)
collapse into three that dispatch on the data's family, with the same
hyperparameter names/defaults (config.Priors) and validation conditions
(:198-286).  Covariate adjustment of the mean (eta) is on when covariates
X are given, that of the covariance (xi) with ``covariate_cov=True``.

The reference's ``n_try`` restarts run serially (:302-325); here all
restarts are the chain axis of one batched run on the device, and the best
chain is still selected by mean log-likelihood of the last 100 draws
(:320-323).

Every function that makes tensors places them on the CUDA card unless
``device="cpu"`` is passed (models/state.py::default_device) and raises
where there is no card; ``fit_theta``, ``fit_warm_start`` and ``fit_pt``
take the device from the data of the result they are given, and
``fit_hmc`` moves the data it is given to its ``device`` (the card when
None).  Traces and estimates are host NumPy arrays; states are tensors on
the device with a leading chain axis.

Under torch.profiler every ``fit_*`` call is a span of its own name
(``api.fit_warm_start``), whose spans below it share its index as their
call id, and every copy of draws to the host is a span ``api.host_copy``
with the bytes copied (utils/observability.py).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from bayesfmmm_torch import validation
from bayesfmmm_torch.config import ModelConfig, Priors
from bayesfmmm_torch.models.state import (STATE_FIELDS, GibbsState,
                                          default_device, init_state,
                                          make_functional_data,
                                          make_hd_functional_data,
                                          make_multivariate_data)
from bayesfmmm_torch.samplers import drivers
from bayesfmmm_torch.utils.observability import span, traced

__all__ = ["FitResult", "build_data", "fit_nu_z", "fit_theta",
           "fit_warm_start", "fit_pt", "fit_smc", "fit_hmc", "fit_advi_init",
           "export_traces", "fit", "PRODUCTION_FLAGS"]

# kernels="production": the bench's production census of ``sweep_full``.
# All five are named because the port's ``sweep_full`` has MALA off by
# default, where the JAX package's turns it on for every gauge caller.
PRODUCTION_FLAGS = dict(collapsed_z=True, gauge=True, p_indep=0.3,
                        phi_mala_steps=4, phi_mala_step=0.05)


class FitResult:
    """Traces + estimates of one fitting phase (best restart chain).

    ``traces`` maps a field to host (n_saved, ...) draws of the best chain,
    ``loglik`` is its (n_saved,) trace, ``final_state`` its last state as a
    one-chain GibbsState on the device."""

    def __init__(self, traces, loglik, final_state, chain_index=0):
        self.traces = traces
        self.loglik = loglik
        self.final_state = final_state
        self.chain_index = chain_index

    def estimates(self, burnin_prop=0.8, align=False, _warn=True):
        """Per-element posterior medians (UserFunctions.cpp:1557-1650).

        align=True first permutation-aligns every draw to the final draw's
        Z (post/label_switch.py) — recommended for K > 2, where the
        reference's K=2-only "rescale" identifiability transform is
        unavailable and label switching would corrupt element-wise medians.
        (The pipeline's internal warm-start median extraction keeps the
        reference's unaligned behavior — a single chain rarely switches
        labels mid-run — and silences this advisory via ``_warn``.)
        """
        traces = self.traces
        if _warn and not align and "Z" in traces \
                and np.asarray(traces["Z"]).shape[-1] > 2:
            warnings.warn(
                "estimates(align=False) with K > 2: element-wise medians "
                "across label-switching draws can be corrupted (the "
                "reference's 'rescale' transform is K=2-only, "
                "PostProcessing.cpp:165-169); pass align=True to "
                "permutation-align draws first.", UserWarning, stacklevel=2)
        if align:
            from bayesfmmm_torch.post.label_switch import align_trace
            traces = align_trace({k: np.asarray(v)
                                  for k, v in traces.items()})
        return drivers.posterior_median_state(traces, burnin_prop)


def build_data(Y, time=None, *, family="functional", basis_degree=3,
               internal_knots=None, boundary_knots=None, X=None,
               basis_degrees=None, internal_knots_list=None, device=None):
    """Construct the padded device data container for any model family."""
    if family == "functional":
        if Y is None or len(Y) < 1:
            raise ValueError("'n_funct' must be an integer greater than or "
                             "equal to 1")
        validation.validate_fit_args(basis_degree=basis_degree)
        validation.validate_knots(internal_knots, boundary_knots)
        return make_functional_data(Y, time, basis_degree=basis_degree,
                                    internal_knots=internal_knots,
                                    boundary_knots=boundary_knots, X=X,
                                    device=device)
    if family == "hd":
        if Y is None or len(Y) < 1:
            raise ValueError("'n_funct' must be an integer greater than or "
                             "equal to 1")
        validation.validate_hd_knots(basis_degrees, internal_knots_list,
                                     boundary_knots)
        return make_hd_functional_data(
            Y, time, basis_degrees=basis_degrees,
            internal_knots_list=internal_knots_list,
            boundary_knots=boundary_knots, X=X, device=device)
    if family == "multivariate":
        Y = np.asarray(Y)
        if Y.ndim != 2 or Y.shape[0] < 1:
            raise ValueError("'Y' must be a matrix with at least one row "
                             "for the multivariate family")
        return make_multivariate_data(Y, X=X, device=device)
    raise ValueError(f"unknown family {family!r}")


def _generator(data, seed):
    return torch.Generator(device=data.device).manual_seed(seed)


def _c_tensor(hp, K, data):
    return torch.as_tensor(hp.c_vector(K), dtype=data.y.dtype,
                           device=data.device)


def _pinned(state, est, fields):
    """``state`` with ``fields`` set to the host estimates, broadcast over
    the chain axis on the state's device."""
    C = state.Z.shape[0]

    def dev(f):
        t = torch.as_tensor(np.asarray(est[f]), dtype=state.Z.dtype,
                            device=state.Z.device)
        return t.expand((C,) + t.shape).contiguous()

    return state.replace(**{f: dev(f) for f in fields})


def _host(*objs):
    """Each of ``objs``, a tensor or a dict of tensors, as host NumPy
    arrays, copied in one span ``api.host_copy`` that counts their
    bytes."""
    with span("api.host_copy") as s:
        out = [{k: v.cpu().numpy() for k, v in o.items()}
               if isinstance(o, dict) else o.cpu().numpy() for o in objs]
        s.set(bytes=sum(a.nbytes for o in out
                        for a in (o.values() if isinstance(o, dict)
                                  else (o,))))
    return out


def _one_chain(state, i):
    return GibbsState(**{f: getattr(state, f)[i:i + 1]
                         for f in STATE_FIELDS})


def _run_restarts(generator, data, cfg, c, phase_fn, n_chains, n_iters,
                  select_window=100, init="random"):
    """Restart batch + best-chain selection (UserFunctions.cpp:302-325).

    init='spectral' seeds every restart from the moment-based archetypal
    initializer (utils/init_strategies.py) with per-chain jitter — a
    deterministic replacement for the reference's blind random restarts.
    """
    states = init_state(generator, cfg, data, chains=n_chains, c=c,
                        dtype=data.y.dtype)
    if init == "spectral":
        from bayesfmmm_torch.utils.init_strategies import spectral_ensemble
        states = spectral_ensemble(generator, states, data, cfg.K, cfg.M,
                                   z_jitter=0.02)
    res = phase_fn(generator, states)
    loglik, = _host(res.loglik)
    best = drivers.best_chain(loglik, window=min(select_window, n_iters))
    traces, = _host({k: v[best] for k, v in res.traces.items()})
    return FitResult(traces, loglik[best], _one_chain(res.final_state, best),
                     best)


@traced("api.fit_nu_z")
def fit_nu_z(Y=None, time=None, *, data=None, K, tot_mcmc_iters=1000,
             n_try=1, X=None, c=None, priors: Priors | None = None,
             family="functional", basis_degree=3, internal_knots=None,
             boundary_knots=None, basis_degrees=None,
             internal_knots_list=None, M=1, seed=0, init="random",
             device=None):
    """Phase 1 — find likely mean/allocation structure (multiple tries).

    Mirrors BFMMM_Nu_Z_multiple_try (UserFunctions.cpp:166) and its MV
    and HD variants; ``n_try + 1`` chains run at once, and the mean's
    covariate adjustment is on when X is given.  The data is built on
    ``device`` (the card when None) unless ``data`` is given.
    """
    validation.validate_fit_args(tot_mcmc_iters=tot_mcmc_iters, n_try=n_try,
                                 K=K, n_eigen=M)
    hp = (priors or Priors()).validate()
    validation.validate_c(hp.c_vector(K), K)
    if data is None:
        data = build_data(Y, time, family=family, basis_degree=basis_degree,
                          internal_knots=internal_knots,
                          boundary_knots=boundary_knots, X=X,
                          basis_degrees=basis_degrees,
                          internal_knots_list=internal_knots_list,
                          device=device)
    covm = data.D > 0
    cfg = ModelConfig(K=K, P=int(data.P), M=M, D=int(data.D),
                      family=data.family, covariate_mean=covm)
    c_vec = _c_tensor(hp, K, data)

    def phase(g, st):
        return drivers.phase_nu_z(g, st, data, hp, c_vec,
                                  n_iters=tot_mcmc_iters,
                                  covariate_mean=covm)

    res = _run_restarts(_generator(data, seed), data, cfg, c_vec, phase,
                        n_try + 1, tot_mcmc_iters, init=init)
    res.data = data
    res.config = cfg
    return res


@traced("api.fit_theta")
def fit_theta(nu_z_result: FitResult, *, tot_mcmc_iters=1000, n_try=1,
              M=None, covariate_cov=False, priors: Priors | None = None,
              burnin_prop=0.8, seed=1):
    """Phase 2 — covariance structure given pinned (Z, nu[, eta]) medians.

    Mirrors BFMMM_Theta_est (UserFunctions.cpp:684): point estimates are
    per-element posterior medians of the phase-1 chain with Z re-normalized;
    ``n_try`` chains run at once.
    """
    validation.validate_fit_args(tot_mcmc_iters=tot_mcmc_iters, n_try=n_try,
                                 burnin_prop=burnin_prop,
                                 n_eigen=M if M is not None else None)
    hp = (priors or Priors()).validate()
    data = nu_z_result.data
    cfg = nu_z_result.config
    new_M = M if M is not None else cfg.M
    covc = bool(covariate_cov) and cfg.D > 0
    if new_M != cfg.M or covc != cfg.covariate_cov:
        cfg = ModelConfig(K=cfg.K, P=cfg.P, M=new_M, D=cfg.D,
                          family=cfg.family,
                          covariate_mean=cfg.covariate_mean,
                          covariate_cov=covc)
    est = nu_z_result.estimates(burnin_prop, _warn=False)
    c_vec = _c_tensor(hp, cfg.K, data)

    def phase(g, st):
        # pin Z, nu (and eta) to the phase-1 medians (BFMMM.h:1244-1250)
        st = _pinned(st, est, ("Z", "nu", "eta", "pi", "alpha3", "tau"))
        return drivers.phase_theta(g, st, data, hp, c_vec,
                                   n_iters=tot_mcmc_iters,
                                   covariate_mean=cfg.covariate_mean,
                                   covariate_cov=cfg.covariate_cov)

    res = _run_restarts(_generator(data, seed), data, cfg, c_vec, phase,
                        n_try, tot_mcmc_iters)
    res.data = data
    res.config = cfg
    return res


def chunk_sizes(tot_mcmc_iters, thinning_num, progress_every):
    """Balanced chunk sizes in sweeps, each a multiple of ``thinning_num``
    and at most two distinct: ``progress_every`` sweeps a chunk, or as near
    below as splits the run evenly."""
    n_units = max(1, tot_mcmc_iters // thinning_num)
    per_chunk = max(1, progress_every // thinning_num)
    n_chunks = -(-n_units // per_chunk)
    base, extra = divmod(n_units, n_chunks)
    return ([(base + 1) * thinning_num] * extra
            + [base * thinning_num] * (n_chunks - extra))


_WARM_FROM_PHASE_1 = ("Z", "pi", "alpha3", "nu", "tau", "eta", "tau_eta")
_WARM_FROM_PHASE_2 = ("Phi", "gamma", "delta", "A", "sigma2", "chi", "xi",
                      "gamma_xi", "delta_xi", "A_xi")


@traced("api.fit_warm_start")
def fit_warm_start(nu_z_result: FitResult | None = None,
                   theta_result: FitResult | None = None, *,
                   tot_mcmc_iters=2000, thinning_num=1, burnin_prop=0.8,
                   n_temp_trans=0, beta_N_t=1.0, N_t=1, n_chains=1,
                   priors: Priors | None = None, directory=None,
                   r_stored_iters=None, seed=2, kernels="reference",
                   progress=True, progress_every=100,
                   resume_from=None, checkpoint_to=None, data=None):
    """Phase 3 — production sampler warm-started from phase-1/2 medians.

    Mirrors BFMMM_warm_start (UserFunctions.cpp:1341): per-element posterior
    medians of both phases seed every chain (:1557-1650), which then differ
    by their noise only; tempered-transition excursions run every
    n_temp_trans iterations; traces optionally export to `directory` using
    the reference's file contract.

    kernels: "reference" reproduces the reference kernel census exactly;
    "production" runs ``PRODUCTION_FLAGS`` (the collapsed (Z, chi) block,
    gauge moves, interweaves and Phi MALA of ops/gibbs.py) — same posterior.

    progress: True (the default, matching the reference's unconditional
    progress prints) or a ProgressStream prints rolling log-likelihood
    every ``progress_every`` iterations (BFMMM.h:870-875 analog); pass
    False for a silent run.  The run executes in ``progress_every``-sweep
    chunks either way; after each chunk its draws move to the host, so
    device memory holds one chunk's traces, and Ctrl-C lands at a chunk
    boundary (Rcpp::checkUserInterrupt analog, BFMMM.h:203).  The draws are
    a function of (seed or checkpoint, tot_mcmc_iters, thinning_num, the
    sampler's flags) and not of ``progress`` or ``progress_every``: the
    ensemble has one generator, whose stream knows nothing of chunks.

    Warm-ensemble protocol (beyond the reference, whose warm start is
    point-estimate-only, BFMMM.h:205-271): ``checkpoint_to`` saves the FULL
    final chain ensemble, the generator's state and the configuration with
    the exact-state checkpoint (io/checkpoint.py); ``resume_from``
    continues from such a checkpoint — n_chains, the chain states and the
    configuration come from the file, the phase-1/2 results are not needed
    (pass ``data`` instead when resuming in a fresh process), and the
    continuation is a deterministic function of the checkpoint alone: two
    resumes from the same file give the same bits, and a run split at a
    checkpoint gives the bits of the unbroken run, excursion schedule
    included.  ``seed`` serves a checkpoint that holds no generator state.
    """
    validation.validate_fit_args(tot_mcmc_iters=tot_mcmc_iters,
                                 burnin_prop=burnin_prop)
    validation.validate_warm_start_args(
        thinning_num=thinning_num, beta_N_t=beta_N_t, N_t=N_t,
        r_stored_iters=r_stored_iters, n_temp_trans=n_temp_trans,
        tot_mcmc_iters=tot_mcmc_iters, directory=directory)
    hp = (priors or Priors()).validate()
    resume = resume_from is not None
    if not resume and (nu_z_result is None or theta_result is None):
        raise ValueError("fit_warm_start needs (nu_z_result, theta_result) "
                         "unless resume_from is given")
    if kernels not in ("reference", "production"):
        raise ValueError("kernels must be 'reference' or 'production'")
    flags = PRODUCTION_FLAGS if kernels == "production" else {}
    batched = r_stored_iters is not None and directory is not None
    if resume and batched:
        raise ValueError("resume_from continues an ensemble; a batched run "
                         "resumes through samplers.batched.resume_batched")
    if resume:
        from bayesfmmm_torch.io.checkpoint import load_checkpoint
        if data is None:
            if theta_result is None:
                raise ValueError("resume_from in a fresh process needs "
                                 "data=...")
            data = theta_result.data
        states, generator, it0, cfg = load_checkpoint(
            resume_from, data.device, seed=seed, dtype=data.y.dtype)
        if cfg is None:
            # a file without a configuration says nothing of covariates,
            # and the shape of xi does not either
            cfg = ModelConfig(K=states.K, P=int(data.P), M=states.M,
                              D=int(data.D), family=data.family,
                              covariate_mean=int(data.D) > 0)
        n_chains = int(states.Z.shape[0])
    else:
        data = theta_result.data
        cfg = theta_result.config
        it0 = 0
        generator = _generator(data, seed)
        est1 = nu_z_result.estimates(burnin_prop, _warn=False)
        est2 = theta_result.estimates(burnin_prop, _warn=False)
    c_vec = _c_tensor(hp, cfg.K, data)

    def seed_state(st):
        return _pinned(_pinned(st, est1, _WARM_FROM_PHASE_1), est2,
                       _WARM_FROM_PHASE_2)

    if batched:
        # reference batch/ring persistence path (BFMMM.h:205-271) with the
        # async native writer overlapping IO and compute; one chain
        from bayesfmmm_torch.io import armaio
        from bayesfmmm_torch.samplers.batched import run_batched
        st0 = seed_state(init_state(generator, cfg, data, chains=1, c=c_vec,
                                    dtype=data.y.dtype))
        final, ll, _ = run_batched(
            generator, st0, data, hp, c_vec, directory=directory,
            tot_mcmc_iters=tot_mcmc_iters, r_stored_iters=r_stored_iters,
            config=cfg, thinning_num=thinning_num, n_temp_trans=n_temp_trans,
            beta_N_t=beta_N_t, N_t=N_t, progress=progress or None,
            covariate_mean=cfg.covariate_mean,
            covariate_cov=cfg.covariate_cov, **flags)
        disk = armaio.load_trace_dir(directory)
        stems = {stem: f for f, stem in _EXPORT_STEMS.items()}
        traces = {stems[k]: v for k, v in disk.items() if k in stems}
        res = FitResult(traces, ll, final)
        res.data = data
        res.config = cfg
        return res

    from bayesfmmm_torch.utils.observability import ProgressStream
    if hasattr(progress, "update"):
        stream = progress
    elif progress:
        stream = ProgressStream(every=1)
    else:
        stream = None
    if not resume:
        states = seed_state(init_state(generator, cfg, data,
                                       chains=n_chains, c=c_vec,
                                       dtype=data.y.dtype))

    done, t_parts, ll_parts, tt_parts = 0, [], [], []
    for n in chunk_sizes(tot_mcmc_iters, thinning_num, progress_every):
        res = drivers.phase_warm_start(
            generator, states, data, hp, c_vec, n_iters=n, thin=thinning_num,
            n_temp_trans=n_temp_trans, beta_N_t=beta_N_t, N_t=N_t,
            start_iter=it0 + done, covariate_mean=cfg.covariate_mean,
            covariate_cov=cfg.covariate_cov, **flags)
        states = res.final_state
        tt = () if res.tt_accept is None else (res.tt_accept,)
        ll, tr, *tt = _host(res.loglik, res.traces, *tt)
        ll_parts.append(ll)
        t_parts.append(tr)
        tt_parts += tt
        done += n
        if stream is not None:
            stream.update(done - 1, ll_parts[-1].mean(axis=0))
    loglik = np.concatenate(ll_parts, axis=1)
    best = drivers.best_chain(loglik, window=min(100, loglik.shape[1]))
    traces = {k: np.concatenate([p[k][best] for p in t_parts], axis=0)
              for k in t_parts[0]}
    if checkpoint_to is not None:
        from bayesfmmm_torch.io.checkpoint import save_checkpoint
        save_checkpoint(checkpoint_to, states, generator,
                        iteration=it0 + done, config=cfg)
    res = FitResult(traces, loglik[best], _one_chain(states, best), best)
    res.all_chain_loglik = loglik
    res.ensemble_state = states
    # (n_chains, n_excursions) bool: which chains accepted each excursion
    res.tt_accept = (np.concatenate(tt_parts, axis=1) if tt_parts
                     else np.zeros((n_chains, 0), dtype=bool))
    res.data = data
    res.config = cfg
    if directory is not None:
        export_traces(directory, res.traces, cfg)
    return res


def _census(kernels, cfg):
    """``sweep_full``'s flags for kernels="reference" or "production", with
    the configuration's covariate flags."""
    if kernels not in ("reference", "production"):
        raise ValueError("kernels must be 'reference' or 'production'")
    return dict(PRODUCTION_FLAGS if kernels == "production" else {},
                covariate_mean=cfg.covariate_mean,
                covariate_cov=cfg.covariate_cov)


def _seeded_state(est1, est2, chains, data):
    """``chains`` chains all at the phase-1/2 medians: every one of the 17
    fields comes from one of the two estimates."""
    host = {**{f: est1[f] for f in _WARM_FROM_PHASE_1},
            **{f: est2[f] for f in _WARM_FROM_PHASE_2}}

    def dev(f):
        t = torch.as_tensor(np.asarray(host[f]), dtype=data.y.dtype,
                            device=data.device)
        return t.expand((chains,) + t.shape).contiguous()

    return GibbsState(**{f: dev(f) for f in STATE_FIELDS})


@traced("api.fit_pt")
def fit_pt(nu_z_result: FitResult, theta_result: FitResult, *,
           tot_mcmc_iters=2000, n_replicas=8, beta_min=0.3,
           n_sweeps_between=1, burnin_prop=0.8,
           priors: Priors | None = None, directory=None, seed=2,
           kernels="reference", ladder="auto", pilot_sweeps=50,
           target_accept=0.4, max_replicas=64):
    """Phase-3 alternative: replica-exchange parallel tempering.

    Tempered replicas, all started at the phase-1/2 medians, run as the
    chain axis of one batched sweep on a temperature ladder and propose
    state swaps after every ``n_sweeps_between`` sweeps
    (parallel/tempering.py); ``tot_mcmc_iters`` rounds.  Returns a
    FitResult of the cold chain (one draw a round: ``traces``,
    ``loglik``, ``final_state``) with ``swap_rate`` and ``ladder``.  The
    device is the data's.

    ladder: "auto" (default) measures the energy sd over a pilot of
    ``pilot_sweeps`` sweeps of one chain at beta 1 (its second half) and
    sizes the rung spacing for ``target_accept`` swap acceptance
    (``auto_ladder``); when bridging to ``beta_min`` would take more than
    ``max_replicas`` rungs the ladder is clamped and a warning says so.
    "geometric" is the fixed ``n_replicas``-rung geometric ladder to
    ``beta_min`` (BFMMM.h:661-670 semantics; ``ladder`` is then None in
    the result, as in the JAX package).  Either way a swap rate under 0.05
    warns.  kernels: "reference" or "production" (``PRODUCTION_FLAGS``,
    MALA included, which the JAX package's gauge callers run)."""
    validation.validate_fit_args(tot_mcmc_iters=tot_mcmc_iters,
                                 burnin_prop=burnin_prop)
    flags = _census(kernels, theta_result.config)
    if ladder not in ("auto", "geometric"):
        raise ValueError("ladder must be 'auto' or 'geometric'")
    if n_replicas < 2:
        raise ValueError("'n_replicas' must be at least 2")
    if not (0.0 < beta_min <= 1.0):
        raise ValueError("'beta_min' must be in (0, 1]")
    from bayesfmmm_torch.models.likelihood import log_likelihood
    from bayesfmmm_torch.ops import gibbs
    from bayesfmmm_torch.parallel.tempering import (_loglik_portion,
                                                    auto_ladder,
                                                    run_parallel_tempering)

    hp = (priors or Priors()).validate()
    data = theta_result.data
    cfg = theta_result.config
    est1 = nu_z_result.estimates(burnin_prop, _warn=False)
    est2 = theta_result.estimates(burnin_prop, _warn=False)
    c_vec = _c_tensor(hp, cfg.K, data)
    generator = _generator(data, seed)

    ladder_t = None
    if ladder == "auto":
        # the pilot: the cold chain's energy sd the rung spacing must
        # resolve, read on the host once
        st, E = _seeded_state(est1, est2, 1, data), []
        for _ in range(pilot_sweeps):
            st = gibbs.sweep_full(generator, st, data, hp, c_vec, **flags)
            E.append(_loglik_portion(st, data))
        half = _host(torch.cat(E))[0][pilot_sweeps // 2:] if E else []
        # too short a pilot has no sd: auto_ladder refuses the NaN
        sd_E = float(np.std(half, ddof=1)) if len(half) > 1 \
            else float("nan")
        ladder_t, feasible = auto_ladder(
            sd_E, beta_min, target_accept=target_accept,
            max_replicas=max_replicas, dtype=data.y.dtype,
            device=data.device)
        n_replicas = int(ladder_t.shape[0])
        if not feasible:
            warnings.warn(
                f"fit_pt: measured energy sd {sd_E:.1f} needs "
                f"~{(1 - beta_min) * sd_E / 1.25:.0f} rungs to bridge to "
                f"beta_min={beta_min} at {target_accept:.0%} swap "
                f"acceptance, more than max_replicas={max_replicas}.  "
                f"Running a clamped ladder to beta="
                f"{float(ladder_t[-1]):.3f} instead; on large-n posteriors "
                f"PT buys little here (adjacent-rung energy overlap needs "
                f"dbeta ~ n^(-1/2); BENCH_SUITE.md section 4.1).",
                UserWarning, stacklevel=3)

    replicas = _seeded_state(est1, est2, n_replicas, data)
    cold, pt, swap_rate = run_parallel_tempering(
        generator, replicas, data, hp, c_vec, n_rounds=tot_mcmc_iters,
        beta_min=beta_min, n_sweeps_between=n_sweeps_between,
        ladder=ladder_t, **flags)
    loglik = log_likelihood(cold, data)          # one K2 launch
    swap_rate = float(swap_rate)
    if swap_rate < 0.05:
        warnings.warn(
            f"fit_pt: measured swap rate {swap_rate:.3f} < 0.05: the "
            f"replicas are effectively independent and the {n_replicas}x "
            f"cost buys no tempering benefit (the failure mode of fixed "
            f"ladders on large-n posteriors, BENCH_SUITE.md section 4.1).  "
            f"Use ladder='auto', reduce beta_min, or prefer fit_smc for "
            f"multimodality at scale.", UserWarning, stacklevel=3)
    traces, loglik = _host({f: getattr(cold, f) for f in STATE_FIELDS},
                           loglik)
    res = FitResult(traces, loglik, _one_chain(pt.states, 0))
    res.data = data
    res.config = cfg
    res.swap_rate = swap_rate
    res.ladder = _host(ladder_t)[0] if ladder_t is not None else None
    if directory is not None:
        export_traces(directory, traces, cfg)
    return res


@traced("api.fit_smc")
def fit_smc(Y=None, time=None, *, data=None, K, M=1, X=None,
            family="functional", n_particles=256, n_mutation_sweeps=2,
            target_cess=0.7, ess_threshold=0.5,
            priors: Priors | None = None, basis_degree=3,
            internal_knots=None, boundary_knots=None, basis_degrees=None,
            internal_knots_list=None, covariate_cov=False, seed=0,
            kernels="reference", device=None):
    """Adaptive tempered SMC fit: prior-to-posterior annealing with
    systematic resampling and tempered-Gibbs mutation (samplers/smc.py).

    No initializer is needed: the particle cloud starts at beta = 0 (the
    prior).  Returns the JAX package's dict: ``particles`` (a GibbsState
    on the device, one chain a particle), normalised ``weights``,
    ``log_evidence``, ``n_stages``, ``final_beta``, weighted posterior
    means ``estimates`` of every field, ``config`` and ``data``.  The data
    is built on ``device`` (the card when None) unless ``data`` is given;
    kernels as in ``fit_pt``."""
    validation.validate_fit_args(K=K, n_eigen=M)
    if n_particles < 2:
        raise ValueError("'n_particles' must be at least 2")
    if kernels not in ("reference", "production"):    # before any data
        raise ValueError("kernels must be 'reference' or 'production'")
    from bayesfmmm_torch.samplers.smc import run_smc

    hp = (priors or Priors()).validate()
    if data is None:
        data = build_data(Y, time, family=family, basis_degree=basis_degree,
                          internal_knots=internal_knots,
                          boundary_knots=boundary_knots, X=X,
                          basis_degrees=basis_degrees,
                          internal_knots_list=internal_knots_list,
                          device=device)
    cfg = ModelConfig(K=K, P=int(data.P), M=M, D=int(data.D),
                      family=data.family, covariate_mean=data.D > 0,
                      covariate_cov=covariate_cov and data.D > 0)
    c_vec = _c_tensor(hp, K, data)
    generator = _generator(data, seed)
    particles = init_state(generator, cfg, data, chains=n_particles, c=c_vec,
                           dtype=data.y.dtype)
    result = run_smc(generator, particles, data, hp, c_vec,
                     n_mutation_sweeps=n_mutation_sweeps,
                     target_cess=target_cess, ess_threshold=ess_threshold,
                     **_census(kernels, cfg))
    w, particles = _host(torch.softmax(result.log_weights, 0),
                         {f: getattr(result.particles, f)
                          for f in STATE_FIELDS})
    est = {f: np.tensordot(w, particles[f], axes=1) for f in STATE_FIELDS}
    return {"particles": result.particles, "weights": w,
            "log_evidence": float(result.log_evidence),
            "n_stages": int(result.n_stages),
            "final_beta": float(result.final_beta),
            "estimates": est, "config": cfg, "data": data}


def _on_device(data, device):
    """``data`` with every tensor on ``device``."""
    if data.device == device:
        return data
    return dataclasses.replace(data, **{
        f.name: getattr(data, f.name).to(device)
        for f in dataclasses.fields(data)
        if isinstance(getattr(data, f.name), torch.Tensor)})


@traced("api.fit_hmc")
def fit_hmc(data, *, K, M, covariate_cov=False, n_warmup=500, n_samples=500,
            n_chains=4, n_leapfrog=24, init="spectral", method="hmc",
            max_depth=8, priors: Priors | None = None, seed=0, device=None):
    """Whole-model HMC/NUTS on the unconstrained log-joint
    (models/logjoint.py, samplers/hmc.py, samplers/nuts.py).

    method: 'hmc' (jittered fixed-length trajectories) or 'nuts'
    (iterative No-U-Turn with ``max_depth``; adaptive trajectory length).
    init: 'spectral' (the archetypal warm start mapped through from_state,
    with per-chain jitter), 'random', or a GibbsState of one chain (or of
    ``n_chains``) to start every chain from.  The data goes to ``device``
    (the card when None).  With X and ``covariate_cov=False`` the xi tower
    stays at zero: the JAX package samples it (ROADMAP F13).

    Returns a FitResult whose traces are the post-warmup draws of the best
    chain (by mean log-likelihood over its last 100 draws), in natural
    parameterization, with ``hmc_diagnostics`` (per-chain arrays: the JAX
    package's, and each iteration's trajectory length ``n_steps`` or tree
    ``depth``) and ``all_chain_loglik`` (chains, samples): the
    post-processing layer takes it as it takes the Gibbs fits'.
    """
    from bayesfmmm_torch.models import logjoint
    from bayesfmmm_torch.models.likelihood import log_likelihood
    from bayesfmmm_torch.samplers import hmc as hmc_mod
    from bayesfmmm_torch.samplers import nuts as nuts_mod

    validation.validate_fit_args(K=K, n_eigen=M)
    hp = (priors or Priors()).validate()
    validation.validate_c(hp.c_vector(K), K)
    if method not in ("hmc", "nuts"):
        raise ValueError(f"unknown method {method!r}; use 'hmc' or 'nuts'")
    if isinstance(init, str) and init not in ("spectral", "random"):
        raise ValueError(f"unknown init {init!r}; use 'spectral', 'random' "
                         f"or a GibbsState")
    data = _on_device(data, default_device(device))
    covm = data.D > 0
    covc = covariate_cov and data.D > 0
    cfg = ModelConfig(K=K, P=int(data.P), M=M, D=int(data.D),
                      family=data.family, covariate_mean=covm,
                      covariate_cov=covc)
    dtype = data.y.dtype
    c_vec = _c_tensor(hp, K, data)
    generator = _generator(data, seed)
    lj = logjoint.make_log_joint(data, hp, c_vec)

    if init == "spectral":
        from bayesfmmm_torch.utils.init_strategies import spectral_init
        sp = {k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                 device=data.device)[None]
              for k, v in spectral_init(data, K, M).items()}
        base = init_state(generator, cfg, data, chains=1, dtype=dtype)
        base = base.replace(Z=sp["Z"].clamp(1e-4, 1 - 1e-4), nu=sp["nu"],
                            chi=sp["chi"], Phi=sp["Phi"] + 1e-3,
                            sigma2=sp["sigma2"].reshape(1))
        unc0 = logjoint.from_state(base)
        uncs = logjoint.UncState(**{
            f: t + 0.01 * torch.randn((n_chains,) + t.shape[1:],
                                      generator=generator, dtype=dtype,
                                      device=data.device)
            for f, t in vars(unc0).items()})
    elif init == "random":
        uncs = logjoint.init_unc(generator, cfg, data, n_chains, dtype=dtype)
    else:
        unc0 = logjoint.from_state(init)
        uncs = logjoint.UncState(**{
            f: t.to(data.device, dtype).expand((n_chains,) + t.shape[1:])
            .contiguous() for f, t in vars(unc0).items()})
    if not covc:
        # F13: the xi tower is no part of this model; it stays at xi = 0
        uncs = uncs.replace(**{f: torch.zeros_like(getattr(uncs, f))
                               for f in logjoint.XI_TOWER})
    like = logjoint.UncState(**{f: t[:1] for f, t in vars(uncs).items()})
    log_joint_flat = logjoint.FlatLogJoint(lj, like, covc)
    q0 = logjoint.flatten(uncs, covc)
    if method == "nuts":
        trace, diag = nuts_mod.run_nuts(
            generator, log_joint_flat, q0, n_warmup=n_warmup,
            n_samples=n_samples, max_depth=max_depth)
    else:
        trace, diag = hmc_mod.run_hmc(
            generator, log_joint_flat, q0, n_warmup=n_warmup,
            n_samples=n_samples, n_leapfrog=n_leapfrog)

    def states(q):
        return logjoint.to_state(logjoint.unflatten(q, like, covc))

    with torch.no_grad():
        ll, = _host(log_likelihood(
            states(trace.reshape(n_chains * n_samples, -1)),
            data).reshape(n_chains, n_samples))
        best = drivers.best_chain(ll, window=min(100, n_samples))
        drawn = states(trace[best])
        traces, diagnostics = _host(
            {f: getattr(drawn, f) for f in STATE_FIELDS}, diag)
        final = states(trace[best, -1:])
    res = FitResult(traces, ll[best], final, best)
    res.data = data
    res.config = cfg
    res.hmc_diagnostics = diagnostics
    res.all_chain_loglik = ll
    return res


@traced("api.fit_advi_init")
def fit_advi_init(data, *, K, M, covariate_cov=False, warm_iters=2000,
                  advi_steps=600, advi_lr=0.03, n_chains=4, thinning_num=1,
                  n_temp_trans=0, beta_N_t=1.0, N_t=1,
                  priors: Priors | None = None, directory=None, seed=0,
                  device=None):
    """ADVI-initialized production sampler: the fast alternative to the
    three-phase restart pipeline (ADVI takes the role of the Nu_Z -> Theta
    warm-start search).

    Runs mean-field ADVI on the whole-model unconstrained log-joint
    (samplers/advi.py), then ``n_chains`` chains of ``phase_warm_start`` in
    the reference census from draws of q, as one batch.  The data goes to
    ``device`` (the card when None).  With X and ``covariate_cov=False`` the
    xi tower stays at zero, in q and in every sweep: the JAX package moves
    it in q and then never again (ROADMAP F14).  The result carries
    ``elbo_trace`` and ``all_chain_loglik`` besides the best chain's traces.
    """
    from bayesfmmm_torch.models import logjoint
    from bayesfmmm_torch.samplers import advi as advi_mod

    validation.validate_fit_args(tot_mcmc_iters=warm_iters, K=K, n_eigen=M)
    validation.validate_warm_start_args(
        thinning_num=thinning_num, beta_N_t=beta_N_t, N_t=N_t,
        n_temp_trans=n_temp_trans)
    hp = (priors or Priors()).validate()
    validation.validate_c(hp.c_vector(K), K)
    data = _on_device(data, default_device(device))
    covm = data.D > 0
    covc = covariate_cov and data.D > 0
    cfg = ModelConfig(K=K, P=int(data.P), M=M, D=int(data.D),
                      family=data.family, covariate_mean=covm,
                      covariate_cov=covc)
    c_vec = _c_tensor(hp, K, data)
    generator = _generator(data, seed)
    lj = logjoint.make_log_joint(data, hp, c_vec)
    # init_unc holds the xi tower at xi = 0 (gamma_xi, delta_xi, A_xi = 1)
    unc0 = logjoint.init_unc(generator, cfg, data, 1, dtype=data.y.dtype)
    res = advi_mod.run_advi(generator, lj, unc0, n_steps=advi_steps,
                            learning_rate=advi_lr, covariate_cov=covc)
    with torch.no_grad():
        states = logjoint.to_state(advi_mod.sample_from_advi(
            generator, res, n_samples=n_chains))
    states = GibbsState(**{f: getattr(states, f).contiguous()
                           for f in STATE_FIELDS})
    out = drivers.phase_warm_start(
        generator, states, data, hp, c_vec, n_iters=warm_iters,
        thin=thinning_num, n_temp_trans=n_temp_trans, beta_N_t=beta_N_t,
        N_t=N_t, covariate_mean=covm, covariate_cov=covc)
    loglik, = _host(out.loglik)
    best = drivers.best_chain(loglik, window=min(100, warm_iters))
    traces, elbo = _host({k: v[best] for k, v in out.traces.items()},
                         res.elbo_trace)
    result = FitResult(traces, loglik[best], _one_chain(out.final_state, best),
                       best)
    result.data = data
    result.config = cfg
    result.elbo_trace = elbo
    result.all_chain_loglik = loglik
    if directory is not None:
        export_traces(directory, result.traces, cfg)
    return result


# trace field -> reference file stem (BFMMM.h:1720-1730)
_EXPORT_STEMS = {
    "nu": "Nu", "chi": "Chi", "pi": "Pi", "alpha3": "alpha_3", "A": "A",
    "delta": "Delta", "sigma2": "Sigma", "tau": "Tau", "gamma": "Gamma",
    "Phi": "Phi", "Z": "Z", "eta": "Eta", "tau_eta": "Tau_Eta", "xi": "Xi",
    "gamma_xi": "Gamma_Xi", "delta_xi": "Delta_Xi", "A_xi": "A_Xi",
}
_COV_MEAN_FIELDS = ("eta", "tau_eta")
_COV_COV_FIELDS = ("xi", "gamma_xi", "delta_xi", "A_xi")


def export_layout(traces, cfg):
    """One chain's traces keyed by the reference's file stems, the
    covariate files only where the configuration has them.

    For the multivariate family the stored Tau is the variance (reciprocal
    of the internal precision scale; UpdateTau.h:58)."""
    out = {}
    for f, stem in _EXPORT_STEMS.items():
        if f in _COV_MEAN_FIELDS and not (cfg.covariate_mean and cfg.D > 0):
            continue
        if f in _COV_COV_FIELDS and not (cfg.covariate_cov and cfg.D > 0):
            continue
        arr = np.asarray(traces[f])
        if f in ("tau", "tau_eta") and cfg.family == "multivariate":
            arr = 1.0 / arr
        out[stem] = arr
    return out


def export_traces(directory, traces, cfg, batch=0):
    """Write traces with the reference file contract (BFMMM.h:1720-1730)."""
    from bayesfmmm_torch.io import armaio
    armaio.save_trace_dir(directory, export_layout(traces, cfg), batch=batch)


# extra fit() kwargs, routed to the phase that consumes them; anything not
# listed raises immediately instead of being silently swallowed
_FIT_PHASE1_KW = frozenset({"basis_degree", "internal_knots",
                            "boundary_knots", "basis_degrees",
                            "internal_knots_list", "init", "device"})
_FIT_PHASE2_KW = frozenset({"burnin_prop"})
_FIT_PHASE3_KW = frozenset({"thinning_num", "n_temp_trans", "beta_N_t",
                            "N_t", "n_chains", "r_stored_iters",
                            "burnin_prop", "kernels", "progress",
                            "progress_every", "checkpoint_to"})


def fit(Y=None, time=None, *, K, M, data=None, X=None, family="functional",
        nu_z_iters=1000, theta_iters=1000, warm_iters=2000, n_try=1,
        covariate_cov=False, priors=None, directory=None, seed=0, **kw):
    """Convenience wrapper running the full 3-phase pipeline.

    Extra keyword arguments are routed to the phase that accepts them
    (basis/init/device args -> fit_nu_z; burnin_prop -> fit_theta and
    fit_warm_start; thinning/tempering/storage/checkpoint args ->
    fit_warm_start); unknown names raise TypeError up front rather than
    passing silently.
    """
    unknown = set(kw) - _FIT_PHASE1_KW - _FIT_PHASE2_KW - _FIT_PHASE3_KW
    if unknown:
        raise TypeError(f"fit() got unexpected keyword arguments: "
                        f"{sorted(unknown)}")
    kw1 = {k: v for k, v in kw.items() if k in _FIT_PHASE1_KW}
    kw2 = {k: v for k, v in kw.items() if k in _FIT_PHASE2_KW}
    kw3 = {k: v for k, v in kw.items() if k in _FIT_PHASE3_KW}
    r1 = fit_nu_z(Y, time, data=data, K=K, M=M, X=X, family=family,
                  tot_mcmc_iters=nu_z_iters, n_try=n_try, priors=priors,
                  seed=seed, **kw1)
    r2 = fit_theta(r1, tot_mcmc_iters=theta_iters, n_try=max(n_try, 1),
                   covariate_cov=covariate_cov, priors=priors, seed=seed + 1,
                   **kw2)
    return fit_warm_start(r1, r2, tot_mcmc_iters=warm_iters, priors=priors,
                          directory=directory, seed=seed + 2, **kw3)
