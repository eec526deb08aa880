"""``api.fit_warm_start`` over an ensemble, resumed call after call.

Set-up builds the data with ``api.build_data`` from the raw curves, runs
short phase-1 and phase-2 fits (``api.fit_nu_z``, ``api.fit_theta``) and
the first ``fit_warm_start`` from their medians, which checkpoints the
ensemble; it is also the warm-up, since it runs every shape the window
does.  Each timed call resumes from the checkpoint and writes it again,
as a user continues a fit.  The work of a call is chains x sweeps.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.entries.common import program_data

RATE_METRIC = "chain_sweeps_per_s"
FIELDS = ("Z", "nu", "Phi", "chi", "eta", "xi", "sigma2")
STATE = ("Z", "pi", "alpha3", "nu", "tau", "sigma2", "chi", "Phi", "gamma",
         "delta", "A", "eta", "tau_eta", "xi", "gamma_xi", "delta_xi",
         "A_xi")


class Entry:
    def __init__(self, cell, config, raw, seed, device, workdir):
        from bayesfmmm_torch import api
        self.api = api
        self.cell, self.config, self.raw = cell, config, raw
        self.seed, self.device = seed, device
        self.ckpt = os.path.join(workdir, "ensemble.npz")
        self.calls = []

    def _flags(self):
        c = self.cell
        return dict(tot_mcmc_iters=c["call_sweeps"], kernels=c["kernels"],
                    checkpoint_to=self.ckpt, progress=False)

    def setup(self):
        api, cfg, s = self.api, self.config, self.cell["setup"]
        self.data = program_data(api, self.raw, self.device)
        r1 = api.fit_nu_z(data=self.data, K=cfg["K"], M=cfg["M"],
                          tot_mcmc_iters=s["nu_z_iters"], n_try=s["n_try"],
                          init=s["init"], seed=self.seed)
        r2 = api.fit_theta(r1, tot_mcmc_iters=s["theta_iters"],
                           n_try=s["n_try"],
                           covariate_cov=cfg["covariate_cov"],
                           seed=self.seed + 1)
        res = api.fit_warm_start(r1, r2, n_chains=self.cell["chains"],
                                 seed=self.seed + 2, **self._flags())
        self.start = res.ensemble_state

    def call(self):
        """One timed call; returns its work and sizes."""
        res = self.api.fit_warm_start(resume_from=self.ckpt, data=self.data,
                                      **self._flags())
        C, n = res.all_chain_loglik.shape
        # the device tensors are read after the window closes
        self.calls.append((res.all_chain_loglik, res.loglik,
                           res.traces, self.start, res.ensemble_state))
        self.start = res.ensemble_state
        return {"work": C * n, "sweeps": n, "chain_sweeps": C * n}

    def answers(self):
        """What each call returned, on the host: every chain's loglik trace,
        state at the start and final state, and the best chain's draws and
        loglik trace."""
        out = []
        for ll_all, best_ll, traces, start, final in self.calls:
            out.append({
                "loglik_all": np.asarray(ll_all),
                "start": {f: getattr(start, f).cpu().numpy() for f in FIELDS},
                "final": {f: getattr(final, f).cpu().numpy() for f in STATE},
                "best_loglik": np.asarray(best_ll),
                "best_draws": {f: np.asarray(traces[f]) for f in FIELDS}})
        self.calls = []
        return out

    def free(self):
        self.calls = []
        self.data = self.start = None
