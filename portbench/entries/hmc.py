"""``api.fit_hmc`` called again and again, each call a whole fit.

Set-up builds the data with ``api.build_data`` from the raw curves and
makes one call of the cell's size, which warms up every shape.  Each
timed call is a fit with its own seed.  The work of a call is its useful
gradient evaluations: the sum over chains and iterations of each chain's
own trajectory length (``hmc_diagnostics["n_steps"]``); the steps a
chain runs masked past its length do not count.
"""

from __future__ import annotations

import numpy as np

from portbench.entries.common import program_data

RATE_METRIC = "grad_evals_per_s"
FIELDS = ("Z", "nu", "Phi", "chi", "eta", "xi", "sigma2")


class Entry:
    def __init__(self, cell, config, raw, seed, device, workdir):
        from bayesfmmm_torch import api
        self.api = api
        self.cell, self.config, self.raw = cell, config, raw
        self.seed, self.device = seed, device
        self.n_calls = 0
        self.calls = []

    def _fit(self):
        c, cfg = self.cell, self.config
        self.n_calls += 1
        return self.api.fit_hmc(
            self.data, K=cfg["K"], M=cfg["M"],
            covariate_cov=cfg["covariate_cov"], method="hmc",
            n_leapfrog=c["n_leapfrog"], n_chains=c["chains"],
            init=c["init"], n_warmup=c["n_warmup"],
            n_samples=c["n_samples"], seed=self.seed + self.n_calls,
            device=self.device)

    def setup(self):
        self.data = program_data(self.api, self.raw, self.device)
        self._fit()

    def call(self):
        """One timed fit; returns its work and sizes."""
        res = self._fit()
        steps = np.asarray(res.hmc_diagnostics["n_steps"])      # (C, iters)
        self.calls.append((res.all_chain_loglik, res.loglik, res.traces))
        return {"work": int(steps.sum()), "grad_evals": int(steps.sum()),
                "leapfrog_steps": int(steps.max(axis=0).sum()),
                "iterations": int(steps.shape[1]),
                "samples": int(res.all_chain_loglik.size)}

    def answers(self):
        """Every chain's loglik trace, and the best chain's draws and loglik
        trace (``fit_hmc`` returns no other chain's draws)."""
        out = [{"loglik_all": np.asarray(ll_all), "final": None,
                "best_loglik": np.asarray(best_ll),
                "best_draws": {f: np.asarray(traces[f]) for f in FIELDS}}
               for ll_all, best_ll, traces in self.calls]
        self.calls = []
        return out

    def free(self):
        self.calls = []
        self.data = None
