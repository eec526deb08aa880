"""Generate tests/data/torch_fit_reference.json: the JAX package's result for
the three-phase fit protocol that chip_smoke.py drives through the PyTorch
port's ``api.fit``.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocol (the bench's headline model, bench.py:115-117):

  * data: simulate_functional(seed=7, N=100, K=3, P=8, M=4,
    n_time=(100, 100));
  * phase 1: fit_nu_z, init="spectral", n_try=7 (8 chains), 300 sweeps;
  * phase 2: fit_theta, n_try=7 (7 chains), 300 sweeps;
  * phase 3: fit_warm_start, kernels="production", 400 sweeps, tempered
    transitions every 100 sweeps with N_t=3, beta_N_t=0.5.

The ensemble is far from stationary after 400 sweeps (its loglik still
climbs), so where it stands then depends on the medians phases 1 and 2
handed it, and those on which restart chain won: two runs of the protocol
differ by more than one run's chains differ among themselves.  This script
therefore runs the protocol on the CPU under 5 fit seeds, 64 chains in
phase 3 each, and records every seed's ensemble median and spread of the
final loglik and sigma2, with the limits chip_smoke.py applies to the port's
ensemble medians:

    mean_s(median_s) +- 5 * sqrt(sd_s(median_s)^2 + se^2),
    se = mean_s(1.2533 * IQR_s / 1.349) * sqrt(1/64 + 1/C_port)

i.e. 5 standard deviations of one run's ensemble median: the spread between
seeds (sample sd of the 5 medians) combined with the standard error of two
sample medians of make_torch_slice_reference.py's rule.

The JAX package restarts its iteration count in every progress chunk, so
phase 3 runs here as ONE chunk (progress_every = the run's length): the
excursions then fall at sweeps 100, 200 and 300, as in the port, whose
schedule counts from the start of the run whatever the chunks.  The
ensemble comes back through ``checkpoint_to``.  Run (about ten minutes):

    JAX_PLATFORMS=cpu python tests/data/make_torch_fit_reference.py
"""

import json
import os
import sys
import tempfile
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, HERE)

from bayesfmmm_tpu import api  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from make_torch_slice_reference import summary  # noqa: E402

PROTOCOL = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100],
                init="spectral", n_try=7, nu_z_iters=300, theta_iters=300,
                warm_iters=400, kernels="production", n_temp_trans=100,
                N_t=3, beta_N_t=0.5, fit_seed=0)
SEEDS = (0, 1, 2, 3, 4)         # the first is the one chip_smoke.py runs
CHAINS = 64
PORT_CHAINS = 256
OUT = os.path.join(HERE, "torch_fit_reference.json")


def run_seed(data, seed):
    """The protocol under one fit seed; returns what the reference keeps."""
    p = PROTOCOL
    r1 = api.fit_nu_z(data=data, K=p["K"], M=p["M"], n_try=p["n_try"],
                      tot_mcmc_iters=p["nu_z_iters"], init=p["init"],
                      seed=seed)
    r2 = api.fit_theta(r1, tot_mcmc_iters=p["theta_iters"], n_try=p["n_try"],
                       seed=seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        r3 = api.fit_warm_start(
            r1, r2, tot_mcmc_iters=p["warm_iters"], n_chains=CHAINS,
            kernels=p["kernels"], n_temp_trans=p["n_temp_trans"],
            N_t=p["N_t"], beta_N_t=p["beta_N_t"], progress=False,
            progress_every=p["warm_iters"], seed=seed + 2,
            checkpoint_to=os.path.join(tmp, "ensemble.npz"))
    for leaf in jax.tree.leaves(r3.ensemble_state):
        assert np.all(np.isfinite(np.asarray(leaf)))
    return {
        "fit_seed": seed,
        "best_chain_loglik_last_100": {
            "nu_z": float(np.mean(r1.loglik[-100:])),
            "theta": float(np.mean(r2.loglik[-100:])),
            "warm_start": float(np.mean(r3.loglik[-100:]))},
        "loglik_first_draw_median": float(
            np.median(r3.all_chain_loglik[:, 0])),
        "loglik": summary(r3.all_chain_loglik[:, -1], PORT_CHAINS),
        "sigma2": summary(r3.ensemble_state.sigma2, PORT_CHAINS)}


def across_seeds(runs, stat):
    """Limits for one run's ensemble median of ``stat``, from all seeds."""
    med = np.array([r[stat]["median"] for r in runs])
    se = np.mean([1.2533 * (r[stat]["q75"] - r[stat]["q25"]) / 1.349
                  for r in runs]) * np.sqrt(1.0 / CHAINS + 1.0 / PORT_CHAINS)
    half = 5.0 * np.sqrt(med.std(ddof=1) ** 2 + se ** 2)
    return {"median": float(med.mean()), "medians": med.tolist(),
            "sd_between_seeds": float(med.std(ddof=1)), "se": float(se),
            "limits": [float(med.mean() - half), float(med.mean() + half)]}


def main():
    p = PROTOCOL
    assert SEEDS[0] == p["fit_seed"]
    data, _ = simulate_functional(seed=p["seed"], N=p["N"], K=p["K"],
                                  P=p["P"], M=p["M"],
                                  n_time=tuple(p["n_time"]))
    t0 = time.time()
    runs = [run_seed(data, seed) for seed in SEEDS]
    ref = {
        "protocol": p,
        "seeds": list(SEEDS),
        "chains": CHAINS,
        "port_chains": PORT_CHAINS,
        "limit_rule": "mean of the seeds' medians +- 5 * sqrt(sd between "
                      "seeds^2 + se^2), se = mean of 1.2533 * (q75 - q25) / "
                      "1.349 * sqrt(1/chains + 1/port_chains)",
        "best_chain_loglik_last_100": runs[0]["best_chain_loglik_last_100"],
        "loglik": across_seeds(runs, "loglik"),
        "sigma2": across_seeds(runs, "sigma2"),
        "runs": runs,
        "jax_version": jax.__version__,
        "cpu_seconds": round(time.time() - t0, 1),
    }
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=1, default=float)
        f.write("\n")
    print(json.dumps(ref, indent=1, default=float))


if __name__ == "__main__":
    main()
