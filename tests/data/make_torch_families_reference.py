"""Generate tests/data/torch_families_reference.json: the JAX package's
results for the protocols that chip_smoke.py drives through the PyTorch port
on four of the repo's own configurations (benchmarks/suite.py:27-78, data
seed 7), and on config 4's model at two covariates: the covariate-adjusted
models and the multivariate and hd families.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocols (``PROTOCOLS`` below has every number):

  * config 4, CovAdjCov_xi_fullM (functional, K=2, P=8, M=16, N=80, D=1, eta
    and xi): fit_nu_z and fit_theta(covariate_cov=True) from the spectral
    init with n_try restarts, then two phase-3 ensembles from the same
    medians: the reference census, and the production census with one
    tempered excursion;
  * config4_D2, CovAdjCov_xi_fullM_D2: config 4's model and protocol at D=2
    covariates (config 3's D), whose joint xi draw has K*M*D*P = 512
    dimensions;
  * config 3, CovAdjMean_eta_D2_K3 (functional, K=3, P=8, M=3, N=100, D=2,
    eta): every chain from the spectral init (eta = 0), then
    sweep_full(covariate_mean=True), the first sweeps annealed, as in
    make_torch_slice_reference.py;
  * config 1, BMVMMM_K2 (multivariate, K=2, P=10, M=3, N=200) and config 5,
    BHDFMMM_2D_K4_manychain (hd, K=4, P=16, M=4, 64 surfaces on a 12 x 12
    grid, degrees [2, 2], one inner knot a side): api.fit, production census.

A fit's ensemble still climbs when these short runs end, and where it stands
depends on which restart chain won phases 1 and 2, so each fit protocol runs
under several fit seeds and its limits are those of
make_torch_fit_reference.py:

    mean_s(median_s) +- 5 * sqrt(sd_s(median_s)^2 + se^2),
    se = mean_s(1.2533 * IQR_s / 1.349) * sqrt(1/chains + 1/port_chains).

Config 3 starts every chain at one point, so one run and
make_torch_slice_reference.py's rule serve.  Phase 3 runs as one chunk (the
JAX package restarts its iteration count in every chunk, so an excursion
would never run otherwise).  Run one configuration or all (tens of minutes
on the CPU; results of configurations not named are kept):

    JAX_PLATFORMS=cpu python tests/data/make_torch_families_reference.py [4 4_D2 3 1 5]
"""

import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, HERE)

from bayesfmmm_tpu import api  # noqa: E402
from bayesfmmm_tpu.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_tpu.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_tpu.models.state import (init_state,  # noqa: E402
                                        make_hd_functional_data)
from bayesfmmm_tpu.ops import gibbs  # noqa: E402
from bayesfmmm_tpu.utils.init_strategies import spectral_init  # noqa: E402
from bayesfmmm_tpu.utils.simulate import (_numpy_mu,  # noqa: E402
                                          _truth_state, simulate_functional,
                                          simulate_multivariate)
from make_torch_slice_reference import betas, summary  # noqa: E402

OUT = os.path.join(HERE, "torch_families_reference.json")

# ``chains``: the JAX ensemble here; ``port_chains``: the port's on the card.
PROTOCOLS = {
    "config4": dict(
        name="CovAdjCov_xi_fullM", family="functional", seed=7, N=80, K=2,
        P=8, M=16, D=1, n_time=[100, 100], with_eta=True, with_xi=True,
        init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        fit_seeds=[0, 1, 2],
        reference=dict(kernels="reference", warm_iters=100, chains=16,
                       port_chains=16),
        production=dict(kernels="production", warm_iters=200, chains=16,
                        port_chains=256, n_temp_trans=100, N_t=2,
                        beta_N_t=0.7)),
    # config 4's model at two covariates: the joint xi draw at
    # K*M*D*P = 512 dimensions, above the blocked K1 kernel's 336
    "config4_D2": dict(
        name="CovAdjCov_xi_fullM_D2", family="functional", seed=7, N=80, K=2,
        P=8, M=16, D=2, n_time=[100, 100], with_eta=True, with_xi=True,
        init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        fit_seeds=[0, 1, 2],
        reference=dict(kernels="reference", warm_iters=100, chains=16,
                       port_chains=16),
        production=dict(kernels="production", warm_iters=200, chains=16,
                        port_chains=256, n_temp_trans=100, N_t=2,
                        beta_N_t=0.7)),
    "config3": dict(
        name="CovAdjMean_eta_D2_K3", family="functional", seed=7, N=100, K=3,
        P=8, M=3, D=2, n_time=[100, 100], with_eta=True, sweeps=300,
        anneal=100, beta0=0.1, z_jitter=0.02, chains=64, port_chains=8),
    "config1": dict(
        name="BMVMMM_K2", family="multivariate", seed=7, N=200, K=2, P=10,
        M=3, init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        warm_iters=200, kernels="production", fit_seeds=[0, 1, 2],
        chains=16, port_chains=4),
    "config5": dict(
        name="BHDFMMM_2D_K4_manychain", family="hd", seed=7, N=64, K=4, M=4,
        grid=12, basis_degrees=[2, 2], n_internal=[1, 1], sigma2=0.01,
        init="spectral", n_try=3, nu_z_iters=200, theta_iters=200,
        warm_iters=100, kernels="production", fit_seeds=[0, 1, 2],
        chains=16, port_chains=64),
}


def grid_points(n):
    g = np.linspace(0, 1, n)
    return np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)


def hd_grid_data(p):
    """simulate_hd_functional's draws with every surface seen on one grid
    (the suite's config 5 observes a 12 x 12 grid): the simulator draws its
    points first, so it is restated here without them."""
    rng = np.random.default_rng(p["seed"])
    internal = [np.linspace(0, 1, n + 2)[1:-1] for n in p["n_internal"]]
    boundary = np.tile(np.array([0.0, 1.0]), (2, 1))
    t_list = [grid_points(p["grid"]) for _ in range(p["N"])]
    kw = dict(basis_degrees=p["basis_degrees"], internal_knots_list=internal,
              boundary_knots=boundary)
    data0 = make_hd_functional_data(
        [np.zeros(t.shape[0]) for t in t_list], t_list, **kw)
    truth = _truth_state(rng, p["N"], p["K"], int(data0.P), p["M"], 0,
                         jnp.float32, sigma2=p["sigma2"])
    mu = _numpy_mu(data0, truth)
    mask = np.asarray(data0.mask)
    y = mu + np.sqrt(p["sigma2"]) * rng.normal(size=mu.shape) * mask
    return make_hd_functional_data([y[i] for i in range(p["N"])], t_list,
                                   **kw)


def build(p):
    if p["family"] == "multivariate":
        return simulate_multivariate(seed=p["seed"], N=p["N"], K=p["K"],
                                     P=p["P"], M=p["M"])[0]
    if p["family"] == "hd":
        return hd_grid_data(p)
    return simulate_functional(
        seed=p["seed"], N=p["N"], K=p["K"], P=p["P"], M=p["M"], D=p["D"],
        n_time=tuple(p["n_time"]), with_eta=p.get("with_eta", False),
        with_xi=p.get("with_xi", False))[0]


def warm(r1, r2, w, seed):
    """One phase-3 ensemble of the JAX package under the settings ``w``."""
    with tempfile.TemporaryDirectory() as tmp:
        r3 = api.fit_warm_start(
            r1, r2, tot_mcmc_iters=w["warm_iters"], n_chains=w["chains"],
            kernels=w["kernels"], n_temp_trans=w.get("n_temp_trans", 0),
            N_t=w.get("N_t", 1), beta_N_t=w.get("beta_N_t", 1.0),
            progress=False, progress_every=w["warm_iters"], seed=seed,
            checkpoint_to=os.path.join(tmp, "ensemble.npz"))
    for leaf in jax.tree.leaves(r3.ensemble_state):
        assert np.all(np.isfinite(np.asarray(leaf)))
    return {"loglik": summary(r3.all_chain_loglik[:, -1], w["port_chains"]),
            "sigma2": summary(r3.ensemble_state.sigma2, w["port_chains"])}


def fit_seed_run(p, data, seed, ensembles):
    r1 = api.fit_nu_z(data=data, K=p["K"], M=p["M"], n_try=p["n_try"],
                      tot_mcmc_iters=p["nu_z_iters"], init=p["init"],
                      seed=seed)
    r2 = api.fit_theta(r1, tot_mcmc_iters=p["theta_iters"],
                       n_try=p["n_try"], seed=seed + 1,
                       covariate_cov=p.get("with_xi", False))
    out = {"fit_seed": seed,
           "best_chain_loglik_last_100": {
               "nu_z": float(np.mean(r1.loglik[-100:])),
               "theta": float(np.mean(r2.loglik[-100:]))}}
    for name, w in ensembles.items():
        out[name] = warm(r1, r2, w, seed + 2)
    return out


def run_fit(p):
    """A fit protocol under every fit seed; limits across the seeds for
    each of its phase-3 ensembles."""
    data = build(p)
    ensembles = ({k: p[k] for k in ("reference", "production")}
                 if "reference" in p else {"ensemble": p})
    runs = [fit_seed_run(p, data, s, ensembles) for s in p["fit_seeds"]]
    out = {"runs": runs}
    for name, w in ensembles.items():
        def one(stat):
            med = np.array([r[name][stat]["median"] for r in runs])
            se = np.mean([1.2533 * (r[name][stat]["q75"]
                                    - r[name][stat]["q25"]) / 1.349
                          for r in runs]) * np.sqrt(
                1.0 / w["chains"] + 1.0 / w["port_chains"])
            half = 5.0 * np.sqrt(med.std(ddof=1) ** 2 + se ** 2)
            return {"median": float(med.mean()), "medians": med.tolist(),
                    "sd_between_seeds": float(med.std(ddof=1)),
                    "se": float(se), "limits": [float(med.mean() - half),
                                                float(med.mean() + half)]}
        out[name] = {"loglik": one("loglik"), "sigma2": one("sigma2")}
    return out


def run_sweeps(p):
    """Config 3: the annealed sweep_full(covariate_mean=True) from the
    spectral init, as make_torch_slice_reference.py runs the slice."""
    K, P, M, D = p["K"], p["P"], p["M"], p["D"]
    data = build(p)
    hp = Priors()
    cfg = ModelConfig(K=K, P=P, M=M, D=D, covariate_mean=True)
    c = jnp.full((K,), 10.0)
    keys = jax.random.split(jax.random.PRNGKey(0), p["chains"])
    sp = {k: jnp.asarray(v, jnp.float32)
          for k, v in spectral_init(data, K, M).items()}

    def init(k):
        st = init_state(k, cfg, data)
        Z0 = jnp.clip(sp["Z"] + p["z_jitter"]
                      * jax.random.normal(k, sp["Z"].shape), 1e-4, None)
        return st.replace(Z=Z0 / Z0.sum(1, keepdims=True), nu=sp["nu"],
                          chi=sp["chi"], Phi=sp["Phi"], sigma2=sp["sigma2"])

    def run(k, st):
        def body(s, inp):
            kk, b = inp
            return gibbs.sweep_full(kk, s, data, hp, c, beta=b,
                                    covariate_mean=True), None
        st, _ = jax.lax.scan(body, st, (jax.random.split(k, p["sweeps"]),
                                        jnp.asarray(betas(p))))
        return st

    states = jax.jit(jax.vmap(init))(keys)
    final = jax.jit(jax.vmap(run))(
        jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys), states)
    ll = jax.jit(jax.vmap(lambda s: log_likelihood(s, data)))(final)
    for leaf in jax.tree.leaves(final):
        assert np.all(np.isfinite(np.asarray(leaf)))
    return {"ensemble": {"loglik": summary(ll, p["port_chains"]),
                         "sigma2": summary(final.sigma2, p["port_chains"])}}


def main(which):
    ref = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            ref = json.load(f)
    for name in which:
        p = PROTOCOLS[name]
        t0 = time.time()
        res = run_fit(p) if "fit_seeds" in p else run_sweeps(p)
        ref[name] = {"protocol": p, **res,
                     "cpu_seconds": round(time.time() - t0, 1)}
        ref["jax_version"] = jax.__version__
        ref["limit_rule"] = (
            "fits: mean of the seeds' medians +- 5 * sqrt(sd between seeds^2 "
            "+ se^2), se = mean of 1.2533 * (q75 - q25) / 1.349 * "
            "sqrt(1/chains + 1/port_chains); config3: median +- 5 * se")
        with open(OUT, "w") as f:
            json.dump(ref, f, indent=1, default=float)
            f.write("\n")
        print(name, json.dumps({k: v for k, v in ref[name].items()
                                if k != "runs"}, indent=1, default=float))


if __name__ == "__main__":
    main([f"config{a}" for a in sys.argv[1:]] or list(PROTOCOLS))
