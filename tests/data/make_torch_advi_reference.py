"""Generate tests/data/torch_advi_reference.json: the JAX package's
``api.fit_advi_init`` and its production sweep with every default-off
kernel on, under the protocols that chip_smoke.py's ``advi`` phase drives
through the PyTorch port at the headline width.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocols (``PROTOCOLS`` below has every number), on bench.py's data
(seed 7, K=3, P=8, M=4, N=100, L=100):

  * advi: fit_advi_init with advi_steps=600, advi_lr=0.03, 4 chains and a
    warm start cut to 300 sweeps (the function's default is 2,000);
  * sweep: 64 chains seeded at the JAX package's own phase-1/2 medians
    (tests/data/torch_fit_reference.json ``warm_start_from``), 100 sweeps of
    the production census (fit_warm_start, kernels="production"), then
    hmc_inv_mass = the ensemble's variance of its flat unconstrained
    positions + 1e-8 (bench.py:196-203), then 100 sweeps of the production
    census plus z_anchor=True, phi_chi_moves=2, hmc_steps=2 and bench.py's
    hmc_eps (BENCH_HMC_EPS's default, 0.003).

Each protocol runs under several seeds.  A statistic x of one run gets the
other reference makers' between-seed rule,

    mean_s(x_s) +- 5 * sqrt(sd_s(x_s)^2 + se^2),

with se the standard error of two runs' x from within one run where a run
has one: the mean ELBO of the last 50 steps, sd * sqrt(2 / 50) of those
steps; the best chain's mean loglik over its last 100 draws, sd * sqrt(2 /
ESS) (ESS by bayesfmmm_tpu.diagnostics); its median sigma^2 over every kept
draw, 1.2533 * (IQR / 1.349) * sqrt(2 / ESS); an ensemble median over C
chains (the chains' mean loglik over the last 50 sweeps, the last sweep's
sigma^2), 1.2533 * (IQR / 1.349) * sqrt(2 / C); for the ELBO's rise (the
mean of the last 50 steps less that of the first 50), none.

    JAX_PLATFORMS=cpu python tests/data/make_torch_advi_reference.py [advi sweep]
    JAX_PLATFORMS=cpu python tests/data/make_torch_advi_reference.py --limits
    JAX_PLATFORMS=cpu python tests/data/make_torch_advi_reference.py --port [advi sweep]

About 1 minute a seed of each on the CPU; the results of a protocol not
named are kept, and --limits recomputes every stored protocol's limits from
its runs.  ``--port`` runs the PyTorch port on the CPU under the named
protocols (``PORT_SEEDS``) and stores its statistics under "port_cpu",
beside the JAX runs, for comparison only: no gate reads them.
"""

import json
import math
import os
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from bayesfmmm_tpu.diagnostics import effective_sample_size  # noqa: E402

OUT = os.path.join(HERE, "torch_advi_reference.json")
FIT_REFERENCE = os.path.join(HERE, "torch_fit_reference.json")

DATA = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100])
PROTOCOLS = {
    "advi": dict(
        data=DATA,
        fit=dict(K=3, M=4, advi_steps=600, advi_lr=0.03, n_chains=4,
                 warm_iters=300),
        seeds=[0, 1, 2, 3, 4]),
    "sweep": dict(
        data=DATA, start="torch_fit_reference.json warm_start_from",
        chains=64, warm_sweeps=100, sweeps=100,
        flags=dict(collapsed_z=True, gauge=True, p_indep=0.3,
                   phi_mala_steps=4, phi_mala_step=0.05, z_anchor=True,
                   phi_chi_moves=2, hmc_steps=2, hmc_eps=0.003),
        seeds=[0, 1, 2, 3, 4]),
}
STATS = {"advi": ("elbo_tail_mean", "elbo_rise", "loglik_tail_mean",
                  "sigma2_median"),
         "sweep": ("loglik_median", "sigma2_median")}
LIMIT_RULE = ("mean of the seeds' x +- 5 * sqrt(sd between seeds^2 + se^2); "
              "se: last 50 ELBOs sd * sqrt(2 / 50), best chain's tail loglik "
              "mean sd * sqrt(2 / ESS), its median sigma2 1.2533 * IQR / "
              "1.349 * sqrt(2 / ESS), an ensemble median over C chains "
              "1.2533 * IQR / 1.349 * sqrt(2 / C), none for the ELBO's rise")
TAIL, ELBO_WINDOW, SWEEP_TAIL = 100, 50, 50
PORT_SEEDS = [0, 1, 2]


def _median_se(x):
    q25, q75 = np.percentile(x, [25, 75])
    return float(1.2533 * (q75 - q25) / 1.349 * math.sqrt(2.0 / len(x)))


def advi_stats(elbo, loglik, sigma2):
    """The advi protocol's statistics of one run: its ELBO trace, the best
    chain's loglik trace and sigma^2 draws."""
    elbo, ll, s2 = (np.asarray(x, np.float64) for x in (elbo, loglik, sigma2))
    tail = ll[-min(TAIL, len(ll)):]
    last, first = elbo[-ELBO_WINDOW:], elbo[:ELBO_WINDOW]
    q25, q75 = np.percentile(s2, [25, 75])
    return {"elbo_tail_mean": float(last.mean()),
            "elbo_tail_mean_se": float(last.std(ddof=1) * math.sqrt(
                2.0 / ELBO_WINDOW)),
            "elbo_rise": float(last.mean() - first.mean()),
            "loglik_tail_mean": float(tail.mean()),
            "loglik_tail_mean_se": float(tail.std(ddof=1) * math.sqrt(
                2.0 / effective_sample_size(tail))),
            "sigma2_median": float(np.median(s2)),
            "sigma2_median_se": float(1.2533 * (q75 - q25) / 1.349
                                      * math.sqrt(2.0 / effective_sample_size(
                                          s2)))}


def sweep_stats(loglik, sigma2):
    """The sweep protocol's statistics: the chains' (C, n) loglik traces of
    the default-off sweeps and their last sigma^2 (C,)."""
    ll = np.asarray(loglik, np.float64)[:, -SWEEP_TAIL:].mean(1)
    s2 = np.asarray(sigma2, np.float64)
    return {"loglik_median": float(np.median(ll)),
            "loglik_median_se": _median_se(ll),
            "sigma2_median": float(np.median(s2)),
            "sigma2_median_se": _median_se(s2)}


def limits(xs, se=0.0):
    xs = np.asarray(xs, np.float64)
    half = 5.0 * math.sqrt(xs.std(ddof=1) ** 2 + se ** 2)
    return {"mean": float(xs.mean()), "values": xs.tolist(),
            "sd_between_seeds": float(xs.std(ddof=1)), "se": float(se),
            "limits": [float(xs.mean() - half), float(xs.mean() + half)]}


def summarize(out, name):
    runs = out["runs"]
    for stat in STATS[name]:
        se = [x[f"{stat}_se"] for x in runs if f"{stat}_se" in x]
        out[stat] = limits([x[stat] for x in runs],
                           se=float(np.mean(se)) if se else 0.0)
    return out


def jax_data():
    from bayesfmmm_tpu.utils.simulate import simulate_functional
    return simulate_functional(seed=DATA["seed"], N=DATA["N"], K=DATA["K"],
                               P=DATA["P"], M=DATA["M"],
                               n_time=tuple(DATA["n_time"]))[0]


def advi_run(data, p, seed):
    from bayesfmmm_tpu import api
    t0 = time.time()
    res = api.fit_advi_init(data, seed=seed, **p["fit"])
    assert np.all(np.isfinite(res.all_chain_loglik))
    return {"seed": seed, "seconds": round(time.time() - t0, 1),
            "best_chain": int(res.chain_index),
            **advi_stats(res.elbo_trace, res.loglik, res.traces["sigma2"])}


def sweep_run(data, p, seed):
    """JAX: fit_warm_start's production census from the medians, the
    inverse mass from its ensemble, then the default-off sweeps (a scan of
    sweep_full per chain, vmapped, loglik each sweep)."""
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from bayesfmmm_tpu import api
    from bayesfmmm_tpu.config import ModelConfig, Priors
    from bayesfmmm_tpu.models import logjoint
    from bayesfmmm_tpu.models.likelihood import log_likelihood
    from bayesfmmm_tpu.ops import gibbs

    sys.path.insert(0, HERE)
    from make_torch_tempering_reference import from_estimates

    t0 = time.time()
    cfg = ModelConfig(K=DATA["K"], P=DATA["P"], M=DATA["M"])
    start = from_estimates(json.load(open(FIT_REFERENCE))["warm_start_from"],
                           data, cfg)
    class Silent:               # the chunked path, which keeps the ensemble
        def update(self, *a):
            pass

    warm = api.fit_warm_start(start, start, tot_mcmc_iters=p["warm_sweeps"],
                              n_chains=p["chains"], kernels="production",
                              seed=seed, progress=Silent())
    states = warm.ensemble_state
    flats = jax.vmap(lambda s: ravel_pytree(logjoint.from_state(s))[0])(
        states)
    inv_mass = jnp.var(flats, axis=0) + 1e-8
    hp, c = Priors(), jnp.full((cfg.K,), 10.0)

    def chain(k, st):
        def body(carry, kk):
            st = gibbs.sweep_full(kk, carry, data, hp, c,
                                  hmc_inv_mass=inv_mass, **p["flags"])
            return st, log_likelihood(st, data)
        return jax.lax.scan(body, st, jax.random.split(k, p["sweeps"]))

    keys = jax.random.split(jax.random.PRNGKey(1000 + seed), p["chains"])
    final, ll = jax.jit(jax.vmap(chain))(keys, states)
    ll = np.asarray(ll)
    assert np.all(np.isfinite(ll))
    return {"seed": seed, "seconds": round(time.time() - t0, 1),
            **sweep_stats(ll, np.asarray(final.sigma2))}


def run(name):
    p = PROTOCOLS[name]
    data = jax_data()
    out = {"protocol": p, "runs": []}
    t0 = time.time()
    fn = advi_run if name == "advi" else sweep_run
    for s in p["seeds"]:
        out["runs"].append(fn(data, p, s))
        print(name, out["runs"][-1], flush=True)
    out["cpu_seconds"] = round(time.time() - t0, 1)
    return summarize(out, name)


def port_run(name, seed):
    """The port on the CPU under protocol ``name``: chip_smoke.py's own
    code for the phase (``advi_fit``, ``default_off_sweeps``)."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "..", ".."))
    import chip_smoke

    torch.set_num_threads(4)
    dev = torch.device("cpu")
    t0 = time.time()
    if name == "advi":
        res = chip_smoke.advi_fit(dev, seed)
        stats = advi_stats(res.elbo_trace, res.loglik, res.traces["sigma2"])
    else:
        ll, final, *_ = chip_smoke.default_off_sweeps(dev, seed)
        stats = sweep_stats(ll.cpu().numpy(), final.sigma2.cpu().numpy())
    return {"seed": seed, "seconds": round(time.time() - t0, 1), **stats}


def main(names):
    """Run the named protocols; "--limits" recomputes the limits of the
    stored runs only; "--port" followed by names runs the port's."""
    ref = json.load(open(OUT)) if os.path.exists(OUT) else {}
    ref.update(limit_rule=LIMIT_RULE, jax_version=jax.__version__)
    if names[:1] == ["--port"]:
        for name in names[1:] or list(PROTOCOLS):
            runs = [port_run(name, s) for s in PORT_SEEDS]
            for r in runs:
                print(name, "port", r, flush=True)
            ref.setdefault("port_cpu", {})[name] = summarize(
                {"protocol": PROTOCOLS[name], "seeds": PORT_SEEDS,
                 "runs": runs}, name)
            with open(OUT, "w") as f:
                json.dump(ref, f, indent=1, default=float)
                f.write("\n")
        return
    only_limits = names == ["--limits"]
    if only_limits:
        names = [n for n in PROTOCOLS if n in ref]
    for name in names:
        ref[name] = summarize(ref[name], name) if only_limits else run(name)
        with open(OUT, "w") as f:
            json.dump(ref, f, indent=1, default=float)
            f.write("\n")
        print(name, json.dumps({k: v for k, v in ref[name].items()
                                if k in STATS[name] + ("cpu_seconds",)},
                               indent=1, default=float))


if __name__ == "__main__":
    main(sys.argv[1:] or list(PROTOCOLS))
