"""Generate tests/data/torch_hmc_reference.json: the JAX package's
whole-model HMC and NUTS (``api.fit_hmc``) under the protocols that
chip_smoke.py drives through the PyTorch port at the headline width, and
under the small protocols of tests/test_torch_hmc.py and
tests/test_torch_nuts.py.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocols (``PROTOCOLS`` below has every number):

  * headline: bench.py's data (seed 7, K=3, P=8, M=4, N=100, L=100),
    fit_hmc with 64 chains from the spectral init: method="hmc" with
    n_warmup=200, n_samples=100, n_leapfrog=24; method="nuts" with
    n_warmup=100, n_samples=100, max_depth=5 (cut so that the whole smoke
    stays near half of its time limit on a slow host);
  * small (tests/test_hmc.py::test_fit_hmc_api's data: seed 91, N=24, K=2,
    P=6, M=2): 4 chains, "hmc" 150 + 100 iterations of up to 12 steps,
    "nuts" 120 + 80 iterations to depth 6.

Each protocol runs under several seeds.  A statistic x of one run gets the
limits of the other reference makers' between-seed rule,

    mean_s(x_s) +- 5 * sqrt(sd_s(x_s)^2 + se^2),

with se the standard error of two runs' x from within one run where a run
has one: for the best chain's mean loglik over its last 100 draws (fewer
when a run keeps fewer), sd * sqrt(2 / ESS) of those draws; for its median
sigma^2 over every kept draw, 1.2533 * (IQR / 1.349) * sqrt(2 / ESS) (ESS
by bayesfmmm_tpu.diagnostics); for the pooled accept_mean (the mean over
chains) and the median eps over chains, none (the seeds' spread alone).

    JAX_PLATFORMS=cpu python tests/data/make_torch_hmc_reference.py [headline small]
    JAX_PLATFORMS=cpu python tests/data/make_torch_hmc_reference.py --limits
    JAX_PLATFORMS=cpu python tests/data/make_torch_hmc_reference.py --port headline

The small protocols take about a minute on the CPU, the headline ones
about 40 s a seed; the results of a protocol set not named are kept, and
--limits recomputes every stored set's limits from its runs.  ``--port``
runs the PyTorch port's ``fit_hmc`` on the CPU under the named protocols
(``PORT_SEEDS``) and stores its statistics under "port_cpu", beside the
JAX runs, for comparison only: no gate reads them.
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

from bayesfmmm_tpu import api  # noqa: E402
from bayesfmmm_tpu.diagnostics import effective_sample_size  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402

OUT = os.path.join(HERE, "torch_hmc_reference.json")

PROTOCOLS = {
    "headline": dict(
        data=dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100]),
        fit=dict(K=3, M=4, n_chains=64, init="spectral"),
        hmc=dict(method="hmc", n_warmup=200, n_samples=100, n_leapfrog=24),
        nuts=dict(method="nuts", n_warmup=100, n_samples=100, max_depth=5),
        # twelve: under a longer protocol the first six seeds spread NUTS's
        # pooled accept by 0.0013, ten by 0.0031
        seeds=list(range(12))),
    "small": dict(
        data=dict(seed=91, N=24, K=2, P=6, M=2, n_time=[25, 30]),
        fit=dict(K=2, M=2, n_chains=4, init="spectral"),
        hmc=dict(method="hmc", n_warmup=150, n_samples=100, n_leapfrog=12),
        nuts=dict(method="nuts", n_warmup=120, n_samples=80, max_depth=6),
        seeds=[0, 1, 2, 3, 4, 5]),
}
METHODS = ("hmc", "nuts")
LIMIT_RULE = ("mean of the seeds' x +- 5 * sqrt(sd between seeds^2 + se^2); "
              "se: best chain's tail loglik mean sd * sqrt(2 / ESS), its "
              "median sigma2 1.2533 * IQR / 1.349 * sqrt(2 / ESS), none for "
              "the pooled accept_mean and the median eps")
TAIL = 100       # draws of the best chain whose mean loglik is gated
PORT_SEEDS = list(range(6))


def run_one(data, p, method, seed, fit_hmc=api.fit_hmc, **kw):
    """One fit_hmc run's statistics."""
    t0 = time.time()
    res = fit_hmc(data, seed=seed, **p["fit"], **p[method], **kw)
    ll = np.asarray(res.loglik, np.float64)
    tail = ll[-min(TAIL, len(ll)):]
    s2 = np.asarray(res.traces["sigma2"], np.float64)
    q25, q75 = np.percentile(s2, [25, 75])
    # the per-chain arrays (the port also records every iteration's
    # trajectory length or depth, which no limit reads)
    diag = {k: np.asarray(v, np.float64) for k, v in
            res.hmc_diagnostics.items() if np.ndim(v) == 1}
    assert np.all(np.isfinite(res.all_chain_loglik))
    return {"seed": seed, "seconds": round(time.time() - t0, 1),
            "best_chain": int(res.chain_index),
            "loglik_tail_mean": float(tail.mean()),
            "loglik_tail_se": float(tail.std(ddof=1) * math.sqrt(
                2.0 / effective_sample_size(tail))),
            "sigma2_median": float(np.median(s2)),
            "sigma2_se": float(1.2533 * (q75 - q25) / 1.349 * math.sqrt(
                2.0 / effective_sample_size(s2))),
            "accept_mean": float(diag["accept_mean"].mean()),
            "eps_median": float(np.median(diag["eps"])),
            "diagnostics": {k: v.tolist() for k, v in diag.items()}}


def limits(xs, se=0.0):
    xs = np.asarray(xs, np.float64)
    half = 5.0 * math.sqrt(xs.std(ddof=1) ** 2 + se ** 2)
    return {"mean": float(xs.mean()), "values": xs.tolist(),
            "sd_between_seeds": float(xs.std(ddof=1)), "se": float(se),
            "limits": [float(xs.mean() - half), float(xs.mean() + half)]}


def summarize(out):
    """The limits of one protocol set, from its runs."""
    for method in METHODS:
        runs = out[f"{method}_runs"]
        out[method] = {
            "loglik_tail_mean": limits(
                [x["loglik_tail_mean"] for x in runs],
                se=float(np.mean([x["loglik_tail_se"] for x in runs]))),
            "sigma2_median": limits(
                [x["sigma2_median"] for x in runs],
                se=float(np.mean([x["sigma2_se"] for x in runs]))),
            "accept_mean": limits([x["accept_mean"] for x in runs]),
            "eps_median": limits([x["eps_median"] for x in runs])}
    return out


def run(name):
    p = PROTOCOLS[name]
    d = p["data"]
    data, _ = simulate_functional(seed=d["seed"], N=d["N"], K=d["K"],
                                  P=d["P"], M=d["M"],
                                  n_time=tuple(d["n_time"]))
    out = {"protocol": p}
    t0 = time.time()
    for method in METHODS:
        out[f"{method}_runs"] = []
        for s in p["seeds"]:
            out[f"{method}_runs"].append(run_one(data, p, method, s))
            print(name, method, {k: v for k, v in
                                 out[f"{method}_runs"][-1].items()
                                 if k != "diagnostics"}, flush=True)
    out["cpu_seconds"] = round(time.time() - t0, 1)
    return summarize(out)


def run_port(name):
    """The port's fit_hmc on the CPU under protocol set ``name``, for
    ``PORT_SEEDS``: its runs and their statistics' mean and spread."""
    import torch

    from bayesfmmm_torch import api as torch_api
    from bayesfmmm_torch.utils.simulate import \
        simulate_functional as torch_simulate

    torch.set_num_threads(4)
    p = PROTOCOLS[name]
    d = p["data"]
    data, _ = torch_simulate(seed=d["seed"], N=d["N"], K=d["K"], P=d["P"],
                             M=d["M"], n_time=tuple(d["n_time"]),
                             device="cpu")
    out = {"protocol": p, "seeds": PORT_SEEDS}
    for method in METHODS:
        runs = [run_one(data, p, method, s, fit_hmc=torch_api.fit_hmc,
                        device="cpu") for s in PORT_SEEDS]
        for r in runs:
            print(name, "port", method, {k: v for k, v in r.items()
                                         if k != "diagnostics"}, flush=True)
        out[f"{method}_runs"] = runs
    return summarize(out)


def main(names):
    """Run the named protocol sets; "--limits" recomputes the limits of the
    stored runs only; "--port" followed by names runs the port's."""
    ref = json.load(open(OUT)) if os.path.exists(OUT) else {}
    ref.update(limit_rule=LIMIT_RULE, jax_version=jax.__version__)
    if names[:1] == ["--port"]:
        for name in names[1:] or list(PROTOCOLS):
            ref.setdefault("port_cpu", {})[name] = run_port(name)
            with open(OUT, "w") as f:
                json.dump(ref, f, indent=1, default=float)
                f.write("\n")
        return
    only_limits = names == ["--limits"]
    if only_limits:
        names = [n for n in PROTOCOLS if n in ref]
    for name in names:
        ref[name] = summarize(ref[name]) if only_limits else run(name)
        with open(OUT, "w") as f:
            json.dump(ref, f, indent=1, default=float)
            f.write("\n")
        print(name, json.dumps({k: v for k, v in ref[name].items()
                                if k in METHODS + ("cpu_seconds",)},
                               indent=1, default=float))


if __name__ == "__main__":
    main(sys.argv[1:] or list(PROTOCOLS))
