"""Generate tests/data/torch_tempering_reference.json: the JAX package's
parallel tempering (``api.fit_pt``) and adaptive tempered SMC
(``api.fit_smc``) under the protocols that chip_smoke.py drives through the
PyTorch port at the headline width, and under the small protocols of
tests/test_torch_tempering.py and tests/test_torch_smc.py.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocols (``PROTOCOLS`` below has every number):

  * headline PT: bench.py's data (seed 7, K=3, P=8, M=4, N=100, L=100),
    phase 3 started from the JAX package's own phase-1/2 medians stored in
    tests/data/torch_fit_reference.json (``warm_start_from``), then
    fit_pt(kernels="production", ladder="auto", beta_min=0.3,
    max_replicas=64, pilot_sweeps=50, tot_mcmc_iters=400);
  * headline SMC: fit_smc on the same data, K=3, M=4, 256 particles, two
    production mutation sweeps a stage;
  * small (N=16, K=2, P=5, M=2, tests/test_samplers_advanced.py:18-24):
    phases 1 and 2 of 100 sweeps each, whose medians are stored so that the
    port starts from the same point, then fit_pt (auto ladder to 0.5, at
    most 8 rungs, 150 rounds) and fit_smc (64 particles), production
    kernels.

Each protocol runs under several seeds.  A statistic x of one run gets the
limits of tests/data/make_torch_families_reference.py's between-seed rule,

    mean_s(x_s) +- 5 * sqrt(sd_s(x_s)^2 + se^2),

with se the standard error of two runs' x from within one run where a run
has one: for the cold chain's median loglik over the last half of the
rounds, 1.2533 * (IQR / 1.349) * sqrt(2 / ESS) (ESS of that half by
bayesfmmm_tpu.diagnostics); for SMC's weighted sigma^2, the weighted sd
* sqrt(2 / weight-ESS); for the ladder's length, SMC's stage count and
log-evidence, none (se = 0: the seeds' spread alone).  The ladder length's
and stage count's limits are rounded outwards to integers.

    JAX_PLATFORMS=cpu python tests/data/make_torch_tempering_reference.py [headline small]
    JAX_PLATFORMS=cpu python tests/data/make_torch_tempering_reference.py --limits

The small protocols take about 7 minutes on the CPU, the headline ones
longer; the results of a protocol set not named are kept, and --limits
recomputes every stored set's limits from its runs.
"""

import json
import math
import os
import sys
import time
import warnings

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from bayesfmmm_tpu import api  # noqa: E402
from bayesfmmm_tpu.config import ModelConfig  # noqa: E402
from bayesfmmm_tpu.diagnostics import effective_sample_size  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402

OUT = os.path.join(HERE, "torch_tempering_reference.json")
FIT_REFERENCE = os.path.join(HERE, "torch_fit_reference.json")

PROTOCOLS = {
    "headline": dict(
        data=dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100]),
        start="torch_fit_reference.json warm_start_from",
        pt=dict(kernels="production", ladder="auto", beta_min=0.3,
                max_replicas=64, pilot_sweeps=50, tot_mcmc_iters=400),
        pt_seeds=[2, 3, 4, 5, 6],
        smc=dict(n_particles=256, n_mutation_sweeps=2, kernels="production"),
        smc_seeds=[0, 1, 2, 3, 4]),
    "small": dict(
        data=dict(seed=61, N=16, K=2, P=5, M=2, n_time=[15, 20]),
        start=dict(nu_z_iters=100, theta_iters=100, nu_z_seed=0,
                   theta_seed=1),
        pt=dict(kernels="production", ladder="auto", beta_min=0.5,
                max_replicas=8, pilot_sweeps=60, tot_mcmc_iters=150),
        pt_seeds=[3, 4, 5, 6, 7, 8],
        smc=dict(n_particles=64, n_mutation_sweeps=2, kernels="production"),
        smc_seeds=[0, 1, 2, 3, 4, 5]),
}
LIMIT_RULE = ("mean of the seeds' x +- 5 * sqrt(sd between seeds^2 + se^2); "
              "se: cold loglik median 1.2533 * IQR / 1.349 * sqrt(2 / ESS), "
              "weighted sigma2 weighted sd * sqrt(2 / weight-ESS), none for "
              "ladder length, n_stages and log_evidence; integer statistics "
              "rounded outwards")
WARM_FROM_PHASE_1 = ("Z", "pi", "alpha3", "nu", "tau", "eta", "tau_eta")
WARM_FROM_PHASE_2 = ("Phi", "gamma", "delta", "A", "sigma2", "chi", "xi",
                     "gamma_xi", "delta_xi", "A_xi")


def from_estimates(est, data, cfg):
    """A JAX FitResult whose estimates() are ``est`` (a one-draw trace)."""
    shapes = dict(
        Z=(data.N, cfg.K), pi=(cfg.K,), alpha3=(), nu=(cfg.K, cfg.P),
        tau=(cfg.K,), sigma2=(), chi=(data.N, cfg.M),
        Phi=(cfg.K, cfg.P, cfg.M), gamma=(cfg.K, cfg.P, cfg.M),
        delta=(cfg.K, cfg.M), A=(cfg.K, 2), eta=(cfg.K, cfg.P, 0),
        tau_eta=(cfg.K, 0), xi=(cfg.K, cfg.P, 0, cfg.M),
        gamma_xi=(cfg.K, cfg.P, 0, cfg.M), delta_xi=(cfg.K, cfg.M, 0),
        A_xi=(cfg.K, 2, 0))
    traces = {f: np.asarray(est[f], np.float32).reshape(shapes[f])[None]
              for f in shapes}
    res = api.FitResult(traces, np.zeros(1), None)
    res.data = data
    res.config = cfg
    return res


def limits(xs, se=0.0, integer=False, clip=(-math.inf, math.inf)):
    xs = np.asarray(xs, np.float64)
    half = 5.0 * math.sqrt(xs.std(ddof=1) ** 2 + se ** 2)
    lo, hi = xs.mean() - half, xs.mean() + half
    if integer:
        lo, hi = math.floor(lo), math.ceil(hi)
    lo, hi = max(lo, clip[0]), min(hi, clip[1])
    return {"mean": float(xs.mean()), "values": xs.tolist(),
            "sd_between_seeds": float(xs.std(ddof=1)), "se": float(se),
            "limits": [float(lo), float(hi)]}


def pt_run(r1, r2, p, seed):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = api.fit_pt(r1, r2, seed=seed, **p)
    ll = np.asarray(res.loglik, np.float64)
    half = ll[len(ll) // 2:]
    q25, q75 = np.percentile(half, [25, 75])
    ess = effective_sample_size(half)
    assert np.all(np.isfinite(ll))
    return {"seed": seed, "ladder": np.asarray(res.ladder).tolist(),
            "ladder_length": int(len(res.ladder)),
            "swap_rate": float(res.swap_rate),
            "loglik_median": float(np.median(half)),
            "loglik_se": float(1.2533 * (q75 - q25) / 1.349
                               * math.sqrt(2.0 / ess)),
            "loglik_ess": float(ess),
            "warnings": [str(w.message)[:80] for w in caught]}


def smc_run(data, cfg, p, seed):
    res = api.fit_smc(data=data, K=cfg.K, M=cfg.M, seed=seed, **p)
    w = np.asarray(res["weights"], np.float64)
    s2 = np.asarray(res["particles"].sigma2, np.float64)
    mean = float(np.sum(w * s2))
    sd = math.sqrt(float(np.sum(w * (s2 - mean) ** 2)))
    ess_w = 1.0 / float(np.sum(w * w))
    return {"seed": seed, "n_stages": int(res["n_stages"]),
            "final_beta": float(res["final_beta"]),
            "log_evidence": float(res["log_evidence"]),
            "sigma2": mean, "sigma2_se": sd * math.sqrt(2.0 / ess_w),
            "weight_ess": ess_w}


def run(name):
    p = PROTOCOLS[name]
    d = p["data"]
    data, _ = simulate_functional(seed=d["seed"], N=d["N"], K=d["K"],
                                  P=d["P"], M=d["M"],
                                  n_time=tuple(d["n_time"]))
    cfg = ModelConfig(K=d["K"], P=d["P"], M=d["M"])
    out = {"protocol": p}
    t0 = time.time()
    if name == "headline":
        start = json.load(open(FIT_REFERENCE))["warm_start_from"]
    else:
        s = p["start"]
        r1 = api.fit_nu_z(data=data, K=d["K"], M=d["M"],
                          tot_mcmc_iters=s["nu_z_iters"], seed=s["nu_z_seed"])
        r2 = api.fit_theta(r1, tot_mcmc_iters=s["theta_iters"],
                           seed=s["theta_seed"])
        start = {**{f: np.asarray(r1.estimates(_warn=False)[f],
                                  np.float64).tolist()
                    for f in WARM_FROM_PHASE_1},
                 **{f: np.asarray(r2.estimates(_warn=False)[f],
                                  np.float64).tolist()
                    for f in WARM_FROM_PHASE_2}}
        out["warm_start_from"] = start
    r = from_estimates(start, data, cfg)
    out["pt_runs"] = [pt_run(r, r, p["pt"], s) for s in p["pt_seeds"]]
    out["smc_runs"] = [smc_run(data, cfg, p["smc"], s)
                       for s in p["smc_seeds"]]
    assert all(x["final_beta"] == 1.0 for x in out["smc_runs"])
    out["cpu_seconds"] = round(time.time() - t0, 1)
    return summarize(out)


def summarize(out):
    """The limits of one protocol set, from its runs."""
    pts, smcs = out["pt_runs"], out["smc_runs"]
    out["pt"] = {
        # a ladder has 2 to max_replicas rungs
        "ladder_length": limits([x["ladder_length"] for x in pts],
                                integer=True,
                                clip=(2, out["protocol"]["pt"]
                                      ["max_replicas"])),
        "swap_rate": limits([x["swap_rate"] for x in pts]),
        "loglik_median": limits(
            [x["loglik_median"] for x in pts],
            se=float(np.mean([x["loglik_se"] for x in pts])))}
    out["smc"] = {
        "n_stages": limits([x["n_stages"] for x in smcs], integer=True),
        "log_evidence": limits([x["log_evidence"] for x in smcs]),
        "sigma2": limits([x["sigma2"] for x in smcs],
                         se=float(np.mean([x["sigma2_se"] for x in smcs])))}
    return out


def main(names):
    """Run the named protocol sets; "--limits" recomputes the limits of the
    stored runs only."""
    ref = json.load(open(OUT)) if os.path.exists(OUT) else {}
    ref.update(limit_rule=LIMIT_RULE, jax_version=jax.__version__)
    if names == ["--limits"]:
        names = [n for n in PROTOCOLS if n in ref]
    for name in names:
        ref[name] = (summarize(ref[name]) if sys.argv[1:] == ["--limits"]
                     else run(name))
        with open(OUT, "w") as f:
            json.dump(ref, f, indent=1, default=float)
            f.write("\n")
        print(name, json.dumps({k: v for k, v in ref[name].items()
                                if k in ("pt", "smc", "cpu_seconds")},
                               indent=1, default=float))


if __name__ == "__main__":
    main(sys.argv[1:] or list(PROTOCOLS))
