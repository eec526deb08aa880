"""Generate tests/data/torch_slice_reference.json: the JAX package's result
for the slice protocol that chip_smoke.py drives in the PyTorch port.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocol (the bench's headline model and init, bench.py:115-154):

  * data: simulate_functional(seed=7, N=100, K=3, P=8, M=4,
    n_time=(100, 100));
  * init: each chain from init_state, then seeded from spectral_init with
    0.02 N(0, 1) jitter on Z (clipped at 1e-4, renormalized);
  * run: 300 sweeps of gibbs.sweep_full in the reference census, the first
    200 annealed with beta rising linearly from 0.1 to 1.

This script runs that protocol on the CPU with 64 chains and records the
ensemble median and spread of the final loglik and sigma2, with the limits
chip_smoke.py applies to the port's ensemble medians:

    median_jax +- 5 * 1.2533 * (IQR / 1.349) * sqrt(1/64 + 1/C_port)

i.e. 5 combined standard errors of two sample medians, the spread of one
chain estimated from the JAX ensemble's interquartile range.  Run:

    JAX_PLATFORMS=cpu python tests/data/make_torch_slice_reference.py
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from bayesfmmm_tpu.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_tpu.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_tpu.models.state import init_state  # noqa: E402
from bayesfmmm_tpu.ops import gibbs  # noqa: E402
from bayesfmmm_tpu.utils.init_strategies import spectral_init  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402

PROTOCOL = dict(seed=7, N=100, K=3, P=8, M=4, n_time=[100, 100],
                sweeps=300, anneal=200, beta0=0.1, z_jitter=0.02)
CHAINS = 64
PORT_CHAINS = 256
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_slice_reference.json")


def betas(p):
    """Per-sweep temperatures: linear from beta0 to 1 over the first
    `anneal` sweeps, then 1."""
    return np.interp(np.arange(p["sweeps"]),
                     [0, p["anneal"] - 1, p["sweeps"] - 1],
                     [p["beta0"], 1.0, 1.0]).astype(np.float32)


def summary(x, n_port):
    x = np.asarray(x, np.float64)
    q25, med, q75 = np.percentile(x, [25, 50, 75])
    half = 5.0 * 1.2533 * (q75 - q25) / 1.349 * np.sqrt(1.0 / len(x)
                                                         + 1.0 / n_port)
    return {"median": med, "q25": q25, "q75": q75, "min": x.min(),
            "max": x.max(), "limits": [med - half, med + half]}


def main(census=None, out=OUT):
    """Run the protocol with sweep_full(**census) (the reference census when
    None) and write the summary to ``out``."""
    census = census or {}
    p = PROTOCOL
    K, P, M = p["K"], p["P"], p["M"]
    data, _ = simulate_functional(seed=p["seed"], N=p["N"], K=K, P=P, M=M,
                                  n_time=tuple(p["n_time"]))
    hp, cfg = Priors(), ModelConfig(K=K, P=P, M=M)
    c = jnp.full((K,), 10.0)
    keys = jax.random.split(jax.random.PRNGKey(0), CHAINS)
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
                                    **census), None
        st, _ = jax.lax.scan(body, st, (jax.random.split(k, p["sweeps"]),
                                        jnp.asarray(betas(p))))
        return st

    states = jax.jit(jax.vmap(init))(keys)
    ll0 = jax.jit(jax.vmap(lambda s: log_likelihood(s, data)))(states)
    t0 = time.time()
    final = jax.jit(jax.vmap(run))(
        jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys), states)
    ll = jax.jit(jax.vmap(lambda s: log_likelihood(s, data)))(final)
    ll.block_until_ready()
    seconds = time.time() - t0
    for leaf in jax.tree.leaves(final):
        assert np.all(np.isfinite(np.asarray(leaf)))
    ref = {
        "protocol": p,
        "census": census,
        "chains": CHAINS,
        "port_chains": PORT_CHAINS,
        "limit_rule": "median +- 5 * 1.2533 * (q75 - q25) / 1.349 * "
                      "sqrt(1/chains + 1/port_chains)",
        "loglik_start": summary(ll0, PORT_CHAINS),
        "loglik": summary(ll, PORT_CHAINS),
        "sigma2": summary(final.sigma2, PORT_CHAINS),
        "jax_version": jax.__version__,
        "cpu_seconds": round(seconds, 1),
    }
    with open(out, "w") as f:
        json.dump(ref, f, indent=1, default=float)
        f.write("\n")
    print(json.dumps(ref, indent=1, default=float))


if __name__ == "__main__":
    main()
