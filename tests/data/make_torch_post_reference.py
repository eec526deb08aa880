"""Generate tests/data/torch_post_reference.json: the JAX package's CPO,
DIC, AIC, BIC and log-likelihood trace on synthetic traces that
chip_smoke.py rebuilds from the same seeds and post-processes with the
PyTorch port, CPO on the card.

The card's machine has no JAX, so chip_smoke.py holds the port against this
file.  Protocol, two cases (``PROTOCOL`` below):

  * headline: simulate_functional(seed=7, N=100, K=3, P=8, M=4,
    n_time=(80, 100)) (ragged: 80 to 100 points a curve), 200 draws;
  * config4: config 4's widths (benchmarks/suite.py: K=2, P=8, M=16, D=1,
    eta and xi), simulate_functional(seed=7, N=80, n_time=(80, 100),
    with_eta=True, with_xi=True), 200 draws, X given (covariate_cov for
    AIC and BIC);

the traces from bayesfmmm_torch.utils.simulate.simulate_draws(truth,
200, seed=13) (NumPy only, so the card's machine rebuilds the same bits),
post-processed with burnin_prop=0.1.  The data of both packages' simulators
is the same bits.  The file also records the sums of the traces, so that a
rebuild that drew other numbers is refused.

CPO's tolerance (``cpo_atol``, a case each) is found here: four times the
largest error of the JAX package's float32 CPO against its float64 dense
CPO (``cpo_dense``) on the same traces.  Two float32 computations of the
function, each as far from the exact value as the JAX one, differ by about
twice that; the rest is margin.  The error comes from r'r - w'w, two sums
of about L * (chi Phi)^2 / sigma2 that cancel to a few hundred nats, so it
grows with the points a curve has.  The port's CPO on this CPU must lie
within it too.  Run:

    JAX_PLATFORMS=cpu python tests/data/make_torch_post_reference.py
"""

import json
import os
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from bayesfmmm_tpu.post import cpo_fast as jcpo_fast  # noqa: E402
from bayesfmmm_tpu.post import model_selection as jms  # noqa: E402
from bayesfmmm_tpu.utils.simulate import (  # noqa: E402
    simulate_functional as jsimulate)
from bayesfmmm_torch.post import cpo_fast  # noqa: E402
from bayesfmmm_torch.utils.simulate import (simulate_draws,  # noqa: E402
                                            simulate_functional)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_post_reference.json")
PROTOCOL = {
    "headline": dict(data=dict(seed=7, N=100, K=3, P=8, M=4,
                               n_time=[80, 100]),
                     draws=200, trace_seed=13, burnin_prop=0.1, X=False),
    "config4": dict(data=dict(seed=7, N=80, K=2, P=8, M=16, D=1,
                              n_time=[80, 100], with_eta=True, with_xi=True),
                    draws=200, trace_seed=13, burnin_prop=0.1, X=True),
}
CPO_MARGIN = 4.0


def case_inputs(case, device):
    """The port's data on ``device``, the traces and X of one case."""
    p = PROTOCOL[case]
    kw = dict(p["data"], n_time=tuple(p["data"]["n_time"]))
    data, truth = simulate_functional(device=device, **kw)
    traces = simulate_draws(truth, p["draws"], seed=p["trace_seed"])
    X = data.X.cpu().numpy() if p["X"] else None
    return data, traces, X


def trace_sums(traces):
    return {k: float(np.sum(v)) for k, v in sorted(traces.items())}


def main():
    out = {"protocol": PROTOCOL, "cpo_margin": CPO_MARGIN}
    for case, p in PROTOCOL.items():
        t0 = time.perf_counter()
        kw = dict(p["data"], n_time=tuple(p["data"]["n_time"]))
        jdata, _ = jsimulate(**kw)
        data, traces, X = case_inputs(case, "cpu")
        np.testing.assert_array_equal(np.asarray(jdata.B), data.B.numpy())
        np.testing.assert_array_equal(np.asarray(jdata.y), data.y.numpy())
        bp = p["burnin_prop"]
        cov = bool(p["X"])
        cpo = jcpo_fast.cpo_fast(traces, jdata, burnin_prop=bp, X=X)
        port = cpo_fast.cpo_fast(traces, data, burnin_prop=bp, X=X)
        dense = jms.cpo_dense(traces, jdata, burnin_prop=bp, X=X)
        e_jax = float(np.max(np.abs(cpo - dense)))
        e_port = float(np.max(np.abs(port - dense)))
        diff = float(np.max(np.abs(port - cpo)))
        atol = CPO_MARGIN * e_jax
        assert diff < atol, (diff, atol)
        out[case] = {
            "cpo_atol": atol,
            "jax_cpo_max_abs_err_vs_float64": e_jax,
            "port_cpu_cpo_max_abs_err_vs_float64": e_port,
            "trace_sums": trace_sums(traces),
            "cpo": [float(v) for v in cpo],
            "dic": jms.dic(traces, jdata, burnin_prop=bp, X=X),
            "aic": jms.aic(traces, jdata, burnin_prop=bp, X=X, cov_adj=cov),
            "bic": jms.bic(traces, jdata, burnin_prop=bp, X=X, cov_adj=cov),
            "loglik": [float(v) for v in jms.loglik_trace(traces, jdata, X)],
            "port_cpu_cpo_max_abs_diff": diff,
        }
        print(f"{case}: {time.perf_counter() - t0:.1f} s; CPO of "
              f"{len(cpo)} observations in [{min(cpo):.3f}, {max(cpo):.3f}]"
              f"; against the float64 dense CPO the JAX package's within "
              f"{e_jax:.3e}, the port's {e_port:.3e}; port - JAX {diff:.3e} "
              f"(tolerance {atol:.3e}); DIC "
              f"{out[case]['dic']:.4f}")
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
