"""The port's legacy binary-membership kernels (ops/legacy_binary.py), the
rest of models/likelihood.py and utils/observability.py's profiling and NaN
hooks, against the JAX package's, on the CPU.

* ``update_z_binary`` and ``update_pi_binary``: a port of tests/
  test_components.py::test_legacy_binary_kernels, and one step of each on
  scripted draws (JAX's Bernoulli and uniform draws, and its Beta variates,
  read from the same tables) equal to JAX's, chain by chain.
* ``pointwise_log_density``, ``marginal_covariance`` and
  ``observation_marginal_loglik`` equal JAX's on identical states, with and
  without covariates, to float32 rounding (relative 2e-5; the covariance's
  and the marginal's sums run over L = 15 points of order-one terms).
* ``trace_profile`` writes a Chrome trace with the program's spans on a
  track of their own; ``debug_nans`` raises on a NaN in a backward pass and
  restores the previous setting.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.models import likelihood as jlik  # noqa: E402
from bayesfmmm_tpu.models.state import GibbsState as JState  # noqa: E402
from bayesfmmm_tpu.ops import legacy_binary as jlegacy  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional as jsim  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig  # noqa: E402
from bayesfmmm_torch.models import likelihood  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS, init_state  # noqa: E402
from bayesfmmm_torch.ops import legacy_binary  # noqa: E402
from bayesfmmm_torch.utils import observability  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

from test_torch_tempering import _random_states  # noqa: E402

LIK_RTOL = 2e-5


def _states(C, N, K, P, M, D, dtype, seed=0):
    """C random chains (NumPy, leading C) as one JAX state a chain and one
    port state, in ``dtype``."""
    st = {f: np.asarray(v, dtype) for f, v in _random_states(
        seed, C, N, K, P, M, D).items()}
    with jax.enable_x64(dtype == np.float64):
        jst = [JState(**{f: jnp.asarray(st[f][c]) for f in STATE_FIELDS})
               for c in range(C)]
    return st, jst, convert.state_from_numpy(
        st, chains=C, device="cpu", dtype=getattr(torch, np.dtype(dtype).name))


# ---------------------------------------------------------------------------
# Legacy binary kernels
# ---------------------------------------------------------------------------

def test_legacy_binary_kernels():
    """Port of tests/test_components.py::test_legacy_binary_kernels (three
    chains): Z stays 0/1 and pi inside (0, 1) over 20 steps of each."""
    data, _ = simulate_functional(seed=72, N=12, K=2, P=5, M=1,
                                  n_time=(12, 15), device="cpu")
    g = torch.Generator().manual_seed(0)
    st = init_state(g, ModelConfig(K=2, P=5, M=1), data, chains=3)
    Z0 = torch.eye(2)[torch.arange(12) % 2].expand(3, 12, 2).contiguous()
    st = st.replace(Z=Z0, pi=torch.full((3, 2), 0.5))
    for _ in range(20):
        st = legacy_binary.update_z_binary(g, st, data, rho=0.8)
        st = legacy_binary.update_pi_binary(g, st)
    assert set(torch.unique(st.Z).tolist()) <= {0.0, 1.0}
    assert bool(((st.pi > 0) & (st.pi < 1)).all())
    assert not torch.equal(st.Z, Z0)


@pytest.mark.parametrize("D,beta", [(0, 1.0), (1, 0.6)])
def test_legacy_binary_matches_jax_on_scripted_draws(monkeypatch, D, beta):
    """One update_z_binary (the proposal's Bernoulli uniforms and the
    accept uniforms scripted alike) and one update_pi_binary (Beta variates
    scripted, their parameters recorded) of three chains in float64: every
    chain's Z equals JAX's, about half the rows move, and the Beta
    parameters equal JAX's."""
    C, N, K = 3, 10, 3
    with jax.enable_x64(True):
        jdata, _ = jsim(seed=4, N=N, K=K, P=5, M=2, D=D, with_eta=D > 0,
                        with_xi=D > 0, n_time=(12, 15), dtype=jnp.float64)
    tdata = convert.data_from_jax(jdata, device="cpu", dtype=torch.float64)
    st, jst, tst = _states(C, N, K, 5, 2, D, np.float64)
    rng = np.random.default_rng(7)
    Zb = np.eye(K)[rng.integers(0, K, (C, N))]
    Zb[:, 0] = 0.0                                  # a row with no feature
    tst = tst.replace(Z=torch.tensor(Zb), sigma2=tst.sigma2 * 4.0)
    ub, ua = rng.uniform(size=(C, N, K)), rng.uniform(size=(C, N))
    beta_draws = rng.uniform(0.1, 0.9, (C, K))

    port_ab = []
    with monkeypatch.context() as mp:
        calls = iter([torch.tensor(ub), torch.tensor(ua)])
        mp.setattr(legacy_binary, "_uniform", lambda *a, **k: next(calls))
        got = legacy_binary.update_z_binary(None, tst, tdata, rho=0.8,
                                            beta=beta)
        mp.setattr(legacy_binary, "_rbeta", lambda g, a, b: (
            port_ab.append((a, b)) or torch.tensor(beta_draws)))
        pi = legacy_binary.update_pi_binary(None, got, alpha=1.5).pi
    assert torch.equal(pi, torch.tensor(beta_draws))
    moved = (got.Z != tst.Z).any(-1)
    assert 0 < int(moved.sum()) < C * N

    for c in range(C):
        ab = []
        with monkeypatch.context() as mp, jax.enable_x64(True):
            mp.setattr(jax.random, "split", lambda k, num=2: jnp.zeros(
                (num, 2), jnp.uint32))
            mp.setattr(jax.random, "bernoulli", lambda k, p=0.5, shape=None:
                       jnp.asarray(ub[c]) < p)
            mp.setattr(jax.random, "uniform", lambda k, shape=(), dtype=float:
                       jnp.asarray(ua[c]))
            mp.setattr(jax.random, "beta", lambda k, a, b: (
                ab.append((np.asarray(a), np.asarray(b)))
                or jnp.asarray(beta_draws[c])))
            js = jst[c].replace(Z=jnp.asarray(Zb[c]),
                                sigma2=jst[c].sigma2 * 4.0)
            want = jlegacy.update_z_binary(jnp.zeros(2, jnp.uint32), js,
                                           jdata, rho=0.8, beta=beta)
            jlegacy.update_pi_binary(jnp.zeros(2, jnp.uint32), want,
                                     alpha=1.5)
        assert np.array_equal(got.Z[c].numpy(), np.asarray(want.Z)), c
        for port, jax_ in zip(port_ab[0], ab[0]):
            np.testing.assert_allclose(port[c].numpy(), jax_, rtol=1e-12)


# ---------------------------------------------------------------------------
# Likelihood
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [0, 1])
def test_likelihood_functions_match_jax(D):
    """pointwise_log_density (C, N, L), marginal_covariance (C, L, L) and
    observation_marginal_loglik (C,) at every i equal the JAX functions on
    each chain's state, in float32, to LIK_RTOL (relative to the largest
    entry for the arrays)."""
    C, N, K = 3, 8, 2
    jdata, _ = jsim(seed=5, N=N, K=K, P=5, M=2, D=D, with_eta=D > 0,
                    with_xi=D > 0, n_time=(12, 15))
    tdata = convert.data_from_jax(jdata, device="cpu")
    st, jst, tst = _states(C, N, K, 5, 2, D, np.float32)
    tst = tst.replace(sigma2=tst.sigma2 * 10.0)
    jst = [s.replace(sigma2=s.sigma2 * 10.0) for s in jst]

    def close(got, want, what):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=LIK_RTOL,
                                   atol=LIK_RTOL * scale, err_msg=what)

    pld = likelihood.pointwise_log_density(tst, tdata).numpy()
    assert pld.shape == (C, N, tdata.L)
    for c in range(C):
        close(pld[c], np.asarray(jlik.pointwise_log_density(jst[c], jdata)),
              f"pointwise chain {c}")
    # the masked points give 0
    assert np.all(pld[:, tdata.mask.numpy() == 0] == 0.0)
    for i in range(N):
        cov = likelihood.marginal_covariance(tst, tdata, i).numpy()
        ml = likelihood.observation_marginal_loglik(tst, tdata, i).numpy()
        assert cov.shape == (C, tdata.L, tdata.L) and ml.shape == (C,)
        for c in range(C):
            close(cov[c], np.asarray(jlik.marginal_covariance(jst[c], jdata,
                                                              i)),
                  f"covariance chain {c} i {i}")
            np.testing.assert_allclose(
                ml[c], float(jlik.observation_marginal_loglik(jst[c], jdata,
                                                              i)),
                rtol=LIK_RTOL, err_msg=f"marginal chain {c} i {i}")


def test_observation_marginal_is_the_chi_integral():
    """The chi-integrated marginal of one observation, at M = 1, equals a
    quadrature of the conditional density over chi ~ N(0, 1) (float64)."""
    data, truth = simulate_functional(seed=9, N=4, K=2, P=5, M=1,
                                      n_time=(6, 8), sigma2=0.5,
                                      device="cpu", dtype=torch.float64)
    st = convert.state_from_numpy(truth, device="cpu", dtype=torch.float64)
    x, w = np.polynomial.hermite_e.hermegauss(80)
    lls = []
    for chi in x:
        s = st.replace(chi=torch.full_like(st.chi, float(chi)))
        lls.append(likelihood.pointwise_log_density(s, data)[0, 0].sum())
    quad = np.log(np.sum(w * np.exp(np.asarray(lls))) / np.sqrt(2 * np.pi))
    got = float(likelihood.observation_marginal_loglik(st, data, 0)[0])
    np.testing.assert_allclose(got, quad, rtol=1e-9)


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------

def test_trace_profile_writes_a_trace(tmp_path):
    with observability.trace_profile(str(tmp_path / "prof")) as prof:
        with observability.span("test.region", bytes=64):
            x = torch.randn(64, 64)
            (x @ x).sum()
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    events = trace["traceEvents"]
    matmul = [e for e in events if "matmul" in str(e.get("name", ""))]
    assert matmul
    assert len(prof.key_averages()) > 0
    # the program's span, on a track of its own around the matmul
    spans = [e for e in events if e.get("cat") == "span"]
    assert [(e["name"], e["ph"], e["args"]) for e in spans] == [
        ("test.region", "X", {"bytes": 64})]
    assert all(e["pid"] != spans[0]["pid"] for e in matmul)
    m = matmul[0]
    assert spans[0]["ts"] - 1e3 <= m["ts"] <= m["ts"] + m["dur"] \
        <= spans[0]["ts"] + spans[0]["dur"] + 1e3


def test_debug_nans_raises_in_backward_and_restores():
    prev = torch.is_anomaly_enabled()
    x = torch.zeros(3, requires_grad=True)
    with observability.debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.warns(UserWarning), \
                pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
    assert torch.is_anomaly_enabled() == prev
    # without it the NaN passes silently
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()
    assert torch.isnan(x.grad).all()
    # nested: off inside on, and back
    with observability.debug_nans(True):
        with observability.debug_nans(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == prev
