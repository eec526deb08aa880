"""Mean structure, likelihood and the joint Phi precision of the port
against the JAX package on the same states (3 chains, each a perturbed
simulation truth).  Tolerance: rtol 1e-5 in f32; absolute terms are scaled
by the magnitude of each quantity (the loglik sums ~300 terms)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.models import likelihood as jlik  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jgibbs  # noqa: E402
from bayesfmmm_tpu.ops import mean as jmean  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.models import likelihood as tlik  # noqa: E402
from bayesfmmm_torch.ops import gibbs as tgibbs  # noqa: E402
from bayesfmmm_torch.ops import mean as tmean  # noqa: E402

C = 3


@pytest.fixture(scope="module")
def case():
    jdata, truth = simulate_functional(seed=4, N=14, K=3, P=6, M=2,
                                       n_time=(18, 22))
    rng = np.random.default_rng(0)
    leaves = {}
    for f in ("Z", "pi", "alpha3", "nu", "tau", "sigma2", "chi", "Phi",
              "gamma", "delta", "A", "eta", "tau_eta", "xi", "gamma_xi",
              "delta_xi", "A_xi"):
        a = np.broadcast_to(np.asarray(getattr(truth, f)),
                            (C,) + np.shape(getattr(truth, f))).copy()
        if f in ("nu", "chi", "Phi"):
            a = a + 0.1 * rng.normal(size=a.shape)
        if f in ("sigma2", "gamma", "delta"):
            a = a * rng.uniform(0.5, 2.0, size=a.shape)
        leaves[f] = a.astype(np.float32)
    jstates = [jax.tree.map(lambda x, c=c: x[c],
                            type(truth)(**{k: jnp.asarray(v)
                                           for k, v in leaves.items()}))
               for c in range(C)]
    return jdata, jstates, convert.data_from_jax(jdata), \
        convert.state_from_numpy(leaves, chains=C)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("fn", ["effective_coeffs", "feature_offsets",
                                "eigen_directions"])
def test_mean_pieces_match_jax(case, fn):
    jdata, jstates, tdata, tstate = case
    got = getattr(tmean, fn)(tstate, tdata.X).numpy()
    for c in range(C):
        _close(got[c], getattr(jmean, fn)(jstates[c], jdata.X))


def test_mu_rss_loglik_match_jax(case):
    jdata, jstates, tdata, tstate = case
    mu = tmean.compute_mu(tdata, tstate).numpy()
    w = tmean.effective_coeffs(tstate, tdata.X)
    rss = tmean.rss_from_coeffs(tdata, w).numpy()
    rows = tmean.rss_rows_from_coeffs(tdata, w).numpy()
    ll = tlik.log_likelihood(tstate, tdata).numpy()
    assert ll.shape == (C,) and mu.shape == (C, tdata.N, tdata.L)
    for c in range(C):
        js = jstates[c]
        _close(mu[c], jmean.compute_mu(jdata, js))
        jw = jmean.effective_coeffs(js, jdata.X)
        _close(rss[c], jmean.rss_from_coeffs(jdata, jw))
        _close(rows[c], jmean.rss_rows_from_coeffs(jdata, jw))
        _close(ll[c], jlik.log_likelihood(js, jdata))


def test_joint_phi_precision_matches_jax(case, monkeypatch):
    """update_phi's joint precision A and linear term b, captured where
    each package hands them to its fused precision draw."""
    jdata, jstates, tdata, tstate = case
    seen = {"jax": [], "torch": []}

    def grab_jax(key, A, b, **kw):
        seen["jax"].append((np.asarray(A), np.asarray(b)))
        return jnp.zeros_like(b), jnp.zeros_like(b)

    def grab_torch(gen, A, b, **kw):
        seen["torch"].append((A.numpy(), b.numpy()))
        return torch.zeros_like(b), torch.zeros_like(b)

    monkeypatch.setattr(jgibbs, "mvn_from_precision_fused", grab_jax)
    monkeypatch.setattr(tgibbs, "mvn_from_precision_fused", grab_torch)
    for c in range(C):
        jgibbs.update_phi(jax.random.PRNGKey(0), jstates[c], jdata, None,
                          jmean.build_cache(jdata, jstates[c]), beta=0.7)
    tgibbs.update_phi(torch.Generator(), tstate, tdata, None,
                      tmean.build_cache(tdata, tstate), beta=0.7)
    (A_t, b_t), = seen["torch"]
    assert A_t.shape == (C, 36, 36)
    for c, (A_j, b_j) in enumerate(seen["jax"]):
        _close(A_t[c], A_j)
        _close(b_t[c], b_j)
