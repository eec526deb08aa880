"""Each updater of the port's reference census against the JAX package's,
by moments.

From one fixed state, the JAX updater runs vmapped over 4000 keys and the
port's over 4000 chains; the mean and variance of every element of the
updated block must agree within 5 combined standard errors, and for the MH
updaters (z, pi, alpha3, A) so must the acceptance rate.  The two packages
draw different random numbers, so draws are never compared one to one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402

N_DRAWS = 4000
BETA = 0.7      # data-likelihood updaters run tempered, to cover beta

# name -> (updated field, MH?, JAX call, port call[, {field: new value as a
# function of the fixture's}])
_UPDATERS = {
    # one Z row on the simplex boundary exercises the auto-accept rule
    "z": ("Z", True,
          lambda k, s, d, c: jg.update_z(k, s, d, Priors(), jcache(d, s),
                                         BETA)[0],
          lambda g, s, d, c: tg.update_z(g, s, d, TPriors(), tcache(d, s),
                                         BETA)[0],
          {"Z": lambda Z: np.concatenate([[[1.0, 0.0]], Z[1:]])}),
    "pi": ("pi", True,
           lambda k, s, d, c: jg.update_pi(k, s, Priors(), c),
           lambda g, s, d, c: tg.update_pi(g, s, TPriors(), c)),
    "alpha3": ("alpha3", True,
               lambda k, s, d, c: jg.update_alpha3(k, s, Priors()),
               lambda g, s, d, c: tg.update_alpha3(g, s, TPriors())),
    # near 0 the proposal's truncation carries real mass (Phi(1) = 0.84), so
    # the inverse-CDF truncated normal is exercised where truncation matters
    "alpha3_near_0": ("alpha3", True,
                      lambda k, s, d, c: jg.update_alpha3(k, s, Priors()),
                      lambda g, s, d, c: tg.update_alpha3(g, s, TPriors()),
                      {"alpha3": lambda a: 0.05}),
    "phi": ("Phi", False,
            lambda k, s, d, c: jg.update_phi(k, s, d, Priors(), jcache(d, s),
                                             BETA)[0],
            lambda g, s, d, c: tg.update_phi(g, s, d, TPriors(),
                                             tcache(d, s), BETA)[0]),
    "delta": ("delta", False,
              lambda k, s, d, c: jg.update_delta(k, s, Priors()),
              lambda g, s, d, c: tg.update_delta(g, s, TPriors())),
    "a": ("A", True,
          lambda k, s, d, c: jg.update_a(k, s, Priors()),
          lambda g, s, d, c: tg.update_a(g, s, TPriors())),
    "gamma": ("gamma", False,
              lambda k, s, d, c: jg.update_gamma(k, s, Priors()),
              lambda g, s, d, c: tg.update_gamma(g, s, TPriors())),
    "nu": ("nu", False,
           lambda k, s, d, c: jg.update_nu(k, s, d, Priors(), jcache(d, s),
                                           BETA)[0],
           lambda g, s, d, c: tg.update_nu(g, s, d, TPriors(), tcache(d, s),
                                           BETA)[0]),
    "tau": ("tau", False,
            lambda k, s, d, c: jg.update_tau(k, s, d, Priors()),
            lambda g, s, d, c: tg.update_tau(g, s, d, TPriors())),
    "sigma": ("sigma2", False,
              lambda k, s, d, c: jg.update_sigma(k, s, d, Priors(),
                                                 jcache(d, s), BETA),
              lambda g, s, d, c: tg.update_sigma(g, s, d, TPriors(),
                                                 tcache(d, s), BETA)),
    "chi": ("chi", False,
            lambda k, s, d, c: jg.update_chi(k, s, d, Priors(), jcache(d, s),
                                             BETA)[0],
            lambda g, s, d, c: tg.update_chi(g, s, d, TPriors(),
                                             tcache(d, s), BETA)[0]),
}


@pytest.fixture(scope="module")
def case():
    """Small model at a perturbed truth: delta, A and sigma2 away from 1 so
    the MGP and noise updaters see a non-trivial state."""
    jdata, truth = simulate_functional(seed=2, N=10, K=2, P=5, M=2,
                                       n_time=(12, 16))
    rng = np.random.default_rng(1)
    js = truth.replace(
        sigma2=np.float32(0.02), alpha3=np.float32(1.5),
        pi=np.asarray([0.4, 0.6], np.float32),
        delta=rng.uniform(0.5, 2.0, size=(2, 2)).astype(np.float32),
        A=np.asarray([[1.5, 2.5], [2.0, 3.0]], np.float32),
        gamma=rng.uniform(0.5, 2.0, size=(2, 5, 2)).astype(np.float32))
    js = jax.tree.map(jnp.asarray, js)
    return jdata, js, convert.data_from_jax(jdata, device="cpu"), \
        convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                 chains=N_DRAWS, device="cpu")


def _moments_agree(a, b, what):
    a = a.reshape(len(a), -1).astype(np.float64)
    b = b.reshape(len(b), -1).astype(np.float64)
    n = len(a)
    for name, xa, xb in (("mean", a, b),
                         ("variance", (a - a.mean(0)) ** 2,
                          (b - b.mean(0)) ** 2)):
        se = np.sqrt(xa.var(0) / n + xb.var(0) / n)
        diff = np.abs(xa.mean(0) - xb.mean(0))
        tol = 5.0 * se + 1e-6 * (1.0 + np.abs(xa.mean(0)))
        bad = np.flatnonzero(diff > tol)
        assert bad.size == 0, (f"{what}: {name} differs at {bad[:5]}: "
                               f"{xa.mean(0)[bad[:5]]} vs "
                               f"{xb.mean(0)[bad[:5]]} (se {se[bad[:5]]})")


def _rates_agree(a, b, what):
    n = len(a)
    p = 0.5 * (a.mean(0) + b.mean(0))
    se = np.sqrt(2.0 * p * (1.0 - p) / n)
    diff = np.abs(a.mean(0) - b.mean(0))
    assert np.all(diff <= 5.0 * se + 1e-9), \
        f"{what}: acceptance {a.mean(0)} vs {b.mean(0)}"


@pytest.mark.parametrize("name", list(_UPDATERS))
def test_updater_moments_match_jax(case, name):
    jdata, js, tdata, ts = case
    field, is_mh, jfn, tfn, *over = _UPDATERS[name]
    for f, fn in (over[0] if over else {}).items():
        v = np.asarray(fn(np.asarray(getattr(js, f))), np.float32)
        js = js.replace(**{f: jnp.asarray(v)})
        ts = ts.replace(**{f: torch.from_numpy(v).expand_as(getattr(ts, f))})
    c = 10.0 * np.ones(2, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), N_DRAWS)
    jout = jax.jit(jax.vmap(lambda k: getattr(jfn(k, js, jdata, c), field)))(
        keys)
    jout = np.asarray(jout)
    g = torch.Generator().manual_seed(11)
    tout = getattr(tfn(g, ts, tdata, torch.from_numpy(c)), field).numpy()
    assert tout.shape == jout.shape
    assert np.all(np.isfinite(tout)) == np.all(np.isfinite(jout))
    _moments_agree(jout, tout, name)
    if is_mh:
        cur = np.asarray(getattr(js, field))
        moved = (lambda x: (x != cur).reshape(N_DRAWS, *cur.shape))
        ja, ta = moved(jout), moved(tout)
        if name == "z":      # a row moves as a whole
            ja, ta = ja.any(-1), ta.any(-1)
            assert ja[:, 0].all() and ta[:, 0].all()   # boundary row
        _rates_agree(ja.reshape(N_DRAWS, -1).astype(float),
                     ta.reshape(N_DRAWS, -1).astype(float), name)
