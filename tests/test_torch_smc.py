"""The port's adaptive tempered SMC against the JAX package's, on the CPU.

The deterministic helpers on identical inputs: systematic resampling's
ancestors for a given uniform (the JAX package's own, including a case
whose float32 cumulative sum ends below the last position, where both
gather the last particle), the ESS, the bisection for the next beta and the
stage's log-likelihood.  Then ports of test_samplers_advanced.py's SMC
tests, and ``fit_smc`` as a whole: its dict's layout equals the JAX
package's through ``convert``, and its statistics on the small protocol lie
inside the JAX limits of tests/data/torch_tempering_reference.json.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu import api as japi  # noqa: E402
from bayesfmmm_tpu.models.state import GibbsState as JState  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.samplers import smc as js  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig as TConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models.state import (  # noqa: E402
    STATE_FIELDS,
    init_state,
    take_chains,
)
from bayesfmmm_torch.samplers import smc as ts  # noqa: E402

from test_torch_tempering import _random_states  # noqa: E402

REFERENCE = Path(__file__).parent / "data" / "torch_tempering_reference.json"


def _log_weights():
    """Log-weight vectors: spread, peaked, flat, and a tail of tiny
    weights."""
    rng = np.random.default_rng(0)
    return [rng.normal(size=16).astype(np.float32) * 3,
            rng.normal(size=256).astype(np.float32) * 0.5,
            np.zeros(64, np.float32),
            np.log(np.asarray([0.5, 0.25, 0.125, 0.125], np.float32)),
            np.concatenate([np.zeros(3), np.full(61, -30.0)]).astype(
                np.float32)]


@pytest.mark.parametrize("case", range(5))
def test_resampling_ancestors_match_jax(case):
    """For the JAX package's own uniforms, the port's ancestors are JAX's
    searchsorted indices, and the particles they gather are the ones JAX's
    clamping gather takes."""
    lw = _log_weights()[case]
    N = len(lw)
    for i in range(6):
        key = jax.random.fold_in(jax.random.PRNGKey(case), i)
        janc = np.asarray(js.systematic_resample(key, jnp.asarray(lw)))
        u = float(jax.random.uniform(key))
        tanc = ts.resample_from_uniform(torch.tensor(u), torch.tensor(lw))
        np.testing.assert_array_equal(tanc.numpy(), janc)
        assert janc.max() <= N


def test_ancestor_past_the_last_particle_is_clamped():
    """A float32 cumulative sum that ends below the last position: both
    packages yield the index N there, and gathering with it takes the last
    particle, the JAX package's clamping gather and the port's take_chains
    alike (on the card an unclamped index would be a device assert)."""
    # flat weights over N particles and the largest uniform below 1: the
    # first N where both packages' float32 sums end below the last
    # position (they sum in different orders, so at some N only one does)
    u = np.nextafter(np.float32(1.0), np.float32(0.0))

    def port(n):
        return ts.resample_from_uniform(torch.tensor(u),
                                        torch.zeros(n, dtype=torch.float32))

    def jax_(n):
        """The JAX package's systematic_resample's body (smc.py:46-50) at
        the uniform u."""
        w = jax.nn.softmax(jnp.zeros(n, jnp.float32))
        return np.asarray(jnp.searchsorted(jnp.cumsum(w),
                                           (u + jnp.arange(n)) / n))

    # the JAX package compiles at every n: ask it only where the port ends
    # past the last particle
    N = next(n for n in range(3, 200)
             if port(n)[-1] == n and jax_(n)[-1] == n)
    tanc, janc = port(N), jax_(N)
    # (the other positions of flat weights at u near 1 sit within an ulp
    # of a cumulative weight, where the two sums' roundings decide: only
    # the last is compared)
    assert tanc[-1] == janc[-1] == N
    # gathering: JAX clamps, the port clamps
    d = _random_states(1, N, 4, 2, 3, 2, 0)
    jgot = np.asarray(jnp.asarray(d["sigma2"])[janc])
    st = convert.state_from_numpy(d, chains=N, device="cpu")
    got = take_chains(st, tanc).sigma2.numpy()
    assert got[-1] == jgot[-1] == d["sigma2"][-1]
    np.testing.assert_array_equal(got, d["sigma2"][np.minimum(tanc, N - 1)])


@pytest.mark.parametrize("case", range(5))
def test_ess_matches_jax(case):
    lw = _log_weights()[case]
    np.testing.assert_allclose(
        float(ts.ess_from_log_weights(torch.tensor(lw))),
        float(js.ess_from_log_weights(jnp.asarray(lw))), rtol=2e-6)


def _next_beta_f64(beta, ll, target, N):
    """The JAX package's bisection in float64 on the host."""
    c = ll.astype(np.float64) - ll.max()

    def cess(b):
        lw = (b - beta) * c
        w = np.exp(lw - lw.max())
        w /= w.sum()
        return 1.0 / np.sum(w * w) / N

    if cess(1.0) >= target:
        return 1.0
    lo, hi = beta, 1.0
    for _ in range(30):
        if hi - lo <= 1e-5:
            break
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if cess(mid) >= target else (lo, mid)
    return lo


@pytest.mark.parametrize("N", [16, 64, 256])
@pytest.mark.parametrize("beta", [0.0, 1e-4, 0.3, 0.97, 0.999])
@pytest.mark.parametrize("scale", [1.0, 50.0, 3000.0])
def test_next_beta_matches_jax(N, beta, scale):
    """The masked bisection on the device against the JAX while_loop and a
    float64 bisection, on loglik vectors of several spreads (small: few
    stages; large: many), at the targets the smoke and the tests use."""
    rng = np.random.default_rng(N + int(scale))
    ll = (rng.normal(size=N) * scale - 9000.0).astype(np.float32)
    for target in (0.5, 0.7):
        got = ts._next_beta(torch.tensor(beta, dtype=torch.float32),
                            torch.tensor(ll), target, N)
        want = js._next_beta(jnp.float32(beta), jnp.asarray(ll), target, N)
        exact = _next_beta_f64(float(np.float32(beta)), ll, target, N)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - exact) <= 2e-6, (N, beta, scale, target)
        if scale >= 50.0:
            assert float(got) == float(want), (N, beta, scale, target)
        else:
            # a spread of 1 under an offset of 9,000: the JAX package's
            # float32 product (beta' - beta) * loglik rounds by ~5e-4 and
            # moves its bisection by a few steps of 1e-5
            assert abs(float(want) - exact) <= 1e-4


def test_stage_loglik_matches_jax():
    jdata, _ = simulate_functional(seed=3, N=10, K=3, P=5, M=3,
                                   n_time=(12, 16))
    d = _random_states(2, 5, 10, 3, 5, 3, 0)
    jl = jax.vmap(lambda s: js._loglik(s, jdata))(
        JState(**{f: jnp.asarray(d[f]) for f in STATE_FIELDS}))
    tl = ts._loglik(convert.state_from_numpy(d, chains=5, device="cpu"),
                    convert.data_from_jax(jdata, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-6)


@pytest.fixture(scope="module")
def small():
    ref = json.loads(REFERENCE.read_text())["small"]
    p = ref["protocol"]["data"]
    jdata, _ = simulate_functional(seed=p["seed"], N=p["N"], K=p["K"],
                                   P=p["P"], M=p["M"],
                                   n_time=tuple(p["n_time"]))
    return ref, jdata, convert.data_from_jax(jdata, device="cpu")


def test_smc_anneals_to_posterior(small):
    """Port of test_samplers_advanced.py's test of the same name."""
    _, _, data = small
    g = torch.Generator().manual_seed(2)
    particles = init_state(g, TConfig(K=2, P=5, M=2), data, chains=16)
    res = ts.run_smc(g, particles, data, TPriors(), torch.full((2,), 10.0),
                     n_mutation_sweeps=2, target_cess=0.5, max_stages=200)
    assert float(res.final_beta) == 1.0
    assert res.n_stages >= 2
    assert np.isfinite(float(res.log_evidence))
    sig = res.particles.sigma2.numpy()
    assert np.isfinite(sig).all() and (sig > 0).all()


def test_smc_stops_at_max_stages(small):
    _, _, data = small
    g = torch.Generator().manual_seed(2)
    particles = init_state(g, TConfig(K=2, P=5, M=2), data, chains=8)
    res = ts.run_smc(g, particles, data, TPriors(), torch.full((2,), 10.0),
                     n_mutation_sweeps=1, max_stages=3)
    assert res.n_stages == 3 and float(res.final_beta) < 1.0


def test_systematic_resampling_unbiased():
    """Port of test_samplers_advanced.py's test of the same name."""
    g = torch.Generator().manual_seed(0)
    log_w = torch.log(torch.tensor([0.5, 0.25, 0.125, 0.125]))
    counts = np.zeros(4)
    for _ in range(200):
        anc = ts.systematic_resample(g, log_w).numpy()
        counts += np.bincount(anc, minlength=4)
    freq = counts / counts.sum()
    np.testing.assert_allclose(freq, [0.5, 0.25, 0.125, 0.125], atol=0.02)


def test_fit_smc_layout_and_statistics_match_jax(small):
    """fit_smc of both packages: the same dict through convert; the port's
    stage count, log-evidence and weighted sigma^2 on the small protocol
    inside the JAX package's limits (six JAX seeds), and beta at 1."""
    ref, jdata, tdata = small
    p = ref["protocol"]
    kw = dict(K=p["data"]["K"], M=p["data"]["M"], **p["smc"])
    res = api.fit_smc(data=tdata, seed=0, **kw)
    # the JAX package's run with its sweep replaced by the identity: only
    # its layout is compared here
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "sweep_full", lambda k, s, *a, **kw: s)
        jres = japi.fit_smc(data=jdata, seed=0, **dict(kw, n_particles=8))
    assert sorted(res) == sorted(jres)
    a, b = convert.smc_result_to_numpy(res), convert.smc_result_to_numpy(jres)
    assert sorted(a) == sorted(b)
    n = p["smc"]["n_particles"]
    for f in STATE_FIELDS:
        assert a["particles"][f].shape == (n,) + b["particles"][f].shape[1:]
        assert a["estimates"][f].shape == b["estimates"][f].shape, f
        assert a["particles"][f].dtype == b["particles"][f].dtype, f
        assert np.all(np.isfinite(a["particles"][f])), f
    assert a["weights"].shape == (n,) and a["weights"].dtype == np.float32
    np.testing.assert_allclose(a["weights"].sum(), 1.0, rtol=1e-5)
    assert res["config"] == TConfig(K=2, P=5, M=2)
    assert res["data"] is tdata and res["particles"].Z.shape == (n, 16, 2)
    np.testing.assert_allclose(
        a["estimates"]["sigma2"],
        np.sum(a["weights"] * a["particles"]["sigma2"]), rtol=1e-5)
    assert a["final_beta"] == 1.0
    lim = ref["smc"]
    s2 = float(np.sum(a["weights"].astype(np.float64)
                      * a["particles"]["sigma2"]))
    for stat, x in (("n_stages", a["n_stages"]),
                    ("log_evidence", a["log_evidence"]), ("sigma2", s2)):
        lo, hi = lim[stat]["limits"]
        assert lo <= x <= hi, (stat, x, lim[stat])


def test_fit_smc_builds_on_the_card_unless_told(small):
    """No device given: the data goes to the card, and without one that
    raises; device="cpu" runs on the CPU."""
    ref, jdata, tdata = small
    y = [np.asarray(r)[:int(m.sum())] for r, m in
         zip(tdata.y.numpy(), tdata.mask.numpy())]
    t = [np.linspace(0, 1, len(v)) for v in y]
    kw = dict(K=2, M=2, n_particles=4, internal_knots=[0.5],
              boundary_knots=[0, 1], basis_degree=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            api.fit_smc(y, t, **kw)
    res = api.fit_smc(y, t, device="cpu", **kw)
    assert res["data"].device.type == "cpu"
    assert res["final_beta"] == 1.0 and res["particles"].Z.shape == (4, 16, 2)
