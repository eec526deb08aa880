"""The port's covariate-adjusted models (eta in the mean, xi in the eigen
directions) against the JAX package's, on the CPU.

Deterministic pieces run on identical inputs made with numpy and must agree
to f32 rounding (2e-5 of the quantity's scale): the mean structure, RSS and
log-likelihood at D > 0, the gauge maps and prior, and, with the SAME noise
injected into both packages' normal draws, update_eta, the joint xi draw and
the sequential blocked scans of Phi and xi (so precision, linear term and the
(j, m, d) block layout are all held, not only shapes).  Each stochastic
updater runs from one fixed state, vmapped over 4000 keys in JAX and over
4000 chains in the port; mean and variance of every updated element, and the
acceptance rates, must agree within 5 combined standard errors (the rule of
test_torch_gibbs.py).  The recovery tests are the JAX package's own
(tests/test_kernels_recovery.py, tests/test_mgp_tower.py), with the chain
axis in the place of iterations where draws are independent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models.likelihood import (  # noqa: E402
    log_likelihood as jlog_likelihood)
from bayesfmmm_tpu.models.state import GibbsState as JState  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops import mean as jmean  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig as TConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS, init_state  # noqa: E402
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops import mean as tmean  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402
from bayesfmmm_torch.utils import simulate as tsimulate  # noqa: E402

from test_torch_gibbs import _moments_agree, _rates_agree  # noqa: E402

N_DRAWS = 4000
BETA = 0.7
F32_RTOL = 2e-5


def _random_states(seed, C, N, K, P, M, D):
    """C distinct chains' states (numpy, leading C), every field
    non-trivial."""
    rng = np.random.default_rng(seed)
    u = rng.uniform
    st = dict(
        Z=rng.dirichlet(np.ones(K), size=(C, N)),
        pi=rng.dirichlet(np.ones(K), size=C), alpha3=u(0.5, 2.0, C),
        nu=rng.normal(size=(C, K, P)), tau=u(0.5, 2.0, (C, K)),
        sigma2=u(0.01, 0.05, C), chi=rng.normal(size=(C, N, M)),
        Phi=0.5 * rng.normal(size=(C, K, P, M)),
        gamma=u(0.5, 2.0, (C, K, P, M)), delta=u(0.5, 2.0, (C, K, M)),
        A=u(1.0, 3.0, (C, K, 2)), eta=rng.normal(size=(C, K, P, D)),
        tau_eta=u(0.5, 2.0, (C, K, D)),
        xi=0.5 * rng.normal(size=(C, K, P, D, M)),
        gamma_xi=u(0.5, 2.0, (C, K, P, D, M)),
        delta_xi=u(0.5, 2.0, (C, K, M, D)), A_xi=u(1.0, 3.0, (C, K, 2, D)))
    return {f: np.asarray(v, np.float32) for f, v in st.items()}


def _jstate(d, i=None):
    return JState(**{f: jnp.asarray(d[f] if i is None else d[f][i])
                     for f in STATE_FIELDS})


def _close(port, ref, what, rtol=F32_RTOL):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, f"{what}: {port.shape} vs {ref.shape}"
    scale = np.max(np.abs(ref)) + 1.0
    err = np.max(np.abs(port - ref))
    assert err <= rtol * scale, f"{what}: max error {err} vs scale {scale}"


@pytest.fixture(scope="module")
def chains():
    """Five random chains at D = 2 on simulated data, in both packages."""
    jdata, _ = simulate_functional(seed=3, N=10, K=3, P=5, M=3, D=2,
                                   n_time=(12, 16), with_eta=True,
                                   with_xi=True)
    d = _random_states(0, 5, 10, 3, 5, 3, 2)
    return jdata, convert.data_from_jax(jdata, device="cpu"), d, \
        convert.state_from_numpy(d, chains=5, device="cpu")


@pytest.fixture(scope="module")
def case():
    """A small covariate-adjusted model (N=10, K=2, P=5, M=2, D=2) at a
    perturbed truth: both MGP towers, A and tau_eta away from 1."""
    jdata, truth = simulate_functional(seed=2, N=10, K=2, P=5, M=2, D=2,
                                       n_time=(12, 16), with_eta=True,
                                       with_xi=True)
    rng = np.random.default_rng(1)
    u = lambda *shape: rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    js = truth.replace(
        sigma2=np.float32(0.02), alpha3=np.float32(1.5),
        pi=np.asarray([0.4, 0.6], np.float32), delta=u(2, 2),
        A=np.asarray([[1.5, 2.5], [2.0, 3.0]], np.float32),
        gamma=u(2, 5, 2), tau_eta=u(2, 2), delta_xi=u(2, 2, 2),
        gamma_xi=u(2, 5, 2, 2), A_xi=1.0 + u(2, 2, 2))
    js = jax.tree.map(jnp.asarray, js)
    return jdata, js, convert.data_from_jax(jdata, device="cpu"), \
        convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                 chains=N_DRAWS, device="cpu")


# ---------------------------------------------------------------------------
# Deterministic pieces on identical inputs
# ---------------------------------------------------------------------------

def test_simulator_with_covariates_is_bit_equal():
    kw = dict(seed=5, N=7, K=2, P=5, M=2, D=2, n_time=(9, 12), with_eta=True,
              with_xi=True)
    jdata, jtruth = simulate_functional(**kw)
    tdata, ttruth = tsimulate.simulate_functional(device="cpu", **kw)
    for f in ("y", "mask", "B", "X", "G", "pen", "u", "yy"):
        np.testing.assert_array_equal(getattr(tdata, f).numpy(),
                                      np.asarray(getattr(jdata, f)), f)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(ttruth[f], np.asarray(getattr(jtruth,
                                                                    f)), f)
    assert tdata.D == 2 and np.abs(ttruth["xi"]).max() > 0


@pytest.mark.parametrize("what", ["effective_coeffs", "feature_offsets",
                                  "eigen_directions", "compute_mu",
                                  "rss_from_coeffs", "rss_rows_from_coeffs",
                                  "log_likelihood"])
def test_mean_structure_with_covariates_matches_jax(chains, what):
    jdata, tdata, d, ts = chains
    if what == "log_likelihood":
        jout = jax.vmap(lambda s: jlog_likelihood(s, jdata))(_jstate(d))
        tout = log_likelihood(ts, tdata)
    elif what in ("effective_coeffs", "feature_offsets", "eigen_directions"):
        jout = jax.vmap(lambda s: getattr(jmean, what)(s, jdata.X))(
            _jstate(d))
        tout = getattr(tmean, what)(ts, tdata.X)
    elif what == "compute_mu":
        jout = jax.vmap(lambda s: jmean.compute_mu(jdata, s))(_jstate(d))
        tout = tmean.compute_mu(tdata, ts)
    else:
        jw = jax.vmap(lambda s: jmean.effective_coeffs(s, jdata.X))(
            _jstate(d))
        jout = jax.vmap(lambda w: getattr(jmean, what)(jdata, w))(jw)
        tout = getattr(tmean, what)(tdata, tmean.effective_coeffs(ts,
                                                                  tdata.X))
    _close(tout.numpy(), jout, what)


def test_gauge_maps_and_prior_with_covariates_match_jax(chains):
    jdata, tdata, d, ts = chains
    C, K, M = 5, 3, 3
    rng = np.random.default_rng(4)
    a, b = np.array([0, 1, 2, 0, 2]), np.array([1, 2, 0, 2, 1])
    eps = rng.normal(0, 0.3, C).astype(np.float32)
    m, m2 = np.array([0, 2, 1, 1, 0]), np.array([1, 0, 2, 0, 2])
    theta = rng.normal(0, 0.5, C).astype(np.float32)
    eyeK, eyeM = np.eye(K, dtype=np.float32), np.eye(M, dtype=np.float32)
    hp = Priors()

    def jmap(fn, *args):
        return jax.vmap(fn)(_jstate(d), *map(jnp.asarray, args))

    jout = {
        "mix": jmap(lambda s, ea, eb, e: jg._mix_features(s, jdata, ea, eb,
                                                          e),
                    eyeK[a], eyeK[b], eps),
        "scale": jmap(lambda s, em, ls: jg._rescale_eigen(s, jdata, em, ls),
                      eyeM[m], eps),
        "rotate": jmap(lambda s, i, j, t: jg._rotate_eigen(s, jdata, i, j, t),
                       m, m2, theta),
    }
    t = torch.from_numpy
    tout = {
        "mix": tg._mix_features(ts, tdata, t(eyeK[a]), t(eyeK[b]), t(eps)),
        "scale": tg._rescale_eigen(ts, tdata, t(eyeM[m]), t(eps)),
        "rotate": tg._rotate_eigen(ts, tdata, t(m), t(m2), t(theta)),
    }
    _close(tg._gauge_logprior(ts, tdata, TPriors()).numpy(),
           jax.vmap(lambda s: jg._gauge_logprior(s, jdata, hp))(_jstate(d)),
           "gauge log prior")
    mu0 = tmean.compute_mu(tdata, ts)
    for name in ("mix", "scale", "rotate"):
        for f in ("Z", "nu", "Phi", "chi", "eta", "xi"):
            _close(getattr(tout[name], f).numpy(),
                   getattr(jout[name], f), f"{name} {f}")
        # each map leaves the model mean where it was, covariate terms too
        assert float((tmean.compute_mu(tdata, tout[name]) - mu0).abs().max()
                     ) < 2e-4 * float(mu0.abs().max())


def _fixed_noise(shape):
    """Standard normal numbers that depend on the number of elements only:
    the port's (1, D) draw and the JAX package's (D,) draw get the same."""
    n = int(np.prod(shape))
    return np.random.default_rng(1000 + n).normal(size=n).astype(
        np.float32).reshape(shape)


@pytest.fixture
def injected_noise(monkeypatch):
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
            _fixed_noise(shape), dtype))
    monkeypatch.setattr(
        torch, "randn",
        lambda shape, generator=None, dtype=None, device=None:
        torch.from_numpy(_fixed_noise(tuple(shape))).to(dtype))


@pytest.mark.parametrize("name,field,joint_max", [
    ("update_eta", "eta", None), ("update_xi", "xi", None),
    ("update_xi", "xi", 0), ("update_phi", "Phi", 0),
    ("update_phi", "Phi", None), ("update_nu", "nu", None)])
def test_blocked_draws_with_injected_noise_match_jax(chains, injected_noise,
                                                     monkeypatch, name,
                                                     field, joint_max):
    """One chain at a time, the same noise in both packages: the draw, and
    the running coefficients it leaves, agree to f32 rounding.  joint_max=0
    sends Phi and xi through the sequential blocked scan."""
    jdata, tdata, d, _ = chains
    if joint_max is not None:
        monkeypatch.setattr(jg, "_JOINT_MAX_DIM", joint_max)
        monkeypatch.setattr(tg, "_JOINT_MAX_DIM", joint_max)
    for i in range(2):
        js = _jstate(d, i)
        jnew, jc = getattr(jg, name)(jax.random.PRNGKey(0), js, jdata,
                                     Priors(), jcache(jdata, js), BETA)
        ts = convert.state_from_numpy({f: d[f][i] for f in STATE_FIELDS},
                                      chains=1, device="cpu")
        tnew, tc = getattr(tg, name)(None, ts, tdata, TPriors(),
                                     tcache(tdata, ts), BETA)
        # the conditional is tight (sigma2 ~ 0.03): hold the draw to the
        # rounding of its (D x D) solve, 2e-4 of its scale
        _close(getattr(tnew, field)[0].numpy(), getattr(jnew, field),
               f"{name} {field}", rtol=2e-4)
        _close(tc.w[0].numpy(), jc.w, f"{name} cache", rtol=2e-4)
        assert float((getattr(tnew, field) - getattr(ts, field)).abs().max()
                     ) > 1e-3


def test_sequential_scan_targets_the_joint_conditional(chains, monkeypatch):
    """With the noise at zero the joint draw returns the conditional mean of
    all blocks; sweeping the sequential scan from there must stay there (the
    joint mean is the fixed point of the blockwise conditional means)."""
    _, tdata, d, ts = chains
    monkeypatch.setattr(torch, "randn",
                        lambda shape, generator=None, dtype=None, device=None:
                        torch.zeros(tuple(shape), dtype=dtype))
    for name, field in (("update_phi", "Phi"), ("update_xi", "xi")):
        joint, _ = getattr(tg, name)(None, ts, tdata, TPriors(),
                                     tcache(tdata, ts), BETA)
        monkeypatch.setattr(tg, "_JOINT_MAX_DIM", 0)
        again, _ = getattr(tg, name)(None, joint, tdata, TPriors(),
                                     tcache(tdata, joint), BETA)
        monkeypatch.undo()
        monkeypatch.setattr(
            torch, "randn",
            lambda shape, generator=None, dtype=None, device=None:
            torch.zeros(tuple(shape), dtype=dtype))
        _close(getattr(again, field).numpy(), getattr(joint, field).numpy(),
               f"{name} fixed point", rtol=5e-4)


def test_joint_xi_draw_keeps_its_weak_columns_under_a_collapsed_tower(
        chains, monkeypatch):
    """xi's joint draw with its MGP tower collapsed past the first column
    (delta_xi 1e15 there, so the precision's diagonal spans ~15 orders of
    magnitude): the ridge stays at a thousandth of the smallest diagonal
    entry (``distributions.jitter_eps``), and with the noise at zero the
    draw is the float64 conditional mean to 1 % on the weakly penalised
    coordinates.  The uncapped contract, a millionth of the diagonal's
    mean, would have drawn those coordinates to zero: the collapse it
    feeds."""
    _, tdata, _, ts = chains
    delta_xi = ts.delta_xi.clone()
    delta_xi[:, :, 1] = 1e15
    ts = ts.replace(delta_xi=delta_xi)
    seen = {}
    real_eps, real_draw = tg.jitter_eps, tg.mvn_from_precision_fused

    def eps_of(diag, jitter):
        seen["eps"] = real_eps(diag, jitter)
        return seen["eps"]

    def draw(generator, A, b, *, jitter):
        seen.update(A=A.clone(), b=b.clone(), jitter=jitter)
        seen["out"] = real_draw(generator, A, b, jitter=jitter)
        return seen["out"]

    monkeypatch.setattr(tg, "jitter_eps", eps_of)
    monkeypatch.setattr(tg, "mvn_from_precision_fused", draw)
    monkeypatch.setattr(torch, "randn",
                        lambda shape, generator=None, dtype=None, device=None:
                        torch.zeros(tuple(shape), dtype=dtype))
    tg.update_xi(None, ts, tdata, TPriors(), tcache(tdata, ts), BETA)
    assert seen["jitter"] == 0.0          # K1 adds no ridge of its own
    eps = seen["eps"].double()
    A = seen["A"].double() - torch.diag_embed(
        eps[:, None].expand(seen["A"].shape[:-1]))
    diag = A.diagonal(dim1=-2, dim2=-1)
    assert float(diag.amax() / diag.amin()) > 1e12
    assert bool((eps <= 1.01e-3 * diag.amin(-1)).all())
    b = seen["b"].double()[..., None]
    exact = torch.linalg.solve(A, b)[..., 0]
    uncapped = torch.linalg.solve(A + torch.diag_embed(
        1e-6 * (diag.mean(-1, keepdim=True) + 1.0).expand_as(diag)), b)[..., 0]
    weak = diag < 1e6
    scale = exact[weak].abs().max()
    port = seen["out"][0].double()
    assert float((port - exact)[weak].abs().max()) <= 1e-2 * scale
    assert float((uncapped - exact)[weak].abs().max()) >= 0.5 * scale


# ---------------------------------------------------------------------------
# Updaters by moments and acceptance, against their vmapped JAX twins
# ---------------------------------------------------------------------------

def _moved(out, cur):
    return (out != cur[None]).reshape(len(out), -1).astype(float)


def _with_cache(name, **kw):
    return (lambda k, s, d: getattr(jg, name)(k, s, d, Priors(), jcache(d, s),
                                              BETA, **kw)[0],
            lambda g, s, d: getattr(tg, name)(g, s, d, TPriors(),
                                              tcache(d, s), BETA, **kw)[0])


# name -> (JAX call, port call, fields compared, rates)
_UPDATERS = {
    "eta": (*_with_cache("update_eta"), ("eta",), {}),
    "tau_eta": (lambda k, s, d: jg.update_tau_eta(k, s, d, Priors()),
                lambda g, s, d: tg.update_tau_eta(g, s, d, TPriors()),
                ("tau_eta",), {}),
    "xi": (*_with_cache("update_xi"), ("xi",), {}),
    "delta_xi": (lambda k, s, d: jg.update_delta_xi(k, s, Priors()),
                 lambda g, s, d: tg.update_delta_xi(g, s, TPriors()),
                 ("delta_xi",), {}),
    "gamma_xi": (lambda k, s, d: jg.update_gamma_xi(k, s, Priors()),
                 lambda g, s, d: tg.update_gamma_xi(g, s, TPriors()),
                 ("gamma_xi",), {}),
    "a_xi": (lambda k, s, d: jg.update_a_xi(k, s, Priors()),
             lambda g, s, d: tg.update_a_xi(g, s, TPriors()),
             ("A_xi",), {"A_xi": lambda o, c: _moved(o["A_xi"], c["A_xi"])}),
    "z": (*_with_cache("update_z"), ("Z",),
          {"Z row": lambda o, c: (o["Z"] != c["Z"][None]).any(-1)}),
    "chi": (*_with_cache("update_chi"), ("chi",), {}),
    "phi": (*_with_cache("update_phi"), ("Phi",), {}),
    "nu": (*_with_cache("update_nu"), ("nu",), {}),
    "z_chi": (*_with_cache("update_z_chi", p_indep=0.3), ("Z", "chi"),
              {"Z row": lambda o, c: (o["Z"] != c["Z"][None]).any(-1)}),
    "chi_joint": (*_with_cache("update_chi_joint"), ("chi",), {}),
    "gauge": (lambda k, s, d: jg.update_gauge(k, s, d, Priors()),
              lambda g, s, d: tg.update_gauge(g, s, d, TPriors()),
              ("Z", "nu", "Phi", "chi", "eta", "xi"),
              {"mix": lambda o, c: (o["eta"] != c["eta"][None]).any((1, 2, 3)),
               "any": lambda o, c: (o["xi"] != c["xi"][None]).any(
                   (1, 2, 3, 4))}),
    "mgp_scale": (*_with_cache("update_mgp_scale"), ("Phi", "delta"),
                  {"delta": lambda o, c: _moved(o["delta"], c["delta"])}),
    "noise_scale": (*_with_cache("update_noise_scale"),
                    ("sigma2", "Phi", "delta", "xi", "delta_xi"),
                    {"sigma2": lambda o, c: _moved(o["sigma2"],
                                                   c["sigma2"])}),
    "phi_mala": (*_with_cache("update_phi_mala", step=0.05, n_steps=4),
                 ("Phi", "chi"),
                 {"Phi": lambda o, c: (o["Phi"] != c["Phi"][None]).any(
                     (1, 2, 3))}),
}


@pytest.mark.parametrize("name", list(_UPDATERS))
def test_covariate_updater_moments_match_jax(case, name):
    jdata, js, tdata, ts = case
    jfn, tfn, fields, rates = _UPDATERS[name]
    keys = jax.random.split(jax.random.PRNGKey(17), N_DRAWS)
    jout = jax.jit(jax.vmap(
        lambda k: {f: getattr(jfn(k, js, jdata), f) for f in fields}))(keys)
    jout = {f: np.asarray(v) for f, v in jout.items()}
    g = torch.Generator().manual_seed(17)
    tst = tfn(g, ts, tdata)
    tout = {f: getattr(tst, f).numpy() for f in fields}
    for f in fields:
        assert tout[f].shape == jout[f].shape, f
        assert np.all(np.isfinite(tout[f])) and np.all(np.isfinite(jout[f]))
        _moments_agree(jout[f], tout[f], f"{name} {f}")
    cur = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    for rname, fn in rates.items():
        ja = np.asarray(fn(jout, cur), float).reshape(N_DRAWS, -1)
        ta = np.asarray(fn(tout, cur), float).reshape(N_DRAWS, -1)
        assert 0.0 < ta.mean() and 0.0 < ja.mean(), f"{name} {rname}"
        _rates_agree(ja, ta, f"{name} {rname}")
    assert all(not getattr(tst, f).requires_grad for f in STATE_FIELDS)


def test_mala_holds_no_graph_of_xi_across_steps(case):
    """Phi is the variable of the move and xi a constant of it: with xi
    attached to a graph on entry, nothing that leaves update_phi_mala is."""
    _, _, tdata, ts = case
    st = ts.replace(**{f: getattr(ts, f)[:3] for f in STATE_FIELDS})
    st = st.replace(xi=st.xi.clone().requires_grad_())
    out, cache = tg.update_phi_mala(torch.Generator().manual_seed(0), st,
                                    tdata, TPriors(), tcache(tdata, st), BETA)
    assert not out.Phi.requires_grad and not out.chi.requires_grad
    assert not cache.w.requires_grad


# ---------------------------------------------------------------------------
# Recovery, as the JAX package tests it
# ---------------------------------------------------------------------------

def _recover(name, field, sim, atol, chains=64, iters=25, joint_max=None,
             monkeypatch=None):
    """The updater alone from the truth, everything else held there: the
    median over the chains' last draws recovers the truth's block."""
    data, truth = tsimulate.simulate_functional(device="cpu", **sim)
    if joint_max is not None:
        monkeypatch.setattr(tg, "_JOINT_MAX_DIM", joint_max)
    st = convert.state_from_numpy(truth, chains=chains, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(iters):
        st = getattr(tg, name)(g, st, data, TPriors(), tcache(data, st))[0]
    med = np.median(getattr(st, field).numpy(), axis=0)
    np.testing.assert_allclose(med, truth[field], atol=atol)


_ETA_SIM = dict(seed=3, N=60, K=2, P=8, M=2, D=2, with_eta=True)
_XI_SIM = dict(seed=4, N=60, K=2, P=8, M=2, D=1, with_eta=True, with_xi=True)


def test_eta_recovery():
    _recover("update_eta", "eta", _ETA_SIM, 0.3)


def test_xi_recovery():
    _recover("update_xi", "xi", _XI_SIM, 0.35)


def test_xi_recovery_sequential_fallback(monkeypatch):
    _recover("update_xi", "xi", _XI_SIM, 0.35, joint_max=0,
             monkeypatch=monkeypatch)


def test_phi_recovery_sequential_fallback(monkeypatch):
    _recover("update_phi", "Phi", dict(seed=1, N=40, K=3, P=8, M=2), 0.3,
             joint_max=0, monkeypatch=monkeypatch)


def _tower_state(K, P, M, D, chains, **fields):
    data, _ = tsimulate.simulate_functional(seed=0, N=4, K=K, P=max(P, 4),
                                            M=M, D=D, n_time=(6, 8),
                                            device="cpu")
    st = init_state(torch.Generator().manual_seed(0),
                    TConfig(K=K, P=P, M=M, D=D, covariate_mean=D > 0,
                            covariate_cov=D > 0), data, chains=chains)
    return st.replace(**{f: torch.from_numpy(np.broadcast_to(
        v, (chains,) + v.shape).copy()) for f, v in fields.items()})


def test_gamma_xi_recovery():
    """tests/test_mgp_tower.py::test_gamma_xi_recovery: xi redrawn from its
    prior at the truth in every one of 10,000 chains, one update each."""
    K, P, M, D, C = 2, 6, 2, 2, 10000
    rng = np.random.default_rng(13)
    gamma_truth = rng.gamma(0.5, 2.0, size=(K, P, D, M)).astype(np.float32)
    delta_truth = np.broadcast_to(
        np.array([2.0, 3.0], np.float32)[None, :, None], (K, M, D)).copy()
    tilde = np.cumprod(delta_truth, axis=1)
    sd = (1.0 / np.sqrt(gamma_truth
                        * tilde.transpose(0, 2, 1)[:, None])).astype(
        np.float32)
    g = torch.Generator().manual_seed(0)
    st = _tower_state(K, P, M, D, C, delta_xi=delta_truth)
    st = st.replace(xi=torch.from_numpy(sd) * torch.randn(
        (C,) + sd.shape, generator=g))
    out = tg.update_gamma_xi(g, st, TPriors(nu_1=0.001))
    np.testing.assert_allclose(np.median(out.gamma_xi.numpy(), axis=0),
                               gamma_truth, atol=0.5)


def test_delta_xi_recovery():
    K, P, M, D, C = 2, 6, 4, 2, 10000
    rng = np.random.default_rng(14)
    delta_truth = np.clip(rng.gamma(2.0, 1.0, size=(K, M, D)),
                          0.5, 4.0).astype(np.float32)
    gamma_truth = rng.gamma(1.5, 1.0 / 1.5,
                            size=(K, P, D, M)).astype(np.float32)
    tilde = np.cumprod(delta_truth, axis=1)
    sd = (1.0 / np.sqrt(gamma_truth
                        * tilde.transpose(0, 2, 1)[:, None])).astype(
        np.float32)
    g = torch.Generator().manual_seed(0)
    # the JAX test runs one chain: delta_xi carries over while xi is redrawn
    # at the truth; here 200 chains of 50 such iterations each
    st = _tower_state(K, P, M, D, 200, gamma_xi=gamma_truth,
                      A_xi=np.full((K, 2, D), 2.0, np.float32))
    draws = []
    for _ in range(50):
        st = st.replace(xi=torch.from_numpy(sd) * torch.randn(
            (200,) + sd.shape, generator=g))
        st = tg.update_delta_xi(g, st, TPriors())
        draws.append(st.delta_xi.numpy())
    med = np.median(np.concatenate(draws[10:]), axis=0)
    np.testing.assert_allclose(med, delta_truth, atol=2.0)
    assert abs(np.mean(med - delta_truth)) < 0.5


def test_a_xi_recovery():
    K, M, D = 2, 5, 2
    delta_xi = np.broadcast_to(
        np.array([2.0, 3.0, 3.0, 3.0, 3.0], np.float32)[None, :, None],
        (K, M, D)).copy()
    hp = TPriors(alpha1l=2.0, beta1l=1.0, alpha2l=3.0, beta2l=1.0)
    g = torch.Generator().manual_seed(0)
    st = _tower_state(K, 6, M, D, 50, delta_xi=delta_xi)
    draws = []
    for _ in range(200):
        st = tg.update_a_xi(g, st, hp)
        draws.append(st.A_xi.numpy())
    med = np.median(np.concatenate(draws[50:]), axis=0)
    expected = np.broadcast_to(
        np.array([2.0, 3.0], np.float32)[None, :, None], (K, 2, D))
    np.testing.assert_allclose(med, expected, atol=0.5)
