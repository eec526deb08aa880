"""The port's production census against the JAX package's.

Deterministic pieces run on identical inputs made with numpy and must agree
to f32 rounding: the gauge maps and prior, the noise-scale acceptance, the
chi-marginal row statistics (against the JAX package's entries form of the
small linalg) and the MALA potential with its gradient (against
jax.value_and_grad).  Each stochastic updater runs from one fixed state,
vmapped over 4000 keys in JAX and over 4000 chains in the port; the mean
and variance of every updated element, and the acceptance rates, must
agree within 5 combined standard errors (the rule of test_torch_gibbs.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models.state import GibbsState as JState  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops import linalg as jl  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig as TConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import (  # noqa: E402
    STATE_FIELDS,
    init_state,
)
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops.mean import (  # noqa: E402
    compute_mu,
    effective_coeffs,
    eigen_directions,
)
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402
from bayesfmmm_torch.utils import simulate as tsimulate  # noqa: E402

from test_torch_gibbs import _moments_agree, _rates_agree  # noqa: E402

N_DRAWS = 4000
BETA = 0.7
# f32 rounding of a few hundred products, relative to the quantity's scale
F32_RTOL = 2e-5


@pytest.fixture(scope="module")
def case():
    """test_torch_gibbs.py's small model at a perturbed truth (N=10, K=2,
    P=5, M=2)."""
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


def _random_states(seed, C, N, K, P, M):
    """C distinct chains' states (numpy, leading C), every field
    non-trivial; D = 0."""
    rng = np.random.default_rng(seed)
    u = rng.uniform
    st = dict(
        Z=rng.dirichlet(np.ones(K), size=(C, N)), pi=rng.dirichlet(
            np.ones(K), size=C), alpha3=u(0.5, 2.0, C),
        nu=rng.normal(size=(C, K, P)), tau=u(0.5, 2.0, (C, K)),
        sigma2=u(0.01, 0.05, C), chi=rng.normal(size=(C, N, M)),
        Phi=0.5 * rng.normal(size=(C, K, P, M)),
        gamma=u(0.5, 2.0, (C, K, P, M)), delta=u(0.5, 2.0, (C, K, M)),
        A=u(1.0, 3.0, (C, K, 2)), eta=np.zeros((C, K, P, 0)),
        tau_eta=np.ones((C, K, 0)), xi=np.zeros((C, K, P, 0, M)),
        gamma_xi=np.ones((C, K, P, 0, M)), delta_xi=np.ones((C, K, M, 0)),
        A_xi=np.ones((C, K, 2, 0)))
    return {f: np.asarray(v, np.float32) for f, v in st.items()}


def _jstate(d):
    return JState(**{f: jnp.asarray(d[f]) for f in STATE_FIELDS})


@pytest.fixture(scope="module")
def chains():
    """Five random chains on the fixture's data shape, in both packages."""
    jdata, _ = simulate_functional(seed=3, N=10, K=3, P=5, M=3,
                                   n_time=(12, 16))
    d = _random_states(0, 5, 10, 3, 5, 3)
    return jdata, convert.data_from_jax(jdata, device="cpu"), d, \
        convert.state_from_numpy(d, chains=5, device="cpu")


def _close(port, ref, what, rtol=F32_RTOL):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.max(np.abs(ref)) + 1.0
    err = np.max(np.abs(port - ref))
    assert err <= rtol * scale, f"{what}: max error {err} vs scale {scale}"


# ---------------------------------------------------------------------------
# Deterministic pieces on identical inputs
# ---------------------------------------------------------------------------

def test_gauge_maps_and_prior_match_jax(chains):
    jdata, tdata, d, ts = chains
    C, K, M = 5, 3, 3
    rng = np.random.default_rng(4)
    a = np.array([0, 1, 2, 0, 2])
    b = np.array([1, 2, 0, 2, 1])
    eps = rng.normal(0, 0.3, C).astype(np.float32)
    m = np.array([0, 2, 1, 1, 0])
    m2 = np.array([1, 0, 2, 0, 2])
    theta = rng.normal(0, 0.5, C).astype(np.float32)
    eyeK, eyeM = np.eye(K, dtype=np.float32), np.eye(M, dtype=np.float32)
    hp = Priors()

    def jmap(fn, *args):
        return jax.vmap(fn)(_jstate(d), *map(jnp.asarray, args))

    jout = {
        "prior": jax.vmap(lambda s: jg._gauge_logprior(s, jdata, hp))(
            _jstate(d)),
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
        "prior": tg._gauge_logprior(ts, tdata, TPriors()),
        "mix": tg._mix_features(ts, tdata, t(eyeK[a]), t(eyeK[b]), t(eps)),
        "scale": tg._rescale_eigen(ts, tdata, t(eyeM[m]), t(eps)),
        "rotate": tg._rotate_eigen(ts, tdata, t(m), t(m2), t(theta)),
    }
    _close(tout["prior"].numpy(), jout["prior"], "gauge log prior")
    for name in ("mix", "scale", "rotate"):
        for f in ("Z", "nu", "Phi", "chi"):
            _close(getattr(tout[name], f).numpy(),
                   getattr(jout[name], f), f"{name} {f}")


def test_noise_scale_log_acc_matches_jax():
    rng = np.random.default_rng(5)
    C = 7
    args = [rng.normal(0, 0.02, C), rng.uniform(0.9, 1.1, C),
            rng.uniform(0.01, 0.05, C), rng.uniform(1, 5, C),
            rng.uniform(0, 1, C), rng.uniform(80, 120, C),
            rng.uniform(-5, 5, C), rng.uniform(300, 400, C),
            rng.uniform(2, 6, C)]
    args = [np.asarray(x, np.float32) for x in args]
    eps, s, sig2, d0, d0xi, rr0, re, ee, sumA = args
    j = jax.vmap(lambda *a: jg._noise_scale_log_acc(
        a[0], a[1], a[2], a[3], a[4], a[5:8], 2000.0, a[8], Priors(), BETA))(
        *map(jnp.asarray, args))
    tt = [torch.from_numpy(x) for x in args]
    t = tg._noise_scale_log_acc(tt[0], tt[1], tt[2], tt[3], tt[4],
                                tuple(tt[5:8]), 2000.0, tt[8], TPriors(),
                                BETA)
    # the formula cancels beta*RSS/(2 sigma2) terms: hold it to their scale
    scale = np.max(BETA * rr0 / (2.0 * sig2))
    assert np.max(np.abs(t.numpy() - np.asarray(j))) <= F32_RTOL * scale


def _jax_row_stats(state, data, Z2, s):
    """The JAX package's update_z_chi row_stats + marg_loglik (gibbs.py:
    304-334), D = 0, in the entries form of its small linalg."""
    M = state.Phi.shape[2]
    hi = dict(precision="highest")
    a = jnp.einsum("enk,kp->enp", Z2, state.nu, **hi)
    Ul = [jnp.einsum("enk,kp->enp", Z2, state.Phi[:, :, m], **hi)
          for m in range(M)]
    GUl = [jnp.einsum("npq,enq->enp", data.G, u, **hi) for u in Ul]
    ur = data.u[None] - jnp.einsum("npq,enq->enp", data.G, a, **hi)
    r = data.y[None] - jnp.einsum("nlp,enp->enl", data.B, a, **hi)
    Cm = [[(1.0 if i == j else 0.0)
           + s * jnp.einsum("enp,enp->en", Ul[i], GUl[j], **hi)
           for j in range(i + 1)] for i in range(M)]
    Fr = [jnp.einsum("enp,enp->en", u, ur, **hi) for u in Ul]
    rr = jnp.sum(r * r, axis=-1)
    Lc = jl.small_chol_entries(Cm)
    wv = jl.small_solve_lower_entries(Lc, Fr)
    quad = s * rr - s * s * sum(v * v for v in wv)
    ml = -0.5 * (jl.small_logdet_entries(Lc) + quad)
    return a, Lc, jnp.stack(Fr, -1), rr, ml


def test_row_stats_and_marg_loglik_match_jax_entries(chains):
    """update_z_chi's stacked row statistics for two given Z endpoints,
    packed (port) against the entries form (JAX): the packed-vs-entries
    parity of the chi-marginal small linalg."""
    jdata, tdata, d, ts = chains
    rng = np.random.default_rng(6)
    Z2 = np.stack([d["Z"], rng.dirichlet(np.ones(3), size=(5, 10))]
                  ).astype(np.float32)                          # (2, C, N, K)
    s = (BETA / d["sigma2"]).astype(np.float32)

    def one(st, z2, sc):
        return _jax_row_stats(st, jdata, z2, sc)

    ja, jL, jFr, jrr, jml = jax.vmap(one, in_axes=(0, 1, 0),
                                     out_axes=1)(_jstate(d), jnp.asarray(Z2),
                                                 jnp.asarray(s))
    a, U, L, Fr, rr = tg._row_stats(ts, tdata, torch.from_numpy(Z2),
                                    torch.from_numpy(s))
    ml = tg._marg_loglik(torch.from_numpy(s), L, Fr, rr)
    _close(a.numpy(), ja, "a")
    _close(Fr.numpy(), jFr, "F'r")
    _close(rr.numpy(), jrr, "rr")
    for i in range(3):
        for j in range(i + 1):
            _close(L[..., i, j].numpy(), jL[i][j], f"L[{i}][{j}]")
    # ml cancels s*rr against s^2 quad: hold it to the scale of s*rr
    scale = np.max(np.abs(s[None, :, None] * np.asarray(jrr)))
    assert np.max(np.abs(ml.numpy() - np.asarray(jml))) <= F32_RTOL * scale


def test_mala_potential_and_gradient_match_jax(chains):
    jdata, tdata, d, ts = chains
    s = (BETA / d["sigma2"]).astype(np.float32)
    hi = dict(precision="highest")

    def jpot(Phi, st, sc):
        """update_phi_mala's potential (JAX gibbs.py:1595-1617), D = 0."""
        M = Phi.shape[2]
        pri = jnp.cumprod(st.delta, axis=1)[:, None, :] * st.gamma
        a = jnp.einsum("nk,kp->np", st.Z, st.nu, **hi)
        r0 = jdata.y - jnp.einsum("nlp,np->nl", jdata.B, a, **hi)
        ur = jdata.u - jnp.einsum("npq,nq->np", jdata.G, a, **hi)
        Ul = [jnp.einsum("nk,kp->np", st.Z, Phi[:, :, m], **hi)
              for m in range(M)]
        GUl = [jnp.einsum("npq,nq->np", jdata.G, u, **hi) for u in Ul]
        Cm = [[(1.0 if i == j else 0.0)
               + sc * jnp.einsum("np,np->n", Ul[i], GUl[j], **hi)
               for j in range(i + 1)] for i in range(M)]
        Lc = jl.small_chol_entries(Cm)
        Fr = [jnp.einsum("np,np->n", Ul[m], ur, **hi) for m in range(M)]
        wv = jl.small_solve_lower_entries(Lc, Fr)
        quad = sum(jnp.sum(v * v) for v in wv)
        ll = -0.5 * (jnp.sum(jl.small_logdet_entries(Lc))
                     + sc * jnp.sum(r0 * r0) - sc * sc * quad)
        return -(ll - 0.5 * jnp.sum(pri * Phi * Phi))

    jst = _jstate(d)
    jv, jgrad = jax.vmap(jax.value_and_grad(jpot))(jst.Phi, jst,
                                                   jnp.asarray(s))
    st = ts
    st_s = torch.from_numpy(s)
    pri = torch.cumprod(st.delta, 2)[:, :, None, :] * st.gamma
    a = torch.einsum("cnk,ckp->cnp", st.Z, st.nu)
    ur = tdata.u - torch.einsum("npq,cnq->cnp", tdata.G, a)
    r0 = tdata.y - torch.einsum("nlp,cnp->cnl", tdata.B, a)
    Phi = st.Phi.clone().requires_grad_()
    pot = tg._mala_potential(Phi, st.Z, tdata, st_s, ur,
                             (r0 * r0).sum((1, 2)), pri)
    grad, = torch.autograd.grad(pot.sum(), Phi)
    # the potential is a sum of terms of size s*rr; hold it to that scale
    scale = float(np.max(np.abs(np.asarray(jv)))) + float(
        np.max(s * (r0 * r0).sum((1, 2)).numpy()))
    assert np.max(np.abs(pot.detach().numpy() - np.asarray(jv))) \
        <= F32_RTOL * scale
    _close(grad.numpy(), jgrad, "MALA gradient", rtol=1e-4)


def test_gauge_maps_exact_mu_invariance():
    """Port of tests/test_collapsed_gauge.py::
    test_gauge_maps_exact_mu_invariance at D = 0 (the covariate terms are
    not ported), over 3 chains with one map parameter each."""
    K, P, M = 3, 8, 3
    data, _ = tsimulate.simulate_functional(seed=3, N=12, K=K, P=P, M=M,
                                            device="cpu")
    g = torch.Generator().manual_seed(0)
    st = init_state(g, TConfig(K=K, P=P, M=M), data, chains=3)
    mu0 = compute_mu(data, st)
    eyeK, eyeM = torch.eye(K), torch.eye(M)
    ea, eb = eyeK[[0, 1, 0]], eyeK[[2, 0, 1]]
    eps = torch.tensor([0.4, -0.3, 0.1])

    def mu_err(s):
        return float((compute_mu(data, s) - mu0).abs().max())

    st1 = tg._mix_features(st, data, ea, eb, eps)
    assert mu_err(st1) < 1e-4
    assert float((st1.Z.sum(-1) - 1.0).abs().max()) < 1e-5
    st2 = tg._rescale_eigen(st, data, eyeM[[1, 0, 2]],
                            torch.tensor([-0.7, 0.3, 0.5]))
    assert mu_err(st2) < 1e-4
    # inverse maps compose to identity
    st3 = tg._mix_features(st1, data, ea, eb, -eps)
    assert float((st3.nu - st.nu).abs().max()) < 1e-4
    assert float((st3.Z - st.Z).abs().max()) < 1e-5
    # eigen rotation: mu invariant, chi norms invariant, inverse composes
    m1, m2 = torch.tensor([0, 2, 1]), torch.tensor([2, 1, 0])
    theta = torch.tensor([0.9, -0.4, 2.0])
    st4 = tg._rotate_eigen(st, data, m1, m2, theta)
    assert mu_err(st4) < 1e-4
    assert float(((st4.chi ** 2).sum(-1)
                  - (st.chi ** 2).sum(-1)).abs().max()) < 1e-4
    st5 = tg._rotate_eigen(st4, data, m1, m2, -theta)
    assert float((st5.Phi - st.Phi).abs().max()) < 1e-5
    assert float((st5.chi - st.chi).abs().max()) < 1e-5


def test_noise_scale_log_acc_matches_brute_force():
    """Port of tests/test_collapsed_gauge.py::
    test_noise_scale_log_acc_matches_brute_force at D = 0, in float64: the
    closed form equals the posterior ratio plus the map's log-Jacobian."""
    K, P, M, N = 3, 6, 3, 15
    f64 = torch.float64
    data, _ = tsimulate.simulate_functional(seed=11, N=N, K=K, P=P, M=M,
                                            n_time=(25, 30), dtype=f64,
                                            device="cpu")
    g = torch.Generator().manual_seed(11)
    st = init_state(g, TConfig(K=K, P=P, M=M), data, chains=2, dtype=f64)
    st = st.replace(
        delta=torch._standard_gamma(torch.full_like(st.delta, 2.0),
                                    generator=g),
        A=0.5 + torch._standard_gamma(torch.full_like(st.A, 2.0),
                                      generator=g),
        sigma2=torch.tensor([0.37, 0.21], dtype=f64))
    hp = TPriors()

    def logprior_moved(s):
        tilde = torch.cumprod(s.delta, 2)[:, :, None, :]
        lp = 0.5 * torch.log(tilde * s.gamma).sum((1, 2, 3)) \
            - 0.5 * (tilde * s.gamma * s.Phi ** 2).sum((1, 2, 3))
        lp = lp + ((s.A[:, :, 0] - 1.0) * torch.log(s.delta[:, :, 0])
                   - s.delta[:, :, 0]).sum(-1)
        return lp - (hp.alpha_0 + 1.0) * torch.log(s.sigma2) \
            - hp.beta_0 / s.sigma2

    U = eigen_directions(st, data.X)
    ec = torch.einsum("cnpm,cnm->cnp", U, st.chi)
    ac = effective_coeffs(st, data.X) - ec
    r0 = data.y - torch.einsum("nlp,cnp->cnl", data.B, ac)
    e = torch.einsum("nlp,cnp->cnl", data.B, ec)
    coeffs = ((r0 * r0).sum((1, 2)), (r0 * e).sum((1, 2)),
              (e * e).sum((1, 2)))
    jac = 1.0 - K + K * P * M / 2.0
    for eps in (0.23, -0.4, 0.05):
        ev = torch.full((2,), eps, dtype=f64)
        closed = tg._noise_scale_log_acc(
            ev, torch.ones(2, dtype=f64), st.sigma2,
            st.delta[:, :, 0].sum(-1), torch.zeros(2, dtype=f64), coeffs,
            data.n_obs, st.A[:, :, 0].sum(-1), hp, 1.0)
        delta = st.delta.clone()
        delta[:, :, 0] *= np.exp(-eps)
        st2 = st.replace(sigma2=st.sigma2 * np.exp(eps),
                         Phi=st.Phi * np.exp(eps / 2.0), delta=delta)
        brute = (log_likelihood(st2, data) - log_likelihood(st, data)
                 + logprior_moved(st2) - logprior_moved(st) + eps * jac)
        assert torch.all((closed - brute).abs() <= 1e-7 * (1.0 + brute.abs())
                         ), (eps, closed, brute)


# ---------------------------------------------------------------------------
# Updaters by moments and acceptance, against their vmapped JAX twins
# ---------------------------------------------------------------------------

def _moved(out, cur):
    """(n, ...) -> (n, prod(...)) 1.0 where an element left its value."""
    return (out != cur[None]).reshape(len(out), -1).astype(float)


# name -> (JAX call, port call, fields compared, rates: {name: function of
# (out dict, current state dict) -> (n, ...) moved indicators}[, {field: new
# value as a function of the fixture's}])
_UPDATERS = {
    # row 0 on the simplex boundary exercises the first stage's auto-accept
    "z_chi": (
        lambda k, s, d: jg.update_z_chi(k, s, d, Priors(), jcache(d, s), BETA,
                                        p_indep=0.3)[0],
        lambda g, s, d: tg.update_z_chi(g, s, d, TPriors(), tcache(d, s),
                                        BETA, p_indep=0.3)[0],
        ("Z", "chi"),
        {"Z row": lambda o, c: (o["Z"] != c["Z"][None]).any(-1)},
        {"Z": lambda Z: np.concatenate([[[1.0, 0.0]], Z[1:]])}),
    "chi_joint": (
        lambda k, s, d: jg.update_chi_joint(k, s, d, Priors(), jcache(d, s),
                                            BETA)[0],
        lambda g, s, d: tg.update_chi_joint(g, s, d, TPriors(),
                                            tcache(d, s), BETA)[0],
        ("chi",), {}),
    "gauge": (
        lambda k, s, d: jg.update_gauge(k, s, d, Priors()),
        lambda g, s, d: tg.update_gauge(g, s, d, TPriors()),
        ("Z", "nu", "Phi", "chi"),
        # nu moves only by the mixing move; Phi by any of the three
        {"mix": lambda o, c: (o["nu"] != c["nu"][None]).any((1, 2)),
         "any": lambda o, c: (o["Phi"] != c["Phi"][None]).any((1, 2, 3))}),
    "mgp_scale": (
        lambda k, s, d: jg.update_mgp_scale(k, s, d, Priors(), jcache(d, s),
                                            BETA)[0],
        lambda g, s, d: tg.update_mgp_scale(g, s, d, TPriors(),
                                            tcache(d, s), BETA)[0],
        ("Phi", "delta"),
        {"delta": lambda o, c: _moved(o["delta"], c["delta"])}),
    "noise_scale": (
        lambda k, s, d: jg.update_noise_scale(k, s, d, Priors(),
                                              jcache(d, s), BETA)[0],
        lambda g, s, d: tg.update_noise_scale(g, s, d, TPriors(),
                                              tcache(d, s), BETA)[0],
        ("sigma2", "Phi", "delta"),
        {"sigma2": lambda o, c: _moved(o["sigma2"], c["sigma2"])}),
    "phi_mala": (
        lambda k, s, d: jg.update_phi_mala(k, s, d, Priors(), jcache(d, s),
                                           BETA, step=0.05, n_steps=4)[0],
        lambda g, s, d: tg.update_phi_mala(g, s, d, TPriors(), tcache(d, s),
                                           BETA, step=0.05, n_steps=4)[0],
        ("Phi", "chi"),
        {"Phi": lambda o, c: (o["Phi"] != c["Phi"][None]).any((1, 2, 3))}),
}


@pytest.mark.parametrize("name", list(_UPDATERS))
def test_production_updater_moments_match_jax(case, name):
    jdata, js, tdata, ts = case
    jfn, tfn, fields, rates, *over = _UPDATERS[name]
    for f, fn in (over[0] if over else {}).items():
        v = np.asarray(fn(np.asarray(getattr(js, f))), np.float32)
        js = js.replace(**{f: jnp.asarray(v)})
        ts = ts.replace(**{f: torch.from_numpy(v).expand_as(getattr(ts, f))})
    keys = jax.random.split(jax.random.PRNGKey(13), N_DRAWS)
    jout = jax.jit(jax.vmap(
        lambda k: {f: getattr(jfn(k, js, jdata), f) for f in fields}))(keys)
    jout = {f: np.asarray(v) for f, v in jout.items()}
    g = torch.Generator().manual_seed(13)
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
    if name == "z_chi":
        # the boundary row always moves (auto-accept), in both packages
        assert np.all(jout["Z"][:, 0] != cur["Z"][0]) \
            and np.all(tout["Z"][:, 0] != cur["Z"][0])
    # no autograd graph leaves the port's updaters
    assert all(not getattr(tst, f).requires_grad for f in STATE_FIELDS)
