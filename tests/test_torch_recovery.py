"""The JAX package's recovery tests of the functional updaters, ported to
the port's updaters on one process (tests/test_kernels_recovery.py's
``func_data`` cases, tests/test_mgp_tower.py's gamma, delta and A,
tests/test_collapsed_gauge.py's collapsed (Z, chi) recovery and its
agreement with the reference sweep, and tests/test_pipeline.py's
multivariate warm start and spectral init).

Each keeps its JAX test's data, seed and bounds.  Where the JAX test scans
one chain for n iterations and keeps the last draws, the port runs a batch
of chains from the same start and keeps each chain's last draws, the chain
axis in the place of iterations (as tests/test_torch_covariates.py does):
an updater whose draw does not depend on its own field's current value
(tau, gamma) draws once in as many chains as the JAX test has iterations;
the others run as many chains as the JAX test keeps draws for a few
iterations, or a few chains for the JAX test's iterations.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_torch.models.state import init_state  # noqa: E402
from bayesfmmm_torch.ops import gibbs  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache, compute_mu  # noqa: E402
from bayesfmmm_torch.samplers import drivers  # noqa: E402
from bayesfmmm_torch.utils.simulate import (  # noqa: E402
    simulate_functional, simulate_multivariate)

HP = Priors()


@pytest.fixture(scope="module")
def func_data():
    return simulate_functional(seed=1, N=40, K=3, P=8, M=2, device="cpu")


def _run_updater(fn, data, truth, chains, iters, seed=0, **kw):
    """``fn(generator, state, data, HP, cache, **kw)`` alone from the truth
    in ``chains`` chains for ``iters`` iterations, everything else held
    there: the last state."""
    st = convert.state_from_numpy(truth, chains=chains, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for _ in range(iters):
        st = fn(g, st, data, HP, build_cache(data, st), **kw)
        st = st[0] if isinstance(st, tuple) else st
    return st


def _median(state, field):
    return np.median(getattr(state, field).numpy(), axis=0)


def test_nu_recovery(func_data):
    """200 chains of 25 updates in the place of 200 kept of 500; atol
    0.3 (so every test below that runs one updater)."""
    data, truth = func_data
    kept = _run_updater(gibbs.update_nu, data, truth, 200, 25)
    np.testing.assert_allclose(_median(kept, "nu"), truth["nu"], atol=0.3)


def test_nu_tempered_recovery(func_data):
    """The tempered update at beta 0.5 still centres on the truth
    (UpdateNu.h:93)."""
    data, truth = func_data
    kept = _run_updater(gibbs.update_nu, data, truth, 200, 25, beta=0.5)
    np.testing.assert_allclose(_median(kept, "nu"), truth["nu"], atol=0.3)


def test_phi_recovery(func_data):
    data, truth = func_data
    kept = _run_updater(gibbs.update_phi, data, truth, 200, 25)
    np.testing.assert_allclose(_median(kept, "Phi"), truth["Phi"], atol=0.3)


def test_chi_recovery(func_data):
    data, truth = func_data
    kept = _run_updater(gibbs.update_chi, data, truth, 200, 25)
    np.testing.assert_allclose(_median(kept, "chi"), truth["chi"],
                               atol=0.25)


def test_sigma_recovery(func_data):
    data, truth = func_data
    kept = _run_updater(gibbs.update_sigma, data, truth, 200, 25)
    assert abs(_median(kept, "sigma2") - float(truth["sigma2"])) < 0.01


def test_z_recovery(func_data):
    """Partial membership recovery (test-PartialMembership.cpp pattern):
    400 chains of 100 updates in the place of 400 kept of 1,000;
    atol 0.2."""
    data, truth = func_data
    kept = _run_updater(gibbs.update_z, data, truth, 400, 100)
    np.testing.assert_allclose(_median(kept, "Z"), truth["Z"], atol=0.2)


def test_tau_gibbs_moments(func_data):
    """tau | nu is exactly Gamma(alpha + P/2, beta + q/2): 4,000 chains of
    one update in the place of 4,000 iterations; the mean to 10 %, the
    variance to 25 %."""
    data, truth = func_data
    st = convert.state_from_numpy(truth, chains=4000, device="cpu")
    draws = gibbs.update_tau(torch.Generator().manual_seed(0), st, data,
                             HP).tau.numpy()
    P = truth["nu"].shape[1]
    quad = np.einsum("kp,pq,kq->k", truth["nu"], data.pen.numpy(),
                     truth["nu"])
    a = HP.alpha_nu + P / 2.0
    rate = HP.beta_nu + 0.5 * quad
    np.testing.assert_allclose(draws.mean(axis=0), a / rate, rtol=0.1)
    np.testing.assert_allclose(draws.var(axis=0), a / rate**2, rtol=0.25)


def test_delta_gamma_a_tower_runs(func_data):
    """MGP tower: 50 rounds of delta, gamma and A from the truth, one chain,
    give finite positive draws."""
    _, truth = func_data
    st = convert.state_from_numpy(truth, chains=1, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        st = gibbs.update_delta(g, st, HP)
        st = gibbs.update_gamma(g, st, HP)
        st = gibbs.update_a(g, st, HP)
    for f in ("delta", "gamma", "A"):
        x = getattr(st, f)
        assert bool((x > 0).all()) and bool(torch.isfinite(x).all()), f


def test_pi_alpha3_mh_moves():
    """pi/alpha3 MH kernels mix and stay on their supports: one chain of
    300 rounds, as the JAX test; pi's mean over the last 100 tracks Z's
    mean membership within 0.15."""
    data, truth = simulate_functional(seed=5, N=40, K=3, P=8, M=2,
                                      device="cpu")
    c = torch.full((3,), 10.0)
    st = convert.state_from_numpy(truth, chains=1, device="cpu")
    g = torch.Generator().manual_seed(0)
    pis, a3s = [], []
    for _ in range(300):
        st = gibbs.update_pi(g, st, HP, c)
        st = gibbs.update_alpha3(g, st, HP)
        pis.append(st.pi[0].numpy())
        a3s.append(float(st.alpha3[0]))
    pis = np.stack(pis)
    np.testing.assert_allclose(pis.sum(axis=1), 1.0, atol=1e-5)
    assert np.std(a3s) > 0
    assert np.all(np.asarray(a3s) > 0)
    np.testing.assert_allclose(pis[-100:].mean(axis=0),
                               truth["Z"].mean(axis=0), atol=0.15)


# ---------------------------------------------------------------------------
# tests/test_mgp_tower.py: Phi redrawn from its conditional prior at the
# truth each iteration, one tower updater after it


def _tower_state(K, P, M, chains, **fields):
    """tests/test_mgp_tower.py::_mk_state over ``chains`` chains (N = 4,
    D = 0), with ``fields`` (one chain's values) in every chain."""
    f32 = np.float32
    one = dict(
        Z=np.full((4, K), 1.0 / K, f32), pi=np.full((K,), 1.0 / K, f32),
        alpha3=f32(1.0), nu=np.zeros((K, P), f32), tau=np.ones((K,), f32),
        sigma2=f32(1.0), chi=np.zeros((4, M), f32),
        Phi=np.zeros((K, P, M), f32), gamma=np.ones((K, P, M), f32),
        delta=np.ones((K, M), f32), A=np.ones((K, 2), f32),
        eta=np.zeros((K, P, 0), f32), tau_eta=np.ones((K, 0), f32),
        xi=np.zeros((K, P, 0, M), f32), gamma_xi=np.ones((K, P, 0, M), f32),
        delta_xi=np.ones((K, M, 0), f32), A_xi=np.ones((K, 2, 0), f32))
    one.update(fields)
    return convert.state_from_numpy(one, chains=chains, device="cpu")


def _phi_prior_sd(gamma, delta):
    tilde = np.cumprod(delta, axis=1)                          # (K, M)
    return (1.0 / np.sqrt(gamma * tilde[:, None, :])).astype(np.float32)


def test_gamma_recovery():
    """updateGamma recovers the truth gamma (test-Phi.cpp:364-413, tol
    0.5): 10,000 chains of one update in the place of 10,000
    iterations."""
    K, P, M, C = 3, 8, 2, 10000
    rng = np.random.default_rng(11)
    gamma_truth = rng.gamma(0.5, 2.0, size=(K, P, M)).astype(np.float32)
    delta_truth = np.tile([2.0, 3.0], (K, 1)).astype(np.float32)
    sd = torch.from_numpy(_phi_prior_sd(gamma_truth, delta_truth))
    g = torch.Generator().manual_seed(0)
    st = _tower_state(K, P, M, C, delta=delta_truth)
    st = st.replace(Phi=sd * torch.randn((C,) + sd.shape, generator=g))
    out = gibbs.update_gamma(g, st, Priors(nu_1=0.001))
    np.testing.assert_allclose(np.median(out.gamma.numpy(), axis=0),
                               gamma_truth, atol=0.5)


def test_delta_recovery():
    """updateDelta recovers the truth delta (test-Phi.cpp:416-464, tol 2.0,
    and the mean offset under 0.5): 200 chains of 50 iterations in the
    place of 10,000 (delta carries over while Phi is redrawn)."""
    K, P, M, C = 3, 8, 5, 200
    rng = np.random.default_rng(12)
    delta_truth = np.clip(rng.gamma(2.0, 1.0, size=(K, M)),
                          0.5, 4.0).astype(np.float32)
    gamma_truth = rng.gamma(1.5, 1.0 / 1.5, size=(K, P, M)).astype(np.float32)
    sd = torch.from_numpy(_phi_prior_sd(gamma_truth, delta_truth))
    g = torch.Generator().manual_seed(0)
    st = _tower_state(K, P, M, C, gamma=gamma_truth,
                      A=np.full((K, 2), 2.0, np.float32))
    draws = []
    for _ in range(50):
        st = st.replace(Phi=sd * torch.randn((C,) + sd.shape, generator=g))
        st = gibbs.update_delta(g, st, Priors())
        draws.append(st.delta.numpy())
    med = np.median(np.concatenate(draws[10:]), axis=0)
    np.testing.assert_allclose(med, delta_truth, atol=2.0)
    assert abs(np.mean(med - delta_truth)) < 0.5


def test_a_recovery():
    """updateA's MH chain centres on the delta evidence (test-Phi.cpp:
    468-505, tol 0.5: delta = (2, 3, 3, 3, 3) -> A ~ (2, 3)): 50 chains of
    200 iterations, the first 50 dropped, in the place of 1,000."""
    K, M = 3, 5
    delta = np.tile([2.0, 3.0, 3.0, 3.0, 3.0], (K, 1)).astype(np.float32)
    hp = Priors(alpha1l=2.0, beta1l=1.0, alpha2l=3.0, beta2l=1.0,
                var_epsilon1=1.0, var_epsilon2=1.0)
    st = _tower_state(K, 8, M, 50, delta=delta)
    g = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(200):
        st = gibbs.update_a(g, st, hp)
        draws.append(st.A.numpy())
    med = np.median(np.concatenate(draws[50:]), axis=0)
    np.testing.assert_allclose(med, np.tile([2.0, 3.0], (K, 1)), atol=0.5)


# ---------------------------------------------------------------------------
# tests/test_collapsed_gauge.py: the production census's collapsed block


def test_collapsed_z_chi_recovery():
    """update_z_chi recovers (Z, chi) with (nu, Phi, sigma2) at the truth:
    4 chains of 600 updates from init_state, each chain's last 300 kept;
    Z's medians within 0.25 after the best relabelling, chi's within 0.35
    (the JAX test runs one chain of 600)."""
    K, P, M, N, C = 3, 8, 2, 40, 4
    data, truth = simulate_functional(seed=2, N=N, K=K, P=P, M=M,
                                      n_time=(60, 70), sigma2=0.001,
                                      device="cpu")
    st = init_state(torch.Generator().manual_seed(0),
                    ModelConfig(K=K, P=P, M=M), data, chains=C)
    fix = convert.state_from_numpy(truth, chains=C, device="cpu")
    st = st.replace(nu=fix.nu, Phi=fix.Phi, sigma2=fix.sigma2,
                    pi=torch.full((C, K), 1.0 / K),
                    alpha3=torch.full((C,), 5.0))
    g = torch.Generator().manual_seed(1)
    cache = build_cache(data, st)
    Zs, chis = [], []
    for i in range(600):
        st, cache = gibbs.update_z_chi(g, st, data, HP, cache)
        if i >= 300:
            Zs.append(st.Z.numpy())
            chis.append(st.chi.numpy())
    Z_med = np.median(np.concatenate(Zs), axis=0)
    chi_med = np.median(np.concatenate(chis), axis=0)
    best = min((np.abs(Z_med[:, list(p)] - truth["Z"]).max(), p)
               for p in itertools.permutations(range(K)))
    assert best[0] < 0.25, best
    assert np.abs(chi_med - truth["chi"]).max() < 0.35


def test_collapsed_matches_conditional_posterior_mean_structure():
    """The collapsed sweep and the reference sweep sample the same
    posterior: their fitted curves' posterior means agree within MC error
    (rms < 5 % of the curves' rms + 0.05).  8 chains of 250 sweeps from
    the truth, the last 150 of each kept, in the place of one chain of 800
    with the last 500 kept."""
    K, P, M, N, C = 2, 8, 2, 30, 8
    data, truth = simulate_functional(seed=4, N=N, K=K, P=P, M=M,
                                      n_time=(50, 60), device="cpu")
    c = torch.full((K,), 10.0)
    st0 = init_state(torch.Generator().manual_seed(0),
                     ModelConfig(K=K, P=P, M=M), data, chains=C)
    fix = convert.state_from_numpy(truth, chains=C, device="cpu")
    st0 = st0.replace(Z=fix.Z, nu=fix.nu, chi=fix.chi, Phi=fix.Phi,
                      sigma2=fix.sigma2)

    def run(collapsed, seed):
        g = torch.Generator().manual_seed(seed)
        st, total = st0, 0.0
        for i in range(250):
            st = gibbs.sweep_full(g, st, data, HP, c, collapsed_z=collapsed)
            if i >= 100:
                total = total + compute_mu(data, st).double().sum(0)
        return (total / (150 * C)).numpy()

    mu_ref, mu_col = run(False, 5), run(True, 6)
    mask = data.mask.numpy() > 0
    rms = np.sqrt(np.mean((mu_ref[mask] - mu_col[mask]) ** 2))
    scale = np.sqrt(np.mean(mu_ref[mask] ** 2))
    assert rms < 0.05 * scale + 0.05, (rms, scale)


# ---------------------------------------------------------------------------
# tests/test_pipeline.py: the multivariate family end to end


def test_multivariate_warm_from_truth_stationary():
    """Warm-started at the truth, one chain of 200 reference sweeps stays
    near the truth's posterior mass: sigma2's median under 6 times the
    truth's, Z's medians within 0.1 of the truth on average."""
    data, truth = simulate_multivariate(seed=22, N=100, K=2, P=5, M=2,
                                        device="cpu")
    res = drivers.phase_warm_start(
        torch.Generator().manual_seed(0),
        convert.state_from_numpy(truth, chains=1, device="cpu"), data, HP,
        torch.full((2,), 10.0), n_iters=200)
    est = drivers.posterior_median_state(
        {f: v[0].numpy() for f, v in res.traces.items()}, burnin_prop=0.5)
    assert float(est["sigma2"]) < 6 * float(truth["sigma2"])
    assert np.abs(est["Z"] - truth["Z"]).mean() < 0.1


def test_spectral_init_beats_random_on_multimodal_mv():
    """The moment-based archetypal init reaches a far better mode than
    random cold starts on the latent-heavy multivariate config: the warm
    start's mean loglik over its last 20 draws above 100 (random starts
    plateau near -280) and sigma2 under 0.08."""
    data, _ = simulate_multivariate(seed=22, N=100, K=2, P=5, M=2,
                                    device="cpu")
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=150, n_try=1,
                      init="spectral")
    r2 = api.fit_theta(r1, tot_mcmc_iters=150)
    r3 = api.fit_warm_start(r1, r2, tot_mcmc_iters=200, progress=False)
    assert np.mean(np.asarray(r3.loglik)[-20:]) > 100.0
    est = r3.estimates(burnin_prop=0.5)
    assert float(est["sigma2"]) < 0.08
