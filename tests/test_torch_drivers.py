"""The port's drivers (samplers/drivers.py) and phase sweeps against the JAX
package's on the same inputs, on the CPU.

Deterministic parts agree to f32 rounding (rtol 1e-6 unless a test says
otherwise); the excursion's logA to rtol 2e-4 / atol 2e-3, the tolerance of
tests/test_tempered_acceptance.py (a sum of large terms that cancel).  The
two phase sweeps draw other random numbers in the two packages, so their
ensemble means after a run agree within 5 combined standard errors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_tpu.models.state import init_state  # noqa: E402
from bayesfmmm_tpu.samplers import drivers as jdrivers  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.ops import gibbs, kernels  # noqa: E402
from bayesfmmm_torch.samplers import drivers  # noqa: E402

HP, THP = Priors(), TPriors()


# ---------------------------------------------------------------------------
# The ladder (tests/test_tempered_acceptance.py:22-40)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta_N_t,N_t", [(0.5, 1), (0.5, 3), (0.3, 2),
                                          (0.7, 4), (0.05, 5)])
def test_ladder_matches_jax_and_reference(beta_N_t, N_t):
    got = drivers.make_temperature_ladder(beta_N_t, N_t)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jdrivers.make_temperature_ladder(beta_N_t, N_t)),
        rtol=1e-6)
    # reference replay of the construction loop (BFMMM.h:661-670)
    ref = np.ones(N_t)
    ref[N_t - 1] = beta_N_t
    if N_t > 1:
        for i in range(1, N_t):
            ref[i] = ref[i - 1] * beta_N_t ** (1.0 / N_t)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# The excursion with a stub sweep (tests/test_tempered_acceptance.py:70-130)
# ---------------------------------------------------------------------------

def _jax_stub(key, st, data, hp, c, beta=1.0):
    return st.replace(nu=st.nu * 1.05 + 0.2 * beta,
                      sigma2=st.sigma2 * (1.0 + 0.1 * beta))


def _torch_stub(generator, st, data, hp, c, beta=1.0):
    return st.replace(nu=st.nu * 1.05 + 0.2 * beta,
                      sigma2=st.sigma2 * (1.0 + 0.1 * beta))


def _chains_of(truth, C, seed):
    """C chains around the truth: nu and sigma2 perturbed per chain."""
    rng = np.random.default_rng(seed)
    leaves = {f: np.broadcast_to(np.asarray(getattr(truth, f)),
                                 (C,) + np.asarray(getattr(truth, f)).shape)
              .copy() for f in STATE_FIELDS}
    leaves["nu"] += 0.3 * rng.normal(size=leaves["nu"].shape).astype(
        np.float32)
    leaves["sigma2"] *= rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    return leaves


@pytest.mark.parametrize("N_t,beta_N_t", [(3, 0.25), (2, 0.5), (1, 0.5)])
def test_excursion_log_acceptance_matches_jax_per_chain(N_t, beta_N_t):
    data, truth = simulate_functional(seed=7, N=6, K=2, P=5, M=2,
                                      n_time=(8, 12), sigma2=0.5)
    C = 4
    leaves = _chains_of(truth, C, seed=N_t)
    jladder = jdrivers.make_temperature_ladder(beta_N_t, N_t)
    c = jnp.full((2,), 10.0)
    jstates = type(truth)(**{f: jnp.asarray(v) for f, v in leaves.items()})
    jnew, jacc, jlogA = jax.jit(jax.vmap(
        lambda k, st: jdrivers.tempered_excursion(
            k, st, data, HP, c, jladder, covariate_mean=False,
            covariate_cov=False, sweep_fn=_jax_stub)))(
        jax.random.split(jax.random.PRNGKey(3), C), jstates)

    tdata = convert.data_from_jax(data, device="cpu")
    tst = convert.state_from_numpy(leaves, chains=C, device="cpu")
    new, acc, logA = drivers.tempered_excursion(
        torch.Generator().manual_seed(0), tst, tdata, THP,
        torch.full((2,), 10.0), drivers.make_temperature_ladder(beta_N_t,
                                                                N_t),
        sweep_fn=_torch_stub)
    assert logA.shape == (C,) and acc.shape == (C,) and acc.dtype == torch.bool
    np.testing.assert_allclose(logA.numpy(), np.asarray(jlogA), rtol=2e-4,
                               atol=2e-3)
    if N_t == 1:
        # an empty ladder sum: logA == 0, every chain accepts (log u < 0)
        # and holds the endpoint of two stub sweeps at beta_N_t
        assert bool((logA == 0).all()) and bool(acc.all())
        st = tst
        for _ in range(2):
            st = _torch_stub(None, st, tdata, THP, None, beta=0.5)
        np.testing.assert_allclose(new.nu.numpy(), st.nu.numpy(), rtol=1e-5)
        np.testing.assert_allclose(new.nu.numpy(), np.asarray(jnew.nu),
                                   rtol=1e-5)
        np.testing.assert_allclose(new.sigma2.numpy(), st.sigma2.numpy(),
                                   rtol=1e-5)


def test_excursion_accepts_and_rejects_per_chain():
    """Chain 0 walks away from the data (logA hugely negative: rejected),
    chain 1 stands still (logA = 0: accepted), chain 2 walks toward the
    truth (logA hugely positive: accepted).  Each chain ends with its own
    whole state, start or endpoint, in every field the sweep moved."""
    data, truth = simulate_functional(seed=7, N=6, K=2, P=5, M=2,
                                      n_time=(8, 12), sigma2=0.5)
    tdata = convert.data_from_jax(data, device="cpu")
    st0 = convert.state_from_numpy(truth, chains=3, device="cpu")
    nu_true = st0.nu.clone()
    st0 = st0.replace(nu=st0.nu * torch.tensor([1.0, 1.0, 3.0])[:, None, None])
    grow = torch.tensor([1.5, 1.0, 1.0])[:, None, None]
    pull = torch.tensor([0.0, 0.0, 0.5])[:, None, None]

    def sweep(generator, st, data, hp, c, beta=1.0):
        nu = st.nu * grow
        nu = nu + pull * (nu_true - nu)
        return st.replace(nu=nu, Z=st.Z.flip(-1), tau=st.tau + 1.0)

    new, acc, logA = drivers.tempered_excursion(
        torch.Generator().manual_seed(1), st0, tdata, THP,
        torch.full((2,), 10.0), drivers.make_temperature_ladder(0.25, 3),
        sweep_fn=sweep)
    assert logA[0] < -100 and abs(logA[1]) < 1e-3 and logA[2] > 100
    assert acc.tolist() == [False, True, True]
    end = st0
    for _ in range(6):
        end = sweep(None, end, tdata, THP, None)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(new, f)[0], getattr(st0, f)[0]), f
        assert torch.equal(getattr(new, f)[1:], getattr(end, f)[1:]), f
    assert not torch.equal(new.tau[1:], st0.tau[1:])


def test_nan_log_acceptance_rejects():
    data, truth = simulate_functional(seed=7, N=6, K=2, P=5, M=2,
                                      n_time=(8, 12), sigma2=0.5)
    tdata = convert.data_from_jax(data, device="cpu")
    st0 = convert.state_from_numpy(truth, chains=2, device="cpu")

    def sweep(generator, st, data, hp, c, beta=1.0):
        return st.replace(sigma2=st.sigma2 * torch.tensor([float("nan"), 1.0]))

    new, acc, logA = drivers.tempered_excursion(
        torch.Generator().manual_seed(1), st0, tdata, THP, None,
        drivers.make_temperature_ladder(0.25, 3), sweep_fn=sweep)
    assert acc.tolist() == [False, True]
    assert bool(torch.isfinite(new.sigma2).all())


# ---------------------------------------------------------------------------
# run_chain: when an excursion runs, and at which temperatures
# ---------------------------------------------------------------------------

def _recording_sweep(log):
    def sweep(generator, st, data, hp, c, beta=1.0):
        log.append(round(float(beta), 6))
        return st.replace(alpha3=st.alpha3 + 1.0)
    return sweep


@pytest.mark.parametrize("thin", [1, 2])
def test_excursion_replaces_the_sweep_of_its_iteration(thin):
    data, truth = simulate_functional(seed=7, N=6, K=2, P=5, M=2,
                                      n_time=(8, 12))
    tdata = convert.data_from_jax(data, device="cpu")
    st = convert.state_from_numpy(truth, chains=2, device="cpu")
    ladder = drivers.make_temperature_ladder(0.25, 2)
    g1 = round(float(ladder[1]), 6)
    rungs = [1.0, g1, g1, 1.0]        # first and last rung at beta 1
    log = []
    res = drivers.run_chain(torch.Generator().manual_seed(0), st, tdata, THP,
                            None, sweep=_recording_sweep(log), n_iters=8,
                            thin=thin, n_temp_trans=3, ladder=ladder)
    # iterations 0..7: excursions at 3 and 6, never at 0
    assert log == [1.0] * 3 + rungs + [1.0] * 2 + rungs + [1.0]
    assert res.tt_accept.shape == (2, 2)
    assert res.loglik.shape == (2, 8 // thin)
    # continued from iteration 2, the schedule is the unbroken run's
    log.clear()
    res = drivers.run_chain(torch.Generator().manual_seed(0), st, tdata, THP,
                            None, sweep=_recording_sweep(log), n_iters=2,
                            n_temp_trans=3, ladder=ladder, start_iter=2)
    assert log == [1.0] + rungs
    # no ladder, no excursion
    log.clear()
    res = drivers.run_chain(torch.Generator().manual_seed(0), st, tdata, THP,
                            None, sweep=_recording_sweep(log), n_iters=4)
    assert log == [1.0] * 4 and res.tt_accept is None


def test_split_run_equals_unbroken_run():
    """6 sweeps with an excursion at 4 equal 3 + 3 from the same generator,
    bit for bit, when the second part starts at iteration 3."""
    data, truth = simulate_functional(seed=3, N=6, K=2, P=5, M=2,
                                      n_time=(8, 12))
    tdata = convert.data_from_jax(data, device="cpu")
    st = convert.state_from_numpy(truth, chains=2, device="cpu")
    c = torch.full((2,), 10.0)
    kw = dict(n_temp_trans=4, N_t=2, beta_N_t=0.5, collapsed_z=True,
              gauge=True, phi_mala_steps=2)
    whole = drivers.phase_warm_start(torch.Generator().manual_seed(5), st,
                                     tdata, THP, c, n_iters=6, **kw)
    g = torch.Generator().manual_seed(5)
    a = drivers.phase_warm_start(g, st, tdata, THP, c, n_iters=3, **kw)
    b = drivers.phase_warm_start(g, a.final_state, tdata, THP, c, n_iters=3,
                                 start_iter=3, **kw)
    assert a.tt_accept is None and b.tt_accept.shape == (2, 1)
    for f in STATE_FIELDS:
        assert torch.equal(torch.cat([a.traces[f], b.traces[f]], 1),
                           whole.traces[f]), f
    assert torch.equal(torch.cat([a.loglik, b.loglik], 1), whole.loglik)


def test_excursion_probes_k2_once_per_rung_state(monkeypatch):
    """An excursion of 2 N_t rungs calls K2's wrapper 2 N_t + 1 times for
    pz_unit, beside its sweeps' own calls; on CPU tensors no call launches
    the kernel."""
    data, truth = simulate_functional(seed=3, N=6, K=2, P=5, M=2,
                                      n_time=(8, 12))
    tdata = convert.data_from_jax(data, device="cpu")
    st = convert.state_from_numpy(truth, chains=2, device="cpu")
    calls = []
    orig = kernels.mean_rss

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(kernels, "mean_rss", counting)
    kernels.reset_launch_counts()
    drivers.tempered_excursion(
        torch.Generator().manual_seed(0), st, tdata, THP, None,
        drivers.make_temperature_ladder(0.5, 3), sweep_fn=_torch_stub)
    assert len(calls) == 2 * 3 + 1
    assert kernels.LAUNCHES["mean_rss"] == 0


# ---------------------------------------------------------------------------
# posterior_median_state, best_chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_draws,burnin", [(10, 0.8), (11, 0.8), (25, 0.5),
                                            (5, 0.0)])
def test_posterior_median_matches_jax(n_draws, burnin):
    """Even numbers of kept draws average the two middle ones, as
    jnp.median does (torch.median would take the lower)."""
    rng = np.random.default_rng(n_draws)
    traces = {"Z": rng.dirichlet(np.ones(3), size=(n_draws, 7)),
              "pi": rng.dirichlet(np.ones(3), size=n_draws),
              "nu": rng.normal(size=(n_draws, 3, 5)),
              "sigma2": rng.gamma(2.0, size=n_draws)}
    traces = {k: v.astype(np.float32) for k, v in traces.items()}
    got = drivers.posterior_median_state(traces, burnin)
    want = jdrivers.posterior_median_state(
        {k: jnp.asarray(v) for k, v in traces.items()}, burnin)
    for k in traces:
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6)
    np.testing.assert_allclose(got["Z"].sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got["pi"].sum(), 1.0, rtol=1e-6)
    kept = n_draws - int(burnin * n_draws)
    lower = torch.median(torch.from_numpy(traces["nu"][n_draws - kept:]),
                         dim=0).values.numpy()
    assert (kept % 2 == 1) == np.allclose(lower, got["nu"], rtol=1e-6)


def test_best_chain_matches_jax_with_a_tie():
    ll = np.array([[0.0, 1.0, 5.0, 5.0], [9.0, 9.0, 5.0, 5.0],
                   [0.0, 0.0, 4.0, 7.0], [0.0, 0.0, 7.0, 4.0]], np.float32)
    for window in (1, 2, 3, 4, 100):
        got = drivers.best_chain(ll, window=window)
        assert isinstance(got, int)
        assert got == int(jdrivers.best_chain(jnp.asarray(ll), window=window))
    assert drivers.best_chain(ll, window=2) == 2      # 2 and 3 tie: the first
    assert drivers.best_chain(ll, window=4) == 1
    assert drivers.best_chain(torch.from_numpy(ll), window=4) == 1


# ---------------------------------------------------------------------------
# The phase sweeps
# ---------------------------------------------------------------------------

def _small_ensemble(chains, seed=9):
    data, truth = simulate_functional(seed=seed, N=12, K=2, P=5, M=2,
                                      n_time=(10, 14))
    cfg = ModelConfig(K=2, P=5, M=2)
    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    states = jax.jit(jax.vmap(lambda k: init_state(k, cfg, data)))(keys)
    return data, truth, states


def test_sweep_nu_z_leaves_the_covariance_block_untouched():
    data, _, states = _small_ensemble(3)
    tdata = convert.data_from_jax(data, device="cpu")
    st = convert.state_from_numpy(states, chains=3, device="cpu")
    new = gibbs.sweep_nu_z(torch.Generator().manual_seed(0), st, tdata, THP,
                           torch.full((2,), 10.0))
    for f in ("Phi", "chi", "gamma", "delta", "A", "xi"):
        assert getattr(new, f) is getattr(st, f), f
    for f in ("Z", "pi", "alpha3", "nu", "tau", "sigma2"):
        assert not torch.equal(getattr(new, f), getattr(st, f)), f
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        gibbs.sweep_nu_z(None, st, tdata, THP, None, covariate_mean=True)


def test_sweep_theta_leaves_the_mean_block_untouched():
    data, _, states = _small_ensemble(3)
    tdata = convert.data_from_jax(data, device="cpu")
    st = convert.state_from_numpy(states, chains=3, device="cpu")
    new = gibbs.sweep_theta(torch.Generator().manual_seed(0), st, tdata, THP)
    for f in ("Z", "nu", "pi", "alpha3", "eta"):
        assert getattr(new, f) is getattr(st, f), f
    for f in ("Phi", "delta", "A", "gamma", "tau", "sigma2", "chi"):
        assert not torch.equal(getattr(new, f), getattr(st, f)), f
    for kw in (dict(covariate_mean=True), dict(covariate_cov=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            gibbs.sweep_theta(None, st, tdata, THP, **kw)


def test_phase_nu_z_pins_phi_at_zero():
    data, _, states = _small_ensemble(2)
    tdata = convert.data_from_jax(data, device="cpu")
    st = convert.state_from_numpy(states, chains=2, device="cpu")
    res = drivers.phase_nu_z(torch.Generator().manual_seed(0), st, tdata,
                             THP, torch.full((2,), 10.0), n_iters=3)
    assert bool((res.traces["Phi"] == 0).all())
    assert bool((res.final_state.xi == 0).all())
    assert res.loglik.shape == (2, 3)
    assert torch.equal(res.traces["chi"][:, -1], st.chi)


@pytest.mark.parametrize("phase", ["nu_z", "theta"])
def test_phase_ensemble_matches_jax(phase):
    """80 sweeps of phase 1 or 2 from the same 96-chain start in both
    packages: the ensemble means of the final loglik, sigma2 and tau agree
    within 5 combined standard errors."""
    C, n = 96, 80
    data, truth, states = _small_ensemble(C)
    # phase 2 runs with (Z, nu) pinned at the truth, as after phase 1
    if phase == "theta":
        states = states.replace(
            Z=jnp.broadcast_to(truth.Z, states.Z.shape),
            nu=jnp.broadcast_to(truth.nu, states.nu.shape))
    c = jnp.full((2,), 10.0)
    jphase = {"nu_z": jdrivers.phase_nu_z, "theta": jdrivers.phase_theta}
    jres = jax.jit(jax.vmap(
        lambda k, st: jphase[phase](k, st, data, HP, c, n_iters=n)))(
        jax.random.split(jax.random.PRNGKey(1), C), states)

    tdata = convert.data_from_jax(data, device="cpu")
    tst = convert.state_from_numpy(states, chains=C, device="cpu")
    tphase = {"nu_z": drivers.phase_nu_z, "theta": drivers.phase_theta}
    res = tphase[phase](torch.Generator().manual_seed(1), tst, tdata, THP,
                        torch.full((2,), 10.0), n_iters=n)
    jfin, tfin = jres.final_state, convert.state_to_numpy(res.final_state)
    stats = {
        "loglik": (np.asarray(jres.loglik)[:, -1:],
                   res.loglik[:, -1:].numpy()),
        "sigma2": (np.asarray(jfin.sigma2)[:, None], tfin["sigma2"][:, None]),
        "tau": (np.sort(np.asarray(jfin.tau), 1), np.sort(tfin["tau"], 1)),
    }
    for name, (a, b) in stats.items():
        a, b = a.astype(np.float64), b.astype(np.float64)
        assert np.all(np.isfinite(b)), name
        se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
        assert np.all(np.abs(a.mean(0) - b.mean(0)) <= 5.0 * se), \
            f"{name}: {a.mean(0)} vs {b.mean(0)} (se {se})"
