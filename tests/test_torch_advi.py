"""The port's ADVI (samplers/advi.py) and ``api.fit_advi_init`` against the
JAX package's, on the CPU.

``run_advi`` on the JAX package's own draws (``jax.random.normal(
fold_in(key, i), (n_mc, dim))``, handed to the port) gives its ELBO trace and
final (mu, log_sd): to 1e-9 relative in float64, and to the float32
tolerance stated in the test in float32.  ``sample_from_advi`` on injected
draws gives the JAX package's states, through ``convert.advi_from_jax``.
Then ports of tests/test_samplers_advanced.py::test_advi_improves_elbo_and_
inits, tests/test_pipeline.py::test_advi_init_pipeline (and a functional
case), the ADVI half of tests/test_validation.py::test_fit_hmc_advi_
validations, and ROADMAP F14: with X and ``covariate_cov=False`` xi stays 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from bayesfmmm_tpu.config import ModelConfig as JConfig  # noqa: E402
from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models import logjoint as jlj  # noqa: E402
from bayesfmmm_tpu.samplers import advi as jadvi  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional as jsim  # noqa: E402
from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models import logjoint  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.samplers import advi  # noqa: E402
from bayesfmmm_torch.utils.simulate import (  # noqa: E402
    simulate_functional, simulate_multivariate)

HP = Priors()
N_STEPS, N_MC, LR = 30, 4, 0.05
# float32: relative error of the ELBO trace, and of (mu, log_sd) as the
# max |port - JAX| over max |JAX|: the two packages sum the log-joint's
# terms in another order, and Adam's steps carry that rounding on (3e-6
# and 5e-6 measured on this model).
F32_TOL = {"elbo": 2e-5, "params": 1e-4}


def _jax_run(dtype):
    """The JAX package's run_advi on a small functional model: the data,
    the init, the result and the draws it used (as NumPy)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jdata, _ = jsim(seed=61, N=15, K=2, P=5, M=2, n_time=(15, 20), dtype=jdt)
    cfg = JConfig(K=2, P=5, M=2)
    lj = jlj.make_log_joint(jdata, HP, jnp.full((2,), 10.0, jdt))
    unc0 = jlj.init_unc(jax.random.PRNGKey(4), cfg, jdata, jdt)
    key = jax.random.PRNGKey(5)
    res = jadvi.run_advi(key, lj, unc0, n_steps=N_STEPS, n_mc=N_MC,
                         learning_rate=LR)
    dim = ravel_pytree(unc0)[0].shape[0]
    draws = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (N_MC, dim))) for i in range(N_STEPS)])
    return jdata, unc0, res, draws


def _port_run(jdata, unc0, draws, dtype):
    tdata = convert.data_from_jax(jdata, device="cpu", dtype=dtype)
    tunc = convert.unc_from_jax(unc0, device="cpu", dtype=dtype)
    lj = logjoint.make_log_joint(tdata, TPriors(),
                                 torch.full((2,), 10.0, dtype=dtype))
    return tunc, advi.run_advi(None, lj, tunc, n_steps=N_STEPS, n_mc=N_MC,
                               learning_rate=LR,
                               draws=torch.tensor(draws, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_run_advi_matches_jax_on_its_draws(dtype):
    """The ELBO trace and the final (mu, log_sd) equal the JAX package's
    run_advi on the same draws: 1e-9 relative in float64, F32_TOL in
    float32."""
    with jax.enable_x64(dtype == torch.float64):
        jdata, unc0, res, draws = _jax_run(dtype)
        j_mu = np.asarray(ravel_pytree(res.mean)[0], np.float64)
        j_sd = np.asarray(res.log_sd_flat, np.float64)
        j_elbo = np.asarray(res.elbo_trace, np.float64)
    _, tres = _port_run(jdata, unc0, draws, dtype)
    t_mu = logjoint.flatten(tres.mean)[0].double().numpy()
    t_elbo = tres.elbo_trace.double().numpy()
    t_sd = tres.log_sd_flat.double().numpy()
    assert tres.elbo_trace.shape == (N_STEPS,) and t_mu.shape == j_mu.shape
    assert j_elbo[-5:].mean() > j_elbo[:5].mean()          # it optimizes
    if dtype == torch.float64:
        np.testing.assert_allclose(t_elbo, j_elbo, rtol=1e-9)
        np.testing.assert_allclose(t_mu, j_mu, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(t_sd, j_sd, rtol=1e-9, atol=1e-12)
    else:
        np.testing.assert_allclose(t_elbo, j_elbo, rtol=F32_TOL["elbo"])
        for got, want in ((t_mu, j_mu), (t_sd, j_sd)):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err < F32_TOL["params"], err


def test_sample_from_advi_matches_jax_on_injected_draws():
    """sample_from_advi of the JAX result carried across by
    convert.advi_from_jax, on the JAX package's draws, gives its states
    (float64, 1e-12)."""
    with jax.enable_x64(True):
        jdata, unc0, res, _ = _jax_run(torch.float64)
        key = jax.random.PRNGKey(6)
        jsamples = jadvi.sample_from_advi(key, res, n_samples=3)
        jstates = jax.vmap(jlj.to_state)(jsamples)
        dim = res.log_sd_flat.shape[0]
        draws = np.asarray(jax.random.normal(key, (3, dim)))
        want = {f: np.asarray(getattr(jstates, f)) for f in STATE_FIELDS}
    like = convert.unc_from_jax(unc0, device="cpu", dtype=torch.float64)
    tres = convert.advi_from_jax(res, like, device="cpu",
                                 dtype=torch.float64)
    got = logjoint.to_state(advi.sample_from_advi(
        None, tres, n_samples=3, draws=torch.tensor(draws)))
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    with pytest.raises(ValueError, match="coordinates"):
        convert.advi_from_jax(res._replace(log_sd_flat=res.log_sd_flat[1:]),
                              like, device="cpu", dtype=torch.float64)


def test_advi_improves_elbo_and_inits():
    """Port of tests/test_samplers_advanced.py::test_advi_improves_elbo_and_
    inits, on the same data and settings."""
    data, _ = simulate_functional(seed=61, N=16, K=2, P=5, M=2,
                                  n_time=(15, 20), device="cpu")
    lj = logjoint.make_log_joint(data, TPriors(), torch.full((2,), 10.0))
    g = torch.Generator().manual_seed(4)
    unc0 = logjoint.init_unc(g, ModelConfig(K=2, P=5, M=2), data, 1)
    res = advi.run_advi(g, lj, unc0, n_steps=200, learning_rate=0.05)
    elbo = res.elbo_trace.numpy()
    assert elbo[-20:].mean() > elbo[:20].mean() + 100
    # the variational mean maps to a valid model state
    st = logjoint.to_state(res.mean)
    assert float(st.sigma2) > 0
    np.testing.assert_allclose(st.Z.sum(-1).numpy(), 1.0, atol=1e-5)
    # samples from q are finite states
    sts = logjoint.to_state(advi.sample_from_advi(g, res, n_samples=3))
    assert sts.nu.shape[0] == 3 and bool(torch.isfinite(sts.nu).all())


@pytest.mark.parametrize("family", ["multivariate", "functional"])
def test_advi_init_pipeline(family):
    """Port of tests/test_pipeline.py::test_advi_init_pipeline (the
    multivariate case, its settings) and a functional case: finite
    log-likelihoods of every chain, a rising ELBO, the result's layout."""
    if family == "multivariate":
        data, _ = simulate_multivariate(seed=22, N=100, K=2, P=5, M=2,
                                        device="cpu")
        kw = dict(warm_iters=150, advi_steps=150, n_chains=2)
    else:
        data, _ = simulate_functional(seed=22, N=20, K=2, P=5, M=2,
                                      n_time=(15, 20), device="cpu")
        kw = dict(warm_iters=120, advi_steps=100, n_chains=3, thinning_num=2)
    res = api.fit_advi_init(data, K=2, M=2, device="cpu", **kw)
    assert np.isfinite(res.all_chain_loglik).all()
    assert res.elbo_trace[-10:].mean() > res.elbo_trace[:10].mean()
    n_kept = kw["warm_iters"] // kw.get("thinning_num", 1)
    assert res.all_chain_loglik.shape == (kw["n_chains"], n_kept)
    assert res.elbo_trace.shape == (kw["advi_steps"],)
    assert res.traces["Z"].shape == (n_kept, data.N, 2)
    assert np.array_equal(res.loglik, res.all_chain_loglik[res.chain_index])
    assert res.config.family == family and not res.config.covariate_mean


def test_fit_advi_init_validations():
    """The ADVI half of tests/test_validation.py::test_fit_hmc_advi_
    validations, and the other checks the JAX function makes."""
    data, _ = simulate_multivariate(seed=1, N=20, K=2, P=4, M=1,
                                    device="cpu")
    for kw, msg in ((dict(K=2, M=1, warm_iters=10), "'tot_mcmc_iters' must "
                     "be an integer"),
                    (dict(K=1, M=1), "'K' must be an integer"),
                    (dict(K=2, M=0), "'n_eigen' must be an integer"),
                    (dict(K=2, M=1, thinning_num=0), "'thinning_num'"),
                    (dict(K=2, M=1, N_t=0), "'N_t'")):
        with pytest.raises(ValueError, match=msg):
            api.fit_advi_init(data, device="cpu", **kw)


def test_xi_stays_zero_without_covariate_cov(tmp_path):
    """ROADMAP F14 not copied: with X and covariate_cov=False the xi tower
    is held out of q and of every sweep, so xi is exactly 0 in every draw
    (the JAX package moves it in q and then never again); with
    covariate_cov=True it moves.  The export writes no Xi file."""
    data, _ = simulate_functional(seed=52, N=15, K=2, P=5, M=2, D=1,
                                  with_eta=True, with_xi=True, device="cpu")
    kw = dict(K=2, M=2, warm_iters=100, advi_steps=50, n_chains=2,
              device="cpu")
    res = api.fit_advi_init(data, covariate_cov=False, directory=tmp_path,
                            **kw)
    assert res.config.covariate_mean and not res.config.covariate_cov
    assert not np.any(res.traces["xi"]) and not res.final_state.xi.any()
    assert np.all(res.traces["gamma_xi"] == 1.0)
    assert np.abs(res.traces["eta"]).max() > 0
    written = {p.name for p in tmp_path.iterdir()}
    assert any("Eta" in f for f in written), written
    assert not any("Xi" in f for f in written), written
    res = api.fit_advi_init(data, covariate_cov=True, **kw)
    assert res.config.covariate_cov and np.abs(res.traces["xi"]).max() > 0


def test_fit_advi_init_without_a_device_needs_the_card(monkeypatch):
    data, _ = simulate_multivariate(seed=1, N=20, K=2, P=4, M=1,
                                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.fit_advi_init(data, K=2, M=1, warm_iters=100)
