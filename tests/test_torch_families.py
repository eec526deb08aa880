"""The port's multivariate (identity basis) and hd (tensor-product basis)
families against the JAX package's, on the CPU.

Deterministic pieces on identical inputs must be equal (the NumPy copies:
tensor basis, penalty, data makers, simulators, spectral init; float64 on
the host) or agree to f32 rounding, 2e-5 of the quantity's scale (mean
structure, RSS, log-likelihood).  The identity-basis shortcuts of the port
are also held against the port's own general path on the same data.  Each
stochastic updater on identity-basis data runs from one fixed state over
4000 keys in JAX and 4000 chains in the port and must agree in mean,
variance and acceptance within 5 combined standard errors
(test_torch_gibbs.py's rule).  The slice as a whole: ``api.fit`` on a small
covariate-adjusted, a multivariate and an hd data set against the JAX fit,
the bands stated in the test.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu import api as japi  # noqa: E402
from bayesfmmm_tpu import basis as jbasis  # noqa: E402
from bayesfmmm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models import state as jstate  # noqa: E402
from bayesfmmm_tpu.models.likelihood import (  # noqa: E402
    log_likelihood as jlog_likelihood)
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops import mean as jmean  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.utils import init_strategies as jinit  # noqa: E402
from bayesfmmm_tpu.utils import simulate as jsim  # noqa: E402
from bayesfmmm_torch import api, basis, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models import state as tstate  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops import kernels  # noqa: E402
from bayesfmmm_torch.ops import mean as tmean  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402
from bayesfmmm_torch.utils import init_strategies as tinit  # noqa: E402
from bayesfmmm_torch.utils import simulate as tsim  # noqa: E402

from test_torch_gibbs import _moments_agree, _rates_agree  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
N_DRAWS = 4000
BETA = 0.7
F32_RTOL = 2e-5
DATA_FIELDS = ("y", "mask", "B", "X", "G", "pen", "u", "yy")
HD = dict(basis_degrees=[2, 2], internal_knots_list=[np.array([0.5])] * 2,
          boundary_knots=np.array([[0., 1.], [0., 1.]]))


def _close(port, ref, what, rtol=F32_RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, f"{what}: {port.shape} vs {ref.shape}"
    err = np.max(np.abs(port - ref))
    assert err <= rtol * (np.max(np.abs(ref)) + 1.0), f"{what}: {err}"


def _same_data(tdata, jdata):
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(tdata, f).numpy(),
                                      np.asarray(getattr(jdata, f)), f)
    assert tdata.identity_basis == jdata.identity_basis
    assert tdata.family == jdata.family
    assert tdata.n_obs == float(np.asarray(jdata.mask).sum())


# ---------------------------------------------------------------------------
# The NumPy copies: basis, penalty, data makers, simulators, spectral init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [[3], [4, 3], [2, 3, 4]])
def test_mixed_radix_indices_copy_equals_original(sizes):
    np.testing.assert_array_equal(basis.mixed_radix_indices(sizes),
                                  jbasis.mixed_radix_indices(sizes))


@pytest.mark.parametrize("degrees,knots", [
    ([2, 2], [[0.5], [0.5]]), ([3, 1], [[0.3, 0.6], []]),
    ([1, 2, 2], [[0.5], [], [0.25, 0.5]])])
def test_tensor_basis_and_penalty_copy_equals_original(degrees, knots):
    rng = np.random.default_rng(0)
    dim = len(degrees)
    t = rng.uniform(0, 1, (17, dim))
    t[0], t[1] = 0.0, 1.0                      # both ends of the domain
    knots = [np.asarray(k, float) for k in knots]
    bounds = np.tile([0.0, 1.0], (dim, 1))
    np.testing.assert_array_equal(
        basis.tensor_bspline_basis(t, degrees, knots, bounds),
        jbasis.tensor_bspline_basis(t, degrees, knots, bounds))
    np.testing.assert_array_equal(basis.tensor_penalty(degrees, knots),
                                  jbasis.tensor_penalty(degrees, knots))
    assert basis.__all__ == ["bspline_basis", "rw1_penalty",
                             "mixed_radix_indices", "tensor_bspline_basis",
                             "tensor_penalty"]


@pytest.mark.parametrize("with_x", [False, True])
def test_hd_data_maker_matches_jax(with_x):
    rng = np.random.default_rng(1)
    t_list = [rng.uniform(0, 1, (n, 2)) for n in (9, 12, 7)]
    y_list = [rng.normal(size=len(t)) for t in t_list]
    X = rng.normal(size=(3, 2)) if with_x else None
    tdata = tstate.make_hd_functional_data(y_list, t_list, X=X, device="cpu",
                                           **HD)
    _same_data(tdata, jstate.make_hd_functional_data(y_list, t_list, X=X,
                                                     **HD))
    assert tdata.P == 16 and tdata.L == 12 and tdata.D == (2 if with_x else 0)


@pytest.mark.parametrize("with_x", [False, True])
def test_multivariate_data_maker_matches_jax(with_x):
    rng = np.random.default_rng(2)
    y = rng.normal(size=(6, 4))
    X = rng.normal(size=6) if with_x else None     # a vector: one covariate
    tdata = tstate.make_multivariate_data(y, X=X, device="cpu")
    _same_data(tdata, jstate.make_multivariate_data(y, X=X))
    assert tdata.identity_basis and tdata.D == int(with_x)
    d64 = tstate.make_multivariate_data(y, X=X, dtype=torch.float64,
                                        device="cpu")
    assert d64.y.dtype == torch.float64
    np.testing.assert_array_equal(d64.y.numpy(), y)


@pytest.mark.parametrize("family,kw", [
    ("hd", dict(seed=4, N=6, K=2, M=2, n_points=(10, 14))),
    ("hd", dict(seed=5, N=5, K=3, M=1, D=1, n_points=(8, 9), with_eta=True,
                with_xi=True)),
    ("multivariate", dict(seed=6, N=9, K=2, P=4, M=2)),
    ("multivariate", dict(seed=7, N=8, K=2, P=3, M=2, D=2, with_eta=True)),
])
def test_family_simulators_are_bit_equal(family, kw):
    name = ("simulate_hd_functional" if family == "hd"
            else "simulate_multivariate")
    jdata, jtruth = getattr(jsim, name)(**kw)
    tdata, ttruth = getattr(tsim, name)(device="cpu", **kw)
    _same_data(tdata, jdata)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(ttruth[f],
                                      np.asarray(getattr(jtruth, f)), f)
    back = convert.data_from_jax(jdata, device="cpu")
    assert back.family == family and torch.equal(back.G, tdata.G)


def test_hd_simulator_on_a_grid_equals_the_reference_generator():
    """chip_smoke.py::hd_grid_data builds the hd configuration's data; the
    JAX-made limits it is held to come from
    make_torch_families_reference.py::hd_grid_data."""
    sys.path.insert(0, os.path.join(HERE, "data"))
    try:
        import make_torch_families_reference as ref
    finally:
        sys.path.pop(0)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    p = dict(seed=7, N=5, K=3, M=2, grid=6, basis_degrees=[2, 2],
             n_internal=[1, 1], sigma2=0.01)
    tdata = chip_smoke.hd_grid_data(p, "cpu")
    _same_data(tdata, ref.hd_grid_data(p))
    assert tdata.L == 36 and tdata.P == 16


@pytest.fixture(scope="module", params=["multivariate", "hd"])
def family_case(request):
    """(JAX data, port data, 5 random chains' states in both packages)."""
    if request.param == "multivariate":
        jdata, _ = jsim.simulate_multivariate(seed=3, N=10, K=3, P=5, M=3,
                                              D=1, with_eta=True,
                                              with_xi=True)
    else:
        jdata, _ = jsim.simulate_hd_functional(seed=3, N=10, K=3, M=3, D=1,
                                               n_points=(20, 24),
                                               with_eta=True, with_xi=True)
    from test_torch_covariates import _jstate, _random_states
    d = _random_states(0, 5, 10, 3, int(jdata.P), 3, 1)
    return jdata, convert.data_from_jax(jdata, device="cpu"), _jstate(d), \
        convert.state_from_numpy(d, chains=5, device="cpu")


@pytest.mark.parametrize("what", ["compute_mu", "rss_from_coeffs",
                                  "rss_rows_from_coeffs", "log_likelihood"])
def test_family_mean_structure_matches_jax(family_case, what):
    jdata, tdata, js, ts = family_case
    if what == "log_likelihood":
        jout = jax.vmap(lambda s: jlog_likelihood(s, jdata))(js)
        tout = log_likelihood(ts, tdata)
    elif what == "compute_mu":
        jout = jax.vmap(lambda s: jmean.compute_mu(jdata, s))(js)
        tout = tmean.compute_mu(tdata, ts)
    else:
        jw = jax.vmap(lambda s: jmean.effective_coeffs(s, jdata.X))(js)
        jout = jax.vmap(lambda w: getattr(jmean, what)(jdata, w))(jw)
        tout = getattr(tmean, what)(tdata,
                                    tmean.effective_coeffs(ts, tdata.X))
    _close(tout.numpy(), jout, what)


def test_spectral_init_copy_equals_original_on_every_family(family_case):
    jdata, tdata, _, _ = family_case
    a, b = tinit.spectral_init(tdata, 3, 2), jinit.spectral_init(jdata, 3, 2)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-12,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The identity-basis shortcuts against the port's own general path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mv_pair():
    """Multivariate data twice: with the identity-basis flag, and the same
    arrays without it (the general path through B and G)."""
    data, truth = tsim.simulate_multivariate(seed=2, N=12, K=2, P=4, M=2,
                                             D=1, with_eta=True,
                                             with_xi=True, device="cpu")
    st = convert.state_from_numpy(truth, chains=3, device="cpu")
    st = st.replace(sigma2=torch.tensor([0.02, 0.05, 0.1]))
    return data, dataclasses.replace(data, identity_basis=False), st


def test_identity_shortcuts_of_the_helpers(mv_pair):
    data, general, st = mv_pair
    w = tmean.effective_coeffs(st, data.X)
    W = torch.rand(3, 5, 12, generator=torch.Generator().manual_seed(0))
    for fn, args in ((tg._gram_bvec, (W[:, 0], w)), (tg._weighted_gram, (W,)),
                     (tmean.rss_from_coeffs, (w,)),
                     (tmean.rss_rows_from_coeffs, (w,)),
                     (tmean.apply_basis, (w,)), (tmean.gram_vec, (w,))):
        torch.testing.assert_close(fn(data, *args), fn(general, *args),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tmean.compute_mu(data, st),
                               tmean.compute_mu(general, st))
    U = tmean.eigen_directions(st, data.X)
    assert tmean.gram_dirs(data, U) is U
    torch.testing.assert_close(tmean.gram_dirs(general, U), U)


@pytest.mark.parametrize("name,kw", [
    ("update_z", {}), ("update_nu", {}), ("update_eta", {}),
    ("update_phi", {}), ("update_xi", {}), ("update_chi", {}),
    ("update_sigma", {}), ("update_z_chi", {}), ("update_chi_joint", {}),
    ("update_mgp_scale", {}), ("update_noise_scale", {}),
    ("update_phi_mala", dict(n_steps=2))])
def test_identity_shortcut_gives_the_general_path_s_draw(mv_pair, name, kw):
    """Same generator seed, same state: the updater's draw on identity-basis
    data equals its draw through B and G up to f32 rounding (1e-4 of the
    scale; MH decisions equal because the ratios differ by rounding only)."""
    data, general, st = mv_pair
    out = []
    for d in (data, general):
        g = torch.Generator().manual_seed(5)
        res = getattr(tg, name)(g, st, d, TPriors(), tcache(d, st), BETA,
                                **kw)
        out.append(res[0] if isinstance(res, tuple) else res)
    for f in STATE_FIELDS:
        _close(getattr(out[0], f).numpy(), getattr(out[1], f).numpy(),
               f"{name} {f}", rtol=1e-4)


def test_multivariate_family_launches_no_k2_and_no_k3(mv_pair, monkeypatch):
    """On identity-basis data no path of the production or the reference
    sweep reaches kernel K2 or K3 (their wrappers are never entered), and
    the general path does."""
    data, general, st = mv_pair
    calls = {"mean_rss": 0, "weighted_gram": 0}
    for name in calls:
        plain = getattr(kernels, name)

        def counted(*a, _name=name, _plain=plain, **k):
            calls[_name] += 1
            return _plain(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    g = torch.Generator().manual_seed(0)
    c = torch.full((2,), 10.0)
    flags = dict(covariate_mean=True, covariate_cov=True)
    for census in ({}, api.PRODUCTION_FLAGS):
        new = tg.sweep_full(g, st, data, TPriors(), c, **flags, **census)
        log_likelihood(new, data)
        tmean.compute_mu(data, new)
    assert calls == {"mean_rss": 0, "weighted_gram": 0}
    tg.sweep_full(g, st, general, TPriors(), c, **flags)
    assert calls["mean_rss"] >= 1 and calls["weighted_gram"] >= 2


def test_export_layout_inverts_tau_for_the_multivariate_family(tmp_path):
    """Trace files of a multivariate fit with covariates, both packages, the
    same traces: equal byte for byte (Tau and Tau_Eta are reciprocals)."""
    from bayesfmmm_torch.io import armaio
    rng = np.random.default_rng(0)
    n, K, P, M, D, N = 3, 2, 3, 2, 1, 4
    shapes = dict(Z=(N, K), pi=(K,), alpha3=(), nu=(K, P), tau=(K,),
                  sigma2=(), chi=(N, M), Phi=(K, P, M), gamma=(K, P, M),
                  delta=(K, M), A=(K, 2), eta=(K, P, D), tau_eta=(K, D),
                  xi=(K, P, D, M), gamma_xi=(K, P, D, M),
                  delta_xi=(K, M, D), A_xi=(K, 2, D))
    traces = {f: rng.uniform(0.5, 2.0, (n,) + s).astype(np.float32)
              for f, s in shapes.items()}
    kw = dict(K=K, P=P, M=M, D=D, family="multivariate",
              covariate_mean=True, covariate_cov=True)
    api.export_traces(str(tmp_path / "t"), traces, ModelConfig(**kw))
    japi.export_traces(str(tmp_path / "j"), traces, JModelConfig(**kw))
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and "Tau_Eta0.txt" in \
        names and "Xi0.txt" in names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    back = armaio.load_trace_dir(str(tmp_path / "t"))
    np.testing.assert_allclose(back["Tau"], 1.0 / traces["tau"], rtol=1e-5)


# ---------------------------------------------------------------------------
# Updaters on identity-basis data by moments, against their JAX twins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mv_case():
    jdata, truth = jsim.simulate_multivariate(seed=2, N=10, K=2, P=5, M=2)
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


_MV_UPDATERS = {
    "z": ("update_z", {}, ("Z",)), "nu": ("update_nu", {}, ("nu",)),
    "phi": ("update_phi", {}, ("Phi",)), "chi": ("update_chi", {}, ("chi",)),
    "sigma": ("update_sigma", {}, ("sigma2",)),
    "z_chi": ("update_z_chi", dict(p_indep=0.3), ("Z", "chi")),
    "chi_joint": ("update_chi_joint", {}, ("chi",)),
    "mgp_scale": ("update_mgp_scale", {}, ("Phi", "delta")),
    "noise_scale": ("update_noise_scale", {}, ("sigma2", "Phi", "delta")),
    "phi_mala": ("update_phi_mala", dict(step=0.05, n_steps=4),
                 ("Phi", "chi")),
}


@pytest.mark.parametrize("name", list(_MV_UPDATERS))
def test_multivariate_updater_moments_match_jax(mv_case, name):
    jdata, js, tdata, ts = mv_case
    fn, kw, fields = _MV_UPDATERS[name]

    def first(res):
        return res[0] if isinstance(res, tuple) else res

    keys = jax.random.split(jax.random.PRNGKey(19), N_DRAWS)
    jout = jax.jit(jax.vmap(lambda k: {f: getattr(first(getattr(jg, fn)(
        k, js, jdata, Priors(), jcache(jdata, js), BETA, **kw)), f)
        for f in fields}))(keys)
    tst = first(getattr(tg, fn)(torch.Generator().manual_seed(19), ts, tdata,
                                TPriors(), tcache(tdata, ts), BETA, **kw))
    for f in fields:
        j, t = np.asarray(jout[f]), getattr(tst, f).numpy()
        assert t.shape == j.shape and np.isfinite(t).all()
        _moments_agree(j, t, f"{name} {f}")
        cur = np.asarray(getattr(js, f))
        if name in ("z", "z_chi", "mgp_scale", "noise_scale", "phi_mala") \
                and f in ("Z", "delta", "sigma2", "Phi"):
            ja = (j != cur[None]).reshape(N_DRAWS, -1).any(1, keepdims=True)
            ta = (t != cur[None]).reshape(N_DRAWS, -1).any(1, keepdims=True)
            _rates_agree(ja.astype(float), ta.astype(float), f"{name} {f}")


def test_nu_recovery_mv():
    """tests/test_kernels_recovery.py::test_nu_recovery_mv over 64 chains."""
    data, truth = tsim.simulate_multivariate(seed=2, N=200, K=2, P=6, M=2,
                                             device="cpu")
    st = convert.state_from_numpy(truth, chains=64, device="cpu")
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        st = tg.update_nu(g, st, data, TPriors(), tcache(data, st))[0]
    np.testing.assert_allclose(np.median(st.nu.numpy(), axis=0), truth["nu"],
                               atol=0.3)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

_FITS = {
    "covariates": (jsim.simulate_functional,
                   dict(seed=31, N=30, K=2, P=6, M=2, D=1, n_time=(30, 40),
                        with_eta=True, with_xi=True), dict(covariate_cov=True)),
    "multivariate": (jsim.simulate_multivariate,
                     dict(seed=32, N=60, K=2, P=6, M=2), {}),
    "hd": (jsim.simulate_hd_functional,
           dict(seed=33, N=24, K=2, M=2, n_points=(30, 36)), {}),
}


@pytest.mark.parametrize("which", list(_FITS))
def test_family_pipeline_matches_jax_by_moments(which, tmp_path):
    """Three phases of 150 sweeps through both packages on the same data,
    two restarts from the spectral init, reference census.  So short a run
    stops short of the mode, in both packages alike, so the bands are per
    observed point: both fits within 0.45 nats a point of the log-likelihood
    at the truth and within 0.12 of each other; sigma2 within a factor 3 of
    the truth and 1.25 of each other.  Over two JAX and three port seeds
    the packages differed by at most 0.09 nats a point and a factor 1.15,
    and lay up to 0.37 and a factor 2.5 from the truth."""
    sim, kw, fit_kw = _FITS[which]
    jdata, truth = sim(**kw)
    ll_truth = float(jlog_likelihood(truth, jdata))
    j1 = japi.fit_nu_z(data=jdata, K=2, M=2, tot_mcmc_iters=150, n_try=2,
                       init="spectral")
    j2 = japi.fit_theta(j1, tot_mcmc_iters=150, n_try=2, **fit_kw)
    j3 = japi.fit_warm_start(j1, j2, tot_mcmc_iters=150, progress=False)
    tdata = convert.data_from_jax(jdata, device="cpu")
    res = api.fit(data=tdata, K=2, M=2, nu_z_iters=150, theta_iters=150,
                  warm_iters=150, n_try=2, progress=False, init="spectral",
                  directory=str(tmp_path), **fit_kw)
    assert res.config == ModelConfig(
        K=2, P=int(jdata.P), M=2, D=int(jdata.D), family=jdata.family,
        covariate_mean=jdata.D > 0,
        covariate_cov=bool(fit_kw.get("covariate_cov")))
    assert res.config == ModelConfig(**dataclasses.asdict(j3.config))
    for v in res.traces.values():
        assert np.isfinite(v).all()
    ll_port = float(np.mean(res.loglik[-20:]))
    ll_jax = float(np.mean(np.asarray(j3.loglik)[-20:]))
    s2_port = float(np.mean(res.traces["sigma2"][-20:]))
    s2_jax = float(np.mean(np.asarray(j3.traces["sigma2"])[-20:]))
    s2_true = float(truth.sigma2)
    n = float(np.asarray(jdata.mask).sum())
    assert abs(ll_port - ll_truth) < 0.45 * n, (ll_port, ll_truth)
    assert abs(ll_jax - ll_truth) < 0.45 * n, (ll_jax, ll_truth)
    assert abs(ll_port - ll_jax) < 0.12 * n, (ll_port, ll_jax)
    for a, b, factor in ((s2_port, s2_true, 3.0), (s2_jax, s2_true, 3.0),
                         (s2_port, s2_jax, 1.25)):
        assert 1 / factor < a / b < factor, (s2_port, s2_jax, s2_true)
    files = sorted(os.listdir(tmp_path))
    assert ("Eta0.txt" in files) == (jdata.D > 0)
    assert ("Xi0.txt" in files) == bool(fit_kw.get("covariate_cov"))
