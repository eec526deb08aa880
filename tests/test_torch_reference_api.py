"""The port's reference-named API (bayesfmmm_torch/reference_api.py) against
the JAX package's, on the CPU.

The 33 names keep the JAX package's signatures but for a keyword-only
``device``.  The R-named fitters are thin wrappers: they are held to the
JAX wrappers by what each hands ``api.fit_*`` for the same R call, and to
the port's own ``api.fit_*`` by the bits (the two packages draw other
random streams).  Every post-processing name is run by both packages on one
trace directory that the port's ``export_traces`` wrote: equal to float64
rounding, CPO within the float32 tolerance of tests/test_torch_post.py."""

import dataclasses
import inspect
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402, F401

from bayesfmmm_tpu import api as japi  # noqa: E402
from bayesfmmm_tpu import reference_api as J  # noqa: E402
from bayesfmmm_torch import api  # noqa: E402
from bayesfmmm_torch import reference_api as R  # noqa: E402
from bayesfmmm_torch.config import ModelConfig  # noqa: E402
from bayesfmmm_torch.models.state import make_hd_functional_data  # noqa: E402
from bayesfmmm_torch.utils.simulate import (functional_lists,  # noqa: E402
                                            simulate_draws,
                                            simulate_functional,
                                            simulate_multivariate)

CPO_TOL = dict(rtol=0, atol=2e-3)     # tests/test_torch_post.py
EXACT = dict(rtol=1e-12, atol=1e-12)
REF_NAMES = [
    "BFMMM_Nu_Z_multiple_try", "BFMMM_Theta_est", "BFMMM_warm_start",
    "BHDFMMM_Nu_Z_multiple_try", "BHDFMMM_Theta_est", "BHDFMMM_warm_start",
    "BMVMMM_Nu_Z_multiple_try", "BMVMMM_Theta_est", "BMVMMM_warm_start",
    "ConditionalPredictiveOrdinates", "FAIC", "FBIC", "FCovCI", "FDIC",
    "FLLik", "FMeanCI", "FSamplePaths", "HDFCovCI", "HDFMeanCI", "MVAIC",
    "MVBIC", "MVCovCI", "MVDIC", "MVLLik", "MVMeanCI", "ReadCube",
    "ReadFieldCube", "ReadFieldMat", "ReadFieldVec", "ReadMat", "ReadVec",
    "SigmaCI", "ZCI"]
# the names that build data or state take a keyword-only device
DEVICE_NAMES = {
    "BFMMM_Nu_Z_multiple_try", "BHDFMMM_Nu_Z_multiple_try",
    "BMVMMM_Nu_Z_multiple_try", "BFMMM_Theta_est", "BHDFMMM_Theta_est",
    "BMVMMM_Theta_est", "FDIC", "FAIC", "FBIC", "FLLik", "MVDIC", "MVAIC",
    "MVBIC", "MVLLik", "ConditionalPredictiveOrdinates", "FSamplePaths",
    "_traces_and_data_from_dir"}


def _knots(P):
    return np.linspace(0, 1, P - 4 + 2)[1:-1]


# ---------------------------------------------------------------------------
# the surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REF_NAMES + ["_traces_and_data_from_dir"])
def test_names_and_signatures_equal_the_jax_package_but_for_device(name):
    assert sorted(R.__all__) == sorted(J.__all__) == sorted(REF_NAMES)
    port, jax_ = inspect.signature(getattr(R, name)), \
        inspect.signature(getattr(J, name))
    params = dict(port.parameters)
    if name in DEVICE_NAMES:
        dev = params.pop("device")
        assert dev.kind == inspect.Parameter.KEYWORD_ONLY and dev.default is None
    else:
        assert "device" not in params
    assert port.replace(parameters=list(params.values())) == jax_


# ---------------------------------------------------------------------------
# argument mapping: what each wrapper hands api.fit_* for one R call
# ---------------------------------------------------------------------------

def _norm(x):
    """A comparable form of what a wrapper passed: arrays by value,
    dataclasses (Priors, ModelConfig) by field, a result by its traces,
    configuration and data, a device dropped."""
    if hasattr(x, "traces"):
        data = getattr(x, "data", None)
        return {"traces": _norm(x.traces), "config": _norm(getattr(x, "config",
                                                                   None)),
                "data": None if data is None else {
                    f: _norm(getattr(data, f))
                    for f in ("y", "mask", "B", "X", "family",
                              "identity_basis")}}
    if dataclasses.is_dataclass(x):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return np.asarray(x.numpy(), np.float64)
    if isinstance(x, (np.ndarray, jax.Array)):
        return np.asarray(x, np.float64)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k != "device"}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _assert_same(a, b, where="call"):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _recorders(monkeypatch, mod, calls):
    for name in ("fit_nu_z", "fit_theta", "fit_warm_start"):
        def record(*a, _name=name, **kw):
            calls.append((_name, a, kw))
            return mod.FitResult({}, np.zeros(1), None)
        monkeypatch.setattr(mod, name, record)


def _fitter_calls(tmp):
    """(R name, positional args, keywords) of every fitter and both
    Theta_est forms, the inputs shared by the two packages."""
    rng = np.random.default_rng(4)
    t = [np.sort(rng.uniform(0, 1, n)) for n in (9, 12, 10)]
    Y = [np.sin(5 * ti) + 0.1 * rng.normal(size=len(ti)) for ti in t]
    knots = [0.3, 0.6]
    Ymv = rng.normal(size=(6, 4))
    g = np.linspace(0, 1, 4)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    Yhd = [np.cos(3 * pts[:, 0]) + 0.1 * rng.normal(size=16) for _ in range(3)]
    thd = [pts] * 3
    hd_knots = [np.array([0.5]), np.array([0.5])]
    bk = np.array([[0.0, 1.0], [0.0, 1.0]])
    X = rng.normal(size=(3, 1))
    # the reference's cubes: (N, K, iters) and (K, P, iters)
    cube = {"Z": np.moveaxis(rng.dirichlet(np.ones(2), size=(7, 3)), 0, -1),
            "nu": rng.normal(size=(2, 6, 7))}
    hd_cube = {"Z": np.moveaxis(rng.dirichlet(np.ones(2), size=(7, 3)), 0,
                                -1),
               "nu": rng.normal(size=(2, 16, 7))}
    mv_first = {"Z": rng.dirichlet(np.ones(2), size=(7, 6)),
                "nu": rng.normal(size=(7, 2, 4))}
    phase1 = types.SimpleNamespace(traces={"Z": np.zeros((1, 3, 2))})
    priors = dict(alpha_0=2.0, beta_0=0.5, c=[4.0, 6.0])
    return [
        ("BFMMM_Nu_Z_multiple_try",
         (100, 3, 2, Y, t, 3, 3, 2, [0, 1], knots), dict(priors)),
        ("BFMMM_Nu_Z_multiple_try",
         (120, 1, 2, Y, t, 3, 2, 1, [0, 1], knots, X), {}),
        ("BFMMM_Theta_est", (150, 0, phase1, 3),
         dict(cov_adj=True, burnin_prop=0.5, b=4.0)),
        ("BFMMM_Theta_est", (150, 2, phase1), dict(n_eigen=2)),
        ("BFMMM_Theta_est",
         (100, 2, 2, Y, t, 3, 3, 2, [0, 1], knots, cube),
         dict(covariance_adj=True, nu_1=4.0)),
        ("BFMMM_Theta_est",
         (100, 1, 2, Y, t, 3, 3, 2, [0, 1], knots, cube, X), {}),
        ("BFMMM_warm_start", (200, phase1, phase1),
         dict(thinning_num=2, dir=tmp, n_temp_trans=50, beta_N_t=0.5, N_t=3,
              burnin_prop=0.5, alpha_nu=3.0)),
        ("BFMMM_warm_start", (100, phase1, phase1, 1, 50, tmp), {}),
        ("BMVMMM_Nu_Z_multiple_try", (100, 2, 2, Ymv, 3), dict(priors)),
        ("BMVMMM_Theta_est", (100, 1, phase1), dict(n_eigen=2)),
        ("BMVMMM_Theta_est", (100, 2, 2, Ymv, 3, mv_first), {}),
        ("BMVMMM_Theta_est", (100, 2), dict(K=2, Y=Ymv, n_eigen=3,
                                            multiple_try=mv_first)),
        ("BMVMMM_warm_start", (100, phase1, phase1), dict(N_t=2)),
        ("BHDFMMM_Nu_Z_multiple_try",
         (100, 1, 2, Yhd, thd, 3, [2, 2], 2, bk, hd_knots), {}),
        ("BHDFMMM_Theta_est",
         (100, 1, 2, Yhd, thd, 3, [2, 2], 2, bk, hd_knots, hd_cube), {}),
        ("BHDFMMM_Theta_est", (100, 1, phase1, 2), {}),
        ("BHDFMMM_warm_start", (100, phase1, phase1), {}),
    ]


def test_fitters_hand_api_what_the_jax_wrappers_hand_it(monkeypatch,
                                                         tmp_path):
    """All nine fitters and both Theta_est forms: the same api.fit_* call
    with the same arguments (n_eigen -> M, cov_adj/covariance_adj ->
    covariate_cov, dir -> directory, burnin_prop 0.8, n_try at least 1, the
    priors by field, a raw trace cube as a phase-1 result with the same
    traces, configuration and data); the port adds only its device."""
    calls_j, calls_p = [], []
    _recorders(monkeypatch, japi, calls_j)
    _recorders(monkeypatch, api, calls_p)
    for name, args, kw in _fitter_calls(str(tmp_path)):
        n_j, n_p = len(calls_j), len(calls_p)
        out_j = getattr(J, name)(*args, **kw)
        dev_kw = {"device": "cpu"} if name in DEVICE_NAMES else {}
        out_p = getattr(R, name)(*args, **kw, **dev_kw)
        assert isinstance(out_p, R.ReferenceFit) and \
            isinstance(out_j, J.ReferenceFit)
        assert len(calls_j) == n_j + 1 and len(calls_p) == n_p + 1, name
        (fj, aj, kj), (fp, ap, kp) = calls_j[-1], calls_p[-1]
        assert fj == fp, name
        if fp == "fit_nu_z":
            assert kp.pop("device") == "cpu"
        assert "device" not in kp, name
        _assert_same(_norm(ap), _norm(aj), f"{name} positional")
        _assert_same(_norm(kp), _norm(kj), f"{name} keywords")
        if fp == "fit_theta" and aj[0].__class__.__name__ == "FitResult":
            assert ap[0].data.device.type == "cpu"


def test_covariance_adj_and_cov_adj_together(monkeypatch):
    """The port reads both spellings of the covariance flag at once (the
    JAX wrapper leaves the second in the priors and raises, ROADMAP F9)."""
    calls = []
    _recorders(monkeypatch, api, calls)
    phase1 = types.SimpleNamespace(traces={})
    R.BFMMM_Theta_est(100, 1, phase1, 2, cov_adj=True, covariance_adj=True)
    R.BFMMM_Theta_est(100, 1, phase1, 2, cov_adj=False, covariance_adj=True)
    assert [c[2]["covariate_cov"] for c in calls] == [True, True]
    with pytest.raises(TypeError, match="unknown hyperparameter"):
        R.BFMMM_Theta_est(100, 1, phase1, 2, not_a_prior=1.0)


# ---------------------------------------------------------------------------
# the fitters against the port's own api, by the bits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    data, truth = simulate_functional(seed=2, N=8, K=2, P=6, M=2,
                                      n_time=(10, 14), device="cpu")
    Y, t = functional_lists(data, seed=2, n_time=(10, 14))
    return data, truth, Y, t


def _assert_same_fit(a, b):
    assert sorted(a.traces) == sorted(b.traces)
    for f in a.traces:
        np.testing.assert_array_equal(a.traces[f], b.traces[f], err_msg=f)
    np.testing.assert_array_equal(a.loglik, b.loglik)
    assert a.chain_index == b.chain_index


def test_r_named_fitters_give_the_bits_of_api(small):
    data, _, Y, t = small
    K, M, knots = 2, 2, _knots(6)
    r1 = R.BFMMM_Nu_Z_multiple_try(100, 1, K, Y, t, 8, 3, M, [0, 1], knots,
                                   device="cpu")
    d1 = api.fit_nu_z(Y, t, K=K, M=M, tot_mcmc_iters=100, n_try=1,
                      basis_degree=3, internal_knots=knots,
                      boundary_knots=[0, 1], device="cpu")
    _assert_same_fit(r1, d1)
    assert torch.equal(r1.data.B, data.B) and torch.equal(r1.data.y, data.y)
    r2 = R.BFMMM_Theta_est(100, 1, K, Y, t, 8, 3, M, [0, 1], knots, r1)
    d2 = api.fit_theta(d1, tot_mcmc_iters=100, n_try=1, M=M)
    _assert_same_fit(r2, d2)
    r3 = R.BFMMM_warm_start(100, r1, r2, n_temp_trans=50, N_t=2)
    d3 = api.fit_warm_start(d1, d2, tot_mcmc_iters=100, n_temp_trans=50,
                            N_t=2, progress=False)
    _assert_same_fit(r3, d3)
    np.testing.assert_array_equal(r3.tt_accept, d3.tt_accept)


# ---------------------------------------------------------------------------
# raw trace cubes, the R-list layouts
# ---------------------------------------------------------------------------

def test_raw_trace_layouts_give_one_result(small):
    data, _, Y, t = small
    rng = np.random.default_rng(0)
    Z = rng.dirichlet(np.ones(2), size=(30, 8))              # draws first
    nu = rng.normal(size=(30, 2, 6))
    kw = dict(family="functional", basis_degree=3, internal_knots=_knots(6),
              boundary_knots=[0, 1], n_eigen=2, device="cpu")
    first = R._result_from_raw_traces({"Z": Z, "nu": nu}, Y, t, **kw)
    cube = R._result_from_raw_traces(
        {"Z": np.moveaxis(Z, 0, -1), "nu": torch.as_tensor(
            np.moveaxis(nu, 0, -1))}, Y, t, **kw)
    want = J._result_from_raw_traces({"Z": Z, "nu": nu}, Y, t,
                                     **{k: v for k, v in kw.items()
                                        if k != "device"})
    for res in (first, cube):
        _assert_same(_norm(res), _norm(want))
        assert res.config == ModelConfig(K=2, P=6, M=2, D=0)
        assert torch.equal(res.data.B, data.B)
    with pytest.raises(ValueError, match="iteration axis"):
        R._result_from_raw_traces({"Z": Z, "nu": nu[:-1]}, Y, t, **kw)
    with pytest.raises(ValueError, match="3-d"):
        R._result_from_raw_traces({"Z": Z[0], "nu": nu}, Y, t, **kw)


def test_a_cube_whose_n_equals_k_is_read_as_a_cube():
    """(N, K, iters) with N = K: the iteration axes alone match on axis 0
    as well, which the JAX package reads draws-first (ROADMAP F11)."""
    rng = np.random.default_rng(1)
    t = [np.linspace(0, 1, 9)] * 3
    Y = [np.sin(4 * ti) for ti in t]
    Z = rng.dirichlet(np.ones(3), size=(20, 3))              # 20 draws, N=K=3
    nu = rng.normal(size=(20, 3, 6))
    res = R._result_from_raw_traces(
        {"Z": np.moveaxis(Z, 0, -1), "nu": np.moveaxis(nu, 0, -1)}, Y, t,
        family="functional", basis_degree=3, internal_knots=_knots(6),
        boundary_knots=[0, 1], device="cpu")
    np.testing.assert_array_equal(res.traces["Z"], Z)
    np.testing.assert_array_equal(res.traces["nu"], nu)


def test_reference_fit_speaks_the_r_list_contract(small):
    data, truth, Y, t = small
    traces = simulate_draws(truth, 12, seed=1)
    res = api.FitResult(traces, np.arange(12.0), None)
    res.data, res.config = data, ModelConfig(K=2, P=6, M=2)
    rf = R.ReferenceFit._wrap(res)
    jrf = J.ReferenceFit._wrap(res)
    assert rf.keys() == jrf.keys()
    for name in rf.keys():
        assert name in rf
        if name == "B":
            continue
        np.testing.assert_array_equal(rf[name], jrf[name])
    assert rf["nu"].shape == (2, 6, 12) and rf["Z"].shape == (8, 2, 12)
    assert rf["Phi"].shape == (2, 6, 2, 12) and rf["sigma_sq"].shape == (12,)
    mask = data.mask.numpy()
    for i, Bi in enumerate(rf["B_obs"]):
        np.testing.assert_array_equal(Bi, data.B.numpy()[i][mask[i] > 0])
    assert "nope" not in rf
    # the multivariate family: tau is the variance, and there is no basis
    mv, mv_truth = simulate_multivariate(seed=1, N=10, K=2, P=3, M=1,
                                         device="cpu")
    res = api.FitResult(simulate_draws(mv_truth, 5), np.zeros(5), None)
    res.data = mv
    res.config = ModelConfig(K=2, P=3, M=1, family="multivariate")
    rf = R.ReferenceFit._wrap(res)
    np.testing.assert_array_equal(rf["tau"],
                                  1.0 / np.moveaxis(res.traces["tau"], 0, -1))
    with pytest.raises(KeyError):
        rf["B"]
    assert "B" not in rf and "B" not in rf.keys()      # ROADMAP F12
    assert rf.keys()[0] == "loglik"


# ---------------------------------------------------------------------------
# every post-processing name, both packages, one directory the port wrote
# ---------------------------------------------------------------------------

def _write_dir(tmp, family, covariates=False, covariate_cov=None, n=40):
    if family == "multivariate":
        data, truth = simulate_multivariate(seed=6, N=25, K=2, P=4, M=2,
                                            device="cpu")
        cfg = ModelConfig(K=2, P=4, M=2, family="multivariate")
        Y, t = data.y.numpy(), None
    else:
        kw = dict(N=10, K=2, P=6, M=2, n_time=(12, 18))
        if covariates:
            kw.update(D=1, with_eta=True, with_xi=True)
        data, truth = simulate_functional(seed=6, device="cpu", **kw)
        cov = covariates if covariate_cov is None else covariate_cov
        cfg = ModelConfig(K=2, P=6, M=2, D=int(data.D),
                          covariate_mean=covariates, covariate_cov=cov)
        Y, t = functional_lists(data, seed=6, n_time=kw["n_time"])
    api.export_traces(tmp, simulate_draws(truth, n, seed=8), cfg)
    return data, Y, t


def _both(name, *args, device=True, **kw):
    want = getattr(J, name)(*args, **kw)
    got = getattr(R, name)(*args, **kw,
                           **({"device": "cpu"} if device else {}))
    return got, want


def _check_functional_dir(d, data, Y, t, X=None, x=None):
    knots, grid = _knots(6), np.linspace(0, 1, 17)
    basis = (3, [0, 1], knots)
    for k in (1, 2):
        for sim in (False, True):
            got, want = _both("FMeanCI", d, 1, grid, *basis, k,
                              simultaneous=sim, X=x, device=False)
            _assert_same(_norm(got), _norm(want))
    got, want = _both("FMeanCI", d, 1, grid, *basis, 2, rescale=False,
                      burnin_prop=0.3, alpha=0.1, X=x, device=False)
    _assert_same(_norm(got), _norm(want))
    for k, l in ((1, 1), (1, 2)):
        got, want = _both("FCovCI", d, 1, grid, grid[::2], *basis, k, l, X=x,
                          device=False)
        _assert_same(_norm(got), _norm(want))
    for name in ("ZCI", "SigmaCI"):
        got, want = _both(name, d, 1, alpha=0.2, device=False)
        _assert_same(_norm(got), _norm(want))
    for name in ("FDIC", "FAIC", "FBIC"):
        got, want = _both(name, d, 1, *basis, t, Y, X=X,
                          cov_adj=X is not None)
        np.testing.assert_allclose(got, want, **EXACT)
    got, want = _both("FLLik", d, 1, *basis, t, Y, X=X)
    np.testing.assert_allclose(got, want, **EXACT)
    got, want = _both("ConditionalPredictiveOrdinates", d, 1, *basis, t, Y,
                      X=X, burnin_prop=0.2)
    assert got.shape == (data.N,)
    np.testing.assert_allclose(got, want, **CPO_TOL)
    adj = dict(mean_adj=True, cov_adj=True) if X is not None else {}
    got, want = _both("FSamplePaths", d, 1, *basis, t, Y, X=X, **adj)
    _assert_same(_norm(got), _norm(want))
    y, mask = data.y.numpy(), data.mask.numpy() > 0
    inside = (y >= got["CI_Lower"]) & (y <= got["CI_Upper"])
    assert inside[mask].mean() > 0.8


def test_post_processing_names_functional(tmp_path):
    d = str(tmp_path)
    data, Y, t = _write_dir(d, "functional")
    _check_functional_dir(d, data, Y, t)
    for reader, stem in (("ReadVec", "Sigma"), ("ReadMat", "Pi"),
                         ("ReadCube", "Z"), ("ReadFieldVec", "Chi"),
                         ("ReadFieldMat", "Nu"), ("ReadFieldCube", "Phi")):
        got, want = _both(reader, os.path.join(d, f"{stem}0.txt"),
                          device=False)
        _assert_same(_norm(got), _norm(want))


def test_post_processing_names_covariates(tmp_path):
    d = str(tmp_path)
    data, Y, t = _write_dir(d, "functional", covariates=True)
    _check_functional_dir(d, data, Y, t, X=data.X.numpy(), x=[0.7])
    for reader, stem in (("ReadFieldMat", "Eta"), ("ReadFieldCube", "Xi"),
                         ("ReadFieldVec", "Tau_Eta")):
        got, want = _both(reader, os.path.join(d, f"{stem}0.txt"),
                          device=False)
        _assert_same(_norm(got), _norm(want))


def test_post_processing_names_multivariate(tmp_path):
    d = str(tmp_path)
    data, Y, _ = _write_dir(d, "multivariate")
    for k in (None, 2):
        got, want = _both("MVMeanCI", d, 1, k, device=False)
        _assert_same(_norm(got), _norm(want))
    got, want = _both("MVCovCI", d, 1, 1, 2, simultaneous=True, device=False)
    _assert_same(_norm(got), _norm(want))
    for name in ("MVDIC", "MVAIC", "MVBIC"):
        got, want = _both(name, d, 1, Y, burnin_prop=0.25)
        np.testing.assert_allclose(got, want, **EXACT)
    got, want = _both("MVLLik", d, 1, Y)
    np.testing.assert_allclose(got, want, **EXACT)


def test_sample_paths_raise_where_the_jax_package_raises(tmp_path):
    plain, eta_only = str(tmp_path / "plain"), str(tmp_path / "eta")
    _, Y, t = _write_dir(plain, "functional")
    data_e, Ye, te = _write_dir(eta_only, "functional", covariates=True,
                                covariate_cov=False)
    basis = (3, [0, 1], _knots(6))
    X = data_e.X.numpy()
    for d, Yd, td, kw, msg in (
            (plain, Y, t, dict(mean_adj=True), "'X' must be provided"),
            (plain, Y, t, dict(mean_adj=True, X=X[:10]), "no Eta files"),
            (eta_only, Ye, te, dict(cov_adj=True, X=X), "no Xi files")):
        for mod, extra in ((J, {}), (R, {"device": "cpu"})):
            with pytest.raises(ValueError, match=msg):
                mod.FSamplePaths(d, 1, *basis, td, Yd, **kw, **extra)
    got, want = _both("FSamplePaths", eta_only, 1, *basis, te, Ye, X=X,
                      mean_adj=True)
    _assert_same(_norm(got), _norm(want))


# ---------------------------------------------------------------------------
# the roxygen example, call for call, and an hd fit post-processed
# ---------------------------------------------------------------------------

def test_roxygen_example_call_for_call(capsys):
    """The reference's @examples block (R/RcppExports.R; UserFunctions.cpp:
    684), positional, on synthetic curves on [0, 1000] with the example's
    knots; the list members in the reference's layouts
    (tests/test_reference_signatures.py:52-68)."""
    n_funct = 10
    data, _ = simulate_functional(seed=4, N=n_funct, K=2, P=7, M=3,
                                  n_time=(15, 20), device="cpu")
    Y, t01 = functional_lists(data, seed=4, n_time=(15, 20))
    time = [1000.0 * ti for ti in t01]
    tot_mcmc_iters = 150
    n_try = 1
    K = 2
    basis_degree = 3
    n_eigen = 3
    boundary_knots = [0, 1000]
    internal_knots = [250, 500, 750]
    est1 = R.BFMMM_Nu_Z_multiple_try(tot_mcmc_iters, n_try, K, Y, time,
                                     n_funct, basis_degree, n_eigen,
                                     boundary_knots, internal_knots,
                                     device="cpu")
    est2 = R.BFMMM_Theta_est(tot_mcmc_iters, n_try, K, Y, time, n_funct,
                             basis_degree, n_eigen, boundary_knots,
                             internal_knots, est1)
    P = len(internal_knots) + basis_degree + 1
    np.testing.assert_allclose(est1.data.B.numpy(), data.B.numpy(),
                               atol=1e-6)
    assert est1["nu"].shape == (K, P, tot_mcmc_iters)
    assert est1["Z"].shape == (n_funct, K, tot_mcmc_iters)
    assert est1["pi"].shape == (K, tot_mcmc_iters)
    assert est1["alpha_3"].shape == (tot_mcmc_iters,)
    assert est1["sigma_sq"].shape == (tot_mcmc_iters,)
    assert est1["tau"].shape == (K, tot_mcmc_iters)
    assert est1["loglik"].shape == (tot_mcmc_iters,)
    B = est1["B"]
    assert len(B) == n_funct and B[0].shape[1] == P
    assert est2["Phi"].shape == (K, P, n_eigen, tot_mcmc_iters)
    assert est2["chi"].shape == (n_funct, n_eigen, tot_mcmc_iters)
    assert est2["gamma"].shape == (K, P, n_eigen, tot_mcmc_iters)
    assert est2["delta"].shape == (K, n_eigen, tot_mcmc_iters)
    assert est2["A"].shape == (K, 2, tot_mcmc_iters)
    assert np.isfinite(est2["loglik"]).all()
    # the raw-cube form of the reference's multiple_try gives the bits of
    # the object form
    cubes = {"Z": est1["Z"], "nu": est1["nu"]}
    est2b = R.BFMMM_Theta_est(tot_mcmc_iters, n_try, K, Y, time, n_funct,
                              basis_degree, n_eigen, boundary_knots,
                              internal_knots, cubes, device="cpu")
    np.testing.assert_array_equal(est2b["Phi"], est2["Phi"])


def test_hd_family_end_to_end_then_hdf_summaries(tmp_path):
    """tests/test_components.py::test_hd_family_end_to_end in the port: 2-D
    surfaces through the three phases of api on the CPU, then HDFMeanCI and
    HDFCovCI on the exported traces, equal to the JAX package's."""
    rng = np.random.default_rng(71)
    N = 12
    g = np.linspace(0, 1, 6)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    t_list = [pts for _ in range(N)]
    y_list = [np.sin(2 * np.pi * pts[:, 0]) * np.cos(np.pi * pts[:, 1])
              + 0.1 * rng.normal(size=pts.shape[0]) for _ in range(N)]
    knots = [np.array([0.5]), np.array([0.5])]
    bk = np.array([[0., 1.], [0., 1.]])
    data = make_hd_functional_data(y_list, t_list, basis_degrees=[2, 2],
                                   internal_knots_list=knots,
                                   boundary_knots=bk, device="cpu")
    assert data.P == 16
    np.testing.assert_allclose(data.pen.numpy() @ np.ones(16), 0.0,
                               atol=1e-5)
    r1 = api.fit_nu_z(data=data, K=2, M=2, family="hd", tot_mcmc_iters=100,
                      n_try=1)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100)
    r3 = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, progress=False,
                            directory=str(tmp_path))
    assert np.isfinite(r3.loglik).all()
    assert np.mean(r3.loglik[-10:]) > np.mean(r1.loglik[:10])
    q = pts[::3]
    for k in (1, 2):
        got, want = _both("HDFMeanCI", str(tmp_path), 1, q, [2, 2], bk,
                          knots, k, device=False)
        assert got["CI_50"].shape == (len(q),)
        _assert_same(_norm(got), _norm(want))
    got, want = _both("HDFCovCI", str(tmp_path), 1, q, q[:4], [2, 2], bk,
                      knots, 1, 2, simultaneous=True, device=False)
    assert got["CI_50"].shape == (len(q), 4)
    _assert_same(_norm(got), _norm(want))
