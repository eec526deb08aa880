"""The port's user-facing API (api.py) and the NumPy-only modules it keeps
its own copies of, against the JAX package's on the same inputs, on the CPU.

The copies (validation, label_switch, armaio, diagnostics) must give equal
results, files equal byte for byte.  The pipeline draws other random numbers
in the two packages, so the fits are compared by moments, each band stated
in its test."""

import importlib.util
import inspect
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402, F401

from bayesfmmm_tpu import api as japi  # noqa: E402
from bayesfmmm_tpu import diagnostics as jdiagnostics  # noqa: E402
from bayesfmmm_tpu import validation as jvalidation  # noqa: E402
from bayesfmmm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from bayesfmmm_tpu.io import armaio as jarmaio  # noqa: E402
from bayesfmmm_tpu.models.likelihood import (  # noqa: E402
    log_likelihood as jlog_likelihood)
from bayesfmmm_tpu.post import label_switch as jlabel_switch  # noqa: E402
from bayesfmmm_tpu.utils.simulate import (  # noqa: E402
    simulate_functional as jsimulate)
from bayesfmmm_torch import api, convert, diagnostics, validation  # noqa: E402
from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_torch.io import armaio  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.ops import gibbs  # noqa: E402
from bayesfmmm_torch.post import label_switch  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KNOTS = dict(basis_degree=3, internal_knots=np.array([0.25, 0.5, 0.75]),
             boundary_knots=np.array([0.0, 1.0]))


def _tiny_Y():
    t = [np.linspace(0, 1, 12)] * 3
    return [np.sin(6 * ti) for ti in t], t


# ---------------------------------------------------------------------------
# The copies of NumPy-only modules
# ---------------------------------------------------------------------------

_VALIDATION_CASES = [
    ("validate_fit_args", dict(tot_mcmc_iters=50)),
    ("validate_fit_args", dict(tot_mcmc_iters=100, n_try=0)),
    ("validate_fit_args", dict(K=1)),
    ("validate_fit_args", dict(n_funct=0)),
    ("validate_fit_args", dict(basis_degree=0)),
    ("validate_fit_args", dict(n_eigen=0)),
    ("validate_fit_args", dict(burnin_prop=1.0)),
    ("validate_fit_args", dict(tot_mcmc_iters=100, n_try=1, K=2, n_eigen=1,
                               burnin_prop=0.5)),
    ("validate_knots", dict(internal_knots=None, boundary_knots=None)),
    ("validate_knots", dict(internal_knots=[0.5], boundary_knots=[0, 1, 2])),
    ("validate_knots", dict(internal_knots=[-0.5], boundary_knots=[0, 1])),
    ("validate_knots", dict(internal_knots=[1.5], boundary_knots=[0, 1])),
    ("validate_knots", dict(internal_knots=[0.5], boundary_knots=[0, 1])),
    ("validate_hd_knots", dict(basis_degrees=None, internal_knots_list=None,
                               boundary_knots=None)),
    ("validate_hd_knots", dict(basis_degrees=[2, 0],
                               internal_knots_list=[[0.5], [0.5]],
                               boundary_knots=[0, 1])),
    ("validate_hd_knots", dict(basis_degrees=[2, 2],
                               internal_knots_list=[[0.5], [1.5]],
                               boundary_knots=[[0, 1], [0, 1]])),
    ("validate_c", dict(c=[1.0, 1.0, 1.0], K=2)),
    ("validate_c", dict(c=[1.0, -1.0], K=2)),
    ("validate_c", dict(c=[1.0, 2.0], K=2)),
    ("validate_warm_start_args", dict(thinning_num=0)),
    ("validate_warm_start_args", dict(beta_N_t=1.5)),
    ("validate_warm_start_args", dict(N_t=0)),
    ("validate_warm_start_args", dict(r_stored_iters=-1)),
    ("validate_warm_start_args", dict(n_temp_trans=-1)),
    ("validate_warm_start_args", dict(r_stored_iters=50, tot_mcmc_iters=100)),
    ("validate_warm_start_args", dict(r_stored_iters=50, tot_mcmc_iters=100,
                                      directory="d")),
    ("validate_postprocess_args", dict(n_files=0)),
    ("validate_postprocess_args", dict(alpha=1.0)),
    ("validate_postprocess_args", dict(basis_degree=[2, 0])),
    ("validate_k", dict(k=0, K=2)),
    ("validate_k", dict(k=3, K=2)),
    ("validate_x_columns", dict(X=np.zeros((3, 2)), D=1)),
]


@pytest.mark.parametrize("fn,kwargs", _VALIDATION_CASES,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(_VALIDATION_CASES)])
def test_validation_copy_equals_original(fn, kwargs):
    """Same verdict and, letter for letter, the same message."""
    def outcome(mod):
        try:
            return getattr(mod, fn)(**kwargs)
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(validation) == outcome(jvalidation)
    assert validation.__all__ == jvalidation.__all__


def test_label_switch_copy_equals_original():
    rng = np.random.default_rng(0)
    Z = rng.dirichlet(np.ones(3), size=(40, 9))
    perms = rng.permuted(np.tile(np.arange(3), (40, 1)), axis=1)
    Zs = np.take_along_axis(Z, perms[:, None, :], axis=2)
    traces = {"Z": Zs, "nu": rng.normal(size=(40, 3, 5)),
              "pi": rng.dirichlet(np.ones(3), size=40),
              "sigma2": rng.gamma(2.0, size=40),
              "Phi": rng.normal(size=(40, 3, 5, 2))}
    got, want = label_switch.align_trace(traces), \
        jlabel_switch.align_trace(traces)
    for k in traces:
        np.testing.assert_array_equal(got[k], want[k])
    got, want = label_switch.align_trace(traces, Z_ref=Z[0], block=7), \
        jlabel_switch.align_trace(traces, Z_ref=Z[0], block=7)
    for k in traces:
        np.testing.assert_array_equal(got[k], want[k])
    p, d = label_switch.align_draw(Zs[3], Z[3])
    pj, dj = jlabel_switch.align_draw(Zs[3], Z[3])
    assert p.tolist() == pj.tolist() and d == dj
    assert label_switch.z_distance(Zs[0], Z[0]) == \
        jlabel_switch.z_distance(Zs[0], Z[0])


@pytest.mark.parametrize("fn", ["effective_sample_size", "split_rhat",
                                "rank_normalize", "rank_normalized_ess",
                                "rank_normalized_rhat"])
def test_diagnostics_copy_equals_original(fn):
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.normal(size=(4, 200)), axis=1) * 0.1 \
        + rng.normal(size=(4, 200))
    for draws in (x, x[0], x[:, :3]):
        np.testing.assert_array_equal(getattr(diagnostics, fn)(draws),
                                      getattr(jdiagnostics, fn)(draws))
    trace = rng.normal(size=(3, 50, 4, 2))
    assert diagnostics.summarize_chains(trace) == \
        jdiagnostics.summarize_chains(trace)


def _random_traces(rng, n=6, N=5, K=2, P=4, M=2, D=0):
    shapes = {"Z": (N, K), "pi": (K,), "alpha3": (), "nu": (K, P),
              "tau": (K,), "sigma2": (), "chi": (N, M), "Phi": (K, P, M),
              "gamma": (K, P, M), "delta": (K, M), "A": (K, 2),
              "eta": (K, P, D), "tau_eta": (K, D), "xi": (K, P, D, M),
              "gamma_xi": (K, P, D, M), "delta_xi": (K, M, D),
              "A_xi": (K, 2, D)}
    return {f: rng.gamma(2.0, size=(n,) + s).astype(np.float32)
            for f, s in shapes.items()}


@pytest.mark.parametrize("family,D,covm,covc", [
    ("functional", 0, False, False), ("functional", 2, True, False),
    ("functional", 2, True, True), ("multivariate", 2, True, False)])
def test_export_traces_files_equal_byte_for_byte(tmp_path, family, D, covm,
                                                 covc):
    """export_traces writes, for the same arrays, the files the JAX
    package's writes; the port's reader gives back what its reader gives."""
    traces = _random_traces(np.random.default_rng(2), D=D)
    kw = dict(K=2, P=4, M=2, D=D, family=family, covariate_mean=covm,
              covariate_cov=covc)
    api.export_traces(str(tmp_path / "port"), traces, ModelConfig(**kw),
                      batch=1)
    japi.export_traces(str(tmp_path / "jax"), traces, JModelConfig(**kw),
                       batch=1)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 11 + 2 * covm + 4 * covc
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_armaio_copy_reads_and_writes_as_the_original(tmp_path):
    traces = _random_traces(np.random.default_rng(3), D=2)
    stems = api.export_layout(traces, ModelConfig(
        K=2, P=4, M=2, D=2, covariate_mean=True, covariate_cov=True))
    for q in (0, 1):
        armaio.save_trace_dir(str(tmp_path), stems, batch=q)
    got = armaio.load_trace_dir(str(tmp_path))
    want = jarmaio.load_trace_dir(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(stems)
    for k, v in stems.items():
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            got[k], np.concatenate([v, v]).astype(np.float64))
    one = armaio.load_trace_dir(str(tmp_path), names=["Nu"], n_files=1)
    np.testing.assert_array_equal(one["Nu"], stems["Nu"].astype(np.float64))
    for fn in ("Nu0.txt", "Phi0.txt", "Sigma0.txt"):
        np.testing.assert_array_equal(
            armaio.load_arma(str(tmp_path / fn), prefer_native=False),
            jarmaio.load_arma(str(tmp_path / fn), prefer_native=False))


def test_native_writer_writes_what_the_python_writer_writes(tmp_path):
    from bayesfmmm_torch.io import native
    rng = np.random.default_rng(4)
    cube, mat = rng.normal(size=(3, 4, 2)), rng.normal(size=(5, 3))
    with native.AsyncTraceWriter() as w:
        w.submit(str(tmp_path / "c.txt"), cube)
        w.submit(str(tmp_path / "m.txt"), mat)
        assert w.flush() == 0
    np.testing.assert_allclose(armaio.load_arma(str(tmp_path / "c.txt")),
                               cube, rtol=1e-15)
    np.testing.assert_allclose(armaio.load_arma(str(tmp_path / "m.txt")),
                               mat, rtol=1e-15)
    armaio.save_arma_cube(str(tmp_path / "c2.txt"), cube)
    np.testing.assert_array_equal(
        armaio.load_arma(str(tmp_path / "c.txt"), prefer_native=False),
        armaio.load_arma(str(tmp_path / "c2.txt"), prefer_native=False))


# ---------------------------------------------------------------------------
# api.py: the deterministic parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tot,thin,every,want", [
    (2000, 1, 100, [100] * 20),
    (250, 1, 100, [84, 83, 83]),
    (120, 3, 50, [42, 39, 39]),
    (100, 1, 1000, [100]),
    (100, 7, 10, [7] * 14),
    (5, 10, 100, [10]),
])
def test_chunk_sizes_are_balanced(tot, thin, every, want):
    """The balanced chunk sizes of the JAX fit_warm_start (api.py:369-374):
    multiples of thinning_num, at most two distinct sizes."""
    got = api.chunk_sizes(tot, thin, every)
    assert got == want
    assert sum(got) == max(1, tot // thin) * thin
    assert len(set(got)) <= 2 and all(n % thin == 0 for n in got)


def test_production_flags_are_the_production_census():
    """kernels="production" names all five flags (the port's sweep_full has
    MALA off by default) and they are the census chip_smoke.py drives."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert api.PRODUCTION_FLAGS == chip_smoke.PATHS["production"][0]
    assert api.PRODUCTION_FLAGS == dict(
        collapsed_z=True, gauge=True, p_indep=0.3, phi_mala_steps=4,
        phi_mala_step=0.05)
    # the JAX package's defaults, which its production fit relies on
    jdefaults = {k: v.default for k, v in inspect.signature(
        __import__("bayesfmmm_tpu.ops.gibbs", fromlist=["x"]).sweep_full)
        .parameters.items()}
    for k in ("p_indep", "phi_mala_steps", "phi_mala_step"):
        assert jdefaults[k] == api.PRODUCTION_FLAGS[k]
    assert inspect.signature(gibbs.sweep_full).parameters[
        "phi_mala_steps"].default == 0


@pytest.fixture(scope="module")
def small_fit():
    data, truth = simulate_functional(seed=5, N=8, K=2, P=5, M=2,
                                      n_time=(8, 10), device="cpu")
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, n_try=2,
                      seed=0)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, n_try=3, seed=1)
    return data, r1, r2


@pytest.mark.parametrize("kernels,batched", [
    ("production", False), ("reference", False), ("production", True)])
def test_every_sweep_of_phase_3_gets_the_census_flags(small_fit, monkeypatch,
                                                      tmp_path, kernels,
                                                      batched):
    """The plain sweeps, the excursions' rungs and the batched path all run
    sweep_full with the five production flags, or with none of them."""
    data, r1, r2 = small_fit
    seen = []
    real = gibbs.sweep_full

    def recording(generator, state, data, hp, c, **kw):
        seen.append(kw)
        return real(generator, state, data, hp, c, **kw)

    monkeypatch.setattr(gibbs, "sweep_full", recording)
    kw = dict(r_stored_iters=50, directory=str(tmp_path)) if batched else {}
    api.fit_warm_start(r1, r2, tot_mcmc_iters=100, kernels=kernels,
                       n_temp_trans=40, N_t=2, beta_N_t=0.5, progress=False,
                       **kw)
    want = api.PRODUCTION_FLAGS if kernels == "production" else {}
    # 100 iterations, 2 of them excursions of 4 rungs
    assert len(seen) == 98 + 2 * 4
    for kw in seen:
        flags = {k: v for k, v in kw.items()
                 if k not in ("beta", "covariate_mean", "covariate_cov")}
        assert flags == want
    assert sorted({round(kw["beta"], 4) for kw in seen}) == [0.7071, 1.0]


def test_restart_counts_and_pinned_estimates(small_fit, monkeypatch):
    """fit_nu_z runs n_try + 1 chains, fit_theta n_try; phase 2 starts every
    chain from the phase-1 medians and phase 3 every chain from the same 17
    medians."""
    from bayesfmmm_torch.samplers import drivers
    data, r1, r2 = small_fit
    assert r1.loglik.shape == (100,) and 0 <= r1.chain_index < 3
    assert 0 <= r2.chain_index < 3
    assert r1.final_state.Z.shape == (1, 8, 2)
    assert bool((torch.as_tensor(r1.traces["Phi"]) == 0).all())
    assert r1.config == ModelConfig(K=2, P=5, M=2) and r2.data is data
    starts = {}
    for name in ("phase_nu_z", "phase_theta", "phase_warm_start"):
        def spy(generator, state, *a, _name=name,
                _real=getattr(drivers, name), **kw):
            starts[_name] = state
            return _real(generator, state, *a, **kw)
        monkeypatch.setattr(drivers, name, spy)
    api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, n_try=2)
    assert starts["phase_nu_z"].Z.shape[0] == 3
    api.fit_theta(r1, tot_mcmc_iters=100, n_try=3)
    st = starts["phase_theta"]
    assert st.Z.shape[0] == 3
    est1 = r1.estimates(_warn=False)
    for f in ("Z", "nu", "pi", "alpha3", "tau"):
        assert st.Z.device == data.device
        np.testing.assert_array_equal(
            getattr(st, f).numpy(), np.broadcast_to(
                est1[f], (3,) + np.shape(est1[f])))
    assert not torch.equal(st.Phi[0], st.Phi[1])
    api.fit_warm_start(r1, r2, tot_mcmc_iters=100, n_chains=4,
                       progress=False)
    st = starts["phase_warm_start"]
    est2 = r2.estimates(_warn=False)
    for f in STATE_FIELDS:
        src = est1 if f in ("Z", "pi", "alpha3", "nu", "tau", "eta",
                            "tau_eta") else est2
        np.testing.assert_array_equal(
            getattr(st, f).numpy(), np.broadcast_to(
                src[f], (4,) + np.shape(src[f])), err_msg=f)


def test_spectral_init_restarts(small_fit):
    from bayesfmmm_torch.utils.init_strategies import spectral_init
    data = small_fit[0]
    r = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, n_try=1,
                     init="spectral", seed=3)
    rr = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, n_try=1,
                      seed=3)
    assert np.isfinite(r.loglik).all()
    # the spectral start is near a mode: its first draw beats a random one
    assert r.loglik[0] > rr.loglik[0]
    sp = spectral_init(data, 2, 2)
    assert sp["Z"].shape == (8, 2)


def test_estimates_warn_for_more_than_two_features():
    rng = np.random.default_rng(0)
    traces = {"Z": rng.dirichlet(np.ones(3), size=(20, 6)).astype(np.float32),
              "pi": rng.dirichlet(np.ones(3), size=20).astype(np.float32),
              "nu": rng.normal(size=(20, 3, 4)).astype(np.float32)}
    res = api.FitResult(traces, np.zeros(20), None)
    with pytest.warns(UserWarning, match="align=True"):
        res.estimates()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res.estimates(_warn=False)
        est = res.estimates(align=True)
    jres = japi.FitResult(traces, np.zeros(20), None)
    want = jres.estimates(align=True)
    for k in traces:
        np.testing.assert_allclose(est[k], np.asarray(want[k]), rtol=1e-6)
    two = api.FitResult({k: v[..., :2] if k != "nu" else v[:, :2]
                         for k, v in traces.items()}, np.zeros(20), None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        two.estimates()


def test_fit_routes_keywords_and_refuses_unknown_ones(small_fit, tmp_path):
    data = small_fit[0]
    with pytest.raises(TypeError, match=r"\['resume_from', 'sweeps'\]"):
        api.fit(data=data, K=2, M=2, sweeps=3, resume_from="x")
    res = api.fit(data=data, K=2, M=2, nu_z_iters=100, theta_iters=100,
                  warm_iters=100, n_try=1, n_chains=2, burnin_prop=0.5,
                  thinning_num=2, progress=False, init="spectral",
                  kernels="production", directory=str(tmp_path / "t"),
                  checkpoint_to=str(tmp_path / "ck"))
    assert res.loglik.shape == (50,) and res.all_chain_loglik.shape == (2, 50)
    assert res.tt_accept.shape == (2, 0)
    assert (tmp_path / "ck.npz").is_file()
    back = armaio.load_trace_dir(str(tmp_path / "t"))
    assert back["Nu"].shape == (50, 2, 5)
    np.testing.assert_array_equal(back["Z"],
                                  res.traces["Z"].astype(np.float64))


# ---------------------------------------------------------------------------
# Validation of the fit_* arguments (ports of tests/test_validation.py:34-76,
# :98-120), devices, and what is not ported
# ---------------------------------------------------------------------------

def test_fit_nu_z_validations():
    y, t = _tiny_Y()
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="'tot_mcmc_iters' must be an "
                                         "integer greater than or equal "
                                         "to 100"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=50, **KNOTS, **cpu)
    with pytest.raises(ValueError, match="'K' must be an integer greater "
                                         "than or equal to 2"):
        api.fit_nu_z(y, t, K=1, tot_mcmc_iters=100, **KNOTS, **cpu)
    with pytest.raises(ValueError, match="'n_try' must be an integer "
                                         "greater than or equal to 1"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, n_try=0, **KNOTS, **cpu)
    with pytest.raises(ValueError, match="'n_eigen' must be an integer"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, M=0, **KNOTS, **cpu)
    with pytest.raises(ValueError, match="'basis_degree' must be an "
                                         "integer greater than or equal "
                                         "to 1"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, basis_degree=0,
                     internal_knots=KNOTS["internal_knots"],
                     boundary_knots=KNOTS["boundary_knots"], **cpu)
    with pytest.raises(ValueError, match="less than or equal to first "
                                         "boundary knot"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, basis_degree=3,
                     internal_knots=np.array([-0.5, 0.5]),
                     boundary_knots=np.array([0.0, 1.0]), **cpu)
    with pytest.raises(ValueError, match="more than or equal to second "
                                         "boundary knot"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, basis_degree=3,
                     internal_knots=np.array([0.5, 1.5]),
                     boundary_knots=np.array([0.0, 1.0]), **cpu)
    with pytest.raises(ValueError, match="'n_funct' must be an integer"):
        api.fit_nu_z([], [], K=2, tot_mcmc_iters=100, **KNOTS, **cpu)
    with pytest.raises(ValueError, match="must be positive"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100,
                     priors=Priors(alpha_nu=-1.0), **KNOTS, **cpu)
    with pytest.raises(ValueError, match="number of elements of the vector "
                                         "'c' must be equal to K"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100,
                     priors=Priors(c=(1.0, 1.0, 1.0)), **KNOTS, **cpu)
    with pytest.raises(ValueError, match="all elements of 'c' must be "
                                         "positive"):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100,
                     priors=Priors(c=(1.0, -1.0)), **KNOTS, **cpu)


def test_warm_start_validations():
    y, t = _tiny_Y()
    r = api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, device="cpu", **KNOTS)
    assert r.data.device.type == "cpu" and r.data.P == 7
    with pytest.raises(ValueError, match="'thinning_num' must be a "
                                         "positive integer"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, thinning_num=0)
    with pytest.raises(ValueError, match="'beta_N_t' must be between 0 "
                                         "and 1"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, beta_N_t=1.5)
    with pytest.raises(ValueError, match="'N_t' must be a positive integer"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, N_t=0)
    with pytest.raises(ValueError, match="'n_temp_trans' must be a "
                                         "non-negative integer"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, n_temp_trans=-1)
    with pytest.raises(ValueError, match="'burnin_prop' must be between 0 "
                                         "and 1"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, burnin_prop=1.0)
    with pytest.raises(ValueError, match="Either specify 'dir' or increase "
                                         "'r_stored_iters'"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, r_stored_iters=50)
    with pytest.raises(ValueError, match="kernels must be"):
        api.fit_warm_start(r, r, tot_mcmc_iters=100, kernels="fast")
    with pytest.raises(ValueError, match="unless resume_from is given"):
        api.fit_warm_start(r, tot_mcmc_iters=100)
    with pytest.raises(ValueError, match="'burnin_prop' must be between"):
        api.fit_theta(r, tot_mcmc_iters=100, burnin_prop=-0.1)


def test_entry_points_default_to_the_card():
    """No device given and no card: a RuntimeError that names the way to
    the CPU, after the arguments were validated; never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device exists")
    y, t = _tiny_Y()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.build_data(y, t, **KNOTS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, **KNOTS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.fit(y, t, K=2, M=1, nu_z_iters=100, **KNOTS)
    with pytest.raises(ValueError, match="'K' must be"):
        api.fit_nu_z(y, t, K=1, tot_mcmc_iters=100, **KNOTS)
    assert api.build_data(y, t, device="cpu", **KNOTS).device.type == "cpu"


def test_what_is_not_ported_names_its_roadmap_item():
    """The three families and covariates build; what is still missing is
    absent by name, and the default-off kernels name their item."""
    y, t = _tiny_Y()
    mv = api.build_data(np.ones((4, 3)), family="multivariate", device="cpu")
    assert mv.family == "multivariate" and mv.identity_basis and mv.P == 3
    pts = np.stack(np.meshgrid(*[np.linspace(0, 1, 4)] * 2), -1).reshape(-1, 2)
    hd = api.build_data([np.ones(16)] * 3, [pts] * 3, family="hd",
                        basis_degrees=[2, 2],
                        internal_knots_list=[np.array([0.5])] * 2,
                        boundary_knots=np.array([[0., 1.], [0., 1.]]),
                        device="cpu")
    assert hd.family == "hd" and hd.P == 16 and not hd.identity_basis
    with pytest.raises(ValueError, match="must be a matrix"):
        api.build_data(np.ones(4), family="multivariate", device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        api.build_data(y, t, family="other", device="cpu")
    r = api.fit_nu_z(y, t, K=2, tot_mcmc_iters=100, X=np.ones((3, 1)),
                     device="cpu", **KNOTS)
    assert r.config.covariate_mean and r.config.D == 1
    assert np.abs(r.traces["eta"][-1]).max() > 0
    assert not hasattr(api, "fit_advi_init")
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        gibbs.sweep_full(None, r.final_state, r.data, Priors(), None,
                         hmc_steps=1)


def test_fit_result_converts_between_the_packages():
    jdata, _ = jsimulate(seed=25, N=20, K=2, P=5, M=2, n_time=(20, 25))
    j1 = japi.fit_nu_z(data=jdata, K=2, M=2, tot_mcmc_iters=100, n_try=1)
    tdata = convert.data_from_jax(jdata, device="cpu")
    t1 = convert.fit_result_from_jax(j1, tdata)
    assert t1.config == ModelConfig(K=2, P=5, M=2) and t1.data is tdata
    assert t1.final_state.Z.shape == (1, 20, 2)
    a, b = convert.fit_result_to_numpy(t1), convert.fit_result_to_numpy(j1)
    assert sorted(a["traces"]) == sorted(b["traces"]) == sorted(STATE_FIELDS)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(a["traces"][k], b["traces"][k])
        np.testing.assert_allclose(a["estimates"][k], b["estimates"][k],
                                   rtol=1e-6)
    # the port's phase 2 continues from the JAX package's phase 1
    t2 = api.fit_theta(t1, tot_mcmc_iters=100)
    assert np.isfinite(t2.loglik).all() and t2.loglik[-1] > t1.loglik[-1]


# ---------------------------------------------------------------------------
# The pipeline as a whole, by moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tempered", [False, True])
def test_pipeline_matches_jax_by_moments(tmp_path, tempered):
    """The protocols of tests/test_pipeline.py:11-31 and :96-103 through
    both packages on the same simulated data, with two restarts from the
    spectral init (a single cold start lands in other modes run by run, in
    both packages).  Both fits end within 12 % of the loglik at the truth
    (the truth's is the larger: 100-150 sweeps a phase stop short of the
    mode) and within 8 % of it of each other; sigma2 within a factor 1.6
    of the truth and 1.2 of each other.  Over three seeds the two packages
    differed by at most 3.3 % and a factor 1.05."""
    if tempered:
        sim = dict(seed=25, N=20, K=2, P=5, M=2, n_time=(20, 25))
        iters, warm = 100, dict(tot_mcmc_iters=120, n_temp_trans=40,
                                beta_N_t=0.5, N_t=2)
    else:
        sim = dict(seed=21, N=30, K=2, P=6, M=2, n_time=(30, 40))
        iters, warm = 150, dict(tot_mcmc_iters=150, thinning_num=1)
    jdata, truth = jsimulate(**sim)
    ll_truth = float(jlog_likelihood(truth, jdata))
    j1 = japi.fit_nu_z(data=jdata, K=2, M=2, tot_mcmc_iters=iters, n_try=2,
                       init="spectral")
    j2 = japi.fit_theta(j1, tot_mcmc_iters=iters, n_try=2)
    j3 = japi.fit_warm_start(j1, j2, progress=False, **warm)

    tdata = convert.data_from_jax(jdata, device="cpu")
    res = api.fit(data=tdata, K=2, M=2, nu_z_iters=iters, theta_iters=iters,
                  warm_iters=warm["tot_mcmc_iters"], n_try=2, progress=False,
                  init="spectral", directory=str(tmp_path),
                  **{k: v for k, v in warm.items() if k != "tot_mcmc_iters"})
    n = warm["tot_mcmc_iters"]
    assert res.loglik.shape == (n,) and np.isfinite(res.loglik).all()
    assert res.tt_accept.shape == (1, 2 if tempered else 0)
    for v in res.traces.values():
        assert np.isfinite(v).all()
    ll_port = float(np.mean(res.loglik[-20:]))
    ll_jax = float(np.mean(np.asarray(j3.loglik)[-20:]))
    s2_port = float(np.mean(res.traces["sigma2"][-20:]))
    s2_jax = float(np.mean(np.asarray(j3.traces["sigma2"])[-20:]))
    s2_true = float(truth.sigma2)
    assert ll_truth > 0
    assert abs(ll_port - ll_truth) < 0.12 * ll_truth, (ll_port, ll_truth)
    assert abs(ll_jax - ll_truth) < 0.12 * ll_truth, (ll_jax, ll_truth)
    assert abs(ll_port - ll_jax) < 0.08 * ll_truth, (ll_port, ll_jax)
    for a, b, factor in ((s2_port, s2_true, 1.6), (s2_jax, s2_true, 1.6),
                         (s2_port, s2_jax, 1.2)):
        assert 1 / factor < a / b < factor, (s2_port, s2_jax, s2_true)
    back = armaio.load_trace_dir(str(tmp_path))
    assert back["Nu"].shape == (n, 2, sim["P"])
    np.testing.assert_allclose(back["Z"].sum(axis=2), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# Covariates and the other families through the entry points
# ---------------------------------------------------------------------------

def test_fit_takes_covariates_and_routes_covariate_cov(tmp_path):
    """X turns the mean's covariate adjustment on in phase 1, covariate_cov
    the covariance's in phase 2, and phase 3 inherits both; the exported
    directory gains the reference's covariate files."""
    rng = np.random.default_rng(0)
    t = [np.sort(rng.uniform(0, 1, 12)) for _ in range(8)]
    X = rng.normal(size=(8, 1))
    Y = [np.sin(5 * ti) * (1 + 0.5 * x) + 0.05 * rng.normal(size=12)
         for ti, x in zip(t, X[:, 0])]
    r1 = api.fit_nu_z(Y, t, K=2, M=2, X=X, tot_mcmc_iters=100, device="cpu",
                      **KNOTS)
    assert r1.config == ModelConfig(K=2, P=7, M=2, D=1, covariate_mean=True)
    assert not r1.traces["xi"].any() and r1.traces["eta"][-1].any()
    plain2 = api.fit_theta(r1, tot_mcmc_iters=100)
    assert not plain2.config.covariate_cov and not plain2.traces["xi"].any()
    # phase 2 keeps eta pinned at phase 1's medians and moves tau_eta
    np.testing.assert_array_equal(
        plain2.traces["eta"][-1], r1.estimates(_warn=False)["eta"])
    assert np.ptp(plain2.traces["tau_eta"]) > 0
    res = api.fit(Y, t, K=2, M=2, X=X, covariate_cov=True, nu_z_iters=100,
                  theta_iters=100, warm_iters=100, progress=False,
                  device="cpu", directory=str(tmp_path), **KNOTS)
    assert res.config.covariate_mean and res.config.covariate_cov
    assert res.traces["xi"][-1].any() and np.ptp(res.traces["A_xi"]) > 0
    back = armaio.load_trace_dir(str(tmp_path))
    assert back["Xi"].shape == (100, 2, 7, 1, 2)
    assert back["Eta"].shape == (100, 2, 7, 1)
    # a JAX configuration of the same fit has the same flags
    assert JModelConfig(K=2, P=7, M=2, D=1, covariate_mean=True,
                        covariate_cov=True).__dict__ == res.config.__dict__


@pytest.mark.parametrize("family", ["multivariate", "hd"])
def test_fit_takes_the_other_families_from_raw_observations(family):
    rng = np.random.default_rng(1)
    if family == "multivariate":
        Y, time, kw = rng.normal(size=(12, 4)), None, {}
    else:
        time = [rng.uniform(0, 1, (14, 2)) for _ in range(6)]
        Y = [np.sin(3 * ti[:, 0]) + ti[:, 1] for ti in time]
        kw = dict(basis_degrees=[2, 2],
                  internal_knots_list=[np.array([0.5])] * 2,
                  boundary_knots=np.array([[0., 1.], [0., 1.]]))
    res = api.fit(Y, time, K=2, M=1, family=family, nu_z_iters=100,
                  theta_iters=100, warm_iters=100, progress=False,
                  kernels="production", device="cpu", **kw)
    assert res.config.family == family == res.data.family
    assert res.data.identity_basis == (family == "multivariate")
    assert np.isfinite(res.loglik).all()
    if family == "multivariate":
        # the stored Tau is the variance: the reciprocal of the precision
        np.testing.assert_allclose(
            api.export_layout(res.traces, res.config)["Tau"],
            1.0 / res.traces["tau"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            api.fit(Y, time, K=2, M=1, family=family, nu_z_iters=100, **kw)


def test_fit_result_from_estimates_starts_phase_3_where_it_says():
    """A FitResult made from stored point estimates gives them back as its
    estimates (Z renormalised), for both phases of fit_warm_start; nested
    lists that lost the axes behind D = 0 are reshaped."""
    data, truth = simulate_functional(seed=4, N=6, K=2, P=5, M=2,
                                      n_time=(8, 9), device="cpu")
    est = {f: np.asarray(v).tolist() for f, v in truth.items()}
    assert np.asarray(est["xi"]).shape == (2, 5, 0)       # the lost axis
    r = convert.fit_result_from_estimates(est, data, ModelConfig(K=2, P=5,
                                                                 M=2))
    got = r.estimates(_warn=False)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(got[f], truth[f], rtol=1e-6, err_msg=f)
    assert got["xi"].shape == (2, 5, 0, 2)
    res = api.fit_warm_start(r, r, tot_mcmc_iters=100, n_chains=2,
                             progress=False)
    assert res.config == r.config and np.isfinite(res.loglik).all()
    # from the truth the first draw is already at the truth's level
    assert res.loglik[0] > 0.8 * res.loglik[-20:].mean() > 0
