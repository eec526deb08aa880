"""The port's post-processing (post/summaries, post/model_selection,
post/predictive, post/cpo_fast) and its trace readers (io/rds, io/armaio on
the covariate golden files) against the JAX package's, on the CPU.

The NumPy copies must give the originals' numbers to float64 rounding on the
same inputs.  CPO is float32 in both packages (XLA there, PyTorch ops here):
the two agree within ``CPO_TOL``, set at about five times the largest
difference found on the CPU over the cases below (3.9e-4 nats in a marginal
log-likelihood of up to 57, 1.0e-4 in a CPO: mostly the JAX package's
float32 rounding of r'r - w'w, which the port takes as a sum of squares);
both are within 5e-3 of the float64 dense reference, as
tests/test_postprocessing.py holds the JAX one."""

import gzip
import io
import os
import struct
import tempfile
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402, F401

from bayesfmmm_tpu.io import armaio as jarmaio  # noqa: E402
from bayesfmmm_tpu.io import rds as jrds  # noqa: E402
from bayesfmmm_tpu.post import cpo_fast as jcpo_fast  # noqa: E402
from bayesfmmm_tpu.post import model_selection as jms  # noqa: E402
from bayesfmmm_tpu.post import predictive as jpredictive  # noqa: E402
from bayesfmmm_tpu.post import summaries as jsummaries  # noqa: E402
from bayesfmmm_tpu.utils.simulate import (  # noqa: E402
    simulate_functional as jsimulate)
from bayesfmmm_torch.io import armaio, rds  # noqa: E402
from bayesfmmm_torch.post import (cpo_fast, model_selection,  # noqa: E402
                                  predictive, summaries)
from bayesfmmm_torch.utils.simulate import (simulate_draws,  # noqa: E402
                                            simulate_functional)

CPO_TOL = dict(rtol=0, atol=2e-3)
EXACT = dict(rtol=1e-12, atol=1e-12)


def _assert_tree_close(got, want, **tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------

def _summary_inputs(K, D=0, n=40, P=6, M=3, N=15, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.dirichlet(np.ones(K), size=(n, N))
    return dict(nu=rng.normal(size=(n, K, P)), Phi=rng.normal(size=(n, K, P, M)),
                Z=Z, sigma=rng.gamma(2.0, 0.01, size=n),
                eta=rng.normal(size=(n, K, P, D)),
                xi=rng.normal(size=(n, K, P, D, M)),
                x=rng.normal(size=D), B=rng.normal(size=(11, P)),
                B2=rng.normal(size=(7, P)),
                T=rng.dirichlet(np.ones(K), size=(n, K)))


_MEAN_CASES = [
    dict(K=2, kw=dict(rescale=True)),
    dict(K=2, kw=dict(rescale=True, simultaneous=True)),
    dict(K=3, kw=dict(rescale=True)),              # warns, then unscaled
    dict(K=3, kw=dict(rescale=False, simultaneous=True, alpha=0.1)),
    dict(K=3, kw=dict(rescale=False, burnin_prop=0.3), trans=3),
    dict(K=2, kw=dict(rescale=False), trans=2),    # stacked (draws*K, K)
    dict(K=2, D=2, kw=dict(rescale=True), cov=True),
    dict(K=3, D=1, kw=dict(rescale=False, simultaneous=True), cov=True),
]


@pytest.mark.parametrize("case", _MEAN_CASES)
@pytest.mark.parametrize("fn", ["mean_ci", "cov_ci"])
def test_summaries_copy_equals_original(case, fn):
    """mean_ci and cov_ci, pointwise and simultaneous, rescaled at K = 2
    with the K > 2 warning, with trans_mats in both layouts and with eta /
    xi and x; the port also takes the inputs as tensors."""
    x = _summary_inputs(case["K"], case.get("D", 0))
    kw = dict(case["kw"], Z_samp=x["Z"])
    K = case["K"]
    if "trans" in case:
        # one transform a kept draw
        T = jsummaries.keep_tail(x["T"], kw.get("burnin_prop", 0.1))
        kw["trans_mats"] = T if case["trans"] == 3 else T.reshape(-1, K)
    if fn == "mean_ci":
        args = (x["nu"], x["B"], K)
        if case.get("cov"):
            kw.update(eta_samp=x["eta"], x=x["x"])
    else:
        args = (x["Phi"], x["B"], x["B2"], 1, K)
        if case.get("cov"):
            kw.update(xi_samp=x["xi"], x=x["x"])
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        want = getattr(jsummaries, fn)(*args, **kw)
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = getattr(summaries, fn)(*args, **kw)
        got_t = getattr(summaries, fn)(
            *(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
              for a in args),
            **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
    assert [str(w.message) for w in w_port] == \
        [str(w.message) for w in w_jax] * 2
    assert bool(w_jax) == (K > 2 and kw["rescale"])
    _assert_tree_close(got, want, **EXACT)
    _assert_tree_close(got_t, want, **EXACT)


@pytest.mark.parametrize("burnin", [0.0, 0.1, 0.25, 0.5])
def test_summary_helpers_copy_equal_originals(burnin):
    x = _summary_inputs(2)
    for f in ("nu", "Phi"):
        T = summaries.rescale_transforms(x["Z"])
        np.testing.assert_array_equal(T, jsummaries.rescale_transforms(x["Z"]))
        np.testing.assert_array_equal(
            summaries.apply_transforms(x[f], T),
            jsummaries.apply_transforms(x[f], T))
    np.testing.assert_array_equal(summaries.keep_tail(x["nu"], burnin),
                                  jsummaries.keep_tail(x["nu"], burnin))
    _assert_tree_close(summaries.z_ci(x["Z"], burnin_prop=burnin, alpha=0.1),
                       jsummaries.z_ci(x["Z"], burnin_prop=burnin,
                                       alpha=0.1), **EXACT)
    _assert_tree_close(
        summaries.sigma_ci(torch.as_tensor(x["sigma"]), burnin_prop=burnin),
        jsummaries.sigma_ci(x["sigma"], burnin_prop=burnin), **EXACT)
    with pytest.raises(ValueError):
        summaries.apply_transforms(x["Z"][0], T)


# ---------------------------------------------------------------------------
# model selection, predictive paths, CPO: shared data and traces
# ---------------------------------------------------------------------------

_CASES = {
    # name -> simulator keywords and whether X goes to the functions
    "plain": dict(N=12, K=2, P=6, M=2, n_time=(15, 24)),
    "eta": dict(N=12, K=2, P=6, M=2, D=2, n_time=(15, 24), with_eta=True),
    "eta_xi": dict(N=10, K=3, P=5, M=3, D=1, n_time=(12, 20), with_eta=True,
                   with_xi=True),
}


def _case(name, n_draws=30):
    kw = _CASES[name]
    jdata, _ = jsimulate(seed=5, **kw)
    data, truth = simulate_functional(seed=5, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(jdata.B), data.B.numpy())
    traces = simulate_draws(truth, n_draws, seed=11, spread=0.05)
    if not kw.get("with_xi"):
        traces = {k: v for k, v in traces.items()
                  if k not in ("xi", "gamma_xi", "delta_xi", "A_xi")}
    X = data.X.numpy() if kw.get("D") else None
    return jdata, data, traces, X


@pytest.fixture(scope="module", params=sorted(_CASES))
def case(request):
    return (request.param,) + _case(request.param)


def test_model_selection_copy_equals_original(case):
    name, jdata, data, traces, X = case
    for cov_adj in (False, True):
        assert model_selection.param_count(traces, data, X, cov_adj) == \
            jms.param_count(traces, jdata, X, cov_adj)
        for fn in ("aic", "bic"):
            got = getattr(model_selection, fn)(traces, data, burnin_prop=0.2,
                                               X=X, cov_adj=cov_adj)
            want = getattr(jms, fn)(traces, jdata, burnin_prop=0.2, X=X,
                                    cov_adj=cov_adj)
            np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(
        model_selection.dic(traces, data, burnin_prop=0.2, X=X),
        jms.dic(traces, jdata, burnin_prop=0.2, X=X), **EXACT)
    for fn in ("loglik_trace", "pointwise_densities"):
        np.testing.assert_allclose(getattr(model_selection, fn)(traces, data, X),
                                   getattr(jms, fn)(traces, jdata, X), **EXACT)
    # trace tensors are taken as they are
    t_traces = {k: torch.as_tensor(v) for k, v in traces.items()}
    np.testing.assert_allclose(model_selection.loglik_trace(t_traces, data, X),
                               jms.loglik_trace(traces, jdata, X), **EXACT)


def test_sample_paths_copy_gives_the_same_bits(case):
    name, jdata, data, traces, X = case
    for seed in (0, 3):
        got = predictive.sample_paths(traces, data, burnin_prop=0.3, X=X,
                                      seed=seed, alpha=0.1)
        want = jpredictive.sample_paths(traces, jdata, burnin_prop=0.3, X=X,
                                        seed=seed, alpha=0.1)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_marginal_loglik_and_cpo_match_jax(case):
    """The port's f32 Woodbury marginal log-likelihoods and CPO against the
    JAX package's, ragged masks, plain, with eta and with eta and xi; and
    both against the float64 dense CPO."""
    name, jdata, data, traces, X = case
    got = cpo_fast.marginal_loglik_matrix(traces, data, X)
    want = jcpo_fast.marginal_loglik_matrix(traces, jdata, X)
    assert got.shape == want.shape == (data.N, 30)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **CPO_TOL)
    cpo = cpo_fast.cpo_fast(traces, data, burnin_prop=0.2, X=X)
    np.testing.assert_allclose(
        cpo, jcpo_fast.cpo_fast(traces, jdata, burnin_prop=0.2, X=X),
        **CPO_TOL)
    np.testing.assert_array_equal(
        model_selection.cpo(traces, data, burnin_prop=0.2, X=X), cpo)
    dense = jms.cpo_dense(traces, jdata, burnin_prop=0.2, X=X)
    np.testing.assert_allclose(cpo, dense, atol=5e-3)
    np.testing.assert_allclose(
        model_selection.cpo_dense(traces, data, burnin_prop=0.2, X=X),
        dense, **EXACT)


@pytest.mark.parametrize("chunk", [1, 4, 7, 30])
def test_cpo_does_not_depend_on_the_chunk(chunk, monkeypatch):
    """Draws in chunks of any size give the numbers of one pass: the chunk
    changes only the order of the batched products' float32 sums, never
    which draws or observations are combined."""
    jdata, data, traces, X = _case("eta_xi")
    whole = cpo_fast.marginal_loglik_matrix(traces, data, X)
    # chunks of ``chunk`` draws
    monkeypatch.setattr(cpo_fast, "CHUNK_VALUES",
                        chunk * data.N * 3 * data.L)     # M = 3
    part = cpo_fast.marginal_loglik_matrix(traces, data, X)
    np.testing.assert_allclose(part, whole, **CPO_TOL)
    np.testing.assert_allclose(
        part, jcpo_fast.marginal_loglik_matrix(traces, jdata, X), **CPO_TOL)


def test_cpo_raises_on_a_failed_factor(monkeypatch):
    """sigma2 I + U U' that is not positive definite raises, also when its
    draw lies in a chunk before the last: no NaN comes back in place of a
    CPO (the JAX package's does, ROADMAP F10)."""
    _, data, traces, X = _case("plain")
    bad = dict(traces, sigma2=traces["sigma2"].copy())
    bad["sigma2"][7] = -1.0
    monkeypatch.setattr(cpo_fast, "CHUNK_VALUES",
                        4 * data.N * 2 * data.L)         # 4 draws, M = 2
    with pytest.raises(np.linalg.LinAlgError, match="positive definite"):
        cpo_fast.cpo_fast(bad, data, burnin_prop=0.0)


# ---------------------------------------------------------------------------
# readers: RDS byte streams, the covariate golden trace files
# ---------------------------------------------------------------------------

def _xdr_header():
    return b"X\n" + struct.pack(">III", 3, 0x040000, 0x030500) + \
        struct.pack(">I", 5) + b"UTF-8"


def _flags(sxp, attr=False, tag=False):
    return struct.pack(">I", sxp | (attr << 9) | (tag << 10))


def _charsxp(s):
    b = s.encode()
    return _flags(9) + struct.pack(">i", len(b)) + b


def _symbol(s):
    return _flags(1) + _charsxp(s)


def _strsxp(items):
    return _flags(16) + struct.pack(">i", len(items)) + \
        b"".join(_charsxp(s) for s in items)


def _pairlist(entries):
    out = b""
    for tag, value in entries:
        out += _flags(2, tag=True) + _symbol(tag) + value
    return out + struct.pack(">I", 254)


_RDS_OBJECTS = {
    "real": _flags(14) + struct.pack(">i", 3) + struct.pack(">3d", 1.5, -2, 7),
    "integer": _flags(13) + struct.pack(">i", 4) + struct.pack(">4i", 1, -3, 5,
                                                               9),
    "logical": _flags(10) + struct.pack(">i", 3) + struct.pack(">3i", 1, 0, 1),
    "logical_na": _flags(10) + struct.pack(">i", 2)
    + struct.pack(">2i", 1, -2147483648),
    "string": _strsxp(["time"]),
    "named_list": _flags(19, attr=True) + struct.pack(">i", 2)
    + _flags(14) + struct.pack(">i", 1) + struct.pack(">d", 3.25)
    + _strsxp(["a", "b"])
    + _pairlist([("names", _strsxp(["x", "labels"]))]),
    "matrix": _flags(14, attr=True) + struct.pack(">i", 6)
    + struct.pack(">6d", *range(6))
    + _pairlist([("dim", _flags(13) + struct.pack(">i", 2)
                  + struct.pack(">2i", 2, 3))]),
    "list_of_vectors": _flags(19) + struct.pack(">i", 2)
    + _flags(14) + struct.pack(">i", 2) + struct.pack(">2d", 0.5, 1.5)
    + _flags(14) + struct.pack(">i", 1) + struct.pack(">d", -4.0),
}


@pytest.mark.parametrize("name", sorted(_RDS_OBJECTS))
@pytest.mark.parametrize("compressed", [True, False])
def test_rds_copy_reads_as_the_original(tmp_path, name, compressed):
    raw = _xdr_header() + _RDS_OBJECTS[name]
    path = tmp_path / "obj.RDS"
    path.write_bytes(gzip.compress(raw) if compressed else raw)
    got, want = rds.read_rds(str(path)), jrds.read_rds(str(path))
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert type(g) is type(w)
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if name == "matrix":
        np.testing.assert_array_equal(got, np.arange(6.0).reshape(2, 3,
                                                                  order="F"))


def test_rds_copy_refuses_what_the_original_refuses(tmp_path):
    path = tmp_path / "bin.RDS"
    path.write_bytes(b"B\n" + b"\0" * 16)
    for reader in (rds.read_rds, jrds.read_rds):
        with pytest.raises(ValueError, match="XDR"):
            reader(str(path))


GOLD = os.path.join(os.path.dirname(__file__), "data", "covadj_golden")
_GOLD_STEMS = ["Eta", "Tau_Eta", "Xi", "Gamma_Xi", "Delta_Xi", "A_Xi"]


def _expect(shape, fn):
    out = np.zeros(shape)
    for idx in np.ndindex(*shape):
        out[idx] = fn(*idx)
    return out


def test_covadj_golden_layouts_in_the_port():
    """The port's armaio reads the hand-built covariate trace files in the
    layouts tests/test_covadj_golden.py holds the JAX package's to."""
    from tests.data.make_covadj_golden import D, IT, K, M, P, val
    got = armaio.load_trace_dir(GOLD, names=_GOLD_STEMS, n_files=1)
    want = jarmaio.load_trace_dir(GOLD, names=_GOLD_STEMS, n_files=1)
    for stem in _GOLD_STEMS:
        np.testing.assert_array_equal(got[stem], want[stem])
    np.testing.assert_array_equal(
        got["Eta"],
        _expect((IT, K, P, D), lambda it, k, p, d: val(it, k, p, d, 0)))
    np.testing.assert_array_equal(
        got["Tau_Eta"], _expect((IT, K, D), lambda it, k, d: val(it, k, 0, d,
                                                                   0)))
    for stem in ("Xi", "Gamma_Xi"):
        np.testing.assert_array_equal(
            got[stem], _expect((IT, K, P, D, M), val))
    np.testing.assert_array_equal(
        got["Delta_Xi"],
        _expect((IT, K, M, D), lambda it, k, m, d: val(it, k, m, d, 0)))
    np.testing.assert_array_equal(
        got["A_Xi"],
        _expect((IT, K, 2, D), lambda it, k, x, d: val(it, k, x, d, 0)))


def test_covadj_golden_bytes_from_the_port_writer():
    got = armaio.load_trace_dir(GOLD, names=_GOLD_STEMS[:1] + _GOLD_STEMS[2:],
                                n_files=1)
    with tempfile.TemporaryDirectory() as tmp:
        armaio.save_trace_dir(tmp, got, batch=0)
        for stem in got:
            with open(os.path.join(tmp, f"{stem}0.txt"), "rb") as f:
                ours = f.read()
            with open(os.path.join(GOLD, f"{stem}0.txt"), "rb") as f:
                assert ours == f.read(), f"{stem} bytes differ"


def test_rds_reads_a_list_of_curves_as_the_fixtures_hold_them(tmp_path):
    """The shape of Sim_data.RDS/time.RDS: an unnamed list of numeric
    vectors, which the R names take as Y and time."""
    rng = np.random.default_rng(2)
    curves = [rng.normal(size=n) for n in (5, 8, 6)]
    body = _flags(19) + struct.pack(">i", 3) + b"".join(
        _flags(14) + struct.pack(">i", len(c)) + struct.pack(f">{len(c)}d",
                                                             *c)
        for c in curves)
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as f:
        f.write(_xdr_header() + body)
    (tmp_path / "Sim_data.RDS").write_bytes(buf.getvalue())
    got = rds.read_rds(str(tmp_path / "Sim_data.RDS"))
    assert len(got) == 3
    for g, c in zip(got, curves):
        np.testing.assert_array_equal(g, c)
