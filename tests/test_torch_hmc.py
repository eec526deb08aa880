"""The port's log-joint, K2's backward and HMC against the JAX package's, on
the CPU.

The log-joint's value and gradient at the same unconstrained point (carried
across by ``convert.unc_from_jax``) for the four families, at temperatures
0 and 1, in float32 and float64; ``flatten`` against ``ravel_pytree``;
``MeanRSS`` (the autograd Function the log-joint's RSS goes through) by
gradcheck, against autograd and against ``jax.grad``; the leapfrog and the
dual averaging on identical inputs.  Then ports of tests/test_hmc.py, and
``fit_hmc`` as a whole: its statistics on the small protocol inside the
JAX limits of tests/data/torch_hmc_reference.json, F13 (xi held at zero
without ``covariate_cov``), and its validations.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from bayesfmmm_tpu import api as japi  # noqa: E402
from bayesfmmm_tpu.config import ModelConfig as JConfig  # noqa: E402
from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models import logjoint as jlj  # noqa: E402
from bayesfmmm_tpu.ops import mean as jmean  # noqa: E402
from bayesfmmm_tpu.samplers import hmc as jhmc  # noqa: E402
from bayesfmmm_tpu.utils.simulate import (  # noqa: E402
    simulate_functional as jsim, simulate_hd_functional as jsim_hd,
    simulate_multivariate as jsim_mv)
from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models import logjoint  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.ops import kernels  # noqa: E402
from bayesfmmm_torch.ops.mean import rss_from_coeffs  # noqa: E402
from bayesfmmm_torch.samplers import hmc  # noqa: E402
from bayesfmmm_torch.utils.simulate import (  # noqa: E402
    simulate_functional, simulate_hd_functional, simulate_multivariate)

HP = Priors()
REFERENCE = json.loads((Path(__file__).parent / "data"
                        / "torch_hmc_reference.json").read_text())
CHAINS = 3

# the four families of the log-joint: (simulator, its arguments, K, M, D)
FAMILIES = {
    "functional": (jsim, dict(seed=51, N=20, K=2, P=6, M=2,
                              n_time=(25, 30)), 2, 2, 0),
    "hd": (jsim_hd, dict(seed=94, N=8, K=2, M=2, n_points=(20, 25)), 2, 2,
           0),
    "multivariate": (jsim_mv, dict(seed=93, N=30, K=2, P=6, M=2,
                                   sigma2=0.05), 2, 2, 0),
    "covariates": (jsim, dict(seed=52, N=15, K=2, P=5, M=2, D=1,
                              with_eta=True, with_xi=True, n_time=(15, 20)),
                   2, 2, 1),
}
# value: relative; gradient: relative norm of the difference, per chain
TOL = {"float32": (1e-4, 1e-3), "float64": (1e-9, 1e-9)}


def _point(family, dtype):
    """The JAX data and a random unconstrained point of CHAINS chains (JAX
    leaves), and the port's data: the JAX init_unc plus 0.3 N(0, 1) noise
    from a NumPy seed on every leaf."""
    sim, kw, K, M, D = FAMILIES[family]
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    jdata, _ = sim(dtype=jdt, **kw)
    cfg = JConfig(K=K, P=int(jdata.P), M=M, D=D, covariate_mean=D > 0,
                  covariate_cov=D > 0)
    uncs = jax.vmap(lambda k: jlj.init_unc(k, cfg, jdata, jdt))(
        jax.random.split(jax.random.PRNGKey(0), CHAINS))
    rng = np.random.default_rng(1)
    uncs = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x, np.float64)
                              + 0.3 * rng.normal(size=x.shape), jdt), uncs)
    tdata = convert.data_from_jax(jdata, device="cpu",
                                  dtype=getattr(torch, dtype))
    return jdata, uncs, tdata, K


def _ravel(tree, i):
    return np.asarray(ravel_pytree(jax.tree.map(lambda x: x[i], tree))[0])


def _value_and_grad(tdata, tu, K, dtype, temperature):
    lj = logjoint.make_log_joint(tdata, TPriors(), torch.full(
        (K,), 10.0, dtype=getattr(torch, dtype)), temperature=temperature)
    return hmc.value_and_grad(lambda q: lj(logjoint.unflatten(q, tu)),
                              logjoint.flatten(tu))


@pytest.mark.parametrize("dtype,temperature", [("float32", 0.0),
                                               ("float32", 1.0),
                                               ("float64", 1.0)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_log_joint_matches_jax(family, dtype, temperature):
    """Value and gradient of the log-joint per chain at one unconstrained
    point equal the JAX package's make_log_joint and jax.grad, to float32
    rounding (1e-4 relative on the value, 1e-3 relative norm on the
    gradient) or float64's (1e-9 on both)."""
    with jax.enable_x64(dtype == "float64"):
        jdata, uncs, tdata, K = _point(family, dtype)
        c = jnp.full((K,), 10.0, uncs.nu.dtype)
        jl = jlj.make_log_joint(jdata, HP, c, temperature=temperature)
        jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jl)))(uncs)
        jv = np.asarray(jv, np.float64)
        jg = np.stack([_ravel(jg, i) for i in range(CHAINS)])
    tu = convert.unc_from_jax(uncs, device="cpu", dtype=getattr(torch, dtype))
    tv, tg = _value_and_grad(tdata, tu, K, dtype, temperature)
    assert tv.shape == (CHAINS,) and tg.shape == jg.shape
    v_tol, g_tol = TOL[dtype]
    np.testing.assert_allclose(tv.numpy(), jv, rtol=v_tol)
    err = np.linalg.norm(tg.numpy() - jg, axis=1) / np.linalg.norm(jg, axis=1)
    assert err.max() < g_tol, err


@pytest.mark.parametrize("family", ["functional", "covariates"])
def test_flatten_follows_ravel_pytree(family):
    """flatten is ravel_pytree's order bit for bit (empty fields give
    nothing), unflatten inverts it, and covariate_cov=False holds the xi
    tower out of the position and takes it from the template."""
    _, uncs, _, _ = _point(family, "float32")
    tu = convert.unc_from_jax(uncs, device="cpu")
    q = logjoint.flatten(tu)
    want = np.stack([_ravel(uncs, i) for i in range(CHAINS)])
    assert np.array_equal(q.numpy(), want)
    back = logjoint.unflatten(q, tu)
    host = convert.unc_from_jax(convert.unc_to_numpy(tu), device="cpu")
    one = convert.unc_from_jax(jax.tree.map(lambda x: x[1], uncs), chains=2,
                               device="cpu")
    for f in logjoint.UNC_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tu, f)), f
        assert torch.equal(getattr(host, f), getattr(tu, f)), f
        assert torch.equal(getattr(one, f), getattr(tu, f)[1:2].expand(
            (2,) + getattr(tu, f).shape[1:])), f
    q_no_xi = logjoint.flatten(tu, covariate_cov=False)
    n_xi = sum(getattr(tu, f)[0].numel() for f in logjoint.XI_TOWER)
    assert q_no_xi.shape == (CHAINS, q.shape[1] - n_xi)
    assert (n_xi > 0) == (family == "covariates")
    like = tu.replace(xi_raw=torch.zeros_like(tu.xi_raw[:1]))
    back = logjoint.unflatten(q_no_xi, like, covariate_cov=False)
    assert torch.equal(back.eta, tu.eta) and not back.xi_raw.any()
    with pytest.raises(ValueError, match="coordinates"):
        logjoint.unflatten(q[:, 1:], tu)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_to_state_matches_jax_and_round_trips(family):
    """to_state equals the JAX package's per chain, and from_state inverts
    it (port of tests/test_hmc.py::test_transform_roundtrip)."""
    _, uncs, _, _ = _point(family, "float32")
    tu = convert.unc_from_jax(uncs, device="cpu")
    st = logjoint.to_state(tu)
    jst = jax.vmap(jlj.to_state)(uncs)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=2e-5,
                                   atol=1e-6, err_msg=f)
    st2 = logjoint.to_state(logjoint.from_state(st))
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(st2, f).numpy(),
                                   getattr(st, f).numpy(), atol=1e-5,
                                   err_msg=f)


def test_transform_roundtrip():
    """Port of tests/test_hmc.py::test_transform_roundtrip on the port's
    own random start."""
    data, _ = simulate_functional(seed=51, N=20, K=2, P=6, M=2,
                                  n_time=(25, 30), device="cpu")
    unc = logjoint.init_unc(torch.Generator().manual_seed(1),
                            ModelConfig(K=2, P=6, M=2), data, 2)
    st = logjoint.to_state(unc)
    st2 = logjoint.to_state(logjoint.from_state(st))
    for f in STATE_FIELDS:
        torch.testing.assert_close(getattr(st2, f), getattr(st, f),
                                   rtol=0, atol=1e-5)


def _truth(truth):
    """The simulators' truth (host arrays) as a one-chain state."""
    return convert.state_from_numpy(truth, device="cpu")


def _small():
    data, truth = simulate_functional(seed=51, N=20, K=2, P=6, M=2,
                                      n_time=(25, 30), device="cpu")
    return (data, _truth(truth), ModelConfig(K=2, P=6, M=2),
            torch.full((2,), 10.0))


def test_log_joint_finite_and_differentiable():
    data, _, cfg, c = _small()
    lj = logjoint.make_log_joint(data, TPriors(), c)
    unc = logjoint.init_unc(torch.Generator().manual_seed(0), cfg, data, 2)
    lp, grad = hmc.value_and_grad(lambda q: lj(logjoint.unflatten(q, unc)),
                                  logjoint.flatten(unc))
    assert torch.isfinite(lp).all() and torch.isfinite(grad).all()
    assert grad.abs().sum() > 0


def test_log_joint_likelihood_term_matches():
    """The likelihood portion of the log joint equals models.likelihood
    (port of tests/test_hmc.py::test_log_joint_likelihood_term_matches)."""
    data, truth, _, c = _small()
    unc = logjoint.from_state(truth)
    lj1 = logjoint.make_log_joint(data, TPriors(), c, temperature=1.0)
    lj0 = logjoint.make_log_joint(data, TPriors(), c, temperature=0.0)
    ll_from_joint = (lj1(unc) - lj0(unc)).double()
    ll_direct = log_likelihood(truth, data).double()
    assert (ll_from_joint - ll_direct).abs().item() \
        < max(2e-3 * ll_direct.abs().item(), 0.5)


def test_covadj_log_joint():
    """Port of tests/test_hmc.py::test_covadj_log_joint: the gradient
    reaches eta and the xi tower."""
    data, _ = simulate_functional(seed=52, N=15, K=2, P=5, M=2, D=1,
                                  with_eta=True, with_xi=True,
                                  n_time=(15, 20), device="cpu")
    cfg = ModelConfig(K=2, P=5, M=2, D=1, covariate_mean=True,
                      covariate_cov=True)
    lj = logjoint.make_log_joint(data, TPriors(), torch.full((2,), 10.0))
    unc = logjoint.init_unc(torch.Generator().manual_seed(3), cfg, data, 1)
    leaves = {f: getattr(unc, f).clone().requires_grad_()
              for f in logjoint.UNC_FIELDS}
    lp = lj(logjoint.UncState(**leaves))
    assert torch.isfinite(lp).all()
    g_xi, g_eta = torch.autograd.grad(lp.sum(), (leaves["xi_raw"],
                                                 leaves["eta"]))
    assert torch.isfinite(g_xi).all() and torch.isfinite(g_eta).all()
    assert g_eta.abs().sum() > 0


# ---------------------------------------------------------------------------
# K2's backward through MeanRSS
# ---------------------------------------------------------------------------

def _k2_inputs(dtype=torch.float64, C=3, N=5, L=7, P=4, seed=0):
    rng = np.random.default_rng(seed)
    B, y, w = (torch.tensor(rng.normal(size=s), dtype=dtype)
               for s in ((N, L, P), (N, L), (C, N, P)))
    return B, y, w


def test_mean_rss_function_passes_gradcheck():
    B, y, w = _k2_inputs()
    w.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda w: kernels.MeanRSS.apply(B, y, w), (w,))


def test_mean_rss_grad_plain_matches_autograd_and_jax():
    """The plain backward equals autograd through mean_rss_plain and
    jax.grad of the JAX package's rss_from_coeffs, chain by chain, for an
    upstream gradient g (float32 rounding: 1e-5 relative)."""
    B, y, w = _k2_inputs(torch.float32, C=4, N=6, L=9, P=5, seed=2)
    g = torch.tensor([1.0, -0.5, 2.0, 0.25])
    got = kernels.mean_rss_grad_plain(B, y, w, g)
    wr = w.clone().requires_grad_()
    want, = torch.autograd.grad(
        (kernels.mean_rss_plain(B, y, wr)[0] * g).sum(), wr)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jdata = type("D", (), {"B": jnp.asarray(B.numpy()),
                           "y": jnp.asarray(y.numpy()),
                           "identity_basis": False})
    for c in range(4):
        jg = jax.grad(lambda wc: jmean.rss_from_coeffs(jdata, wc))(
            jnp.asarray(w[c].numpy()))
        np.testing.assert_allclose(got[c].numpy(),
                                   float(g[c]) * np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)
    # the function's backward is the plain one on the CPU, K2 launched never
    kernels.reset_launch_counts()
    wr = w.clone().requires_grad_()
    rss = kernels.MeanRSS.apply(B, y, wr)
    assert torch.equal(rss.detach(), kernels.mean_rss_plain(B, y, w)[0])
    back, = torch.autograd.grad((rss * g).sum(), wr)
    assert torch.equal(back, got)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_rss_from_coeffs_takes_the_function_when_w_needs_a_gradient():
    data, _, _, _ = _small()
    w = torch.randn(2, data.N, data.P, generator=torch.Generator()
                    .manual_seed(0))
    plain = rss_from_coeffs(data, w)
    assert plain.grad_fn is None
    wr = w.clone().requires_grad_()
    rss = rss_from_coeffs(data, wr)
    assert type(rss.grad_fn).__name__ == "MeanRSSBackward"
    assert torch.equal(rss.detach(), plain)
    with torch.no_grad():
        assert rss_from_coeffs(data, wr).grad_fn is None


def test_mean_rss_grad_plan_covers_the_forwards_p_range():
    """One launch's layout at every P the forward serves: whole warps of at
    most K2_GRAD_THREADS, a chain's lanes within one warp and covering P,
    every chain and observation in the grid, the chunks' shared memory
    within K2_GRAD_SMEM."""
    for C, N, L, P in ((64, 100, 100, 8), (1, 100, 100, 8), (64, 64, 144, 16),
                       (3, 5, 7000, 1280), (300, 2, 3, 1)):
        plan = kernels.mean_rss_grad_plan(C, N, L, P)
        assert set(plan) == {"KP", "SP", "SL", "TC", "threads", "LC",
                             "buffers", "grid", "smem"}
        S = plan["SP"] * plan["SL"]
        assert S <= 32 and plan["KP"] * plan["SP"] >= P
        assert plan["KP"] in kernels.K2_GRAD_LANE_FLOATS
        assert plan["threads"] == plan["TC"] * S
        assert plan["threads"] % 32 == 0
        assert plan["threads"] <= kernels.K2_GRAD_THREADS
        assert plan["grid"] == (N, -(-C // plan["TC"]))
        row = (plan["KP"] if plan["SP"] == 1 else P) + 1
        assert plan["smem"] == 4 * plan["buffers"] * plan["LC"] * row \
            <= kernels.K2_GRAD_SMEM
        assert 1 <= plan["LC"] <= L
        assert plan["buffers"] == (1 if plan["LC"] == L else 2)
        if plan["buffers"] == 2:
            assert plan["LC"] % plan["SL"] == 0
    assert kernels.K2_MAX_P == 1280
    kernels.mean_rss_plan(8, 5, 7, 1280)
    for plan in (kernels.mean_rss_plan, kernels.mean_rss_grad_plan):
        with pytest.raises(NotImplementedError, match="P=1281"):
            plan(8, 5, 7, 1281)
    b = kernels.kernel_bound("mean_rss_grad", C=64, N=100, L=100, P=8)
    # 4P + 1 a chain and point: 2P for the residual's multiply-adds, 1 for
    # its difference from y, 2P for the multiply-adds into grad_w
    assert b["flop"] == 64 * 100 * 100 * 33
    assert b["bytes"] == 4 * (100 * 100 * 8 + 100 * 100 + 2 * 64 * 100 * 8
                              + 64)


# ---------------------------------------------------------------------------
# The sampler's pieces on identical inputs
# ---------------------------------------------------------------------------

def _gauss(prec, mu):
    return lambda q: -0.5 * ((q - mu) @ prec * (q - mu)).sum(-1)


def test_leapfrog_matches_jax():
    """8 leapfrog steps from the same q, p0, eps and inverse mass, chain by
    chain, equal the JAX package's _leapfrog (float32 rounding); a chain
    given fewer steps stops where JAX's own shorter run stops."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(4, 4))
    prec = A @ A.T + 4 * np.eye(4)
    mu = rng.normal(size=4)
    q, p0 = rng.normal(size=(2, 3, 4))
    inv_mass = rng.uniform(0.5, 2.0, size=(3, 4))
    eps = np.array([0.05, 0.1, 0.2])
    n = np.array([8, 8, 5])
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    lj = _gauss(f32(prec), f32(mu))
    logp, grad = hmc.value_and_grad(lj, f32(q))
    got = hmc._leapfrog(lambda x: hmc.value_and_grad(lj, x), f32(q),
                        f32(p0), grad, logp, f32(eps), f32(inv_mass),
                        torch.tensor(n))
    jl = lambda x: -0.5 * (x - mu) @ jnp.asarray(prec, jnp.float32) \
        @ (x - mu)  # noqa: E731
    vg = jax.value_and_grad(jl)
    for c in range(3):
        qc = jnp.asarray(q[c], jnp.float32)
        jq, jp, jgr = jhmc._leapfrog(
            vg, qc, jnp.asarray(p0[c], jnp.float32), vg(qc)[1],
            jnp.float32(eps[c]), jnp.asarray(inv_mass[c], jnp.float32),
            int(n[c]))
        for a, b in zip(got[:3], (jq, jp, jgr)):
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[3][c].item(), float(jl(jq)),
                                   rtol=1e-5)


def test_dual_avg_update_matches_jax():
    rng = np.random.default_rng(4)
    C, dim = 3, 2
    fields = [rng.normal(size=C) for _ in range(3)] + [np.full(C, 7.0)]
    ad = hmc.AdaptState(*(torch.tensor(a, dtype=torch.float32)
                          for a in fields),
                        torch.zeros(C, dim), torch.zeros(C, dim),
                        torch.zeros(C))
    ap = rng.uniform(size=C)
    for mu in (None, 0.3):
        got = hmc._dual_avg_update(ad, torch.tensor(ap, dtype=torch.float32),
                                   0.8, mu=mu)
        for c in range(C):
            jad = jhmc.AdaptState(*(jnp.float32(a[c]) for a in fields),
                                  jnp.zeros(dim), jnp.zeros(dim), 0.0)
            want = jhmc._dual_avg_update(jad, jnp.float32(ap[c]), 0.8, mu=mu)
            for f in ("log_eps", "log_eps_avg", "h_avg", "step"):
                np.testing.assert_allclose(getattr(got, f)[c].item(),
                                           float(getattr(want, f)),
                                           rtol=1e-6, err_msg=f)


def test_hmc_evaluations_follow_the_trajectory_lengths():
    """One gradient evaluation to start, then the longest of the chains'
    drawn lengths each iteration: the masked loop runs no step more."""
    calls = []
    lj = _gauss(torch.eye(3) * 2.0, torch.zeros(3))

    def counted(q):
        calls.append(q.shape[0])
        return lj(q)

    q0 = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    _, diag = hmc.run_hmc(torch.Generator().manual_seed(1), counted, q0,
                          n_warmup=10, n_samples=6, n_leapfrog=7)
    n = diag["n_steps"]
    assert n.shape == (5, 16) and n.min() >= 1 and n.max() <= 7
    assert len(calls) == 1 + int(n.max(0).values.sum())
    assert set(calls) == {5}


# ---------------------------------------------------------------------------
# Ports of tests/test_hmc.py's sampling tests, and fit_hmc
# ---------------------------------------------------------------------------

def test_hmc_samples_and_mixes():
    data, truth, cfg, c = _small()
    lj = logjoint.make_log_joint(data, TPriors(), c)
    g = torch.Generator().manual_seed(2)
    unc = logjoint.init_unc(torch.Generator().manual_seed(1), cfg, data, 2)
    trace, diag = hmc.run_hmc(g, lambda q: lj(logjoint.unflatten(q, unc)),
                              logjoint.flatten(unc), n_warmup=150,
                              n_samples=80, n_leapfrog=12)
    acc = diag["accept_mean"]
    assert (acc > 0.4).all() and (acc <= 1.0).all()
    st = logjoint.to_state(logjoint.unflatten(trace.reshape(160, -1), unc))
    sig = st.sigma2
    assert torch.isfinite(sig).all()
    # sigma2 concentrates within an order of magnitude of truth
    assert sig.median() < 10 * truth.sigma2.item()
    # Z stays on the simplex
    torch.testing.assert_close(st.Z.sum(-1), torch.ones(160, 20), rtol=0,
                               atol=1e-5)


def test_fit_hmc_multivariate(tmp_path):
    """fit_hmc takes the family from the data; the trace export applies the
    multivariate tau reciprocal (UpdateTau.h:58)."""
    from bayesfmmm_torch.io import armaio
    data, truth = simulate_multivariate(seed=93, N=60, K=2, P=6, M=2,
                                        sigma2=0.05, device="cpu")
    truth = _truth(truth)
    res = api.fit_hmc(data, K=2, M=2, n_warmup=200, n_samples=120,
                      n_chains=2, n_leapfrog=12, device="cpu")
    assert res.config.family == "multivariate"
    assert (res.hmc_diagnostics["accept_mean"] > 0.4).all()
    truth_ll = log_likelihood(truth, data).item()
    best_tail = res.all_chain_loglik[res.chain_index, -20:].mean()
    assert best_tail > truth_ll - 150, (best_tail, truth_ll)
    api.export_traces(tmp_path, res.traces, res.config)
    back = armaio.load_trace_dir(tmp_path)
    np.testing.assert_allclose(back["Tau"], 1.0 / res.traces["tau"],
                               rtol=1e-4)


def test_fit_hmc_nuts_hd():
    """The hd (tensor-basis) family through the gradient path via NUTS."""
    data, truth = simulate_hd_functional(seed=94, N=12, K=2, M=2,
                                         n_points=(30, 40), device="cpu")
    truth = _truth(truth)
    res = api.fit_hmc(data, K=2, M=2, n_warmup=100, n_samples=60,
                      n_chains=2, method="nuts", max_depth=6, device="cpu")
    assert res.config.family == "hd"
    truth_ll = log_likelihood(truth, data).item()
    best_tail = res.all_chain_loglik[res.chain_index, -20:].mean()
    assert np.isfinite(best_tail)
    assert best_tail > truth_ll - 400, (best_tail, truth_ll)
    assert np.isfinite(res.traces["sigma2"]).all()


def test_fit_hmc_api():
    """Spectral-initialized whole-model HMC through the user API, drop-in
    compatible with the post-processing layer."""
    from bayesfmmm_torch.post import summaries
    data, truth = simulate_functional(seed=91, N=24, K=2, P=6, M=2,
                                      n_time=(25, 30), device="cpu")
    truth = _truth(truth)
    res = api.fit_hmc(data, K=2, M=2, n_warmup=150, n_samples=100,
                      n_chains=2, n_leapfrog=12, device="cpu")
    assert (res.hmc_diagnostics["accept_mean"] > 0.4).all()
    truth_ll = log_likelihood(truth, data).item()
    best_tail = res.all_chain_loglik[res.chain_index, -20:].mean()
    assert best_tail > truth_ll - 150, (best_tail, truth_ll)
    est = res.estimates(burnin_prop=0.3)
    assert float(est["sigma2"]) < 10 * truth.sigma2.item()
    ci = summaries.z_ci(res.traces["Z"], burnin_prop=0.3)
    assert ci["CI_50"].shape == (24, 2)
    assert res.final_state.Z.shape == (1, 24, 2)
    torch.testing.assert_close(log_likelihood(res.final_state, data),
                               torch.tensor(res.loglik[-1:]))


def _small_protocol(method):
    p = REFERENCE["small"]["protocol"]
    d = p["data"]
    data, _ = simulate_functional(seed=d["seed"], N=d["N"], K=d["K"],
                                  P=d["P"], M=d["M"],
                                  n_time=tuple(d["n_time"]), device="cpu")
    return data, dict(p["fit"], **p[method])


def check_small_statistics(method, seed):
    """fit_hmc on the small protocol: the best chain's mean loglik over its
    last 100 draws, its median sigma2, the pooled accept_mean and the
    median eps inside the JAX package's between-seed limits."""
    data, kw = _small_protocol(method)
    res = api.fit_hmc(data, seed=seed, device="cpu", **kw)
    got = {"loglik_tail_mean": res.loglik[-100:].mean(),
           "sigma2_median": np.median(res.traces["sigma2"]),
           "accept_mean": res.hmc_diagnostics["accept_mean"].mean(),
           "eps_median": np.median(res.hmc_diagnostics["eps"])}
    for stat, x in got.items():
        lo, hi = REFERENCE["small"][method][stat]["limits"]
        assert lo <= x <= hi, (method, stat, x, lo, hi)
    return res


def test_fit_hmc_small_statistics_inside_jax_limits():
    res = check_small_statistics("hmc", seed=11)
    n = res.hmc_diagnostics["n_steps"]
    assert n.shape == (4, 250) and n.min() >= 1 and n.max() <= 12
    assert res.all_chain_loglik.shape == (4, 100)


def test_xi_stays_zero_without_covariate_cov():
    """F13: with covariates but covariate_cov=False the xi tower is held
    out of the position, so xi stays zero while eta moves; with
    covariate_cov=True xi is sampled."""
    data, _ = simulate_functional(seed=52, N=15, K=2, P=5, M=2, D=1,
                                  with_eta=True, with_xi=True,
                                  n_time=(15, 20), device="cpu")
    kw = dict(K=2, M=2, n_warmup=20, n_samples=10, n_chains=2, n_leapfrog=6,
              device="cpu")
    off = api.fit_hmc(data, **kw)
    assert off.config.covariate_mean and not off.config.covariate_cov
    assert not off.traces["xi"].any() and not off.final_state.xi.any()
    assert np.abs(np.diff(off.traces["eta"], axis=0)).max() > 0
    on = api.fit_hmc(data, covariate_cov=True, **kw)
    assert on.config.covariate_cov and np.abs(on.traces["xi"]).max() > 0


def test_fit_hmc_validations():
    """The fit_hmc half of tests/test_validation.py::
    test_fit_hmc_advi_validations, and the port's own refusals."""
    data, _ = simulate_multivariate(seed=1, N=20, K=2, P=4, M=1,
                                    device="cpu")
    with pytest.raises(ValueError, match="'K' must be an integer"):
        api.fit_hmc(data, K=1, M=1, device="cpu")
    with pytest.raises(ValueError, match="'n_eigen' must be an integer"):
        api.fit_hmc(data, K=2, M=0, device="cpu")
    with pytest.raises(ValueError, match="'n_warmup' must be an integer"):
        api.fit_hmc(data, K=2, M=1, n_warmup=1, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        api.fit_hmc(data, K=2, M=1, method="mala", device="cpu")
    with pytest.raises(ValueError, match="unknown init"):
        api.fit_hmc(data, K=2, M=1, init="prior", device="cpu")


def test_fit_hmc_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    data, _ = simulate_multivariate(seed=1, N=20, K=2, P=4, M=1,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        api.fit_hmc(data, K=2, M=1, n_warmup=4, n_samples=1)


def test_fit_hmc_starts_from_a_state_and_converts():
    """init= a one-chain GibbsState starts every chain there; the result
    converts to host arrays with its diagnostics, and a JAX fit_hmc result
    carries its diagnostics across."""
    data, truth = simulate_functional(seed=91, N=24, K=2, P=6, M=2,
                                      n_time=(25, 30), device="cpu")
    res = api.fit_hmc(data, K=2, M=2, n_warmup=4, n_samples=3, n_chains=2,
                      n_leapfrog=3, init=_truth(truth), device="cpu")
    out = convert.fit_result_to_numpy(res)
    assert sorted(out["hmc_diagnostics"]) == [
        "accept_mean", "eps", "n_steps", "warm_accept"]
    assert out["all_chain_loglik"].shape == (2, 3)
    jdata, jtruth = jsim(seed=91, N=24, K=2, P=6, M=2, n_time=(25, 30))
    jres = japi.FitResult({f: np.asarray(getattr(jtruth, f))[None]
                           for f in STATE_FIELDS}, np.zeros(1), jtruth, 0)
    jres.config = JConfig(K=2, P=6, M=2)
    jres.hmc_diagnostics = {"eps": jnp.ones(2)}
    jres.all_chain_loglik = np.zeros((2, 1))
    t = convert.fit_result_from_jax(jres, convert.data_from_jax(
        jdata, device="cpu"))
    assert isinstance(t.hmc_diagnostics["eps"], np.ndarray)
    assert t.all_chain_loglik.shape == (2, 1)
