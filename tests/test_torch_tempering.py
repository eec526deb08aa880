"""The port's parallel tempering and per-chain temperatures against the JAX
package's, on the CPU.

* Per-chain temperatures: ``sweep_full``, ``sweep_nu_z`` and
  ``sweep_theta`` take a float or a (C,) tensor ``beta``.  A tensor whose
  entries all equal a float32 value b gives the float b's bits; at a mixed
  tensor v, each tempered updater gives chain i the result of the same-seed
  call at the float v[i] (the random draws do not depend on beta), in both
  censuses, with covariates and in the multivariate family.  sigma^2's
  gamma shape depends on beta, so its shape and rate are held per chain and
  its draw by moments; and the tempered updaters' moments at a mixed beta
  against the JAX package vmapped at each beta (test_torch_gibbs.py's
  rule).
* The pieces of PT on identical inputs: the ladders, the energy and the
  swap permutation and counters, against JAX's ``pt_step`` fed the same
  energies and the JAX package's own uniforms.
* Ports of test_samplers_advanced.py's PT tests, ROADMAP F4 not copied, and
  ``fit_pt`` as a whole: its layout equals the JAX package's through
  ``convert``, and its statistics on the small protocol lie inside the JAX
  limits of tests/data/torch_tempering_reference.json.
"""

import json
import math
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu import api as japi  # noqa: E402
from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models.state import GibbsState as JState  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.parallel import tempering as jt  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig as TConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models.state import (  # noqa: E402
    STATE_FIELDS,
    init_state,
    take_chains,
)
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402
from bayesfmmm_torch.parallel import tempering as tt  # noqa: E402
from bayesfmmm_torch.utils import simulate as tsim  # noqa: E402

from test_torch_gibbs import _moments_agree  # noqa: E402

REFERENCE = Path(__file__).parent / "data" / "torch_tempering_reference.json"
# float32 values, so a float and a tensor hold the same temperature
B_EQUAL = (0.5, float(np.float32(0.37)))
MIXED = tuple(float(np.float32(b)) for b in (0.3, 1.0, 0.55, 0.8))


def _random_states(seed, C, N, K, P, M, D):
    """C distinct chains' states (numpy, leading C), every field
    non-trivial (test_torch_covariates.py's)."""
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


def _model(kind, C=len(MIXED)):
    """(data, state of C random chains, covariate flags) of a small model:
    the functional family without covariates, with eta and xi (D = 1), or
    the multivariate family."""
    if kind == "multivariate":
        data, _ = tsim.simulate_multivariate(seed=2, N=12, K=2, P=4, M=2,
                                             device="cpu")
        D = 0
    else:
        D = 1 if kind == "covariates" else 0
        data, _ = tsim.simulate_functional(
            seed=2, N=10, K=2, P=5, M=2, D=D, n_time=(12, 16),
            with_eta=D > 0, with_xi=D > 0, device="cpu")
    st = convert.state_from_numpy(
        _random_states(0, C, data.N, 2, data.P, 2, D), chains=C,
        device="cpu")
    return data, st, dict(covariate_mean=D > 0, covariate_cov=D > 0)


def _same_bits(a, b, what):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what}: {f}"


# ---------------------------------------------------------------------------
# Per-chain temperatures
# ---------------------------------------------------------------------------

_SWEEPS = {
    "reference": lambda g, s, d, c, cov, beta: tg.sweep_full(
        g, s, d, TPriors(), c, beta=beta, **cov),
    "production": lambda g, s, d, c, cov, beta: tg.sweep_full(
        g, s, d, TPriors(), c, beta=beta, **cov, **api.PRODUCTION_FLAGS),
    "nu_z": lambda g, s, d, c, cov, beta: tg.sweep_nu_z(
        g, s, d, TPriors(), c, beta=beta,
        covariate_mean=cov["covariate_mean"]),
    "theta": lambda g, s, d, c, cov, beta: tg.sweep_theta(
        g, s, d, TPriors(), beta=beta, **cov),
}


@pytest.mark.parametrize("kind", ["functional", "covariates",
                                  "multivariate"])
@pytest.mark.parametrize("sweep", list(_SWEEPS))
def test_equal_tensor_beta_gives_the_float_bits(kind, sweep):
    """Two sweeps at a (C,) beta of equal entries b and at the float b:
    every field the same bits."""
    data, st, cov = _model(kind)
    c = torch.full((2,), 10.0)
    for b in B_EQUAL:
        out = {}
        for name, beta in (("float", b), ("tensor", torch.full((4,), b))):
            g = torch.Generator().manual_seed(5)
            s = st
            for _ in range(2):
                s = _SWEEPS[sweep](g, s, data, c, cov, beta)
            out[name] = s
        _same_bits(out["float"], out["tensor"], f"{kind} {sweep} beta={b}")


def test_a_malformed_beta_raises():
    data, st, cov = _model("functional")
    c = torch.full((2,), 10.0)
    g = torch.Generator().manual_seed(0)
    for bad in (torch.ones(3), torch.ones(4, 1)):
        with pytest.raises(ValueError, match="beta must be a float"):
            tg.sweep_full(g, st, data, TPriors(), c, beta=bad)


def _with_w(fn):
    return lambda g, s, d, beta: fn(g, s, d, TPriors(), tcache(d, s), beta)


# name -> port call (generator, state, data, beta) -> (state, cache)
_TEMPERED = {
    "z": _with_w(tg.update_z),
    "z_chi": lambda g, s, d, beta: tg.update_z_chi(
        g, s, d, TPriors(), tcache(d, s), beta, p_indep=0.3),
    "nu": _with_w(tg.update_nu),
    "phi": _with_w(tg.update_phi),
    "chi": _with_w(tg.update_chi),
    "chi_joint": _with_w(tg.update_chi_joint),
    "eta": _with_w(tg.update_eta),
    "xi": _with_w(tg.update_xi),
    "mgp_scale": _with_w(tg.update_mgp_scale),
    "noise_scale": _with_w(tg.update_noise_scale),
    "phi_mala": lambda g, s, d, beta: tg.update_phi_mala(
        g, s, d, TPriors(), tcache(d, s), beta, step=0.05, n_steps=2),
}


@pytest.mark.parametrize("kind", ["functional", "covariates",
                                  "multivariate"])
@pytest.mark.parametrize("name", list(_TEMPERED))
def test_mixed_beta_gives_each_chain_its_float(kind, name):
    """At beta = v (C,), chain i is chain i of the same-seed call at the
    float v[i], to f32 rounding: every field and the running coefficients.
    """
    data, st, _ = _model(kind)
    fn = _TEMPERED[name]
    v = torch.tensor(MIXED)
    s_mix, c_mix = fn(torch.Generator().manual_seed(9), st, data, v)
    for i, b in enumerate(MIXED):
        s_i, c_i = fn(torch.Generator().manual_seed(9), st, data, b)
        for f in STATE_FIELDS:
            torch.testing.assert_close(
                getattr(s_mix, f)[i], getattr(s_i, f)[i], rtol=1e-5,
                atol=1e-6, msg=lambda m: f"{kind} {name} chain {i} {f}: {m}")
        torch.testing.assert_close(c_mix.w[i], c_i.w[i], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["functional", "covariates",
                                  "multivariate"])
def test_sigma_shape_and_rate_per_chain(kind):
    """sigma^2 | rest at a mixed beta: each chain's inverse-Gamma shape and
    rate are those of its float, exactly; the draw by moments against the
    inverse-Gamma's per chain group."""
    data, st, _ = _model(kind)
    v = torch.tensor(MIXED)
    a_mix, b_mix = tg.sigma_shape_rate(st, data, TPriors(),
                                       tcache(data, st), v)
    for i, b in enumerate(MIXED):
        a_i, b_i = tg.sigma_shape_rate(st, data, TPriors(),
                                       tcache(data, st), b)
        assert a_mix[i] == a_i[i] and b_mix[i] == b_i[i], (kind, i)
    # 4000 draws of each chain: the inverse-Gamma's mean and variance
    n = 4000
    big = take_chains(st, torch.arange(4).repeat_interleave(n))
    out = tg.update_sigma(torch.Generator().manual_seed(3), big, data,
                          TPriors(), tcache(data, big),
                          v.repeat_interleave(n)).sigma2.double()
    for i in range(4):
        a, b = float(a_mix[i]), float(b_mix[i])
        x = out[i * n:(i + 1) * n]
        mean, var = b / (a - 1), b * b / ((a - 1) ** 2 * (a - 2))
        se_mean = math.sqrt(var / n)
        assert abs(x.mean().item() - mean) < 5 * se_mean, (kind, i)
        assert abs(x.var().item() / var - 1) < 5 * math.sqrt(2.0 / n) + 0.02


# the tempered updaters at beta = BETAS[g] for the g-th group of N_GROUP
# chains, against the JAX package vmapped over N_GROUP keys at each beta
BETAS = (0.3, 0.8)
N_GROUP = 2000
_MOMENTS = {
    "z": ("Z", lambda k, s, d, b: jg.update_z(k, s, d, Priors(),
                                              jcache(d, s), b)[0],
          _TEMPERED["z"]),
    "nu": ("nu", lambda k, s, d, b: jg.update_nu(k, s, d, Priors(),
                                                 jcache(d, s), b)[0],
           _TEMPERED["nu"]),
    "phi": ("Phi", lambda k, s, d, b: jg.update_phi(k, s, d, Priors(),
                                                    jcache(d, s), b)[0],
            _TEMPERED["phi"]),
    "chi": ("chi", lambda k, s, d, b: jg.update_chi(k, s, d, Priors(),
                                                    jcache(d, s), b)[0],
            _TEMPERED["chi"]),
    "sigma": ("sigma2", lambda k, s, d, b: jg.update_sigma(
        k, s, d, Priors(), jcache(d, s), b),
        lambda g, s, d, beta: (tg.update_sigma(
            g, s, d, TPriors(), tcache(d, s), beta), None)),
    "z_chi": ("Z", lambda k, s, d, b: jg.update_z_chi(
        k, s, d, Priors(), jcache(d, s), b, p_indep=0.3)[0],
        _TEMPERED["z_chi"]),
    "noise_scale": ("sigma2", lambda k, s, d, b: jg.update_noise_scale(
        k, s, d, Priors(), jcache(d, s), b)[0], _TEMPERED["noise_scale"]),
}


@pytest.fixture(scope="module")
def moment_case():
    """test_torch_gibbs.py's small model at a perturbed truth."""
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
    C = N_GROUP * len(BETAS)
    return jdata, js, convert.data_from_jax(jdata, device="cpu"), \
        convert.state_from_numpy(jax.tree.map(np.asarray, js), chains=C,
                                 device="cpu")


@pytest.mark.parametrize("name", list(_MOMENTS))
def test_mixed_beta_moments_match_jax_at_each_beta(moment_case, name):
    jdata, js, tdata, ts = moment_case
    field, jfn, tfn = _MOMENTS[name]
    beta = torch.tensor(BETAS).repeat_interleave(N_GROUP)
    tout = getattr(tfn(torch.Generator().manual_seed(21), ts, tdata,
                       beta)[0], field).numpy()
    for i, b in enumerate(BETAS):
        keys = jax.random.split(jax.random.PRNGKey(21 + i), N_GROUP)
        jout = np.asarray(jax.jit(jax.vmap(
            lambda k: getattr(jfn(k, js, jdata, b), field)))(keys))
        part = tout[i * N_GROUP:(i + 1) * N_GROUP]
        assert np.all(np.isfinite(part)) and part.shape == jout.shape
        _moments_agree(jout, part, f"{name} at beta {b}")


# ---------------------------------------------------------------------------
# The pieces of PT on identical inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,b", [(5, 0.2), (8, 0.3), (2, 0.01), (64, 0.3),
                                 (17, 0.37), (1, 0.3)])
def test_geometric_ladder_matches_jax(n, b):
    np.testing.assert_array_equal(tt.geometric_ladder(n, b).numpy(),
                                  np.asarray(jt.geometric_ladder(n, b)))


@pytest.mark.parametrize("sd,beta_min,kw", [
    (5.0, 0.3, dict(target_accept=0.4)),
    (70.0, 0.3, dict(max_replicas=64)),
    (1000.0, 0.3, dict(max_replicas=64)),
    (23.7, 0.5, dict(target_accept=0.25, max_replicas=8)),
    (0.0, 0.3, {})])
def test_auto_ladder_matches_jax(sd, beta_min, kw):
    """The three cases of test_auto_ladder_sizing and two more: the same
    rung count and feasibility, the rungs to f32 rounding (torch.linspace
    and the JAX package's jnp.linspace round differently by an ulp or
    two)."""
    lt, ok_t = tt.auto_ladder(sd, beta_min, **kw)
    lj, ok_j = jt.auto_ladder(sd, beta_min, **kw)
    assert ok_t == ok_j and lt.shape == lj.shape and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=2.4e-7)
    assert lt[0] == 1.0
    if ok_t:
        assert lt[-1] == np.float32(beta_min)


def test_auto_ladder_sizing():
    """Port of test_samplers_advanced.py::test_auto_ladder_sizing."""
    lad, ok = tt.auto_ladder(5.0, 0.3, target_accept=0.4)
    assert ok and float(lad[0]) == 1.0
    np.testing.assert_allclose(float(lad[-1]), 0.3, atol=1e-6)
    assert lad.shape[0] <= 6
    db = float(lad[0] - lad[1])
    assert 0.15 < db * 5.0 < 0.75
    lad2, ok2 = tt.auto_ladder(70.0, 0.3, max_replicas=64)
    assert ok2 and 40 <= lad2.shape[0] <= 64
    lad3, ok3 = tt.auto_ladder(1000.0, 0.3, max_replicas=64)
    assert not ok3
    assert lad3.shape[0] == 64
    assert float(lad3[-1]) > 0.3
    assert np.all(np.diff(lad3.numpy()) < 0)


def test_auto_ladder_refuses_what_the_jax_package_lets_through():
    """ROADMAP F4, not copied: a ladder to beta_min = 1 (one rung) and a
    non-finite energy sd raise, naming the cause; so does fit_pt."""
    with pytest.raises(ValueError, match="one rung"):
        tt.auto_ladder(5.0, 1.0)
    for sd in (float("nan"), float("inf")):
        with pytest.raises(ValueError, match="not finite"):
            tt.auto_ladder(sd, 0.3)
    # the JAX package's: one rung at beta_min = 1
    assert np.asarray(jt.auto_ladder(5.0, 1.0)[0]).shape == (1,)


@pytest.fixture(scope="module")
def pt_case():
    """R replicas near one state, sigma2 falling by 2 % from the cold
    replica to the hottest (so that some swaps are accepted and some
    refused), in both packages."""
    jdata, _ = simulate_functional(seed=3, N=10, K=3, P=5, M=3,
                                   n_time=(12, 16))
    d = _random_states(4, 1, 10, 3, 5, 3, 0)
    R = 7
    d = {f: np.repeat(v, R, 0) for f, v in d.items()}
    d["sigma2"] = d["sigma2"] * np.linspace(1.01, 0.99, R).astype(np.float32)
    return jdata, convert.data_from_jax(jdata, device="cpu"), d, \
        convert.state_from_numpy(d, chains=R, device="cpu")


def test_loglik_portion_matches_jax(pt_case):
    jdata, tdata, d, ts = pt_case
    jE = jax.vmap(lambda s: jt._loglik_portion(s, jdata))(
        JState(**{f: jnp.asarray(d[f]) for f in STATE_FIELDS}))
    np.testing.assert_allclose(tt._loglik_portion(ts, tdata).numpy(),
                               np.asarray(jE), rtol=2e-6)


@pytest.mark.parametrize("R", [7, 6, 2])
@pytest.mark.parametrize("parity", [0, 1])
def test_swap_phase_matches_jax_pt_step(pt_case, R, parity, monkeypatch):
    """JAX's pt_step with no sweeps is a pure swap phase: fed the same
    energies, ladder, parity and the JAX package's own uniforms, the port's
    permutation carries the same states to the same replicas, and the
    counters agree.  (The sweep, which a scan of length 0 would still
    trace, is replaced by the identity.)"""
    monkeypatch.setattr(jg, "sweep_full", lambda k, s, *a, **kw: s)
    jdata, tdata, d, ts = pt_case
    d = {f: v[:R] for f, v in d.items()}
    ts = take_chains(ts, torch.arange(R))
    js = JState(**{f: jnp.asarray(d[f]) for f in STATE_FIELDS})
    ladder = jt.geometric_ladder(R, 0.2)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jpt = jt.pt_step(key, jt.pt_init(js), jdata, Priors(), None, ladder,
                         parity=parity, n_sweeps_between=0)
        u = jax.random.uniform(jax.random.split(key)[1], (R,))
        E = jax.vmap(lambda s: jt._loglik_portion(s, jdata))(js)
        perm, acc, att = tt.swap_phase(
            torch.tensor(np.asarray(E)), torch.tensor(np.asarray(ladder)),
            parity, torch.tensor(np.asarray(u)))
        moved = take_chains(ts, perm)
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(moved, f).numpy(),
                                          np.asarray(getattr(jpt.states, f)))
        assert float(acc) == float(jpt.swap_accepts)
        assert float(att) == float(jpt.swap_attempts)


def test_swaps_are_both_taken_and_refused(pt_case):
    """The case above exercises both outcomes."""
    jdata, tdata, d, ts = pt_case
    ladder = tt.geometric_ladder(7, 0.2)
    E = tt._loglik_portion(ts, tdata)
    g = torch.Generator().manual_seed(0)
    acc = []
    for i in range(40):
        u = torch.rand(7, generator=g)
        perm, a, _ = tt.swap_phase(E, ladder, i % 2, u)
        acc.append(float(a))
    assert 0 < sum(acc) < 3 * 20 + 2 * 20


def test_take_chains_clamps_past_the_last_chain():
    data, st, _ = _model("functional")
    out = take_chains(st, torch.tensor([3, 4, 7, 0]))
    _same_bits(out, take_chains(st, torch.tensor([3, 3, 3, 0])), "clamped")


# ---------------------------------------------------------------------------
# PT as a whole
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The small protocol's data and its JAX phase-1/2 medians from the
    reference file, as a start in both packages."""
    ref = json.loads(REFERENCE.read_text())["small"]
    p = ref["protocol"]["data"]
    jdata, _ = simulate_functional(seed=p["seed"], N=p["N"], K=p["K"],
                                   P=p["P"], M=p["M"],
                                   n_time=tuple(p["n_time"]))
    tdata = convert.data_from_jax(jdata, device="cpu")
    tstart = convert.fit_result_from_estimates(
        ref["warm_start_from"], tdata, TConfig(K=p["K"], P=p["P"], M=p["M"]))
    return ref, jdata, tdata, tstart


def test_parallel_tempering_runs_and_swaps(small):
    """Port of test_samplers_advanced.py's test of the same name."""
    _, _, data, _ = small
    g = torch.Generator().manual_seed(0)
    states = init_state(g, TConfig(K=2, P=5, M=2), data, chains=4)
    cold, pt, rate = tt.run_parallel_tempering(
        g, states, data, TPriors(), torch.full((2,), 10.0), n_rounds=30,
        beta_min=0.4)
    assert torch.isfinite(cold.sigma2).all() and cold.sigma2.shape == (30,)
    r = float(rate)
    assert 0.0 <= r <= 1.0
    assert r > 0.05, f"swap rate {r}"
    np.testing.assert_allclose(cold.Z.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(pt.swap_attempts) == 30 * 1.5      # 2 and 1 pairs a round


def test_fit_pt_auto_ladder_and_swap_warning(small):
    """Port of test_samplers_advanced.py's test of the same name (phases 1
    and 2 of the port itself)."""
    _, _, data, _ = small
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, seed=0)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, seed=1)
    res = api.fit_pt(r1, r2, tot_mcmc_iters=150, beta_min=0.5,
                     ladder="auto", pilot_sweeps=60, max_replicas=8, seed=3)
    assert res.ladder is not None and res.ladder.shape[0] >= 2
    assert res.swap_rate > 0.0, res.swap_rate
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        api.fit_pt(r1, r2, tot_mcmc_iters=100, n_replicas=2,
                   beta_min=0.01, ladder="geometric", seed=4)
    assert any("swap rate" in str(x.message) for x in w)
    # F4: beta_min = 1 with the auto ladder, and a pilot too short for an
    # sd, raise instead of running one rung or a NaN ladder
    with pytest.raises(ValueError, match="one rung"):
        api.fit_pt(r1, r2, tot_mcmc_iters=100, beta_min=1.0)
    with pytest.raises(ValueError, match="not finite"):
        api.fit_pt(r1, r2, tot_mcmc_iters=100, pilot_sweeps=2)


def test_fit_pt_layout_and_statistics_match_jax(small, tmp_path):
    """fit_pt of both packages from the same phase-1/2 medians: the same
    layout through convert; the port's ladder length, swap rate and the
    cold chain's median loglik over the last half inside the JAX package's
    limits (six JAX seeds); the exported directory reads back."""
    ref, jdata, tdata, tstart = small
    p = ref["protocol"]["pt"]
    res = api.fit_pt(tstart, tstart, seed=3, directory=str(tmp_path), **p)
    jstart = japi.FitResult(
        {f: np.asarray(v)[None] for f, v in
         tstart.estimates(_warn=False).items()}, np.zeros(1), None)
    jstart.data, jstart.config = jdata, tstart.config
    # the JAX package's run with its sweep replaced by the identity: only
    # its layout is compared here (its statistics are the reference
    # file's), and a real sweep would take a minute to compile
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "sweep_full", lambda k, s, *a, **kw: s)
        jres = japi.fit_pt(jstart, jstart, seed=3, **dict(
            p, tot_mcmc_iters=100, pilot_sweeps=6))
    a, b = convert.fit_result_to_numpy(res), convert.fit_result_to_numpy(jres)
    assert sorted(a) == sorted(b) == ["estimates", "ladder", "loglik",
                                      "swap_rate", "traces"]
    assert sorted(a["traces"]) == sorted(b["traces"]) == sorted(STATE_FIELDS)
    n = p["tot_mcmc_iters"]
    for f in STATE_FIELDS:
        assert a["traces"][f].shape == (n,) + b["traces"][f].shape[1:], f
        assert a["traces"][f].dtype == b["traces"][f].dtype, f
        assert np.all(np.isfinite(a["traces"][f])), f
    assert a["loglik"].shape == (n,) and b["loglik"].shape == (100,)
    assert a["ladder"].dtype == b["ladder"].dtype == np.float32
    assert res.final_state.Z.shape == (1, tdata.N, 2)
    torch.testing.assert_close(res.final_state.sigma2,
                               torch.tensor(a["traces"]["sigma2"][-1:]))
    lim = ref["pt"]
    ll = float(np.median(a["loglik"][n // 2:]))
    L = len(a["ladder"])
    assert lim["ladder_length"]["limits"][0] <= L \
        <= lim["ladder_length"]["limits"][1]
    assert lim["loglik_median"]["limits"][0] <= ll \
        <= lim["loglik_median"]["limits"][1], (ll, lim["loglik_median"])
    assert 0.0 < a["swap_rate"] <= 1.0
    assert lim["swap_rate"]["limits"][0] <= a["swap_rate"] \
        <= lim["swap_rate"]["limits"][1]
    from bayesfmmm_torch.io import armaio
    disk = armaio.load_trace_dir(str(tmp_path))
    np.testing.assert_array_equal(disk["Sigma"],
                                  a["traces"]["sigma2"].astype(np.float64))


def test_fit_pt_follows_its_data():
    """fit_pt takes its device from the phase results' data: on the CPU
    here, with no device argument."""
    data, _ = tsim.simulate_functional(seed=5, N=8, K=2, P=5, M=2,
                                       n_time=(10, 12), device="cpu")
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100)
    res = api.fit_pt(r1, r2, tot_mcmc_iters=100, ladder="geometric",
                     n_replicas=3, kernels="production")
    assert res.final_state.Z.device.type == "cpu" and res.ladder is None
    assert res.traces["Z"].shape == (100, 8, 2)
