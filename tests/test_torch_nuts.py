"""The port's iterative NUTS against the JAX package's, on the CPU.

The U-turn test on given vectors, and one subtree built from the same
start by both packages: what no random draw decides and the tree merges
(the U-turn and divergence flags, acceptance sum and leaf count; the
endpoints, momentum sum and weight of a subtree that ran to its end) agrees
chain by chain, so the checkpoint stack finds the same U-turns.  One whole
NUTS transition on the model's log-joint, with the momenta, directions and
uniforms of both packages scripted to the same numbers, gives the same
proposal and statistics.  Then ports
of tests/test_nuts.py, the evaluations a run makes against its own tree
depths, and ``fit_hmc(method="nuts")`` on the small protocol inside the JAX
limits of tests/data/torch_hmc_reference.json.
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

from bayesfmmm_tpu.samplers import nuts as jnuts  # noqa: E402
from bayesfmmm_torch import api  # noqa: E402
from bayesfmmm_torch.samplers import hmc, nuts  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

from bayesfmmm_torch.config import Priors  # noqa: E402
from bayesfmmm_torch.models import logjoint  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_tpu.models import logjoint as jlj  # noqa: E402

from test_torch_hmc import (HP, _point, _ravel,  # noqa: E402
                            check_small_statistics)


def test_is_turning_matches_jax():
    rng = np.random.default_rng(0)
    inv_mass, p1, p2, rho = rng.normal(size=(4, 6, 5))
    inv_mass = np.abs(inv_mass)
    got = nuts._is_turning(*(torch.tensor(a) for a in (inv_mass, p1, p2,
                                                       rho)))
    want = [bool(jnuts._is_turning(*(jnp.asarray(a[i]) for a in (
        inv_mass, p1, p2, rho)))) for i in range(6)]
    assert got.tolist() == want
    assert 0 < sum(want) < 6


def _gaussian(dim=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(dim, dim))
    prec = A @ A.T + 0.5 * np.eye(dim)
    mu = rng.normal(size=dim)
    return prec.astype(np.float32), mu.astype(np.float32)


@pytest.mark.parametrize("depth", [0, 3, 5])
def test_subtree_matches_jax_where_no_draw_decides(depth):
    """A subtree of 2^depth leaves from the same start, chain by chain:
    both packages reach the same U-turn and divergence flags, acceptance
    sum and leaf count, and where the subtree ran to its end the same
    endpoints, momentum sum and log weight (the multinomial proposal is the
    only random part).  The step sizes make
    some chains turn early and one diverge; one chain is not live and takes
    no leaf."""
    prec, mu = _gaussian()
    C, dim, max_depth = 6, 3, 6
    rng = np.random.default_rng(depth)
    q0, p0 = rng.normal(size=(2, C, dim)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, size=(C, dim)).astype(np.float32)
    eps = np.array([0.05, -0.2, 0.4, 0.9, -1.5, 0.3], np.float32)
    live = np.array([True, True, True, True, True, False])

    def tlj(q):
        d = q - torch.tensor(mu)
        return -0.5 * (d @ torch.tensor(prec) * d).sum(-1)

    def jlj(q):
        d = q - mu
        return -0.5 * d @ prec @ d

    vg = jax.value_and_grad(jlj)
    logp0, grad0 = hmc.value_and_grad(tlj, torch.tensor(q0))
    energy0 = -logp0 + 0.5 * (torch.tensor(inv_mass)
                              * torch.tensor(p0) ** 2).sum(1)
    sub = nuts._build_subtree(
        torch.Generator().manual_seed(0),
        lambda q: hmc.value_and_grad(tlj, q), torch.tensor(q0),
        torch.tensor(p0), grad0, torch.tensor(eps), depth,
        torch.tensor(inv_mass), energy0, max_depth, torch.tensor(live))
    fields = ("q_left", "p_left", "grad_left", "q_right", "p_right",
              "grad_right", "log_weight", "p_sum", "sum_accept")
    turned = 0
    for c in range(C):
        got = {f: getattr(sub, f)[c] for f in sub._fields}
        if not live[c]:
            assert got["n_leaves"] == 0 and got["sum_accept"] == 0
            assert not got["turning"] and not got["diverging"]
            assert got["logp_prop"] == -np.inf    # no leaf proposed
            continue
        want = jnuts._build_subtree(
            jax.random.PRNGKey(c), vg, jnp.asarray(q0[c]),
            jnp.asarray(p0[c]), vg(jnp.asarray(q0[c]))[1],
            jnp.float32(eps[c]), depth, jnp.asarray(inv_mass[c]),
            jnp.float32(float(energy0[c])), max_depth)
        for f in ("turning", "diverging", "n_leaves"):
            assert int(got[f]) == int(getattr(want, f)), (c, f)
        ended = bool(want.turning) or bool(want.diverging)
        # a subtree that ended early is merged by nothing but its flags,
        # acceptance sum and leaf count, and the port keeps no more of it
        for f in ("sum_accept",) if ended else fields:
            np.testing.assert_allclose(got[f].numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"chain {c} {f}")
        turned += ended
    if depth >= 3:
        assert 0 < turned < 5        # both early ends and full subtrees


# a scripted jax.random key: (chain, doubling, role, leaf)
_MOM, _LOOP, _DIR, _SUB, _ACC, _LEAF, _SPARE = range(7)


def _script_jax_random(monkeypatch, z, right, u_leaf, u_acc):
    """jax.random's split, normal, bernoulli and uniform as look-ups in
    the given tables, for the JAX package's ``nuts_kernel`` step: a key is
    (chain, doubling, role, leaf), split as the step splits its keys (into
    3 at the start, into 4 a doubling, into 2 a leaf)."""
    z, right, u_leaf, u_acc = map(jnp.asarray, (z, right, u_leaf, u_acc))

    def key(*parts):
        return jnp.stack([jnp.asarray(x, jnp.int32) for x in parts])

    def split(k, num=2):
        c, d, i = k[0], k[1], k[3]
        if num == 3:            # the step: momentum, unused, the loop's
            return jnp.stack([key(c, 0, _MOM, 0), key(c, 0, _SPARE, 0),
                              key(c, 0, _LOOP, 0)])
        if num == 4:            # a doubling: next, direction, subtree, take
            return jnp.stack([key(c, d + 1, _LOOP, 0), key(c, d, _DIR, 0),
                              key(c, d, _SUB, 0), key(c, d, _ACC, 0)])
        return jnp.stack([key(c, d, _SUB, i + 1), key(c, d, _LEAF, i)])

    def normal(k, shape=(), dtype=float):
        return z[k[0]].astype(dtype)

    def bernoulli(k, p=0.5, shape=None):
        return right[k[0], k[1]]

    def uniform(k, shape=(), dtype=float, minval=0.0, maxval=1.0):
        return jnp.where(k[2] == _LEAF, u_leaf[k[0], k[1], k[3]],
                         u_acc[k[0], k[1]])

    for name, fn in (("split", split), ("normal", normal),
                     ("bernoulli", bernoulli), ("uniform", uniform)):
        monkeypatch.setattr(jax.random, name, fn)
    return key


def _script_torch_random(monkeypatch, z, right, u_leaf, u_acc):
    """The port's draws in ``nuts_kernel``'s step from the same tables: the
    momentum's normals, then a doubling's direction (a uniform below 0.5
    goes right), its leaves' uniforms (2^d, C) and its take's uniform."""
    calls = []

    def uniform(generator, like):
        d, take = divmod(len(calls), 2)
        calls.append(d)
        if take:
            return torch.tensor(u_acc[:, d])
        return torch.tensor(np.where(right[:, d], 0.25, 0.75))

    def rand(shape, **kw):
        d = int(shape[0]).bit_length() - 1
        return torch.tensor(u_leaf[:, d, :shape[0]].T.copy())

    monkeypatch.setattr(nuts, "_uniform", uniform)
    monkeypatch.setattr(torch, "rand", rand)
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.tensor(z))


@pytest.mark.parametrize("seed,eps", [
    (0, (0.001, 0.012, 0.03)), (1, (0.001, 0.012, 0.03)),
    (2, (0.012, 0.04, 0.5))])
def test_nuts_step_matches_jax_on_scripted_draws(monkeypatch, seed, eps):
    """One whole NUTS transition of three chains on the functional model's
    log-joint in float64, from the same point, step sizes and inverse
    masses, with the draws of both packages scripted to the same numbers:
    the momenta, each doubling's direction and take uniform, each leaf's
    multinomial uniform.  The port's batch gives each chain JAX's proposal
    (q, logp, grad) to float64 rounding (1e-9) and the same depth, leaf
    count, divergence flag and acceptance statistic.  The step sizes give
    trees that reach the maximum depth, trees that turn at depths 2-4, and
    trees that diverge."""
    max_depth = 5
    with jax.enable_x64(True):
        jdata, uncs, tdata, K = _point("functional", "float64")
        C, dim = uncs.nu.shape[0], _ravel(uncs, 0).shape[0]
        rng = np.random.default_rng(seed)
        z = rng.normal(size=(C, dim))
        right = rng.random((C, max_depth)) < 0.5
        u_leaf = rng.random((C, max_depth, 1 << (max_depth - 1)))
        u_acc = rng.random((C, max_depth))
        inv_mass = rng.uniform(0.5, 1.5, size=(C, dim))
        key = _script_jax_random(monkeypatch, z, right, u_leaf, u_acc)
        jl = jlj.make_log_joint(jdata, HP, jnp.full((K,), 10.0))
        unravel = ravel_pytree(jax.tree.map(lambda x: x[0], uncs))[1]

        def jflat(q):
            return jl(unravel(q))

        jstep = jax.jit(jnuts.nuts_kernel(jflat, max_depth=max_depth))
        want = []
        for c in range(C):
            q = jnp.asarray(_ravel(uncs, c))
            want.append(jstep(key(c, 0, _SPARE, 0),
                              (q,) + jax.value_and_grad(jflat)(q),
                              jnp.float64(eps[c]), jnp.asarray(inv_mass[c])))
    tu = convert.unc_from_jax(uncs, device="cpu", dtype=torch.float64)
    lj = logjoint.make_log_joint(tdata, Priors(), torch.full(
        (K,), 10.0, dtype=torch.float64))

    def tflat(q):
        return lj(logjoint.unflatten(q, tu))

    q0 = logjoint.flatten(tu)
    state = (q0,) + hmc.value_and_grad(tflat, q0)
    _script_torch_random(monkeypatch, z, right, u_leaf, u_acc)
    (q, logp, grad), info = nuts.nuts_kernel(tflat, max_depth=max_depth)(
        None, state, torch.tensor(eps, dtype=torch.float64),
        torch.tensor(inv_mass))
    for c, ((jq, jlogp, jgrad), jinfo) in enumerate(want):
        for got, exp in ((q, jq), (logp, jlogp), (grad, jgrad),
                         (info["accept_p"], jinfo["accept_p"])):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(exp),
                                       rtol=1e-9, atol=1e-9,
                                       err_msg=f"chain {c}")
        for f in ("depth", "n_leaves", "diverging"):
            assert int(info[f][c]) == int(jinfo[f]), (c, f)
    assert not torch.equal(q, q0)
    if eps[0] < 0.01:           # a tree at full depth and one that turned
        depth = info["depth"].tolist()
        assert max(depth) == max_depth and min(depth) < max_depth
    else:
        assert bool(info["diverging"].any())


def test_nuts_evaluations_follow_the_tree_depths():
    """One evaluation to start, then 2^D - 1 an iteration for D the
    deepest tree of the batch: no step runs past the doublings the trees
    needed, and every doubling runs all its leaves."""
    prec, mu = _gaussian(seed=1)
    calls = []

    def lj(q):
        calls.append(1)
        d = q - torch.tensor(mu)
        return -0.5 * (d @ torch.tensor(prec) * d).sum(-1)

    q0 = torch.randn(4, 3, generator=torch.Generator().manual_seed(2))
    _, diag = nuts.run_nuts(torch.Generator().manual_seed(3), lj, q0,
                            n_warmup=12, n_samples=8, max_depth=5)
    depth = diag["depth"]
    assert depth.shape == (4, 20) and depth.min() >= 1 and depth.max() <= 5
    assert len(calls) == 1 + int((2 ** depth.max(0).values - 1).sum())
    assert diag["n_divergent"].shape == (4,)
    torch.testing.assert_close(diag["mean_depth"],
                               depth[:, 12:].float().mean(1))


def test_nuts_gaussian_recovery():
    """Correlated 3-D Gaussian: posterior mean/cov within MC error."""
    A = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.3], [0.0, -0.3, 0.5]])
    cov = A @ A.T
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
    mu = torch.tensor([1.0, -2.0, 0.5])

    def lj(q):
        d = q - mu
        return -0.5 * (d @ prec * d).sum(-1)

    init = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    tr, diag = nuts.run_nuts(torch.Generator().manual_seed(1), lj, init,
                             n_warmup=400, n_samples=500, max_depth=8)
    qs = tr.reshape(-1, 3).numpy()
    assert int(diag["n_divergent"].sum()) == 0
    np.testing.assert_allclose(qs.mean(0), mu.numpy(), atol=0.25)
    np.testing.assert_allclose(np.cov(qs.T), cov, atol=0.6, rtol=0.25)
    # adaptive trajectories actually engaged (depth > 0 on average)
    assert float(diag["mean_depth"].mean()) > 0.5


@pytest.mark.slow
def test_nuts_adapts_trajectory_to_scale():
    """Wider targets need longer trajectories: NUTS depth responds to the
    condition number where fixed-length HMC cannot.  Slow: ~200,000
    leapfrog steps (the early warmup's trees reach depth 10), ~35 s on the
    CPU."""
    scales = torch.tensor([100.0, 1.0, 0.01])

    def lj(q):
        return -0.5 * ((q / scales) ** 2).sum(-1)

    init = torch.randn(2, 3, generator=torch.Generator().manual_seed(2))
    tr, _ = nuts.run_nuts(torch.Generator().manual_seed(3), lj, init,
                          n_warmup=500, n_samples=300, max_depth=10)
    sd = tr.reshape(-1, 3).std(0).numpy()
    # diagonal mass adaptation + U-turn lengths recover all three scales
    assert 40.0 < sd[0] < 250.0
    assert 0.4 < sd[1] < 2.5
    assert 0.004 < sd[2] < 0.025


def test_fit_nuts_api():
    """fit_hmc(method='nuts') through the user API on a small functional
    model, drop-in compatible with post-processing."""
    data, _ = simulate_functional(seed=93, N=16, K=2, P=5, M=2,
                                  n_time=(15, 20), device="cpu")
    res = api.fit_hmc(data, K=2, M=2, n_warmup=120, n_samples=80,
                      n_chains=2, method="nuts", max_depth=6, device="cpu")
    assert (res.hmc_diagnostics["accept_mean"] > 0.4).all()
    np.testing.assert_allclose(res.traces["Z"].sum(-1), 1.0, atol=1e-5)
    assert np.isfinite(res.traces["sigma2"]).all()
    assert sorted(res.hmc_diagnostics) == [
        "accept_mean", "depth", "eps", "mean_depth", "n_divergent",
        "warm_accept"]


def test_fit_nuts_small_statistics_inside_jax_limits():
    res = check_small_statistics("nuts", seed=11)
    assert res.hmc_diagnostics["depth"].shape == (4, 200)
