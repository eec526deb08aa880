"""The default-off Gibbs kernels of ``sweep_full`` against the JAX package's,
on the CPU: the Phi column moves (``update_phi_chi``), the anchor-guided
stage of the collapsed (Z, chi) block (``update_z_chi(anchor_prop=True)``)
and whole-model HMC inside the sweep (``update_hmc_joint``).

Each kernel runs once in both packages in float64 from the same states, with
every random draw of both scripted to the same numbers (the pattern of
tests/test_torch_nuts.py): the JAX package's keys become look-ups into
tables, the port's draws are patched to read the same tables.  The port
batches the chains, JAX runs one at a time.  The states, the running
coefficients and every MH log-acceptance equal JAX's to 1e-9; so do the
corner marginals of the anchor stage.  Then: in a batch of chains of
different trajectory lengths each chain takes its own trajectory; a rejected HMC
chain keeps its original bits; xi stays 0 without ``covariate_cov`` (ROADMAP
F14); the (C,) beta rules of ROADMAP "Decisions taken" for each new updater;
a port of tests/test_collapsed_gauge.py::test_phi_chi_marginal_moves_and_
preserves_fit; and a short sweep with every flag on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models.state import GibbsState as JState  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional as jsim  # noqa: E402
from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models import logjoint  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import (STATE_FIELDS,  # noqa: E402
                                          GibbsState, init_state)
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

from test_torch_tempering import (B_EQUAL, MIXED, _model,  # noqa: E402
                                  _random_states, _same_bits)

HP = Priors()
TOL = dict(rtol=1e-9, atol=1e-9)


def _setup(C, K=3, D=0, seed=4):
    """float64 JAX data and one JAX state a chain, and the port's data and
    the C-chain state holding the same numbers."""
    with jax.enable_x64(True):
        jdata, _ = jsim(seed=seed, N=10, K=K, P=5, M=2, D=D, with_eta=D > 0,
                        with_xi=D > 0, n_time=(12, 15), dtype=jnp.float64)
        st = {f: np.asarray(v, np.float64) for f, v in _random_states(
            seed, C, 10, K, 5, 2, D).items()}
        jstates = [JState(**{f: jnp.asarray(st[f][c]) for f in STATE_FIELDS})
                   for c in range(C)]
    tdata = convert.data_from_jax(jdata, device="cpu", dtype=torch.float64)
    return jdata, jstates, tdata, convert.state_from_numpy(
        st, chains=C, device="cpu", dtype=torch.float64)


def _check_state(got, want, c, what):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(got, f)[c].numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f"{what} chain {c}: {f}", **TOL)


def _spy_port_accept(monkeypatch):
    """Record every log-acceptance the port's MH decisions read."""
    seen, accept = [], tg._mh_accept

    def spy(log_acc, u):
        seen.append(log_acc.clone())
        return accept(log_acc, u)

    monkeypatch.setattr(tg, "_mh_accept", spy)
    return seen


def _queue(monkeypatch, module, name, values):
    """``module.name`` returns the next of ``values`` at each call."""
    it = iter(values)
    monkeypatch.setattr(module, name, lambda *a, **kw: next(it))


# ---------------------------------------------------------------------------
# update_hmc_joint
# ---------------------------------------------------------------------------

def _hmc_draws(seed, C, dim, lengths, u):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, dim)), np.asarray(lengths),
            np.asarray(u, np.float64), rng.uniform(0.5, 1.5, dim))


def _jax_hmc(monkeypatch, jdata, jstate, draws, c_idx, eps, n_leapfrog):
    """The JAX package's update_hmc_joint for one chain on the scripted
    draws; returns (state, log-acceptance)."""
    z, n, u, inv_mass = draws
    seen = []
    with monkeypatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax.random, "split", lambda k, num=2: jnp.zeros(
            (num, 2), jnp.uint32))
        mp.setattr(jax.random, "normal",
                   lambda k, shape=(), dtype=float: jnp.asarray(z[c_idx]))
        mp.setattr(jax.random, "randint",
                   lambda k, shape, minval, maxval: jnp.asarray(n[c_idx]))
        mp.setattr(jax.random, "uniform",
                   lambda k, shape=(), dtype=float: jnp.asarray(u[c_idx]))
        nan_to_num = jnp.nan_to_num

        def spy(x, **kw):
            seen.append(float(x))
            return nan_to_num(x, **kw)

        mp.setattr(jnp, "nan_to_num", spy)
        out = jg.update_hmc_joint(
            jnp.zeros(2, jnp.uint32), jstate, jdata, HP,
            jnp.full((jstate.Z.shape[1],), 10.0), eps=eps,
            n_leapfrog=n_leapfrog, inv_mass=jnp.asarray(inv_mass))
    return out, seen[-1]


def _port_hmc(monkeypatch, tdata, st, draws, eps, n_leapfrog, rows=None,
              **kw):
    z, n, u, inv_mass = draws
    rows = slice(None) if rows is None else rows
    seen = _spy_port_accept(monkeypatch)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda *a, **k: torch.tensor(z[rows]))
        mp.setattr(torch, "randint", lambda *a, **k: torch.tensor(n[rows]))
        mp.setattr(tg, "_uniform", lambda *a, **k: torch.tensor(u[rows]))
        out = tg.update_hmc_joint(
            None, st, tdata, TPriors(), torch.full((st.K,), 10.0,
                                                   dtype=torch.float64),
            eps=eps, n_leapfrog=n_leapfrog, inv_mass=torch.tensor(inv_mass),
            **kw)
    return out, seen[-1]


def test_hmc_joint_matches_jax_on_scripted_draws(monkeypatch):
    """One trajectory of each of three chains of lengths 1, 3 and 5 (of up
    to 5), with the momenta, lengths and uniforms scripted to the same
    numbers: the port's batch gives each chain JAX's state and
    log-acceptance to 1e-9, hence its decision (from these random states
    u = 0.5 takes every trajectory at eps 0.01 and refuses every one at
    0.08)."""
    C = 3
    jdata, jstates, tdata, st = _setup(C, K=2)
    dim = logjoint.flatten(logjoint.from_state(st), False).shape[1]
    draws = _hmc_draws(0, C, dim, [1, 3, 5], [0.5] * C)
    for eps in (0.01, 0.08):
        got, log_acc = _port_hmc(monkeypatch, tdata, st, draws, eps, 5)
        for c in range(C):
            want, jlog_acc = _jax_hmc(monkeypatch, jdata, jstates[c], draws,
                                      c, eps, 5)
            np.testing.assert_allclose(log_acc[c].item(), jlog_acc,
                                       err_msg=f"eps {eps} chain {c}", **TOL)
            _check_state(got, want, c, f"eps {eps}")
        took = torch.log(torch.tensor(0.5)) < log_acc
        assert bool(took.all()) if eps < 0.05 else not took.any(), log_acc


def test_hmc_joint_batch_gives_each_chain_its_own_trajectory(monkeypatch):
    """A batch of chains of different lengths (masked steps) gives each
    chain the bits it gets in a batch of the same size where every chain
    runs its length (so a frozen chain is not moved by the steps it does
    not take), and its numbers alone (to 1e-12: a batch of one sums in
    another order)."""
    C = 3
    lengths = [4, 1, 2]
    _, _, tdata, st = _setup(C, K=2)
    dim = logjoint.flatten(logjoint.from_state(st), False).shape[1]
    draws = _hmc_draws(1, C, dim, lengths, [1e-3] * C)
    batch, _ = _port_hmc(monkeypatch, tdata, st, draws, 0.02, 4)
    for c in range(C):
        same = (draws[0], np.full(C, lengths[c]), *draws[2:])
        even, _ = _port_hmc(monkeypatch, tdata, st, same, 0.02, 4)
        one = GibbsState(**{f: getattr(st, f)[c:c + 1]
                            for f in STATE_FIELDS})
        alone, _ = _port_hmc(monkeypatch, tdata, one, draws, 0.02, 4,
                             rows=slice(c, c + 1))
        for f in STATE_FIELDS:
            assert torch.equal(getattr(batch, f)[c], getattr(even, f)[c]), \
                (c, f)
            torch.testing.assert_close(getattr(batch, f)[c:c + 1],
                                       getattr(alone, f), rtol=1e-12,
                                       atol=1e-12)
    assert not torch.equal(batch.nu, st.nu)


def test_hmc_joint_rejection_keeps_the_original_bits(monkeypatch):
    """A refused trajectory returns the original state, not its round trip
    through the unconstrained space: exact zeros in Z stay exact."""
    C = 2
    _, _, tdata, st = _setup(C, K=2)
    Z = st.Z.clone()
    Z[:, 0] = torch.tensor([1.0, 0.0], dtype=Z.dtype)
    st = st.replace(Z=Z)
    dim = logjoint.flatten(logjoint.from_state(st), False).shape[1]
    # a step far too long: the trajectory diverges and is refused
    out, log_acc = _port_hmc(monkeypatch, tdata, st, _hmc_draws(
        2, C, dim, [3, 3], [0.5, 0.5]), 5.0, 3)
    assert not (torch.log(torch.tensor(0.5)) < log_acc).any()
    _same_bits(out, st, "refused")
    assert out.Z[0, 0, 1] == 0.0


def test_hmc_joint_holds_xi_without_covariate_cov():
    """ROADMAP F14 not copied: with X and without covariate_cov the xi
    tower keeps its bits through accepted trajectories (the JAX package
    moves it); with covariate_cov it moves."""
    data, st, _ = _model("covariates")
    st = st.replace(xi=torch.zeros_like(st.xi))
    c = torch.full((2,), 10.0)
    out = st
    for i in range(3):
        out = tg.update_hmc_joint(torch.Generator().manual_seed(i), out,
                                  data, TPriors(), c, eps=0.002,
                                  n_leapfrog=3)
    assert not torch.equal(out.nu, st.nu)
    for f in ("xi", "gamma_xi", "delta_xi", "A_xi"):
        assert torch.equal(getattr(out, f), getattr(st, f)), f
    moved = tg.update_hmc_joint(torch.Generator().manual_seed(0), st, data,
                                TPriors(), c, eps=0.002, n_leapfrog=3,
                                covariate_cov=True)
    assert moved.xi.abs().max() > 0
    # the sweep passes covariate_cov on: xi stays exactly 0 without it
    g = torch.Generator().manual_seed(1)
    s = st
    for _ in range(2):
        s = tg.sweep_full(g, s, data, TPriors(), c, covariate_mean=True,
                          collapsed_z=True, gauge=True, hmc_steps=2,
                          hmc_eps=0.002)
    assert not s.xi.any() and not torch.equal(s.nu, st.nu)


# ---------------------------------------------------------------------------
# update_phi_chi
# ---------------------------------------------------------------------------

# scripted JAX keys: (role, index)
_MOVE, _KK, _KE, _KU, _CHI = range(5)


def _phi_chi_draws(seed, C, K, P, M, N, n_moves):
    rng = np.random.default_rng(seed)
    return dict(j=rng.integers(0, K * M, (C, n_moves)),
                noise=rng.normal(size=(C, n_moves, P)),
                u=rng.uniform(size=(C, n_moves)),
                z=rng.normal(size=(C, M, N)))


def _jax_phi_chi(monkeypatch, jdata, jstate, d, c, n_moves, beta=1.0):
    seen = []
    with jax.enable_x64(True):
        j, noise, u, z = (jnp.asarray(d[k][c])
                          for k in ("j", "noise", "u", "z"))

    def key(*parts):
        return jnp.stack([jnp.asarray(x, jnp.int32) for x in parts])

    def fold_in(k, data):
        if isinstance(data, int) and data == 179424673:
            return key(_CHI, 0)
        return key(_MOVE, data - 86028121)

    with monkeypatch.context() as mp, jax.enable_x64(True), \
            jax.disable_jit():
        mp.setattr(jax.random, "fold_in", fold_in)
        mp.setattr(jax.random, "split", lambda k, num=2: jnp.stack(
            [key(_KK, k[1]), key(_KE, k[1]), key(_KU, k[1])]))
        mp.setattr(jax.random, "randint",
                   lambda k, shape, minval, maxval: j[k[1]])
        mp.setattr(jax.random, "normal", lambda k, shape=(), dtype=float:
                   noise[k[1]] if k[0] == _KE else z)
        mp.setattr(jax.random, "uniform",
                   lambda k, shape=(), dtype=float: u[k[1]])
        nan_to_num = jnp.nan_to_num

        def spy(x, **kw):
            seen.append(float(x))
            return nan_to_num(x, **kw)

        mp.setattr(jnp, "nan_to_num", spy)
        st, cache = jg.update_phi_chi(key(0, 0), jstate, jdata, HP,
                                      jcache(jdata, jstate), beta,
                                      sigma_rw=0.3, n_moves=n_moves)
    return st, cache.w, seen


def _port_phi_chi(monkeypatch, tdata, st, d, n_moves, beta=1.0):
    C, N, M = st.chi.shape
    P = st.Phi.shape[2]
    seen = _spy_port_accept(monkeypatch)
    moves = iter(range(n_moves))
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randint", lambda *a, **k: torch.tensor(
            d["j"][:, next(moves)]))
        noise = iter(d["noise"].transpose(1, 0, 2))
        mp.setattr(torch, "randn", lambda shape, **k: torch.tensor(
            next(noise) if tuple(shape) == (C, P)
            else d["z"].transpose(0, 2, 1)))
        _queue(mp, tg, "_uniform", [torch.tensor(x) for x in d["u"].T])
        out, cache = tg.update_phi_chi(None, st, tdata, TPriors(),
                                       tcache(tdata, st), beta,
                                       sigma_rw=0.3, n_moves=n_moves)
    return out, cache.w, seen


@pytest.mark.parametrize("D", [0, 1])
def test_phi_chi_matches_jax_on_scripted_draws(monkeypatch, D):
    """Six column moves of two chains (the column, its step and uniform,
    then the chi redraw's normals scripted alike): Phi, chi, the running
    coefficients and every move's log-acceptance equal JAX's to 1e-9
    (float64), without and with the covariate directions xi x_n."""
    C, n_moves = 2, 6
    jdata, jstates, tdata, st = _setup(C, D=D)
    d = _phi_chi_draws(3, C, st.K, 5, st.M, tdata.N, n_moves)
    got, w, seen = _port_phi_chi(monkeypatch, tdata, st, d, n_moves)
    log_acc = torch.stack(seen, 1).numpy()                  # (C, moves)
    for c in range(C):
        want, jw, jseen = _jax_phi_chi(monkeypatch, jdata, jstates[c], d, c,
                                       n_moves)
        np.testing.assert_allclose(log_acc[c], jseen, err_msg=f"chain {c}",
                                   **TOL)
        _check_state(got, want, c, "phi_chi")
        np.testing.assert_allclose(w[c].numpy(), np.asarray(jw), **TOL)
    took = np.log(d["u"]) < log_acc
    assert took.any() and not took.all(), log_acc


def test_phi_chi_marginal_moves_and_preserves_fit():
    """Port of tests/test_collapsed_gauge.py::test_phi_chi_marginal_moves_
    and_preserves_fit: started at the simulation truth on high-SNR data,
    the kernel (a) accepts moves, (b) keeps the fit at the truth's level,
    (c) keeps every value finite; 200 calls of one chain, as there."""
    K, P, M, N = 3, 8, 2, 40
    data, truth = simulate_functional(seed=21, N=N, K=K, P=P, M=M,
                                      n_time=(60, 70), sigma2=0.001,
                                      device="cpu")
    g = torch.Generator().manual_seed(0)
    st = init_state(g, ModelConfig(K=K, P=P, M=M), data, chains=1)
    tr = convert.state_from_numpy(truth, device="cpu")
    st = st.replace(Z=tr.Z, nu=tr.nu, chi=tr.chi, Phi=tr.Phi,
                    sigma2=tr.sigma2)
    ll_truth = float(log_likelihood(tr, data))
    n_changed = 0
    for _ in range(200):
        new, _ = tg.update_phi_chi(g, st, data, TPriors(), tcache(data, st))
        n_changed += int(not torch.equal(new.Phi, st.Phi))
        st = new
    assert n_changed > 20, n_changed
    ll = float(log_likelihood(st, data))
    assert abs(ll - ll_truth) < 0.02 * abs(ll_truth) + 50, (ll, ll_truth)
    assert bool(torch.isfinite(st.Phi).all() and torch.isfinite(st.chi).all())


# ---------------------------------------------------------------------------
# update_z_chi(anchor_prop=True)
# ---------------------------------------------------------------------------

# scripted JAX keys of update_z_chi: (role, row)
(_TOP, _KP, _KI, _KB, _KA, _KC, _F97, _KP1, _KP2, _KSU, _F131, _KA1, _KA2,
 _KA3, _RW, _IND, _ANC) = range(17)


def _z_chi_draws(seed, C, N, K, M):
    rng = np.random.default_rng(seed)
    i1 = rng.integers(0, K, (C, N))
    return dict(g=rng.gamma(1.0, size=(C, 3, N, K)) + 1e-3,
                u=rng.uniform(size=(C, 4, N)), i1=i1,
                r2=rng.integers(0, K - 1, (C, N)),
                a_sel=rng.integers(0, K, (C, N)), z=rng.normal(size=(C, M, N)))


def _jax_z_chi(monkeypatch, jdata, jstate, d, c, beta=1.0):
    N = jdata.N
    with jax.enable_x64(True):
        g = jnp.asarray(d["g"][c])
    u = {_KB: 0, _KA: 1, _KSU: 2, _KA3: 3}
    logits, isnan_args = [], []

    def key(*parts):
        return jnp.stack([jnp.asarray(x, jnp.int32) for x in parts])

    def rows(role):
        return jnp.stack([key(role, i) for i in range(N)])

    def split(k, num=2):
        role = int(k[0])
        if role == _TOP:
            return jnp.stack([key(r, 0) for r in (_KP, _KI, _KB, _KA, _KC)])
        if role == _F97:
            return jnp.stack([key(r, 0) for r in (_KP1, _KP2, _KSU)])
        if role == _F131:
            return jnp.stack([key(r, 0) for r in (_KA1, _KA2, _KA3)])
        return rows({_KP: _RW, _KI: _IND, _KA2: _ANC}[role])

    def rdirichlet(k, alpha):
        x = g[k[0] - _RW, k[1]]
        return x / jnp.sum(x, axis=-1, keepdims=True)

    def categorical(k, lg, axis=-1, shape=None):
        logits.append(np.asarray(lg))
        return jnp.asarray(d["a_sel"][c])

    with monkeypatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax.random, "split", split)
        mp.setattr(jax.random, "fold_in",
                   lambda k, data: key({97: _F97, 131: _F131}[data], 0))
        mp.setattr(jg, "rdirichlet", rdirichlet)
        mp.setattr(jax.random, "uniform", lambda k, shape=(), dtype=float:
                   jnp.asarray(d["u"][c, u[int(k[0])]]))
        mp.setattr(jax.random, "randint", lambda k, shape, lo, hi: jnp.asarray(
            d["i1"][c] if int(k[0]) == _KP1 else d["r2"][c]))
        mp.setattr(jax.random, "categorical", categorical)
        mp.setattr(jax.random, "normal", lambda k, shape=(), dtype=float:
                   jnp.asarray(d["z"][c]))
        isnan = jnp.isnan

        def spy(x):
            if np.shape(x) == (N,):
                isnan_args.append(np.asarray(x))
            return isnan(x)

        mp.setattr(jnp, "isnan", spy)
        st, cache = jg.update_z_chi(key(_TOP, 0), jstate, jdata, HP,
                                    jcache(jdata, jstate), beta,
                                    p_indep=0.3, anchor_prop=True)
    return st, cache.w, logits[0], isnan_args


def _port_z_chi(monkeypatch, tdata, st, d, beta=1.0):
    seen = _spy_port_accept(monkeypatch)
    logits = []
    with monkeypatch.context() as mp:
        gs = iter(d["g"].transpose(1, 0, 2, 3))
        mp.setattr(tg, "rdirichlet", lambda gen, alpha, **kw: (
            lambda x: x / x.sum(-1, keepdim=True))(torch.tensor(next(gs))))
        _queue(mp, tg, "_uniform",
               [torch.tensor(x) for x in d["u"].transpose(1, 0, 2)])
        i1, r2 = d["i1"], d["r2"]
        mp.setattr(tg, "_ordered_pair", lambda *a, **k: (
            torch.tensor(i1), torch.tensor(np.where(r2 >= i1, r2 + 1, r2))))

        def categorical(gen, lg):
            logits.append(lg.clone())
            return torch.tensor(d["a_sel"])

        mp.setattr(tg, "_categorical", categorical)
        mp.setattr(torch, "randn", lambda *a, **k: torch.tensor(
            d["z"].transpose(0, 2, 1)))
        out, cache = tg.update_z_chi(None, st, tdata, TPriors(),
                                     tcache(tdata, st), beta, p_indep=0.3,
                                     anchor_prop=True)
    return out, cache.w, logits[0], seen


@pytest.mark.parametrize("D", [0, 1])
def test_z_chi_anchor_matches_jax_on_scripted_draws(monkeypatch, D):
    """The collapsed (Z, chi) block with the anchor stage, two chains of
    K = 3 (the proposals' gamma variates, the uniforms, the swap pair, the
    anchor picks and the chi normals scripted alike): the corner marginals
    (the anchor logits), the three stages' log-acceptances, Z, chi and the
    running coefficients equal JAX's to 1e-9 (float64)."""
    C = 2
    jdata, jstates, tdata, st = _setup(C, K=3, D=D)
    # row 1 on the boundary, and both its proposals too: the first stage
    # takes the proposal whatever its ratio, the anchor stage leaves the
    # row alone
    Z = st.Z.clone()
    Z[:, 1] = torch.tensor([0.5, 0.5, 0.0], dtype=Z.dtype)
    st = st.replace(Z=Z)
    with jax.enable_x64(True):
        jstates = [s.replace(Z=jnp.asarray(Z[c].numpy())) for c, s in
                   enumerate(jstates)]
    d = _z_chi_draws(5, C, tdata.N, 3, st.M)
    d["g"][:, :2, 1, 2] = 0.0
    got, w, logits, seen = _port_z_chi(monkeypatch, tdata, st, d)
    assert len(seen) == 3
    for c in range(C):
        want, jw, jlogits, jseen = _jax_z_chi(monkeypatch, jdata, jstates[c],
                                              d, c)
        np.testing.assert_allclose(logits[:, c].numpy().T, jlogits, **TOL)
        assert len(jseen) == 3
        for stage, (a, b) in enumerate(zip(seen, jseen)):
            np.testing.assert_allclose(a[c].numpy(), b, err_msg=f"stage "
                                       f"{stage} chain {c}", **TOL)
        _check_state(got, want, c, "z_chi anchor")
        np.testing.assert_allclose(w[c].numpy(), np.asarray(jw), **TOL)
    anchor_took = np.log(d["u"][:, 3]) < seen[2].numpy()
    others = np.arange(tdata.N) != 1
    assert anchor_took[:, others].any() and not anchor_took[:, others].all()
    assert bool((got.Z[:, 1] == 0.0).any(-1).all())


def test_categorical_draws_by_the_softmax():
    """The anchor pick (the Gumbel maximum) has the softmax's frequencies."""
    logits = torch.log(torch.tensor([0.2, 0.5, 0.3]))[:, None].expand(3, 40000)
    a = tg._categorical(torch.Generator().manual_seed(0), logits)
    freq = torch.bincount(a, minlength=3) / a.numel()
    np.testing.assert_allclose(freq.numpy(), [0.2, 0.5, 0.3], atol=0.01)


# ---------------------------------------------------------------------------
# The (C,) beta rules, and the sweep with every flag on
# ---------------------------------------------------------------------------

_NEW = {
    "z_chi_anchor": lambda g, s, d, beta: tg.update_z_chi(
        g, s, d, TPriors(), tcache(d, s), beta, p_indep=0.3,
        anchor_prop=True),
    "phi_chi": lambda g, s, d, beta: tg.update_phi_chi(
        g, s, d, TPriors(), tcache(d, s), beta, n_moves=3),
    "hmc_joint": lambda g, s, d, beta: (tg.update_hmc_joint(
        g, s, d, TPriors(), torch.full((2,), 10.0), beta, eps=0.005,
        n_leapfrog=3), tcache(d, s)),
}
ALL_FLAGS = dict(collapsed_z=True, gauge=True, phi_mala_steps=1,
                 phi_chi_moves=2, z_anchor=True, hmc_steps=2, hmc_eps=0.02)


@pytest.mark.parametrize("kind", ["functional", "covariates",
                                  "multivariate"])
@pytest.mark.parametrize("name", list(_NEW) + ["sweep"])
def test_beta_rules_of_the_new_updaters(kind, name):
    """A (C,) beta of equal float32 entries gives the float's bits; at a
    mixed beta v, chain i is chain i of the same-seed call at the float
    v[i], to f32 rounding (tests/test_torch_tempering.py's rules)."""
    data, st, cov = _model(kind)
    if name == "sweep":
        def fn(g, s, d, beta):
            return tg.sweep_full(g, s, d, TPriors(), torch.full((2,), 10.0),
                                 beta=beta, **cov, **ALL_FLAGS), None
    else:
        fn = _NEW[name]
    for b in B_EQUAL:
        a = fn(torch.Generator().manual_seed(5), st, data, b)[0]
        t = fn(torch.Generator().manual_seed(5), st, data,
               torch.full((4,), b))[0]
        _same_bits(a, t, f"{kind} {name} beta={b}")
    if name == "sweep":
        return
    s_mix = fn(torch.Generator().manual_seed(9), st, data,
               torch.tensor(MIXED))[0]
    for i, b in enumerate(MIXED):
        s_i = fn(torch.Generator().manual_seed(9), st, data, b)[0]
        for f in STATE_FIELDS:
            torch.testing.assert_close(
                getattr(s_mix, f)[i], getattr(s_i, f)[i], rtol=1e-5,
                atol=1e-6, msg=lambda m: f"{kind} {name} chain {i} {f}: {m}")


@pytest.mark.parametrize("kind", ["functional", "covariates",
                                  "multivariate"])
def test_sweep_with_every_flag_runs(kind):
    """A few sweeps with every default-off flag on (JAX's Geweke proof's
    set, tests/test_geweke_covadj.py:167-168), through phase_warm_start
    with an inverse mass as bench.py forms it: finite, Z on the simplex,
    everything moved."""
    from bayesfmmm_torch.samplers import drivers
    data, st, cov = _model(kind)
    c = torch.full((2,), 10.0)
    flags = dict(ALL_FLAGS, **cov)
    unc = logjoint.from_state(st)
    q = logjoint.flatten(unc, cov["covariate_cov"])
    inv_mass = q.var(0).clamp(min=1e-4)
    res = drivers.phase_warm_start(torch.Generator().manual_seed(2), st,
                                   data, TPriors(), c, n_iters=3,
                                   hmc_inv_mass=inv_mass, **flags)
    out = res.final_state
    for f in STATE_FIELDS:
        assert bool(torch.isfinite(getattr(out, f)).all()), f
    assert bool(torch.isfinite(res.loglik).all())
    assert bool((out.Z >= 0).all())
    torch.testing.assert_close(out.Z.sum(-1), torch.ones_like(out.Z[..., 0]))
    for f in ("Z", "nu", "Phi", "chi", "sigma2"):
        assert not torch.equal(getattr(out, f), getattr(st, f)), f


def test_fit_warm_start_production_flags_unchanged():
    """api.PRODUCTION_FLAGS keeps its five flags: the default-off kernels
    stay off in kernels="production" (MALA on, named: ROADMAP F3)."""
    assert api.PRODUCTION_FLAGS == dict(collapsed_z=True, gauge=True,
                                        p_indep=0.3, phi_mala_steps=4,
                                        phi_mala_step=0.05)
