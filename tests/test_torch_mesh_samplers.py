"""SMC, HMC, NUTS, ADVI and the sweep's whole-model HMC step
(``update_hmc_joint``) over the port's rank mesh (``parallel/mesh.py``) on
the CPU under gloo: the chains over (2, 1) and (4, 1) meshes, the data's
rows over (1, 2), (2, 2) and (1, 4) meshes, each run held to the same
program in one process, every rank's generator in step with the others',
and every rank of a data group holding the same bits of every global field.

Each mesh is one start of ``dryrun.run_ranks`` (a ``file://`` store in a
temporary directory, killed and failed past its time limit) that serves
every case of that mesh: the ranks load this file and run ``_rank_main``,
which runs ``programs`` under the mesh and saves each rank's results; the
one-process results are ``programs`` without a mesh, in this process.
Sizes are the JAX tests' ``_small`` (tests/test_checkpoint_parallel.py:
17-21): N = 8, K = 2, P = 5, M = 2; 8 particles or chains, SMC to 4
stages, HMC and NUTS 4 + 4 iterations (up to 4 steps; depth 3), ADVI 10
steps.

Bits: a rank that holds another count of chains than one process puts
another shape into the CPU's products (MKL picks its kernel by the shape
in the einsums that meet a data tensor every chain shares, and K2's plain
version is one of them), and a sum over n split over data ranks adds in
another order; so the split runs are held at the JAX sharding tests'
``atol = 2e-4`` (tests/test_checkpoint_parallel.py:79), every discrete
outcome (SMC's stages and ancestors, HMC's lengths, NUTS's depths)
exactly, and a case says where the bits hold.  SMC, HMC and NUTS run in
float64: in float32 a last-bit difference moves SMC's bisection by a step
of its 1e-5 tolerance (at 4 ranks, the weights then 9e-4 apart) and the
step-size adaptation carries HMC's and NUTS's acceptance differences into
their traces (7e-4 to 9e-4 apart after 8 iterations), which is rounding,
not the split; the log-joint, ADVI and the HMC-step sweep stay float32.
The log-joint of a data split is held to one process and to the JAX
package's ``jax.value_and_grad`` at the tolerance of
tests/test_torch_hmc.py::test_log_joint_matches_jax.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesfmmm_torch import dryrun  # noqa: E402
from bayesfmmm_torch.api import PRODUCTION_FLAGS  # noqa: E402
from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_torch.models import logjoint  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS, init_state  # noqa
from bayesfmmm_torch.ops import gibbs  # noqa: E402
from bayesfmmm_torch.parallel import mesh as pmesh  # noqa: E402
from bayesfmmm_torch.samplers import advi, hmc, nuts, smc  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

ATOL = 2e-4
# the log-joint's float32 tolerance: value relative, gradient relative norm
# per chain (tests/test_torch_hmc.py)
LJ_TOL = (1e-4, 1e-3)
MESHES = [(2, 1), (4, 1), (1, 2), (2, 2), (1, 4)]
DATA_MESHES = [cd for cd in MESHES if cd[1] > 1]
GLOBAL_FIELDS = [f for f in STATE_FIELDS if f not in ("Z", "chi")]
SMC_PARTICLES, SMC_STAGES = 8, 4
HMC_CHAINS, HMC_WARMUP, HMC_SAMPLES, HMC_STEPS, NUTS_DEPTH = 8, 4, 4, 4, 3
ADVI_STEPS, ADVI_MC, ADVI_SAMPLES = 10, 4, 3
SWEEP_CHAINS, SWEEP_HMC_STEPS, SWEEP_HMC_EPS = 4, 3, 0.003
LJ_CHAINS = 4


def _small(dtype=torch.float32):
    data, _ = simulate_functional(seed=31, N=8, K=2, P=5, M=2,
                                  n_time=(10, 12), dtype=dtype, device="cpu")
    return data, ModelConfig(K=2, P=5, M=2), Priors(), \
        torch.full((2,), 10.0, dtype=dtype)


def _point(data, cfg, chains, seed):
    """A whole unconstrained point of ``chains`` chains in the data's dtype:
    N(0, 1) on z_raw, nu, chi and Phi_raw and 0.3 N(0, 1) on every other
    coordinate, from a NumPy seed."""
    like = logjoint.init_unc(torch.Generator().manual_seed(0), cfg, data,
                             chains)
    rng = np.random.default_rng(seed)
    scale = {"z_raw": 1.0, "chi": 1.0, "Phi_raw": 1.0, "nu": 1.0}
    return logjoint.UncState(**{
        f: torch.tensor(scale.get(f, 0.3) * rng.normal(size=t.shape),
                        dtype=data.y.dtype)
        for f, t in vars(like).items()})


def _place(mesh, x, spec):
    return x if mesh is None else pmesh.NamedSharding(mesh, spec).place(x)


def _local_unc(mesh, unc, split_chains=True):
    """This rank's chains (when ``split_chains``) of ``unc``, and its rows of
    z_raw and chi."""
    c = pmesh.CHAIN_AXIS if split_chains else None
    return logjoint.UncState(**{
        f: _place(mesh, t, (c, pmesh.DATA_AXIS) if f in logjoint.ROW_FIELDS
                  else (c,)) for f, t in vars(unc).items()})


def _fields(st):
    return {f: getattr(st, f) for f in STATE_FIELDS}


def _inputs():
    """The programs' whole inputs, built outside any mesh: the data (float32
    and, for HMC and NUTS, float64), the points and the start states."""
    data, cfg, hp, c = _small()
    data64, _, _, c64 = _small(torch.float64)
    point64 = _point(data64, cfg, HMC_CHAINS, 6)
    sweep = init_state(torch.Generator().manual_seed(4), cfg, data,
                       chains=SWEEP_CHAINS)
    dim = logjoint.flatten(logjoint.from_state(sweep), False).shape[1]
    return {
        "data": data, "hp": hp, "c": c, "data64": data64, "c64": c64,
        "lj_point": _point(data, cfg, LJ_CHAINS, 5),
        "particles": init_state(torch.Generator().manual_seed(0), cfg,
                                data64, chains=SMC_PARTICLES,
                                dtype=torch.float64),
        "hmc_point": point64, "advi_point": _point(data, cfg, 1, 7),
        "sweep": sweep, "inv_mass": torch.tensor(np.random.default_rng(
            8).uniform(0.5, 1.5, dim), dtype=torch.float32)}


def _flat_log_joint(data, hp, c, unc):
    """The FlatLogJoint of ``unc``'s layout (covariate_cov=False)."""
    return logjoint.FlatLogJoint(
        logjoint.make_log_joint(data, hp, c),
        logjoint.UncState(**{f: t[:1] for f, t in vars(unc).items()}), False)


def programs(mesh=None):
    """Every program of this file on the small data, under ``mesh`` (split
    over its ranks) or in one process.  Returns ({program: its results,
    gathered whole}, {program: this rank's global fields and slots},
    {program: the generator's state after it})."""
    x = _inputs()
    hp = x["hp"]
    whole, mine, gens = {}, {}, {}

    def split(key):
        """The data ``key``, this rank's rows of it under the mesh."""
        return x[key] if mesh is None else pmesh.shard_data(x[key], mesh)

    def shard(states):
        return states if mesh is None else pmesh.shard_chain_states(states,
                                                                    mesh)

    def gather(states):
        return states if mesh is None else pmesh.gather_chain_states(states,
                                                                     mesh)

    def over_chains(v):
        return v if mesh is None else mesh.gather(v)

    data, data64 = split("data"), split("data64")
    with (mesh if mesh is not None else contextlib.nullcontext()):
        # the log-joint's value and gradient at a point of 4 chains
        unc = _local_unc(mesh, x["lj_point"])
        lj = _flat_log_joint(data, hp, x["c"], unc)
        slots = lj.slots()
        value, grad = hmc.value_and_grad(lj, logjoint.flatten(unc, False))
        with torch.no_grad():
            plain = lj(logjoint.flatten(unc, False))
        whole["logjoint"] = {"value": over_chains(value),
                             "plain": over_chains(plain),
                             "grad": slots.gather(grad)}
        mine["logjoint"] = {"value": value, "grad_global": _glob(slots, grad)}

        # SMC in float64: 8 particles from the prior, 4 stages of the
        # production census, its bisection's and resampling's inputs and
        # outputs kept
        record = {"beta": [], "resample": []}
        next_beta, resample = smc._next_beta, smc.resample_from_uniform

        def spy_beta(beta, ll, target, n):
            out = next_beta(beta, ll, target, n)
            record["beta"].append((beta, ll, target, n, out))
            return out

        def spy_resample(u, lw):
            out = resample(u, lw)
            record["resample"].append((u, lw, out))
            return out

        smc._next_beta, smc.resample_from_uniform = spy_beta, spy_resample
        try:
            g = torch.Generator().manual_seed(1)
            r = smc.run_smc(g, shard(x["particles"]), data64, hp, x["c64"],
                            max_stages=SMC_STAGES, **PRODUCTION_FLAGS)
        finally:
            smc._next_beta, smc.resample_from_uniform = next_beta, resample
        whole["smc"] = {"particles": _fields(gather(r.particles)),
                        "log_weights": r.log_weights,
                        "n_stages": r.n_stages,
                        "log_evidence": r.log_evidence,
                        "final_beta": r.final_beta, "record": record}
        mine["smc"] = {f: getattr(r.particles, f) for f in GLOBAL_FIELDS}
        gens["smc"] = g.get_state()

        # HMC and NUTS in float64: 8 chains from a whole point, 4 + 4
        # iterations (the chain axis of the positions as the ensemble's)
        if mesh is not None:
            mesh.n_chains = HMC_CHAINS
        unc = _local_unc(mesh, x["hmc_point"])
        lj = _flat_log_joint(data64, hp, x["c64"], unc)
        slots = lj.slots()
        q0 = logjoint.flatten(unc, False)
        for name, run, kw in (
                ("hmc", hmc.run_hmc, dict(n_leapfrog=HMC_STEPS)),
                ("nuts", nuts.run_nuts, dict(max_depth=NUTS_DEPTH))):
            g = torch.Generator().manual_seed(2)
            qs, diag = run(g, lj, q0, n_warmup=HMC_WARMUP,
                           n_samples=HMC_SAMPLES, init_step_size=0.01, **kw)
            whole[name] = {"trace": slots.gather(qs),
                           **{k: over_chains(v) for k, v in diag.items()}}
            mine[name] = {"trace_global": _glob(slots, qs)}
            gens[name] = g.get_state()

        # ADVI: one chain, every rank its rows; then 3 draws of q
        unc = _local_unc(mesh, x["advi_point"], split_chains=False)
        g = torch.Generator().manual_seed(3)
        res = advi.run_advi(g, logjoint.make_log_joint(data, hp, x["c"]), unc,
                            n_steps=ADVI_STEPS, n_mc=ADVI_MC,
                            covariate_cov=False)
        slots = logjoint.rank_slots(res.like, False)
        mu = logjoint.flatten(res.mean, False)
        draws = logjoint.flatten(advi.sample_from_advi(
            g, res, n_samples=ADVI_SAMPLES), False)
        whole["advi"] = {"mu": slots.gather(mu, None),
                         "log_sd": slots.gather(res.log_sd_flat[None],
                                                None),
                         "elbo": res.elbo_trace,
                         "draws": slots.gather(draws, None)}
        mine["advi"] = {"mu_global": _glob(slots, mu),
                        "log_sd_global": _glob(slots, res.log_sd_flat),
                        "elbo": res.elbo_trace}
        gens["advi"] = g.get_state()

        # two production sweeps with the whole-model HMC step, 4 chains, an
        # inverse mass over the whole position
        g = torch.Generator().manual_seed(5)
        sweep = shard(x["sweep"])
        for _ in range(2):
            sweep = gibbs.sweep_full(g, sweep, data, hp, x["c"],
                                     **PRODUCTION_FLAGS,
                                     hmc_steps=SWEEP_HMC_STEPS,
                                     hmc_eps=SWEEP_HMC_EPS,
                                     hmc_inv_mass=x["inv_mass"])
        whole["hmc_sweep"] = _fields(gather(sweep))
        mine["hmc_sweep"] = {f: getattr(sweep, f) for f in GLOBAL_FIELDS}
        gens["hmc_sweep"] = g.get_state()
    return whole, mine, gens


def _glob(slots, x):
    """The global slots of positions x (..., local dim)."""
    return x if slots.glob is None else x[..., slots.glob]


def _rank_main(out, chains, rows):
    """A rank of one mesh: every program under it, then a plain density
    under the data split; saves its results to ``out``.<rank>."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(n_chain_shards=chains, n_data_shards=rows,
                           devices="cpu")
    whole, mine, gens = programs(mesh)
    refused = None
    if rows > 1:
        try:
            with mesh:
                hmc.run_hmc(torch.Generator(), lambda x: -(x * x).sum(1),
                            torch.zeros(2, 3), n_warmup=4, n_samples=1)
        except ValueError as e:
            refused = str(e)
    torch.save({"coords": [mesh.coords["chains"], mesh.coords["data"]],
                "whole": whole, "mine": mine, "gens": gens,
                "refused": refused, "collectives": mesh.collectives},
               f"{out}.{mesh.rank}")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """mesh -> every rank's saved results, in rank order."""
    res = {}
    for c, d in MESHES:
        out = tmp_path_factory.mktemp(f"samplers{c}x{d}") / "rank"
        dryrun.run_ranks(c * d, f"{Path(__file__).resolve()}:_rank_main",
                         {"out": str(out), "chains": c, "rows": d},
                         timeout=240)
        res[(c, d)] = [torch.load(f"{out}.{r}", weights_only=False)
                       for r in range(c * d)]
    return res


@pytest.fixture(scope="module")
def one_process():
    torch.set_num_threads(1)
    return programs()


def _close(got, want, what, atol=ATOL):
    """Tensors (or nested dicts of them) within ``atol`` (None: the same
    bits); ints and lists exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _close(got[k], want[k], f"{what} {k}", atol)
    elif isinstance(want, torch.Tensor):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        if atol is None or want.dtype in (torch.bool, torch.int32,
                                          torch.int64):
            assert torch.equal(got, want), (
                f"{what} differs" + ("" if want.dtype == torch.bool else
                                     f" by {(got - want).abs().max():.3g}"))
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                       rtol=0, err_msg=what)
    else:
        assert got == want, what


# ---------------------------------------------------------------------------
# the flat position's layout


@pytest.mark.parametrize("covariate_cov", [False, True])
@pytest.mark.parametrize("d", [2, 4])
def test_rank_slots_cover_the_whole_position(d, covariate_cov):
    """Under a data split of d ranks (a mesh object, no process group) each
    rank's flat position, the rows of z_raw and chi its own, is the whole
    position at that rank's ``keep``; the ranks' slots cover every
    coordinate, the global ones on every rank and each row slot on one."""
    from bayesfmmm_torch.utils.simulate import simulate_functional as sim

    data, _ = sim(seed=32, N=8, K=3, P=5, M=2, D=1, n_time=(10, 12),
                  with_eta=True, with_xi=True, device="cpu")
    cfg = ModelConfig(K=3, P=5, M=2, D=1, covariate_mean=True,
                      covariate_cov=True)
    point = _point(data, cfg, 3, 9)
    want = logjoint.flatten(point, covariate_cov)
    seen = torch.zeros(want.shape[1], dtype=torch.int64)
    for k in range(d):
        mesh = pmesh.Mesh(np.arange(d).reshape(1, d), k, torch.device("cpu"),
                          {pmesh.CHAIN_AXIS: None, pmesh.DATA_AXIS: None})
        mesh.n_rows = 8
        with mesh:
            slots = logjoint.rank_slots(_local_unc(mesh, point, False),
                                        covariate_cov)
            local = logjoint.flatten(_local_unc(mesh, point, False),
                                     covariate_cov)
        assert slots.dim == want.shape[1]
        assert torch.equal(local, want[:, slots.keep])
        assert torch.equal(slots.every[k], slots.keep)
        assert torch.equal(torch.sort(torch.cat([slots.rows, slots.glob]))[0],
                           torch.arange(local.shape[1]))
        seen[slots.keep] += 1
    n_rows = 8 * (2 + 2)           # z_raw's K - 1 and chi's M a row
    assert int((seen == 1).sum()) == n_rows
    assert bool(((seen == 1) | (seen == d)).all())
    assert int((seen == d).sum()) == want.shape[1] - n_rows


def test_collectives_are_plain_outside_a_mesh():
    x = torch.tensor([3, 1, 4])
    assert pmesh.mesh_max(x) == 4 and pmesh.mesh_any(x > 3)
    assert not pmesh.mesh_any(x > 4)
    slots = logjoint.Slots(3)
    y = torch.randn(2, 3)
    assert torch.equal(slots.sum(y), y.sum(-1))
    assert slots.take(y) is y and slots.gather(y) is y


# ---------------------------------------------------------------------------
# each program split against one process


@pytest.mark.parametrize("cd", DATA_MESHES)
def test_split_log_joint_matches_one_process_and_jax(ranks, one_process, cd):
    """The log-joint's value and gradient at a point of 4 chains with the
    rows split over d = 2 and 4 data ranks: the row terms over every rank
    plus the global terms once (the whole N in -N log B(alpha3 pi)), their
    gradient gathered into the whole position, against one process (the
    same point and data) and against the JAX package's make_log_joint under
    jax.value_and_grad, to tests/test_torch_hmc.py's float32 tolerance; the
    value without a gradient (``log_joint`` under the mesh) too."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from bayesfmmm_tpu.config import Priors as JPriors
    from bayesfmmm_tpu.models import logjoint as jlj
    from bayesfmmm_tpu.utils.simulate import simulate_functional as jsim

    jdata, _ = jsim(seed=31, N=8, K=2, P=5, M=2, n_time=(10, 12))
    data, cfg, _, _ = _small()
    point = _point(data, cfg, LJ_CHAINS, 5)
    juncs = jlj.UncState(**{f: jnp.asarray(t.numpy())
                            for f, t in vars(point).items()})
    jl = jlj.make_log_joint(jdata, JPriors(), jnp.full((2,), 10.0))
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jl)))(juncs)
    jv = np.asarray(jv, np.float64)
    jg = np.stack([np.asarray(ravel_pytree(jax.tree.map(
        lambda x: x[i], jg))[0]) for i in range(LJ_CHAINS)])
    want = one_process[0]["logjoint"]
    v_tol, g_tol = LJ_TOL
    for ref_v, ref_g in ((want["value"].numpy(), want["grad"].numpy()),
                         (jv, jg)):
        for res in ranks[cd]:
            got = res["whole"]["logjoint"]
            for v in (got["value"], got["plain"]):
                np.testing.assert_allclose(v.numpy(), ref_v, rtol=v_tol)
            err = (np.linalg.norm(got["grad"].numpy() - ref_g, axis=1)
                   / np.linalg.norm(ref_g, axis=1))
            assert err.max() < g_tol, (cd, err)
    # one process and JAX agree, so the split is held to both
    np.testing.assert_allclose(want["value"].numpy(), jv, rtol=v_tol)


@pytest.mark.parametrize("cd", MESHES)
def test_split_smc_matches_one_process(ranks, one_process, cd):
    """SMC, 8 particles, 4 stages: the stage count, every stage's beta and
    resampling ancestors exactly; the particles (gathered), the weights,
    log_Z and the final beta within the atol.  The chain split's
    log-likelihoods come from K2's plain version at 4 or 2 particles and the
    data split's from sums over the ranks' rows."""
    want = one_process[0]["smc"]
    for res in ranks[cd]:
        got = res["whole"]["smc"]
        assert got["n_stages"] == want["n_stages"] == SMC_STAGES
        for a, b in zip(got["record"]["resample"],
                        want["record"]["resample"]):
            assert torch.equal(a[2], b[2]), cd
        _close({k: got[k] for k in ("particles", "log_weights",
                                    "log_evidence", "final_beta")},
               {k: want[k] for k in ("particles", "log_weights",
                                     "log_evidence", "final_beta")},
               f"SMC over {cd}")
        for a, b in zip(got["record"]["beta"], want["record"]["beta"]):
            _close(a[4], b[4], f"SMC beta over {cd}")


@pytest.mark.parametrize("cd", MESHES)
def test_split_smc_reductions_match_jax(ranks, cd):
    """The whole ensemble's gathered log-likelihoods that every rank's
    bisection read give the JAX package's ``_next_beta`` (within 1e-4, the
    JAX bisection's own float32 rounding, tests/test_torch_smc.py), and
    the weights and uniform that its resampling read give the JAX
    package's systematic resampling's ancestors exactly; every rank read
    the same bits."""
    import jax
    import jax.numpy as jnp

    from bayesfmmm_tpu.samplers import smc as js

    first = ranks[cd][0]["whole"]["smc"]["record"]
    for res in ranks[cd]:
        rec = res["whole"]["smc"]["record"]
        for a, b in zip(rec["beta"], first["beta"]):
            assert torch.equal(a[1], b[1]) and torch.equal(a[4], b[4])
        for a, b in zip(rec["resample"], first["resample"]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    with jax.enable_x64(True):
        for beta, ll, target, n, got in first["beta"]:
            assert ll.shape == (SMC_PARTICLES,) and n == SMC_PARTICLES
            want = js._next_beta(jnp.float64(float(beta)),
                                 jnp.asarray(ll.numpy()), target, n)
            assert abs(float(got) - float(want)) <= 1e-4, (cd, float(got),
                                                           float(want))
        for u, lw, got in first["resample"]:
            w = jax.nn.softmax(jnp.asarray(lw.numpy()))
            want = jnp.searchsorted(jnp.cumsum(w), (float(u) + jnp.arange(
                SMC_PARTICLES)) / SMC_PARTICLES)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["hmc", "nuts"])
@pytest.mark.parametrize("cd", MESHES)
def test_split_hmc_and_nuts_match_one_process(ranks, one_process, cd,
                                              method):
    """HMC (up to 4 steps) and NUTS (to depth 3), 8 chains, 4 + 4
    iterations: every trajectory's length or tree's depth exactly, the
    traces (whole positions, put together from every rank's chains and
    slots), the step sizes and the acceptance within the atol."""
    want = one_process[0][method]
    for res in ranks[cd]:
        got = res["whole"][method]
        info = "n_steps" if method == "hmc" else "depth"
        assert torch.equal(got[info], want[info]), cd
        _close({k: v for k, v in got.items() if k != info},
               {k: v for k, v in want.items() if k != info},
               f"{method} over {cd}")


@pytest.mark.parametrize("cd", MESHES)
def test_split_advi_matches_one_process(ranks, one_process, cd):
    """ADVI, 10 steps of 4 draws, then 3 draws of q: the means, the log
    standard deviations, the ELBO trace and the draws within the atol.
    Under a chain split every rank runs the one-process optimisation on
    the whole position, with its bits."""
    want = one_process[0]["advi"]
    for res in ranks[cd]:
        _close(res["whole"]["advi"], want, f"ADVI over {cd}",
               None if cd[1] == 1 else ATOL)


@pytest.mark.parametrize("cd", MESHES)
def test_split_hmc_steps_sweep_matches_one_process(ranks, one_process, cd):
    """Two production sweeps with the whole-model HMC step (up to 3 steps,
    an inverse mass over the whole position cut to each rank's slots), 4
    chains: every field within the atol."""
    for res in ranks[cd]:
        _close(res["whole"]["hmc_sweep"], one_process[0]["hmc_sweep"],
               f"hmc_steps sweep over {cd}")


@pytest.mark.parametrize("cd", MESHES)
def test_split_ranks_stay_in_step(ranks, one_process, cd):
    """After each program every rank's generator is in the state of the
    one-process run's (every draw taken at the whole shape, every loop as
    long on every rank), and every rank of a data group holds the same bits
    of every global field and slot."""
    for res in ranks[cd]:
        for name, state in one_process[2].items():
            assert torch.equal(res["gens"][name], state), (cd, name)
        first = ranks[cd][ranks[cd].index(res) - res["coords"][1]]
        _close(res["mine"], first["mine"], f"global fields over {cd}", None)


def test_plain_density_refused_under_data_split(ranks):
    """A log density that is not a FlatLogJoint cannot say which of its
    coordinates are a rank's rows: HMC refuses it under a data split."""
    for cd in DATA_MESHES:
        for res in ranks[cd]:
            assert "FlatLogJoint" in res["refused"]
