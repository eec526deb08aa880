"""The port's rank mesh (``bayesfmmm_torch/parallel/mesh.py``) on the CPU
under gloo: the chains of a sweep, of parallel tempering and of a
checkpoint split over 2 and 4 ranks give the one-process run's draws, and
so do the data's rows split over the data axis of (1, 2), (2, 2) and
(4, 2) meshes, each rank of a data group holding the same global fields.

Each multi-rank case runs in ranks started by ``dryrun.run_ranks`` (a
``file://`` store in a temporary directory, 120 s for all ranks (150 s for
the data axis's), killed and failed past it); one start of 2 ranks and one
of 4 serve every chain-axis case, and the first rank saves what the cases
read; one start of each data mesh serves its cases, every rank saving its
own.  Sizes are the JAX tests' ``_small``
(tests/test_checkpoint_parallel.py:17-21).

Where the CPU's float32 products take another summation order at another
chain count (MKL's sgemm picks its kernel by the matrix's shape, and the
einsums that meet a data tensor shared by every chain put the chain axis
into that shape), a split run cannot give the one-process bits; those
cases hold the JAX test's own ``atol=2e-4`` and say so.  A sum over n
split over data ranks rounds in another order than one process's, so the
data axis's cases hold every field at that atol and the global fields to
the bit across the ranks of a data group.
"""

import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bayesfmmm_tpu.parallel import mesh as jmesh  # noqa: E402
from bayesfmmm_torch import dryrun  # noqa: E402
from bayesfmmm_torch.api import PRODUCTION_FLAGS  # noqa: E402
from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_torch.io.checkpoint import (load_checkpoint,  # noqa: E402
                                          save_checkpoint)
from bayesfmmm_torch.models.state import STATE_FIELDS, init_state  # noqa
from bayesfmmm_torch.ops import distributions, gibbs  # noqa: E402
from bayesfmmm_torch.parallel import mesh as pmesh  # noqa: E402
from bayesfmmm_torch.parallel import tempering  # noqa: E402
from bayesfmmm_torch.samplers import drivers  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

# the JAX tests' tolerance of a sharded sweep against the unsharded one
# (tests/test_checkpoint_parallel.py:79, :138-141)
ATOL = 2e-4
CENSUSES = {"reference": {}, "production": PRODUCTION_FLAGS}
SWEEP_CHAINS, PT_REPLICAS, PT_ROUNDS, PT_BETA_MIN = 4, 8, 5, 0.4
CKPT_CHAINS, CKPT_SWEEPS = 4, 5
# the shapes of the gathered-gamma case: every rank holds 2 rows
GAMMA_COLS = 64

_WORKER = textwrap.dedent('''
    import math
    import torch
    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.config import ModelConfig, Priors
    from bayesfmmm_torch.io.checkpoint import save_checkpoint
    from bayesfmmm_torch.models.state import STATE_FIELDS, init_state
    from bayesfmmm_torch.ops import distributions, gibbs
    from bayesfmmm_torch.parallel import mesh as pmesh
    from bayesfmmm_torch.parallel import tempering
    from bayesfmmm_torch.samplers import drivers
    from bayesfmmm_torch.utils.simulate import simulate_functional

    CENSUSES = {"reference": {}, "production": PRODUCTION_FLAGS}


    def small():
        data, _ = simulate_functional(seed=31, N=8, K=2, P=5, M=2,
                                      n_time=(10, 12), device="cpu")
        return data, ModelConfig(K=2, P=5, M=2), Priors(), \\
            torch.full((2,), 10.0)


    def whole(mesh, st):
        g = pmesh.gather_chain_states(st, mesh)
        return {f: getattr(g, f) for f in STATE_FIELDS}


    def refused(fn):
        try:
            fn()
        except ValueError as e:
            return type(e).__name__
        return "nothing"


    def main(out, ckpt, gamma_cols):
        mesh = pmesh.make_mesh(devices="cpu")
        n = mesh.shape[pmesh.CHAIN_AXIS]
        data, cfg, hp, c = small()
        data = pmesh.shard_data(data, mesh)
        res = {"shape": [n, mesh.shape[pmesh.DATA_AXIS]]}

        # one sweep of 4 chains in each census
        states = init_state(torch.Generator().manual_seed(0), cfg, data,
                            chains=4)
        for name, flags in CENSUSES.items():
            local = pmesh.shard_chain_states(states, mesh)
            with mesh:
                new = gibbs.sweep_full(torch.Generator().manual_seed(1),
                                       local, data, hp, c, **flags)
            res["sweep_" + name] = whole(mesh, new)

        # gamma draws whose rows hold shapes from 0.01 to 50; then a normal
        # draw, which is the same only if the generators stayed in step
        alpha = torch.logspace(math.log10(0.01), math.log10(50.0),
                               2 * n * gamma_cols).reshape(2 * n, gamma_cols)
        alpha = alpha[:, torch.randperm(gamma_cols,
                                        generator=torch.Generator()
                                        .manual_seed(3))]
        mesh.n_chains = 2 * n
        g = torch.Generator().manual_seed(4)
        with mesh:
            lo, hi = mesh.chain_rows(2)
            x = distributions.standard_gamma(g, alpha[lo:hi].contiguous())
            z = distributions.normal(g, (2, 3), dtype=torch.float32,
                                     device="cpu")
        res["gamma"] = mesh.gather(x)
        res["gamma_then_normal"] = mesh.gather(z)

        # parallel tempering: 8 replicas, 5 rounds, every swap decision kept
        perms = []
        swap = tempering.swap_phase

        def spy(E, ladder, parity, u):
            perm, acc, att = swap(E, ladder, parity, u)
            perms.append(perm.tolist())
            return perm, acc, att

        tempering.swap_phase = spy
        states = init_state(torch.Generator().manual_seed(11), cfg, data,
                            chains=8)
        local = pmesh.shard_chain_states(states, mesh)
        with mesh:
            cold, pt, rate = tempering.run_parallel_tempering(
                torch.Generator().manual_seed(12), local, data, hp, c,
                n_rounds=5, beta_min=0.4)
        res["pt_cold"] = {f: getattr(cold, f) for f in STATE_FIELDS}
        res["pt_rate"] = rate
        res["pt_counts"] = [pt.swap_accepts, pt.swap_attempts]
        res["pt_perms"] = perms
        res["pt_final"] = whole(mesh, pt.states)

        # the port of tests/test_multiprocess.py's two-process sweep: each
        # rank prints the gathered sigma2 of 8 chains after one sweep
        states = init_state(torch.Generator().manual_seed(0), cfg, data,
                            chains=8)
        local = pmesh.shard_chain_states(states, mesh)
        with mesh:
            new = gibbs.sweep_full(torch.Generator().manual_seed(1), local,
                                   data, hp, c)
        sig = mesh.gather(new.sigma2)
        print("RESULT", mesh.size, " ".join(f"{v:.6f}" for v in
                                            sig.tolist()), flush=True)

        if n == 2:
            # 5 sweeps of 4 chains, checkpointed from both ranks
            states = init_state(torch.Generator().manual_seed(5), cfg, data,
                                chains=4)
            local = pmesh.shard_chain_states(states, mesh)
            g = torch.Generator().manual_seed(6)
            with mesh:
                r = drivers.run_chain(g, local, data, hp, c,
                                      sweep=gibbs.sweep_full, n_iters=5)
                save_checkpoint(ckpt, r.final_state, g, iteration=5,
                                config=cfg)
            # refusals
            whole4 = init_state(torch.Generator().manual_seed(0), cfg, data,
                                chains=4)
            three = init_state(torch.Generator().manual_seed(0), cfg, data,
                               chains=3)

            def draw_whole():
                pmesh.shard_chain_states(whole4, mesh)
                with mesh:
                    gibbs.sweep_full(torch.Generator(), whole4, data, hp, c)

            res["refusals"] = {
                "indivisible": refused(
                    lambda: pmesh.shard_chain_states(three, mesh)),
                "local_shape": refused(draw_whole)}
        if mesh.rank == 0:
            torch.save(res, out)
''')


def _small():
    data, _ = simulate_functional(seed=31, N=8, K=2, P=5, M=2,
                                  n_time=(10, 12), device="cpu")
    return data, ModelConfig(K=2, P=5, M=2), Priors(), torch.full((2,), 10.0)


def _fields(st):
    return {f: getattr(st, f) for f in STATE_FIELDS}


def _run(tmp_path_factory, n):
    tmp = tmp_path_factory.mktemp(f"ranks{n}")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    out, ckpt = tmp / "rank0.pt", tmp / "ckpt"
    outs = dryrun.run_ranks(n, f"{worker}:main",
                            {"out": str(out), "ckpt": str(ckpt),
                             "gamma_cols": GAMMA_COLS}, timeout=120)
    return torch.load(out), outs, ckpt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {n: _run(tmp_path_factory, n) for n in (2, 4)}


@pytest.fixture(scope="module")
def one_process():
    """The same programs in this process, unsplit."""
    data, cfg, hp, c = _small()
    res = {}
    states = init_state(torch.Generator().manual_seed(0), cfg, data,
                        chains=SWEEP_CHAINS)
    for name, flags in CENSUSES.items():
        res["sweep_" + name] = _fields(gibbs.sweep_full(
            torch.Generator().manual_seed(1), states, data, hp, c, **flags))
    perms, swap = [], tempering.swap_phase

    def spy(E, ladder, parity, u):
        perm, acc, att = swap(E, ladder, parity, u)
        perms.append(perm.tolist())
        return perm, acc, att

    states = init_state(torch.Generator().manual_seed(11), cfg, data,
                        chains=PT_REPLICAS)
    tempering.swap_phase = spy
    try:
        cold, pt, rate = tempering.run_parallel_tempering(
            torch.Generator().manual_seed(12), states, data, hp, c,
            n_rounds=PT_ROUNDS, beta_min=PT_BETA_MIN)
    finally:
        tempering.swap_phase = swap
    res.update(pt_cold=_fields(cold), pt_rate=rate, pt_perms=perms,
               pt_counts=[pt.swap_accepts, pt.swap_attempts],
               pt_final=_fields(pt.states))
    return res


def _same(got, want, what, atol=None):
    """Every field equal (torch.equal), or within ``atol``."""
    for f in want:
        a, b = got[f], want[f]
        assert a.shape == b.shape, (what, f)
        if atol is None:
            assert torch.equal(a, b), (
                f"{what}: {f} differs by {(a - b).abs().max().item():.3g}")
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol,
                                       rtol=0, err_msg=f"{what}: {f}")


# ---------------------------------------------------------------------------
# the mesh's shape, against the JAX package's make_mesh on 8 virtual devices


def _valid_shapes(n):
    shapes = [(None, None), (n, None), (None, 1)]
    shapes += [(c, n // c) for c in range(1, n + 1) if n % c == 0]
    return shapes


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_match_jax(n):
    devices = jax.devices()[:n]
    assert len(devices) == n
    for c, d in _valid_shapes(n):
        want = jmesh.make_mesh(n_chain_shards=c, n_data_shards=d,
                               devices=devices).shape
        got = pmesh.mesh_shape(n, c, d)
        assert got == (want[jmesh.CHAIN_AXIS], want[jmesh.DATA_AXIS]), (c, d)
    with pytest.raises(AssertionError):
        jmesh.make_mesh(n_chain_shards=n + 1, n_data_shards=1,
                        devices=devices)
    with pytest.raises(ValueError, match="ranks"):
        pmesh.mesh_shape(n, n + 1, 1)
    assert (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS) == (jmesh.CHAIN_AXIS,
                                                   jmesh.DATA_AXIS)


def test_one_process_mesh_changes_nothing():
    """Without a process group the mesh is 1 x 1; under it a sweep, a
    checkpointless chain and shard_data/shard_chain_states give the bits of
    the plain calls."""
    mesh = pmesh.make_mesh(devices="cpu")
    assert mesh.shape == {"chains": 1, "data": 1} and mesh.size == 1
    data, cfg, hp, c = _small()
    states = init_state(torch.Generator().manual_seed(0), cfg, data,
                        chains=SWEEP_CHAINS)
    want = gibbs.sweep_full(torch.Generator().manual_seed(1), states, data,
                            hp, c, **PRODUCTION_FLAGS)
    sdata = pmesh.shard_data(data, mesh)
    local = pmesh.shard_chain_states(states, mesh)
    with mesh:
        assert pmesh.active_mesh() is None
        got = gibbs.sweep_full(torch.Generator().manual_seed(1), local, sdata,
                               hp, c, **PRODUCTION_FLAGS)
    _same(_fields(got), _fields(want), "1 x 1 mesh")
    assert mesh.collectives == 0
    assert pmesh.key_sharding(mesh).spec == (pmesh.CHAIN_AXIS,)
    spec = pmesh.chain_state_sharding(mesh, states)
    assert spec["Z"].spec == (pmesh.CHAIN_AXIS, pmesh.DATA_AXIS)
    assert spec["nu"].spec == (pmesh.CHAIN_AXIS,)


def test_initialize_distributed_refusals():
    assert pmesh.initialize_distributed(num_processes=1) is None
    with pytest.raises(RuntimeError, match="NCCL"):
        pmesh.initialize_distributed(num_processes=2, process_id=0,
                                     init_method="file:///nonexistent",
                                     backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pmesh.initialize_distributed(num_processes=2, process_id=0,
                                     init_method="file:///nonexistent",
                                     backend="mpi", device="cpu")
    assert pmesh.collective_backend("cpu", 2) == "gloo"


# ---------------------------------------------------------------------------
# split runs against one process


def _split_atol(census, n):
    """The bits hold for the reference census over 2 ranks; the production
    census (gram_dirs in the collapsed Z block) and 1 chain a rank
    (apply_basis in update_z) take another sgemm kernel on the CPU."""
    return None if (census, n) == ("reference", 2) else ATOL


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("census", ["reference", "production"])
def test_split_sweep_matches_one_process(ranks, one_process, census, n):
    """4 chains over 2 and 4 ranks, one sweep_full (at one data shard; the
    port of tests/test_checkpoint_parallel.py:58)."""
    res = ranks[n][0]
    assert res["shape"] == [n, 1]
    key = "sweep_" + census
    _same(res[key], one_process[key], f"{census} sweep over {n} ranks",
          _split_atol(census, n))


@pytest.mark.parametrize("n", [2, 4])
def test_split_gamma_gathers_shapes(ranks, n):
    """Every rank's rows of a gamma draw whose other rows hold shapes from
    0.01 to 50 are the one-process rows, and the generators stay in step:
    the normal draw after it is the one-process draw too."""
    res = ranks[n][0]
    alpha = torch.logspace(np.log10(0.01), np.log10(50.0),
                           2 * n * GAMMA_COLS).reshape(2 * n, GAMMA_COLS)
    alpha = alpha[:, torch.randperm(GAMMA_COLS, generator=torch.Generator()
                                    .manual_seed(3))]
    g = torch.Generator().manual_seed(4)
    want = distributions.standard_gamma(g, alpha)
    assert torch.equal(res["gamma"], want)
    assert torch.equal(res["gamma_then_normal"], torch.randn(
        (2 * n, 3), generator=g))


@pytest.mark.parametrize("n", [2, 4])
def test_split_pt_matches_one_process(ranks, one_process, n):
    """R = 8 replicas over 2 and 4 ranks, 5 rounds, beta_min = 0.4 (the
    port of tests/test_checkpoint_parallel.py:126): every round's swap
    permutation, the counts and the rate are the one-process run's, and at
    least one accepted swap crossed a rank boundary; the cold trace and
    the replicas at JAX's atol (gram_dirs and apply_basis, as above)."""
    res = ranks[n][0]
    assert res["pt_perms"] == one_process["pt_perms"]
    for a, b in zip(res["pt_counts"], one_process["pt_counts"]):
        assert torch.equal(a, b)
    assert torch.equal(res["pt_rate"], one_process["pt_rate"])
    share = PT_REPLICAS // n
    crossed = [(i, b) for i, perm in enumerate(res["pt_perms"])
               for b in range(share, PT_REPLICAS, share) if perm[b - 1] == b]
    assert crossed, "no accepted swap crossed a rank boundary"
    _same(res["pt_cold"], one_process["pt_cold"], f"PT cold over {n}", ATOL)
    _same(res["pt_final"], one_process["pt_final"], f"PT over {n}", ATOL)


def test_split_checkpoint_resumes_in_one_process(ranks):
    """2 ranks run 5 sweeps of 4 chains and checkpoint; one process loads the
    file, runs 5 more, and has the bits of 10 one-process sweeps."""
    data, cfg, hp, c = _small()
    states = init_state(torch.Generator().manual_seed(5), cfg, data,
                        chains=CKPT_CHAINS)
    want = drivers.run_chain(torch.Generator().manual_seed(6), states, data,
                             hp, c, sweep=gibbs.sweep_full,
                             n_iters=2 * CKPT_SWEEPS).final_state
    st, g, it, got_cfg = load_checkpoint(ranks[2][2], "cpu")
    assert it == CKPT_SWEEPS and got_cfg == cfg
    assert st.Z.shape[0] == CKPT_CHAINS
    got = drivers.run_chain(g, st, data, hp, c, sweep=gibbs.sweep_full,
                            n_iters=CKPT_SWEEPS,
                            start_iter=CKPT_SWEEPS).final_state
    _same(_fields(got), _fields(want), "resumed split checkpoint")


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_sweep_ranks_agree(ranks, one_process, n):
    """The port of tests/test_multiprocess.py::
    test_two_process_distributed_sweep, chains axis only: every rank prints
    the gathered sigma2 of one sweep of 8 chains, and all print the same,
    finite and positive."""
    outs = ranks[n][1]
    lines = [[ln for ln in out.splitlines() if ln.startswith("RESULT")]
             for out in outs]
    assert all(len(ln) == 1 for ln in lines), outs
    parts = [ln[0].split() for ln in lines]
    assert all(p[1] == str(n) for p in parts)
    sig = [np.array([float(x) for x in p[2:]]) for p in parts]
    for s in sig[1:]:
        np.testing.assert_array_equal(s, sig[0])
    assert sig[0].shape == (8,)
    assert np.isfinite(sig[0]).all() and (sig[0] > 0).all()


@pytest.mark.parametrize("case,error", [
    ("indivisible", "ValueError"),
    ("local_shape", "ValueError")])
def test_split_refusals(ranks, case, error):
    """On 2 ranks: 3 chains over 2 ranks, and a sweep of the whole ensemble
    under the split mesh, raise ValueError."""
    assert ranks[2][0]["refusals"][case] == error


def test_dryrun_multichip_two_ranks(capsys):
    """2 ranks, 2 chains each: the bits of one process (the reference
    census at 2 chains a rank takes the one-process sgemm kernels)."""
    dryrun.dryrun_multichip(2)
    assert "parity=bit-equal" in capsys.readouterr().out


def test_entry_is_one_production_sweep():
    step, (g, st) = dryrun.entry(device="cpu")
    out = step(g, st)
    assert out.nu.shape == (1, 3, 8) and out.Phi.shape == (1, 3, 8, 4)
    assert all(bool(torch.isfinite(getattr(out, f)).all())
               for f in STATE_FIELDS)


# ---------------------------------------------------------------------------
# the data axis: the N rows of the data, and of Z and chi, over the ranks of
# (1, 2), (2, 2) and (4, 2) meshes (the JAX test's 4 x 2,
# tests/test_checkpoint_parallel.py:58-80, on its data)

DATA_MESHES = [(1, 2), (2, 2), (4, 2)]
# the fields no rank holds by rows: equal bits on every rank of a data group
GLOBAL_FIELDS = [f for f in STATE_FIELDS if f not in ("Z", "chi")]
EXC_SWEEPS = 5
EXC_FLAGS = dict(n_temp_trans=2, N_t=2, beta_N_t=0.5)

_DATA_WORKER = textwrap.dedent('''
    import torch
    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.config import ModelConfig, Priors
    from bayesfmmm_torch.io.checkpoint import save_checkpoint
    from bayesfmmm_torch.models.state import STATE_FIELDS, init_state
    from bayesfmmm_torch.ops import distributions, gibbs
    from bayesfmmm_torch.parallel import mesh as pmesh
    from bayesfmmm_torch.parallel import tempering
    from bayesfmmm_torch.samplers import drivers
    from bayesfmmm_torch.utils.simulate import (simulate_functional,
                                                simulate_multivariate)

    GLOBAL = [f for f in STATE_FIELDS if f not in ("Z", "chi")]


    def cases():
        """name -> (data, config, sweep flags), the test module's own."""
        fn, _ = simulate_functional(seed=31, N=8, K=2, P=5, M=2,
                                    n_time=(10, 12), device="cpu")
        cov, _ = simulate_functional(seed=32, N=8, K=2, P=5, M=2, D=1,
                                     n_time=(10, 12), with_eta=True,
                                     with_xi=True, device="cpu")
        mv, _ = simulate_multivariate(seed=33, N=8, K=2, P=4, M=2,
                                      device="cpu")
        base = ModelConfig(K=2, P=5, M=2)
        covariate = dict(covariate_mean=True, covariate_cov=True)
        return {
            "reference": (fn, base, {}),
            "production": (fn, base, PRODUCTION_FLAGS),
            "covariate": (cov, ModelConfig(K=2, P=5, M=2, D=1, **covariate),
                          {**PRODUCTION_FLAGS, **covariate}),
            "multivariate": (mv, ModelConfig(K=2, P=4, M=2),
                             PRODUCTION_FLAGS)}


    def start(data, cfg, chains, seed=0):
        """chains chains from init_state, eta and xi away from zero."""
        st = init_state(torch.Generator().manual_seed(seed), cfg, data,
                        chains=chains)
        g = torch.Generator().manual_seed(seed + 100)
        return st.replace(
            eta=torch.randn(st.eta.shape, generator=g),
            xi=0.5 * torch.randn(st.xi.shape, generator=g))


    def whole(mesh, st):
        g = pmesh.gather_chain_states(st, mesh)
        return {f: getattr(g, f) for f in STATE_FIELDS}


    def mala(data, st):
        s, a, ur, rr0, U_xi = gibbs._phi_move_terms(st, data, 0.7)
        pri = torch.cumprod(st.delta, 2)[:, :, None, :] * st.gamma
        return gibbs._mala_value_and_grad(st.Phi, st.Z, data, s, ur, rr0,
                                          pri, U_xi)


    def refused(fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            return type(e).__name__
        return "nothing"


    def main(out, ckpt, chains, rows, twin):
        mesh = pmesh.make_mesh(n_chain_shards=chains, n_data_shards=rows,
                               devices="cpu")
        res = {"shape": [mesh.shape["chains"], mesh.shape["data"]],
               "coords": [mesh.coords["chains"], mesh.coords["data"]]}
        hp = Priors()
        for name, (data, cfg, flags) in cases().items():
            c = torch.full((cfg.K,), 10.0)
            sdata = pmesh.shard_data(data, mesh)
            res["rows_" + name] = [sdata.N, sdata.N_whole]
            local = pmesh.shard_chain_states(start(data, cfg, 4), mesh)
            with mesh:
                new = gibbs.sweep_full(torch.Generator().manual_seed(1),
                                       local, sdata, hp, c, **flags)
                if name == "covariate":
                    pot, grad = mala(sdata, local)
                    res["mala"] = [mesh.gather(pot), mesh.gather(grad)]
            res["sweep_" + name] = whole(mesh, new)
            res["global_" + name] = {f: getattr(new, f) for f in GLOBAL}

        data, cfg, _ = cases()["reference"]
        sdata = pmesh.shard_data(data, mesh)
        c = torch.full((2,), 10.0)
        # parallel tempering: 8 replicas, 5 rounds, every swap kept
        perms, swap = [], tempering.swap_phase

        def spy(E, ladder, parity, u):
            perm, acc, att = swap(E, ladder, parity, u)
            perms.append(perm.tolist())
            return perm, acc, att

        tempering.swap_phase = spy
        local = pmesh.shard_chain_states(
            init_state(torch.Generator().manual_seed(11), cfg, data,
                       chains=8), mesh)
        with mesh:
            cold, pt, rate = tempering.run_parallel_tempering(
                torch.Generator().manual_seed(12), local, sdata, hp, c,
                n_rounds=5, beta_min=0.4)
        tempering.swap_phase = swap
        res["pt"] = {"cold": {f: getattr(cold, f) for f in STATE_FIELDS},
                     "final": whole(mesh, pt.states), "perms": perms,
                     "counts": [pt.swap_accepts, pt.swap_attempts],
                     "rate": rate}

        # the production census with tempered excursions, checkpointed
        local = pmesh.shard_chain_states(
            init_state(torch.Generator().manual_seed(5), cfg, data,
                       chains=4), mesh)
        g = torch.Generator().manual_seed(6)
        with mesh:
            r = drivers.phase_warm_start(
                g, local, sdata, hp, c, n_iters=EXC_SWEEPS,
                **EXC_FLAGS, **PRODUCTION_FLAGS)
            save_checkpoint(ckpt, r.final_state, g, iteration=EXC_SWEEPS,
                            config=cfg)
        res["excursion"] = {"loglik": mesh.gather(r.loglik),
                            "accept": mesh.gather(r.tt_accept)}

        if twin:
            # the port of tests/test_multiprocess.py: every rank prints the
            # gathered sigma2 of one sweep of 8 chains
            local = pmesh.shard_chain_states(
                init_state(torch.Generator().manual_seed(0), cfg, data,
                           chains=8), mesh)
            with mesh:
                new = gibbs.sweep_full(torch.Generator().manual_seed(1),
                                       local, sdata, hp, c)
            sig = mesh.gather(new.sigma2)
            print("RESULT", mesh.size, " ".join(
                float(v).hex() for v in sig.tolist()), flush=True)

        if (chains, rows) == (1, 2):
            odd, _ = simulate_functional(seed=31, N=7, K=2, P=5, M=2,
                                         n_time=(10, 12), device="cpu")

            def whole_rows():
                with mesh:
                    distributions.normal(torch.Generator(), (8, 8),
                                         dtype=torch.float32, device="cpu",
                                         data_dim=1)

            def graph():
                with mesh:
                    pmesh.data_sum(torch.ones(3, requires_grad=True))

            res["refusals"] = {
                "indivisible_rows": refused(
                    lambda: pmesh.shard_data(odd, mesh)),
                "whole_rows": refused(whole_rows),
                "gradient": refused(graph)}
        torch.save(res, f"{out}.{mesh.rank}")
''')


def _data_run(tmp_path_factory, c, d):
    tmp = tmp_path_factory.mktemp(f"data{c}x{d}")
    worker = tmp / "worker.py"
    worker.write_text(_DATA_WORKER.replace(
        "EXC_SWEEPS", str(EXC_SWEEPS)).replace(
        "**EXC_FLAGS", ", ".join(f"{k}={v!r}" for k, v in EXC_FLAGS.items())))
    out, ckpt = tmp / "rank", tmp / "ckpt"
    outs = dryrun.run_ranks(c * d, f"{worker}:main",
                            {"out": str(out), "ckpt": str(ckpt), "chains": c,
                             "rows": d, "twin": (c, d) != (4, 2)},
                            timeout=150)
    return [torch.load(f"{out}.{r}") for r in range(c * d)], outs, ckpt


@pytest.fixture(scope="module")
def data_ranks(tmp_path_factory):
    return {cd: _data_run(tmp_path_factory, *cd) for cd in DATA_MESHES}


def _data_cases():
    """The worker's cases, in this process: name -> (data, config,
    flags)."""
    from bayesfmmm_torch.utils.simulate import simulate_multivariate

    fn, _ = simulate_functional(seed=31, N=8, K=2, P=5, M=2,
                                n_time=(10, 12), device="cpu")
    cov, _ = simulate_functional(seed=32, N=8, K=2, P=5, M=2, D=1,
                                 n_time=(10, 12), with_eta=True,
                                 with_xi=True, device="cpu")
    mv, _ = simulate_multivariate(seed=33, N=8, K=2, P=4, M=2, device="cpu")
    base = ModelConfig(K=2, P=5, M=2)
    covariate = dict(covariate_mean=True, covariate_cov=True)
    return {
        "reference": (fn, base, {}),
        "production": (fn, base, PRODUCTION_FLAGS),
        "covariate": (cov, ModelConfig(K=2, P=5, M=2, D=1, **covariate),
                      {**PRODUCTION_FLAGS, **covariate}),
        "multivariate": (mv, ModelConfig(K=2, P=4, M=2), PRODUCTION_FLAGS)}


def _start(data, cfg, chains, seed=0):
    st = init_state(torch.Generator().manual_seed(seed), cfg, data,
                    chains=chains)
    g = torch.Generator().manual_seed(seed + 100)
    return st.replace(eta=torch.randn(st.eta.shape, generator=g),
                      xi=0.5 * torch.randn(st.xi.shape, generator=g))


@pytest.fixture(scope="module")
def data_one_process(tmp_path_factory):
    """The data worker's programs in this process, unsplit."""
    res, hp = {}, Priors()
    for name, (data, cfg, flags) in _data_cases().items():
        st = _start(data, cfg, 4)
        res["sweep_" + name] = _fields(gibbs.sweep_full(
            torch.Generator().manual_seed(1), st, data, hp,
            torch.full((cfg.K,), 10.0), **flags))
        if name == "covariate":
            s, a, ur, rr0, U_xi = gibbs._phi_move_terms(st, data, 0.7)
            pri = torch.cumprod(st.delta, 2)[:, :, None, :] * st.gamma
            res["mala"] = gibbs._mala_value_and_grad(
                st.Phi, st.Z, data, s, ur, rr0, pri, U_xi)
    data, cfg, _ = _data_cases()["reference"]
    c = torch.full((2,), 10.0)
    perms, swap = [], tempering.swap_phase

    def spy(E, ladder, parity, u):
        perm, acc, att = swap(E, ladder, parity, u)
        perms.append(perm.tolist())
        return perm, acc, att

    tempering.swap_phase = spy
    try:
        cold, pt, rate = tempering.run_parallel_tempering(
            torch.Generator().manual_seed(12),
            init_state(torch.Generator().manual_seed(11), cfg, data,
                       chains=8), data, hp, c, n_rounds=5, beta_min=0.4)
    finally:
        tempering.swap_phase = swap
    res["pt"] = {"cold": _fields(cold), "final": _fields(pt.states),
                 "perms": perms, "counts": [pt.swap_accepts,
                                            pt.swap_attempts], "rate": rate}
    g = torch.Generator().manual_seed(6)
    r = drivers.phase_warm_start(
        g, init_state(torch.Generator().manual_seed(5), cfg, data, chains=4),
        data, hp, c, n_iters=EXC_SWEEPS, **EXC_FLAGS, **PRODUCTION_FLAGS)
    ckpt = tmp_path_factory.mktemp("one") / "ckpt"
    save_checkpoint(ckpt, r.final_state, g, iteration=EXC_SWEEPS, config=cfg)
    res["excursion"] = {"loglik": r.loglik, "accept": r.tt_accept,
                        "ckpt": ckpt}
    res["twin"] = gibbs.sweep_full(
        torch.Generator().manual_seed(1),
        init_state(torch.Generator().manual_seed(0), cfg, data, chains=8),
        data, hp, c).sigma2
    return res


@pytest.mark.parametrize("cd", DATA_MESHES)
@pytest.mark.parametrize("census", ["reference", "production", "covariate",
                                    "multivariate"])
def test_data_split_sweep_matches_one_process(data_ranks, data_one_process,
                                              census, cd):
    """One sweep_full of 4 chains with the 8 rows over the data axis: every
    field (Z's and chi's rows gathered) within the JAX test's atol of one
    process, in both censuses, the covariate model (eta and xi) and the
    multivariate family; every rank of a data group holds the same bits of
    every global field."""
    per_rank = data_ranks[cd][0]
    c, d = cd
    for r, res in enumerate(per_rank):
        assert res["shape"] == [c, d]
        assert res["rows_" + census] == [8 // d, 8]
        _same(res["sweep_" + census], data_one_process["sweep_" + census],
              f"{census} sweep over {cd}, rank {r}", ATOL)
        first = per_rank[r - res["coords"][1]]
        _same(res["global_" + census], first["global_" + census],
              f"{census}: rank {r} against its data group's first")


@pytest.mark.parametrize("cd", DATA_MESHES)
def test_data_split_mala_gradient_matches_one_process(data_ranks,
                                                      data_one_process, cd):
    """MALA's potential and its gradient in Phi (the covariate model, U_xi
    non-zero), with the likelihood's row sums over the data axis: the
    one-process value and gradient to float32 rounding, equal on every
    rank of a data group; no part of the gradient is dropped."""
    want_pot, want_grad = data_one_process["mala"]
    per_rank = data_ranks[cd][0]
    for res in per_rank:
        pot, grad = res["mala"]
        scale = float(want_grad.abs().max())
        assert float((grad - want_grad).abs().max()) <= 1e-5 * scale
        assert float((pot - want_pot).abs().max()) <= \
            1e-5 * float(want_pot.abs().max())
        first = per_rank[per_rank.index(res) - res["coords"][1]]
        assert torch.equal(grad, first["mala"][1])


@pytest.mark.parametrize("cd", DATA_MESHES)
def test_data_split_pt_matches_one_process(data_ranks, data_one_process, cd):
    """8 replicas, 5 rounds at beta_min 0.4 with the rows split: every
    round's swap permutation, the counts and the rate are one process's;
    the cold trace (rows gathered) and the replicas within the atol, their
    global fields the same bits on every rank."""
    want = data_one_process["pt"]
    for res in data_ranks[cd][0]:
        got = res["pt"]
        assert got["perms"] == want["perms"]
        for a, b in zip(got["counts"], want["counts"]):
            assert torch.equal(a, b)
        assert torch.equal(got["rate"], want["rate"])
        _same(got["cold"], want["cold"], f"PT cold over {cd}", ATOL)
        _same(got["final"], want["final"], f"PT over {cd}", ATOL)
        first = data_ranks[cd][0][0]["pt"]
        for what in ("cold", "final"):
            _same({f: got[what][f] for f in GLOBAL_FIELDS},
                  {f: first[what][f] for f in GLOBAL_FIELDS},
                  f"PT {what}'s global fields against rank 0's")


@pytest.mark.parametrize("cd", DATA_MESHES)
def test_data_split_checkpoint_and_excursions(data_ranks, data_one_process,
                                              cd):
    """The production census with a tempered excursion every 2nd sweep, 5
    sweeps, then a checkpoint from every rank: the excursions' decisions
    are one process's and its loglik trace within 1e-5 of the trace's
    scale (its fields within the atol, a loglik sums ~100 points'
    terms of size ~n_obs log sigma2 / 2), the file is
    the one-process file (the whole ensemble within the atol, the same
    generator state, iteration and config), and both resume alike."""
    want = data_one_process["excursion"]
    for res in data_ranks[cd][0]:
        assert torch.equal(res["excursion"]["accept"], want["accept"])
        assert torch.equal(res["excursion"]["loglik"],
                           data_ranks[cd][0][0]["excursion"]["loglik"])
        scale = float(want["loglik"].abs().max())
        np.testing.assert_allclose(res["excursion"]["loglik"].numpy(),
                                   want["loglik"].numpy(), rtol=0,
                                   atol=1e-5 * scale)
    st, g, it, cfg = load_checkpoint(data_ranks[cd][2], "cpu")
    st1, g1, it1, cfg1 = load_checkpoint(want["ckpt"], "cpu")
    assert (it, cfg) == (it1, cfg1) == (EXC_SWEEPS, ModelConfig(K=2, P=5,
                                                                M=2))
    assert torch.equal(g.get_state(), g1.get_state())
    _same(_fields(st), _fields(st1), f"checkpoint over {cd}", ATOL)
    data, _, _ = _data_cases()["reference"]
    hp, c = Priors(), torch.full((2,), 10.0)
    a, b = (drivers.phase_warm_start(
        gen, s, data, hp, c, n_iters=2, start_iter=EXC_SWEEPS,
        **PRODUCTION_FLAGS).final_state for gen, s in ((g, st), (g1, st1)))
    _same(_fields(a), _fields(b), f"resumed checkpoint over {cd}", ATOL)


@pytest.mark.parametrize("cd", [(1, 2), (2, 2)])
def test_data_split_distributed_sweep_ranks_agree(data_ranks,
                                                  data_one_process, cd):
    """The port of tests/test_multiprocess.py::
    test_two_process_distributed_sweep with the data split: two ranks at
    (1, 2) and four at (2, 2) each print the gathered sigma2 of one sweep
    of 8 chains; every rank prints the same bits, and they lie within the
    atol of one process's."""
    outs = data_ranks[cd][1]
    lines = [[ln for ln in out.splitlines() if ln.startswith("RESULT")]
             for out in outs]
    assert all(len(ln) == 1 for ln in lines), outs
    parts = [ln[0].split() for ln in lines]
    assert all(p[1] == str(cd[0] * cd[1]) for p in parts)
    assert all(p[2:] == parts[0][2:] for p in parts)
    sig = np.array([float.fromhex(x) for x in parts[0][2:]])
    np.testing.assert_allclose(sig, data_one_process["twin"].numpy(),
                               atol=ATOL, rtol=0)
    assert sig.shape == (8,) and np.isfinite(sig).all() and (sig > 0).all()


@pytest.mark.parametrize("case,error", [
    ("indivisible_rows", "ValueError"), ("whole_rows", "ValueError"),
    ("gradient", "RuntimeError")])
def test_data_split_refusals(data_ranks, case, error):
    """Under a (1, 2) mesh: 7 rows over 2 data ranks, and a draw at the
    whole N's rows, raise ValueError; a data sum of a tensor that needs a
    gradient raises RuntimeError (it would drop the other ranks' part)."""
    for res in data_ranks[(1, 2)][0]:
        assert res["refusals"][case] == error


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("what", ["mean_rss", "weighted_gram"])
def test_row_block_partial_sums_match_pallas_kernels(what, d):
    """K2's and K3's plain versions over d blocks of the rows, added in
    block order as ``Mesh.sum_over_data`` adds them, against the JAX
    package's Pallas kernels on the whole data in interpret mode, within
    tests/test_pallas_kernels.py's tolerances (K3's absolute part scaled
    by N/21, as test_torch_kernels.py holds it)."""
    import functools

    import jax.numpy as jnp

    from bayesfmmm_torch.ops import kernels
    from bayesfmmm_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(40 + d)
    N = 12 * d
    if what == "mean_rss":
        L, P, C = 24, 6, 3
        B = rng.normal(size=(N, L, P)).astype(np.float32)
        y = rng.normal(size=(N, L)).astype(np.float32)
        w = rng.normal(size=(C, N, P)).astype(np.float32)
        blocks = [kernels.mean_rss(
            torch.from_numpy(B[i * 12:(i + 1) * 12]),
            torch.from_numpy(y[i * 12:(i + 1) * 12]),
            torch.from_numpy(w[:, i * 12:(i + 1) * 12].copy()))[0]
            for i in range(d)]
        got = functools.reduce(torch.add, blocks)
        for c in range(C):
            _, rss = pk.fused_mean_rss(jnp.asarray(B), jnp.asarray(w[c]),
                                       jnp.asarray(y), tile_n=4)
            np.testing.assert_allclose(float(got[c]), float(rss), rtol=1e-5)
    else:
        P, R = 8, 4
        G = rng.normal(size=(N, P, P)).astype(np.float32)
        W = rng.uniform(size=(R, N)).astype(np.float32)
        blocks = [kernels.weighted_gram(
            torch.from_numpy(W[:, i * 12:(i + 1) * 12].copy()),
            torch.from_numpy(G[i * 12:(i + 1) * 12])) for i in range(d)]
        got = functools.reduce(torch.add, blocks)
        for r in range(R):
            ref = np.asarray(pk.weighted_gram(jnp.asarray(G),
                                              jnp.asarray(W[r]), tile_n=8))
            np.testing.assert_allclose(got[r].numpy(), ref, rtol=2e-5,
                                       atol=2e-5 * N / 21)
