"""The port's rank mesh (``bayesfmmm_torch/parallel/mesh.py``) on the CPU
under gloo: the chains of a sweep, of parallel tempering and of a
checkpoint split over 2 and 4 ranks give the one-process run's draws.

Each multi-rank case runs in ranks started by ``dryrun.run_ranks`` (a
``file://`` store in a temporary directory, 120 s for all ranks, killed
and failed past it); one start of 2 ranks and one of 4 serve every case,
and the first rank saves what the cases read.  Sizes are the JAX tests'
``_small`` (tests/test_checkpoint_parallel.py:17-21).

Where the CPU's float32 products take another summation order at another
chain count (MKL's sgemm picks its kernel by the matrix's shape, and the
einsums that meet a data tensor shared by every chain put the chain axis
into that shape), a split run cannot give the one-process bits; those
cases hold the JAX test's own ``atol=2e-4`` and say so.
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
from bayesfmmm_torch.io.checkpoint import load_checkpoint  # noqa: E402
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
        except (ValueError, NotImplementedError) as e:
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

            split_data = pmesh.make_mesh(n_chain_shards=1, n_data_shards=2,
                                         devices="cpu")

            def enter_split_data():
                with split_data:
                    pass

            def unported(module, name, n_args):
                def run():
                    with mesh:
                        getattr(module, name)(*[None] * n_args)
                return run

            from bayesfmmm_torch.samplers import advi, hmc, nuts, smc
            res["refusals"] = {
                **{name: refused(unported(module, name, n_args))
                   for module, name, n_args in (
                       (smc, "run_smc", 5), (hmc, "run_hmc", 3),
                       (nuts, "run_nuts", 3), (advi, "run_advi", 3))},
                "shard_data": refused(
                    lambda: pmesh.shard_data(data, split_data)),
                "data_sharding": refused(
                    lambda: pmesh.data_sharding(split_data)),
                "with": refused(enter_split_data),
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
    ("shard_data", "NotImplementedError"),
    ("data_sharding", "NotImplementedError"),
    ("with", "NotImplementedError"),
    ("indivisible", "ValueError"),
    ("local_shape", "ValueError"),
    ("run_smc", "NotImplementedError"), ("run_hmc", "NotImplementedError"),
    ("run_nuts", "NotImplementedError"),
    ("run_advi", "NotImplementedError")])
def test_split_refusals(ranks, case, error):
    """On 2 ranks: a data axis of 2 (shard_data, data_sharding and entering
    the mesh) raises NotImplementedError; 3 chains over 2 ranks, and a
    sweep of the whole ensemble under the split mesh, raise ValueError; the
    samplers not ported to a split mesh (SMC, HMC, NUTS, ADVI) raise
    NotImplementedError under it."""
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
