"""The captured sweep of samplers/drivers.py, on the CPU: when a run
replays a graph, the step the graph wraps, the key of the process's one
graph, and the driver's replay loop with the capture and the replay
stood in for by the step run eagerly.  The card's own capture is held to
the eager sweep in tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bayesfmmm_torch.api import PRODUCTION_FLAGS  # noqa: E402
from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import (  # noqa: E402
    STATE_FIELDS, GibbsState, init_state)
from bayesfmmm_torch.ops import gibbs  # noqa: E402
from bayesfmmm_torch.samplers import drivers  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402


def _model(C, D=0, seed=4, census="reference"):
    """(data, state, c, sweep flags) of a small functional model; the
    production census adds ``PRODUCTION_FLAGS`` to the flags."""
    data, _ = simulate_functional(seed=seed, N=12, K=2, P=5, M=2, D=D,
                                  n_time=(10, 14), with_eta=D > 0,
                                  with_xi=D > 0, device="cpu")
    cfg = ModelConfig(K=2, P=5, M=2, D=D, covariate_mean=D > 0,
                      covariate_cov=D > 0)
    st = init_state(torch.Generator().manual_seed(1), cfg, data, chains=C)
    flags = dict(covariate_mean=D > 0, covariate_cov=D > 0,
                 **(PRODUCTION_FLAGS if census == "production" else {}))
    return data, st, torch.full((2,), 10.0), flags


def _assert_same_state(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# When a run replays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,mesh,flags,n_temp_trans,want", [
    ("cuda", None, {}, 0, True),
    ("cuda:0", None, {"covariate_mean": True, "covariate_cov": True}, 0,
     True),
    ("cpu", None, {}, 0, False),
    ("cuda", object(), {}, 0, False),
    ("cuda", None, {}, 60, False),
    ("cuda", None, {"collapsed_z": False, "gauge": False, "hmc_steps": 0},
     0, True),
    ("cuda", None, PRODUCTION_FLAGS, 0, True),
    ("cuda", None, {"collapsed_z": True}, 0, True),
    ("cuda", None, {"gauge": True}, 0, True),
    ("cuda", None, {"phi_mala_steps": 4}, 0, True),
    ("cuda", None, {"z_anchor": True}, 0, False),
    ("cuda", None, {"phi_chi_moves": 2}, 0, False),
    ("cuda", None, {"hmc_steps": 2}, 0, False),
    ("cuda:0", None, dict(PRODUCTION_FLAGS, covariate_mean=True,
                          covariate_cov=True), 0, True),
    ("cpu", None, PRODUCTION_FLAGS, 0, False),
    ("cuda", object(), PRODUCTION_FLAGS, 0, False),
    ("cuda", None, PRODUCTION_FLAGS, 60, False),
    ("cuda", None, dict(PRODUCTION_FLAGS, z_anchor=True), 0, False),
    ("cuda", None, dict(PRODUCTION_FLAGS, phi_chi_moves=2), 0, False),
    ("cuda", None, dict(PRODUCTION_FLAGS, hmc_steps=2), 0, False),
])
def test_replays_either_census_on_cuda_without_default_off_switches(
        device, mesh, flags, n_temp_trans, want):
    """True only on CUDA, without a mesh, without excursions, for
    sweep_full of the reference or the production census (each production
    switch alone included); each default-off switch turns it off, alone or
    beside the production census."""
    assert drivers.replays_sweep(device, mesh, flags, n_temp_trans) is want


def test_phase_warm_start_decides_and_run_chain_stays_eager(monkeypatch):
    """phase_warm_start asks replays_sweep with the state's device, the
    active mesh, its sweep flags and n_temp_trans; run_chain, even of
    sweep_full, runs every iteration eagerly whatever the decision."""
    data, st, c, flags = _model(2)
    asked = []

    def decide(*a):
        asked.append(a)
        return False
    monkeypatch.setattr(drivers, "replays_sweep", decide)
    drivers.phase_warm_start(torch.Generator().manual_seed(0), st, data,
                             Priors(), c, n_iters=2, n_temp_trans=7, **flags)
    assert asked == [(st.Z.device, None, flags, 7)]
    monkeypatch.setattr(drivers, "replays_sweep", lambda *a: True)
    before = dict(drivers.SWEEP_GRAPHS)
    drivers.run_chain(torch.Generator().manual_seed(0), st, data, Priors(),
                      c, sweep=gibbs.sweep_full, n_iters=3)
    assert drivers.SWEEP_GRAPHS == dict(before, eager=before["eager"] + 3)


# ---------------------------------------------------------------------------
# The step a graph wraps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,D,census", [
    pytest.param(1, 0, "reference", id="1-0"),
    pytest.param(3, 0, "reference", id="3-0"),
    pytest.param(2, 1, "reference", id="2-1"),
    pytest.param(1, 0, "production", id="production-1-0"),
    pytest.param(3, 0, "production", id="production-3-0"),
    pytest.param(2, 1, "production", id="production-2-1")])
def test_buffered_step_gives_the_eager_bits(C, D, census):
    """The buffered step (beta a tensor of ones, the state updated in
    place) run eagerly n times gives the bits of n sweep_full +
    log_likelihood steps at the float beta 1, and the generator ends in
    the same state, in either census (the production one with its MALA
    gradient)."""
    data, st, c, flags = _model(C, D, census=census)
    hp = Priors()
    g_eager, g_buf = (torch.Generator().manual_seed(9) for _ in range(2))
    buf = drivers.SweepBuffers(
        GibbsState(**{f: getattr(st, f).clone() for f in STATE_FIELDS}),
        c.clone(), torch.ones(C), torch.empty(C))
    eager = st
    for _ in range(3):
        eager = gibbs.sweep_full(g_eager, eager, data, hp, c, **flags)
        ll = log_likelihood(eager, data)
        drivers.buffered_sweep(g_buf, buf, data, hp, flags)
        _assert_same_state(buf.state, eager)
        assert torch.equal(buf.loglik, ll)
    assert torch.equal(g_eager.get_state(), g_buf.get_state())


def test_graph_cache_key_hits_same_data_and_shapes_only(monkeypatch):
    """The same data object, priors, flags and shapes give one key; a new
    ModelData of equal values, another chain count, other flags, other
    priors, the TF32 switch turned, or a patched sweep give another."""
    data, st, c, flags = _model(2)
    hp = Priors()
    key = drivers.sweep_graph_key(data, hp, flags, st, c)
    _, st_b, c_b, _ = _model(2, seed=4)
    assert drivers.sweep_graph_key(data, Priors(), dict(flags), st_b,
                                   c_b) == key
    data_b, _, _, _ = _model(2)
    assert drivers.sweep_graph_key(data_b, hp, flags, st, c) != key
    _, st3, _, _ = _model(3)
    assert drivers.sweep_graph_key(data, hp, flags, st3, c) != key
    assert drivers.sweep_graph_key(data, hp, {"covariate_mean": True}, st,
                                   c) != key
    assert drivers.sweep_graph_key(data, Priors(b=5.0), flags, st, c) != key
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert drivers.sweep_graph_key(data, hp, flags, st, c) != key
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(gibbs, "sweep_full", lambda *a, **k: None)
    assert drivers.sweep_graph_key(data, hp, flags, st, c) != key


# ---------------------------------------------------------------------------
# The driver's replay loop, the capture stood in for by the eager step
# ---------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """run_chain takes its replay path on the CPU: the decision says yes,
    a capture records nothing, and a replay runs the buffered step; the
    process holds no graph."""
    monkeypatch.setattr(drivers, "replays_sweep", lambda *a: True)
    monkeypatch.setattr(drivers.SweepGraph, "_capture", lambda self: None)
    monkeypatch.setattr(drivers.SweepGraph, "replay", drivers.SweepGraph.step)
    monkeypatch.setattr(drivers, "_GRAPH", None)


def _eager(monkeypatch, fn):
    """``fn()`` with run_chain on its eager loop."""
    with monkeypatch.context() as m:
        m.setattr(drivers, "replays_sweep", lambda *a: False)
        return fn()


def _assert_same_run(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(a.traces[f], b.traces[f]), f
    assert torch.equal(a.loglik, b.loglik)
    _assert_same_state(a.final_state, b.final_state)


@pytest.mark.parametrize("C,thin,census", [
    pytest.param(1, 1, "reference", id="1-1"),
    pytest.param(3, 1, "reference", id="3-1"),
    pytest.param(3, 2, "reference", id="3-2"),
    pytest.param(1, 1, "production", id="production-1-1"),
    pytest.param(3, 2, "production", id="production-3-2")])
def test_replayed_run_gives_the_eager_bits(stand_in, monkeypatch, C, thin,
                                           census):
    """A run through the replay loop gives the eager run's traces,
    log-likelihoods, final state and generator state, in either census;
    the first run warms up and captures once, the second replays every
    sweep from the cache."""
    data, st, c, flags = _model(C, census=census)
    hp = Priors()

    def run(g, state):
        return drivers.phase_warm_start(g, state, data, hp, c, n_iters=6,
                                        thin=thin, **flags)

    g_e, g_r = (torch.Generator().manual_seed(5) for _ in range(2))
    want = _eager(monkeypatch, lambda: run(g_e, st))
    g_want = g_e.get_state()
    want2 = _eager(monkeypatch, lambda: run(g_e, want.final_state))
    before = dict(drivers.SWEEP_GRAPHS)
    got = run(g_r, st)
    counts = {k: drivers.SWEEP_GRAPHS[k] - before[k] for k in before}
    assert counts == {"captures": 1, "replays": 6 - drivers.WARMUP_SWEEPS,
                      "eager": drivers.WARMUP_SWEEPS}
    _assert_same_run(got, want)
    assert torch.equal(g_r.get_state(), g_want)
    got2 = run(g_r, got.final_state)
    assert drivers.SWEEP_GRAPHS["captures"] == before["captures"] + 1
    assert drivers.SWEEP_GRAPHS["replays"] == \
        before["replays"] + 12 - drivers.WARMUP_SWEEPS
    _assert_same_run(got2, want2)
    assert torch.equal(g_r.get_state(), g_e.get_state())
    assert got.traces["Z"].shape == (C, 6 // thin) + st.Z.shape[1:]
    # the final state is the run's own, not the graph's buffers
    graph = drivers._GRAPH
    assert got2.final_state.Z.data_ptr() != graph.buf.state.Z.data_ptr()


def test_replayed_run_follows_annealed_betas(stand_in, monkeypatch):
    """Per-sweep temperatures reach the graph's beta buffer: the run gives
    the eager run's bits at each float."""
    data, st, c, flags = _model(2)
    betas = [0.25, 0.25, 0.5, 0.75, 1.0, 1.0]

    def run():
        return drivers.phase_warm_start(torch.Generator().manual_seed(2), st,
                                        data, Priors(), c, n_iters=6,
                                        betas=betas, **flags)

    _assert_same_run(run(), _eager(monkeypatch, run))


def test_replayed_runs_split_equal_the_unbroken_run(stand_in, monkeypatch):
    """Two runs of 5 sweeps, the second continuing the first's state and
    generator, give the bits of one eager run of 10."""
    data, st, c, flags = _model(2)
    g = torch.Generator().manual_seed(8)
    first = drivers.phase_warm_start(g, st, data, Priors(), c, n_iters=5,
                                     **flags)
    rest = drivers.phase_warm_start(g, first.final_state, data, Priors(), c,
                                    n_iters=5, **flags)
    g_w = torch.Generator().manual_seed(8)
    whole = _eager(monkeypatch, lambda: drivers.phase_warm_start(
        g_w, st, data, Priors(), c, n_iters=10, **flags))
    assert torch.equal(torch.cat([first.loglik, rest.loglik], 1),
                       whole.loglik)
    for f in STATE_FIELDS:
        assert torch.equal(torch.cat([first.traces[f], rest.traces[f]], 1),
                           whole.traces[f]), f
    _assert_same_state(rest.final_state, whole.final_state)
    assert torch.equal(g.get_state(), g_w.get_state())


def test_a_new_key_captures_in_place_of_the_held_graph(stand_in):
    """The process holds one graph: a run on other data captures its own
    in its place, and a run on the first data again captures anew."""
    hp = Priors()
    (da, sa, ca, fa), (db, sb, cb, fb) = _model(1, seed=0), _model(1, seed=1)
    g = torch.Generator().manual_seed(0)
    before = drivers.SWEEP_GRAPHS["captures"]
    for data, st, c, flags in ((da, sa, ca, fa), (da, sa, ca, fa),
                               (db, sb, cb, fb), (da, sa, ca, fa)):
        drivers.phase_warm_start(g, st, data, hp, c, n_iters=2, **flags)
    assert drivers.SWEEP_GRAPHS["captures"] == before + 3
    assert drivers._GRAPH.data is da


def test_each_census_captures_its_own_graph(stand_in, monkeypatch):
    """On one data object the reference census, then the production
    census, then the reference again: the flags are in the key, so each
    run captures its own graph in place of the other's, and each gives
    its eager run's bits and generator state."""
    data, st, c, ref = _model(2)
    hp = Priors()
    g = torch.Generator().manual_seed(3)
    before = drivers.SWEEP_GRAPHS["captures"]
    for flags in (ref, dict(ref, **PRODUCTION_FLAGS), ref):
        g_e = torch.Generator()
        g_e.set_state(g.get_state())
        want = _eager(monkeypatch, lambda: drivers.phase_warm_start(
            g_e, st, data, hp, c, n_iters=3, **flags))
        got = drivers.phase_warm_start(g, st, data, hp, c, n_iters=3,
                                       **flags)
        _assert_same_run(got, want)
        assert torch.equal(g.get_state(), g_e.get_state())
        assert drivers._GRAPH.flags == flags
    assert drivers.SWEEP_GRAPHS["captures"] == before + 3


def test_eager_runs_count_their_iterations():
    """On the CPU every iteration runs eagerly and is counted; nothing is
    captured or replayed."""
    data, st, c, flags = _model(2)
    before = dict(drivers.SWEEP_GRAPHS)
    drivers.phase_warm_start(torch.Generator().manual_seed(0), st, data,
                             Priors(), c, n_iters=4, **flags)
    assert drivers.SWEEP_GRAPHS == dict(before, eager=before["eager"] + 4)
