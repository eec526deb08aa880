"""The port's spans (utils/observability.py) on the CPU: nothing recorded
with the profiler off, the same draws with it on, the tree of spans a
warm-start fit records, their clock against the profiler's, the bytes
counted, and the decorated functions unchanged to their callers."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from bayesfmmm_torch import api  # noqa: E402
from bayesfmmm_torch.models import likelihood  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.ops import gibbs, mean  # noqa: E402
from bayesfmmm_torch.samplers import drivers  # noqa: E402
from bayesfmmm_torch.utils import observability as obs  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

# the sweeps' updaters in sweep order, each its own span under the sweep's
CENSUS = {
    "reference": ["ops.mean.build_cache"] + [
        "ops.gibbs." + n for n in (
            "update_z", "update_pi", "update_alpha3", "update_phi",
            "update_delta", "update_a", "update_gamma", "update_nu",
            "update_tau", "update_sigma", "update_chi")],
    "production": ["ops.mean.build_cache"] + [
        "ops.gibbs." + n for n in (
            "update_z_chi", "update_pi", "update_alpha3", "update_phi",
            "update_delta", "update_a", "update_gamma", "update_nu",
            "update_tau", "update_sigma", "update_chi_joint",
            "update_gauge")] + ["ops.mean.build_cache"] + [
        "ops.gibbs." + n for n in (
            "update_mgp_scale", "update_noise_scale", "update_phi_mala")],
}
# 100 iterations in 2 chunks of 50; excursions of 2 N_t = 4 rungs at
# iterations 40 and 80
WARM = dict(tot_mcmc_iters=100, progress_every=50, n_chains=3,
            n_temp_trans=40, N_t=2, beta_N_t=0.5, progress=False, seed=7)
SWEEPS = 98 + 2 * 4

TRACED = (
    [(gibbs, n) for n in (
        "update_z", "update_pi", "update_alpha3", "update_nu", "update_eta",
        "update_phi", "update_xi", "update_chi", "update_sigma", "update_tau",
        "update_tau_eta", "update_delta", "update_delta_xi", "update_gamma",
        "update_gamma_xi", "update_a", "update_a_xi", "update_z_chi",
        "update_chi_joint", "update_gauge", "update_mgp_scale",
        "update_noise_scale", "update_phi_chi", "update_phi_mala",
        "update_hmc_joint", "sweep_nu_z", "sweep_theta", "sweep_full")]
    + [(mean, "build_cache"), (likelihood, "log_likelihood"),
       (drivers, "tempered_excursion")]
    + [(api, n) for n in ("fit_nu_z", "fit_theta", "fit_warm_start",
                          "fit_pt", "fit_smc", "fit_hmc", "fit_advi_init")])


@pytest.fixture(scope="module")
def phases():
    data, _ = simulate_functional(seed=5, N=8, K=2, P=5, M=2,
                                  n_time=(8, 10), device="cpu")
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, n_try=2,
                      seed=0)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, n_try=2, seed=1)
    return r1, r2


def _profiled(fn):
    """fn() under torch.profiler on the host; (its result, the spans it
    recorded, the profiler)."""
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = obs.recorded_spans()
    obs.clear_spans()
    return out, spans, prof


def _warm(phases, kernels, path):
    return api.fit_warm_start(*phases, kernels=kernels, checkpoint_to=path,
                              **WARM)


def test_nothing_is_recorded_with_the_profiler_off(phases, tmp_path):
    obs.clear_spans()
    assert obs.span("x") is obs.span("y", bytes=1)     # one inert object
    with obs.span("x") as s:
        s.set(bytes=1)
    _warm(phases, "production", str(tmp_path / "a.npz"))
    assert obs.recorded_spans() == [] and obs.dropped_spans() == 0


@pytest.mark.parametrize("kernels", ["reference", "production"])
def test_the_same_bits_with_the_profiler_on_and_off(phases, tmp_path,
                                                    kernels):
    off = _warm(phases, kernels, str(tmp_path / "off.npz"))
    on, spans, _ = _profiled(
        lambda: _warm(phases, kernels, str(tmp_path / "on.npz")))
    assert spans
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(on.traces[f], off.traces[f])
        assert torch.equal(getattr(on.ensemble_state, f),
                           getattr(off.ensemble_state, f))
    np.testing.assert_array_equal(on.all_chain_loglik, off.all_chain_loglik)
    np.testing.assert_array_equal(on.tt_accept, off.tt_accept)
    with np.load(tmp_path / "on.npz") as a, np.load(tmp_path / "off.npz") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kernels", ["reference", "production"])
def test_a_warm_start_records_its_tree_of_spans(phases, tmp_path, kernels):
    path = str(tmp_path / "ck.npz")
    res, spans, _ = _profiled(lambda: _warm(phases, kernels, path))
    names = [s.name for s in spans]
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns
               for s in spans)
    assert names.count("api.fit_warm_start") == 1
    fit = names.index("api.fit_warm_start")
    assert all(s.call == fit for s in spans)              # one call id
    assert spans[fit].parent == -1

    def children(i):
        return [j for j, s in enumerate(spans) if s.parent == i]

    def named(idx):
        return [spans[j].name for j in idx]

    runs = [j for j in children(fit)
            if names[j] == "samplers.drivers.run_chain"]
    assert [spans[j].counts for j in runs] == [{"sweeps": 50}] * 2
    assert named(children(fit)) == [
        "samplers.drivers.run_chain", "api.host_copy"] * 2 + [
        "io.checkpoint.save"]
    sweeps = [j for j, n in enumerate(names) if n == "ops.gibbs.sweep_full"]
    assert len(sweeps) == SWEEPS
    excursions = [j for j, n in enumerate(names)
                  if n == "samplers.drivers.tempered_excursion"]
    assert len(excursions) == 2
    for j in excursions:
        assert spans[j].parent in runs
        assert named(children(j)) == ["ops.gibbs.sweep_full"] * 4
    for j in sweeps:
        assert spans[j].parent in runs + excursions
        assert named(children(j)) == CENSUS[kernels]
        for k in children(j):
            assert spans[j].start_ns <= spans[k].start_ns \
                <= spans[k].end_ns <= spans[j].end_ns
    for r in runs:
        below = named(children(r))
        assert below.count("models.likelihood.log_likelihood") == 50
        assert below[-1] == "samplers.drivers.stack_traces"
        assert below.count("ops.gibbs.sweep_full") + below.count(
            "samplers.drivers.tempered_excursion") == 50
    assert sum(s.counts.get("bytes", 0) for s in spans
               if s.name == "io.checkpoint.save") == \
        (tmp_path / "ck.npz").stat().st_size

    # a resumed call loads the checkpoint inside its own fit span
    _, spans, _ = _profiled(lambda: api.fit_warm_start(
        resume_from=path, data=phases[1].data, kernels=kernels,
        tot_mcmc_iters=100, progress=False))
    load = [s for s in spans if s.name == "io.checkpoint.load"]
    assert len(load) == 1 and load[0].parent == load[0].call == 0
    assert load[0].counts == {"bytes": (tmp_path / "ck.npz").stat().st_size}


def test_host_copies_count_the_bytes_returned(phases, tmp_path):
    res, spans, _ = _profiled(
        lambda: _warm(phases, "reference", str(tmp_path / "c.npz")))
    copied = sum(s.counts["bytes"] for s in spans
                 if s.name == "api.host_copy")
    C = WARM["n_chains"]
    assert copied == (res.all_chain_loglik.nbytes + res.tt_accept.nbytes
                      + C * sum(a.nbytes for a in res.traces.values()))


def test_parallel_tempering_records_its_swap_phases(phases):
    with pytest.warns(UserWarning, match="swap rate") as caught:
        res, spans, _ = _profiled(lambda: api.fit_pt(
            *phases, tot_mcmc_iters=100, n_replicas=2, ladder="geometric",
            seed=3))
    # the warning names the caller's line, not the span's wrapper
    assert caught[0].filename == __file__
    names = [s.name for s in spans]
    assert names[0] == "api.fit_pt" and names.count("api.fit_pt") == 1
    swaps = [s for s in spans if s.name == "parallel.tempering.swap"]
    assert len(swaps) == 100 and all(s.call == 0 for s in swaps)
    assert names.count("ops.gibbs.sweep_full") == 100
    copied = sum(s.counts["bytes"] for s in spans
                 if s.name == "api.host_copy")
    assert copied == res.loglik.nbytes + sum(
        a.nbytes for a in res.traces.values())


def test_a_range_inside_a_span_lies_inside_it_on_the_profilers_clock():
    """The spans' clock is the profiler's: a record_function range opened
    inside a span starts and ends inside it, within 1 ms, on the
    profiler's timeline, and a span inside a range lies inside the
    range."""
    def work():
        with obs.span("test.outer"):
            with record_function("test.range"):
                torch.ones(64).cumsum(0).sum()
                with obs.span("test.inner"):
                    torch.ones(64).sum()

    _, spans, prof = _profiled(work)
    outer, inner = spans
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "test.range"]
    assert len(ev) == 1
    r0, r1 = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    ms = 1_000_000
    assert outer.start_ns - ms <= r0 <= r1 <= outer.end_ns + ms
    assert r0 - ms <= inner.start_ns <= inner.end_ns <= r1 + ms
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_the_list_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(obs, "MAX_SPANS", 3)

    def work():
        with obs.span("a"):
            for _ in range(4):
                with obs.span("b"):
                    pass
        assert obs.dropped_spans() == 2

    _, spans, _ = _profiled(work)
    assert [s.name for s in spans] == ["a", "b", "b"]
    assert [s.parent for s in spans] == [-1, 0, 0]
    assert obs.dropped_spans() == 0                    # cleared


def test_spans_open_across_a_clear_are_not_recorded():
    def work():
        with obs.span("api.fit_a"):
            obs.clear_spans()
            with obs.span("b"):
                pass

    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    spans = obs.recorded_spans()
    obs.clear_spans()
    assert spans == [obs.Span("b", spans[0].start_ns, spans[0].end_ns, -1,
                              -1, {})]


@pytest.mark.parametrize("module,name", TRACED,
                         ids=[f"{m.__name__.split('.', 1)[1]}.{n}"
                              for m, n in TRACED])
def test_a_traced_function_keeps_its_name_and_signature(module, name):
    fn = getattr(module, name)
    assert fn.__name__ == name and fn.__module__ == module.__name__
    assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
    assert fn.__doc__ == fn.__wrapped__.__doc__


def test_the_sweep_looks_its_updaters_up_by_name(phases, monkeypatch):
    """A test can still replace an updater: the sweep calls the module's
    attribute."""
    r1, r2 = phases
    seen = []
    real = gibbs.update_pi

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(gibbs, "update_pi", spy)
    res = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, progress=False)
    assert len(seen) == 100 and res.loglik.shape == (100,)
