"""The readers of the program's spans (``spans.py``, ``api_self_pct``,
``driver_self_pct``, ``host_syncs_per_sweep``): on a made-up slice, where
each number is known; on a program that records no spans, where each reads
None; and in a traced run of every cell on the CPU."""

import pytest

from portbench import spec
from portbench import spans as sp
from portbench.tests.conftest import ROOT, full_root, run_small
from portbench.trace import Event

# the cells of BENCHMARK.json and the headline cell kept as files
CELLS = [w["name"] for w in spec.load_benchmark(full_root())["workloads"]]
READERS = ("api_self_pct", "driver_self_pct", "host_syncs_per_sweep")
SWEEP = "ops.gibbs.sweep_full"


class _Slice:
    def __init__(self, t0, t1, host):
        self.t0, self.t1, self.host = t0, t1, host


class _Ctx:
    def __init__(self, slice_):
        self.slice, self.slice_call = slice_, {"sweeps": 2}


def _fake_program(monkeypatch, spans):
    from bayesfmmm_torch.utils import observability as obs
    made = [obs.Span(n, s, e, -1, -1, {}) for n, s, e in spans]
    monkeypatch.setattr(obs, "recorded_spans", lambda: made)


# one fit of 1,000 ns: a chain run over [100, 900) holding two sweeps of
# 200 ns and an excursion of 100; a span of an earlier profiled call
PROGRAM = [("api.fit_warm_start", 0, 1000),
           ("samplers.drivers.run_chain", 100, 900),
           (SWEEP, 150, 350), (SWEEP, 400, 600),
           ("samplers.drivers.tempered_excursion", 650, 750),
           (SWEEP, 660, 700),
           ("api.fit_warm_start", -5000, -4000)]


def test_the_readers_on_a_made_up_slice(monkeypatch):
    _fake_program(monkeypatch, PROGRAM)
    host = [Event("cudaLaunchKernel", "cuda_runtime", 160, 161),
            Event("cudaStreamSynchronize", "cuda_runtime", 500, 510),
            Event("cudaMemcpy", "cuda_runtime", 670, 680),
            Event("cudaMemcpyAsync", "cuda_runtime", 420, 430),
            Event("cudaDeviceSynchronize", "cuda_runtime", 950, 990)]
    ctx = _Ctx(_Slice(0, 1000, host))
    got = {m: spec.load_reader(m, ROOT).read(ctx) for m in READERS}
    # api: 1,000 - 800 of chain run; driver: 800 - (400 + 100) in sweeps
    # and the excursion; syncs: two of three start inside the 3 sweeps
    assert got == {"api_self_pct": 20.0, "driver_self_pct": 30.0,
                   "host_syncs_per_sweep": 2 / 3}


def test_spans_are_cut_to_the_slice(monkeypatch):
    _fake_program(monkeypatch, PROGRAM)
    spans = sp.of_slice(_Slice(100, 500, []))
    assert ("api.fit_warm_start", 100, 500) in spans
    assert (SWEEP, 400, 500) in spans
    assert all(s >= 100 and e <= 500 for _, s, e in spans)
    assert sp.of_slice(_Slice(2000, 3000, [])) is None


def test_no_cuda_runtime_no_syncs(monkeypatch):
    _fake_program(monkeypatch, PROGRAM)
    host = [Event("aten::mul", "cpu_op", 160, 161)]
    assert spec.load_reader("host_syncs_per_sweep", ROOT).read(
        _Ctx(_Slice(0, 1000, host))) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """Against a program that records no spans, every reader reads None
    and none raises."""
    from bayesfmmm_torch.utils import observability as obs
    monkeypatch.delattr(obs, "recorded_spans")
    host = [Event("cudaStreamSynchronize", "cuda_runtime", 500, 510)]
    for m in READERS:
        assert spec.load_reader(m, ROOT).read(
            _Ctx(_Slice(0, 1000, host))) is None


def test_interval_arithmetic():
    a = sp.merged([("x", 0, 10), ("x", 5, 20), ("y", 0, 100),
                   ("x", 30, 40)], ("x",))
    assert a == [(0, 20), (30, 40)] and sp.length(a) == 30
    assert sp.intersect(a, [(15, 35)]) == [(15, 20), (30, 35)]
    assert sp.count_inside([-1, 0, 19, 20, 25, 39, 40], a) == 3


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_programs_spans(cell):
    """8 chains: the spans' readings, not the draws' check, are tested."""
    line = run_small(cell, trace=True, chains=8, root=full_root())
    m = line["metrics"]
    assert 0 < m["api_self_pct"]["value"] < 100
    assert 0 < m["driver_self_pct"]["value"] < 100
    assert "host_syncs_per_sweep" not in m           # no CUDA on the CPU
