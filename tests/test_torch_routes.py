"""Which kernel each plan picks at the benchmark's configurations, the names
the device trace shows for them on the card, and the span of the data's
set-up (``api.build_data``).

The file imports no JAX; its card test runs with the others of the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_routes.py
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bayesfmmm_torch import api  # noqa: E402
from bayesfmmm_torch.models.state import ModelData  # noqa: E402
from bayesfmmm_torch.ops import kernels  # noqa: E402
from bayesfmmm_torch.utils import observability as obs  # noqa: E402

BENCH = Path(__file__).resolve().parents[1] / "portbench"

# configuration -> what its sweeps' plans pick: K1's kernel at every joint
# draw, K2's chain tile TC at the chains and at twice them (production's
# stacked pair), K3 tiled or not at nu's rows and eta's.  K2's instantiation
# is mean_rss_tile_kernel<TC, PV, false>, PV = P where P is 8 or 16 (and B
# and w start on 16 bytes, csrc/mean_rss.cu), else 0: general.
PICKS = {
    "fmm_k3_p8_m4_n100": {"chol_solve": {"tiled"}, "mean_rss": {8, 24, 40},
                          "weighted_gram": {True}},
    "covcov_k2_p8_m16_d2_n80": {"chol_solve": {"blocked", "panels"},
                                "mean_rss": {24, 40},
                                "weighted_gram": {True}},
    "bhdfmmm_k2_p36_m2_n100": {"chol_solve": {"blocked"},
                               "mean_rss": {40},
                               "weighted_gram": {False}},
}


def _chains(name):
    """The chain counts of every workload file of a configuration."""
    cells = [json.loads(p.read_text())
             for p in sorted((BENCH / "workloads").glob("*.json"))]
    return sorted({c["chains"] for c in cells if c["config"] == name})


@pytest.mark.parametrize("name", sorted(PICKS))
def test_the_plans_route_at_each_configuration(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    K, P, M, D, N = (cfg[k] for k in "KPMDN")
    L = cfg["n_time"][1]
    chains = _chains(name)
    assert chains
    got = {"chol_solve": set(), "mean_rss": set(), "weighted_gram": set()}
    for C in chains:
        for dim in cfg["joint_draws"].values():
            got["chol_solve"].add(kernels.chol_solve_plan(C, dim)["kernel"])
        for rows in (C, 2 * C):
            got["mean_rss"].add(kernels.mean_rss_plan(rows, N, L, P)["TC"])
        for R in (C * K,) + ((C * D * K,) if D else ()):
            got["weighted_gram"].add(
                kernels.weighted_gram_plan(R, N, P)["tiled"])
    assert got == PICKS[name]
    assert sorted(cfg["joint_draws"].values()) == sorted(
        [K * M * P] + ([K * M * D * P] if cfg["covariate_cov"] else []))


def test_the_routes_of_each_kernel():
    """Each kernel every plan can pick, at the shapes that take it."""
    assert kernels.chol_solve_plan(4, 96)["kernel"] == "tiled"
    assert kernels.chol_solve_plan(4, 144)["kernel"] == "blocked"
    assert kernels.chol_solve_plan(4, 400)["kernel"] == "panels"
    assert kernels.mean_rss_plan(4, 10, 20, 8)["TC"] == 8
    assert kernels.mean_rss_plan(64, 100, 900, 36)["TC"] == 40
    assert kernels.mean_rss_plan(64, 100, 900, 36, want_mu=True)["TC"] == \
        kernels.K2_MU_CHAIN_TILE
    assert kernels.weighted_gram_plan(12, 10, 8)["tiled"]
    assert kernels.weighted_gram_plan(12, 10, 16)["tiled"]
    for P in (5, 17, 36):
        assert not kernels.weighted_gram_plan(12, 10, P)["tiled"]


def test_reset_launch_counts_zeroes_every_kernel(monkeypatch):
    monkeypatch.setattr(kernels, "LAUNCHES",
                        {"chol_solve": 1, "mean_rss": 2, "mean_rss_grad": 3,
                         "weighted_gram": 4})
    kernels.reset_launch_counts()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert set(kernels.LAUNCHES) == {"chol_solve", "mean_rss",
                                     "mean_rss_grad", "weighted_gram"}


def test_no_launch_is_counted_on_the_cpu(monkeypatch):
    """At the hd configuration's P the CPU takes the plain versions, which
    launch nothing."""
    monkeypatch.setattr(kernels, "LAUNCHES",
                        dict.fromkeys(kernels.LAUNCHES, 0))
    g = torch.Generator().manual_seed(0)
    B, y = torch.randn(3, 7, 36, generator=g), torch.randn(3, 7, generator=g)
    rss, _ = kernels.mean_rss(B, y, torch.randn(2, 3, 36, generator=g))
    gram = kernels.weighted_gram(torch.rand(4, 3, generator=g),
                                 torch.randn(3, 36, 36, generator=g))
    assert rss.shape == (2,) and gram.shape == (4, 36, 36)
    assert set(kernels.LAUNCHES.values()) == {0}


# --- the span of the data's set-up -----------------------------------------

def _surfaces(seed=3, N=5):
    rng = np.random.default_rng(seed)
    t = [rng.uniform(0.0, 990.0, size=(n, 2)) for n in (40, 55, 31, 48, 60)]
    y = [rng.normal(size=len(ti)) for ti in t]
    kw = dict(family="hd", basis_degrees=[2, 2],
              internal_knots_list=[[250.0, 500.0, 750.0]] * 2,
              boundary_knots=[[0.0, 990.0]] * 2, device="cpu")
    return y[:N], t[:N], kw


def _curves(seed=4):
    rng = np.random.default_rng(seed)
    t = [np.sort(rng.uniform(0.0, 1.0, size=n)) for n in (12, 9, 15)]
    y = [rng.normal(size=len(ti)) for ti in t]
    return y, t, dict(family="functional", internal_knots=[0.25, 0.5, 0.75],
                      boundary_knots=[0.0, 1.0], device="cpu")


def _profiled(fn):
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    spans = obs.recorded_spans()
    obs.clear_spans()
    return out, spans


def _same(a: ModelData, b: ModelData):
    for f in ("y", "mask", "B", "X", "G", "pen", "u", "yy"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.n_obs, a.family, a.pen_rank) == (b.n_obs, b.family, b.pen_rank)


def test_build_data_spans_under_the_profiler():
    y, t, kw = _surfaces()
    off = api.build_data(y, t, **kw)
    on, spans = _profiled(lambda: api.build_data(y, t, **kw))
    _same(on, off)
    assert [(s.name, s.counts, s.parent) for s in spans] == [
        ("api.build_data", {"family": "hd", "N": 5, "P": 36,
                            "points": 40 + 55 + 31 + 48 + 60}, -1)]
    assert spans[0].start_ns <= spans[0].end_ns

    y, t, kw = _curves()
    off = api.build_data(y, t, **kw)
    on, spans = _profiled(lambda: api.build_data(y, t, **kw))
    _same(on, off)
    assert [(s.name, s.counts) for s in spans] == [
        ("api.build_data", {"family": "functional", "N": 3, "P": 7,
                            "points": 36})]


def test_build_data_records_nothing_with_the_profiler_off():
    obs.clear_spans()
    y, t, kw = _surfaces()
    api.build_data(y, t, **kw)
    assert obs.recorded_spans() == [] and obs.dropped_spans() == 0


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_the_trace_names_the_instantiation_on_the_card():
    """K1, K2 and K3 at the hd configuration's shapes and at the headline's:
    the device trace names the kernel each plan picked, and K2's general
    instantiation (PV 0) at P = 36 against the vectorised one at P = 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = {}
    for N, L, P, C in ((100, 900, 36, 64), (100, 100, 8, 256)):
        inputs[P] = (torch.randn(N, L, P, generator=g, device=dev),
                     torch.randn(N, L, generator=g, device=dev),
                     torch.randn(C, N, P, generator=g, device=dev),
                     torch.rand(2 * C, N, generator=g, device=dev),
                     torch.randn(N, P, P, generator=g, device=dev))
    solves = []
    for C, D in ((64, 144), (256, 96)):
        X = torch.randn(C, D, D, generator=g, device=dev)
        solves.append((X @ X.mT + 50.0 * torch.eye(D, device=dev),
                       torch.randn(C, D, generator=g, device=dev),
                       torch.randn(C, D, generator=g, device=dev)))
    torch.cuda.synchronize()
    names = {}
    for key, run in [(36, lambda: kernels.mean_rss(*inputs[36][:3])),
                     (8, lambda: kernels.mean_rss(*inputs[8][:3])),
                     ("gram36", lambda: kernels.weighted_gram(*inputs[36][3:])),
                     ("gram8", lambda: kernels.weighted_gram(*inputs[8][3:])),
                     (144, lambda: kernels.chol_solve(*solves[0])),
                     (96, lambda: kernels.chol_solve(*solves[1]))]:
        run()                                   # loads the library
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names[key] = " | ".join(
            e.name() for e in prof.profiler.kineto_results.events())
    tc36 = kernels.mean_rss_plan(64, 100, 900, 36)["TC"]
    tc8 = kernels.mean_rss_plan(256, 100, 100, 8)["TC"]
    want = {36: f"mean_rss_tile_kernel<{tc36}, 0, false>",
            8: f"mean_rss_tile_kernel<{tc8}, 8, false>",
            "gram36": "weighted_gram_chunk_kernel",
            "gram8": "weighted_gram_tile_kernel",
            144: "chol_blocked_kernel", 96: "chol_tiled_kernel"}
    for key, name in want.items():
        assert name in names[key], (key, names[key][:3000])
