"""The frozen arithmetic: equal to what it was copied from, and to values
worked by hand at the shapes of PERF.md's kernel table."""

import importlib.util

import pytest

from portbench.counts import flops, kernel_bound, logjoint
from portbench.tests.conftest import ROOT
from bayesfmmm_torch.ops import kernels

CONFIGS = {
    "fmm": dict(N=100, L=100, P=8, K=3, M=4, D=0),
    "covcov": dict(N=80, L=100, P=8, K=2, M=16, D=2),
}


def _original_flops():
    spec = importlib.util.spec_from_file_location(
        "original_flops", ROOT / "benchmarks" / "flops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("production", [False, True])
def test_frozen_sweep_flops_equal_the_original_term_by_term(name,
                                                            production):
    c = CONFIGS[name]
    kw = dict(collapsed_z=production, gauge=production,
              covariate_mean=bool(c["D"]), covariate_cov=bool(c["D"]))
    args = (c["N"], c["L"], c["P"], c["K"], c["M"], c["D"])
    assert flops.sweep_flops(*args, **kw) == \
        _original_flops().sweep_flops(*args, **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_census_total_is_the_copy_plus_mala(name):
    c = CONFIGS[name]
    config = dict(N=c["N"], n_time=[c["L"], c["L"]], P=c["P"], K=c["K"],
                  M=c["M"], D=c["D"], with_eta=bool(c["D"]),
                  covariate_cov=bool(c["D"]))
    args = (c["N"], c["L"], c["P"], c["K"], c["M"], c["D"])
    base = _original_flops().sweep_flops(
        *args, collapsed_z=True, gauge=True, covariate_mean=bool(c["D"]),
        covariate_cov=bool(c["D"]))["total"]
    mala = flops.mala_flops(*args)
    assert flops.chain_sweep_flops(config, "production") == base + mala
    assert 0.1 * base < mala < base
    ref = _original_flops().sweep_flops(
        *args, covariate_mean=bool(c["D"]),
        covariate_cov=bool(c["D"]))["total"]
    assert flops.chain_sweep_flops(config, "reference") == ref


def test_mala_by_hand_at_the_headline():
    # N=100, L=100, P=8, K=3, M=4: the chi-marginal's forward pass
    fwd = (2 * 100 * 3 * 8 * 4 + 2 * 100 * 64 * 4 + 2 * 100 * 8 * 16
           + 100 * 16 + 100 * 64 / 3 + 2 * 100 * 8 * 4 + 100 * 16
           + 100 * 4 + 2 * 100 * 4)
    assert flops._chi_marginal_flops(100, 3, 8, 4, False) == \
        pytest.approx(fwd)
    assert flops.mala_flops(100, 100, 8, 3, 4) == pytest.approx(
        1_981_173.33, rel=1e-6)


# PERF.md section 6's table: (kernel, shape, bytes, FLOP, bound in us)
TABLE = [
    ("chol_solve", dict(C=256, D=96), 5_160_960, 82.6e6, 1.541),
    ("chol_solve", dict(C=256, D=256), 34_734_080, 1_482.0e6, 22.119),
    ("chol_solve", dict(C=256, D=512), 136_577_024, 11_654.6e6, 173.949),
    ("mean_rss", dict(C=256, N=100, L=100, P=8), 1_180_224, 48.6e6, 0.726),
    ("mean_rss", dict(C=512, N=100, L=100, P=8), 2_000_448, 97.3e6, 1.452),
    ("mean_rss_grad", dict(C=64, N=100, L=100, P=8), 769_856, 21.12e6,
     0.315),
    ("weighted_gram", dict(R=768, N=100, P=8), 529_408, 9.83e6, 0.158),
]


@pytest.mark.parametrize("name,shape,nbytes,flop,bound_us", TABLE)
def test_kernel_bound_against_the_table(name, shape, nbytes, flop,
                                        bound_us):
    b = kernel_bound.kernel_bound(name, **shape)
    assert b["bytes"] == nbytes
    assert b["flop"] == pytest.approx(flop, rel=2e-3)
    assert b["bound_ms"] * 1e3 == pytest.approx(bound_us, abs=1e-3)
    assert b == kernels.kernel_bound(name, **shape)


def test_kernel_bound_by_hand():
    # K1 at C=1, D=2: triangle 3 + 4 D = 11 floats, 8/3 + 12 FLOP
    b = kernel_bound.kernel_bound("chol_solve", C=1, D=2)
    assert b["bytes"] == 44 and b["flop"] == pytest.approx(8 / 3 + 12)
    assert b["bound_by"] == "bytes"
    # K2 at C=1, N=1, L=2, P=1: B 2, y 2, w 1, rss 1 floats; 2 (2 + 3)
    b = kernel_bound.kernel_bound("mean_rss", C=1, N=1, L=2, P=1)
    assert b["bytes"] == 24 and b["flop"] == 10
    assert kernel_bound.PEAK_BYTES_PER_S == kernels.PEAK_BYTES_PER_S
    assert kernel_bound.PEAK_F32_FLOP_PER_S == kernels.PEAK_F32_FLOP_PER_S


def test_logjoint_count_by_hand():
    t = logjoint.logjoint_terms(100, 100, 8, 3, 4)
    assert t["k2_forward"] == 100 * 100 * 19
    assert t["k2_backward"] == 100 * 100 * 33
    assert t["mean_coeffs"] == 3 * (2 * 100 * 3 * 8 * 4 + 100 * 3 * 8
                                    + 2 * 100 * 3 * 8)
    assert t["total"] == pytest.approx(sum(v for k, v in t.items()
                                           if k != "total"))


def test_frozen_diagnostics_equal_the_originals():
    import numpy as np
    from bayesfmmm_torch import diagnostics as original
    from portbench import diagnostics
    x = np.cumsum(np.random.default_rng(7).normal(size=(4, 300)), axis=1)
    for name in ("effective_sample_size", "split_rhat",
                 "rank_normalized_ess", "rank_normalized_rhat"):
        assert getattr(diagnostics, name)(x) == getattr(original, name)(x)
