"""Data and state of the port against the JAX package, on the same seeds."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bayesfmmm_tpu import basis as jbasis  # noqa: E402
from bayesfmmm_tpu import config as jconfig  # noqa: E402
from bayesfmmm_tpu.models import state as jstate  # noqa: E402
from bayesfmmm_tpu.utils import init_strategies as jinit  # noqa: E402
from bayesfmmm_tpu.utils import simulate as jsim  # noqa: E402
from bayesfmmm_torch import basis, config, convert  # noqa: E402
from bayesfmmm_torch.models import state as tstate  # noqa: E402
from bayesfmmm_torch.utils import init_strategies as tinit  # noqa: E402
from bayesfmmm_torch.utils import simulate as tsim  # noqa: E402

_SIM = dict(seed=3, N=12, K=3, P=7, M=2, n_time=(15, 22))


@pytest.fixture(scope="module")
def both():
    return (jsim.simulate_functional(**_SIM),
            tsim.simulate_functional(**_SIM, device="cpu"))


@pytest.mark.parametrize("field", ["y", "mask", "B", "G", "u", "yy", "pen",
                                   "X"])
def test_simulated_data_matches_jax(both, field):
    (jdata, _), (tdata, _) = both
    np.testing.assert_allclose(getattr(tdata, field).numpy(),
                               np.asarray(getattr(jdata, field)), rtol=1e-6,
                               atol=0)
    assert tdata.n_obs == float(np.sum(np.asarray(jdata.mask)))


def test_simulated_truth_matches_jax(both):
    (_, jtruth), (_, ttruth) = both
    for f in tstate.STATE_FIELDS:
        np.testing.assert_array_equal(ttruth[f], np.asarray(getattr(jtruth,
                                                                    f)))


def test_make_functional_data_matches_jax():
    rng = np.random.default_rng(5)
    t_list = [np.sort(rng.uniform(0, 1, n)) for n in (9, 13, 11)]
    y_list = [rng.normal(size=len(t)) for t in t_list]
    kw = dict(basis_degree=3, internal_knots=np.array([0.3, 0.6]),
              boundary_knots=np.array([0.0, 1.0]))
    jd = jstate.make_functional_data(y_list, t_list, **kw)
    td = tstate.make_functional_data(y_list, t_list, device="cpu", **kw)
    for f in ("y", "mask", "B", "G", "u", "yy", "pen"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))


def test_restated_numpy_modules_equal_jax_package(both):
    """The port restates a few framework-free pieces of the JAX package so
    that it loads none of it; they must stay equal to the originals."""
    assert dataclasses.asdict(config.Priors()) == \
        dataclasses.asdict(jconfig.Priors())
    assert [f.name for f in dataclasses.fields(config.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.ModelConfig)]
    t = np.linspace(0, 1, 37)
    for P in (1, 2, 8):
        np.testing.assert_array_equal(basis.rw1_penalty(P),
                                      jbasis.rw1_penalty(P))
    args = (t, 3, np.array([0.25, 0.5, 0.75]), np.array([0.0, 1.0]))
    np.testing.assert_array_equal(basis.bspline_basis(*args),
                                  jbasis.bspline_basis(*args))
    (jdata, _), (tdata, _) = both
    jsp, tsp = jinit.spectral_init(jdata, 3, 2), tinit.spectral_init(tdata,
                                                                     3, 2)
    for k in jsp:
        np.testing.assert_allclose(tsp[k], jsp[k], rtol=1e-12, atol=1e-12)


def test_spectral_ensemble_seeds_every_chain(both):
    """Every chain starts at the JAX package's spectral init; only Z is
    jittered per chain, and its rows stay on the simplex."""
    (jdata, _), (tdata, _) = both
    jsp = jinit.spectral_init(jdata, 3, 2)
    g = torch.Generator().manual_seed(0)
    st = tstate.init_state(g, config.ModelConfig(K=3, P=7, M=2), tdata,
                           chains=4)
    flat = tinit.spectral_ensemble(g, st, tdata, 3, 2, z_jitter=0.0)
    jit = tinit.spectral_ensemble(g, st, tdata, 3, 2)
    for k in ("Z", "nu", "chi", "Phi", "sigma2"):
        want = np.broadcast_to(np.asarray(jsp[k], np.float32),
                               getattr(st, k).shape)
        np.testing.assert_allclose(getattr(flat, k).numpy(), want,
                                   rtol=1e-6, atol=1e-7)
        if k != "Z":
            assert torch.equal(getattr(jit, k), getattr(flat, k))
    Z = jit.Z.numpy()
    assert Z.min() > 0 and not np.allclose(Z[0], Z[1])
    np.testing.assert_allclose(Z.sum(-1), 1.0, rtol=1e-6)


def test_convert_roundtrip_is_exact(both):
    (jdata, jtruth), (tdata, _) = both
    cfg = jconfig.ModelConfig(K=3, P=7, M=2)
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    jst = jax.vmap(lambda k: jstate.init_state(k, cfg, jdata))(keys)
    st = convert.state_from_numpy(jst, chains=5, device="cpu")
    back = convert.state_to_numpy(st)
    for f in tstate.STATE_FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
    one = convert.state_from_numpy(jtruth, chains=4, device="cpu")
    assert one.Z.shape == (4, 12, 3) and one.alpha3.shape == (4,)
    np.testing.assert_array_equal(convert.state_to_numpy(one)["Phi"][3],
                                  np.asarray(jtruth.Phi))
    with pytest.raises(ValueError):
        convert.state_from_numpy(jst, chains=4, device="cpu")
    dd = convert.data_from_jax(jdata, device="cpu")
    for f in ("y", "mask", "B", "X", "G", "pen", "u", "yy"):
        assert torch.equal(getattr(dd, f), getattr(tdata, f))
    assert dd.n_obs == tdata.n_obs
    mv, _ = jsim.simulate_multivariate(seed=0, N=5, K=2, P=3, M=1)
    with pytest.raises(NotImplementedError, match="multivariate"):
        convert.data_from_jax(mv, device="cpu")


def test_init_state_shapes_and_support(both):
    _, (tdata, _) = both
    g = torch.Generator().manual_seed(1)
    st = tstate.init_state(g, config.ModelConfig(K=3, P=7, M=2), tdata,
                           chains=6)
    for f, ndim in tstate.STATE_FIELDS.items():
        assert getattr(st, f).ndim == ndim + 1 and getattr(st, f).shape[0] == 6
    assert st.Z.shape == (6, 12, 3) and st.Phi.shape == (6, 3, 7, 2)
    torch.testing.assert_close(st.Z.sum(-1), torch.ones(6, 12))
    torch.testing.assert_close(st.pi.sum(-1), torch.ones(6))
    assert bool((st.Z >= 0).all()) and bool(torch.isfinite(st.nu).all())
