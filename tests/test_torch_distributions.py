"""Sampling and density primitives of the port against the JAX package.

Densities are compared on identical inputs (rtol 1e-5, f32).  Samplers are
compared by moments of 20000 draws within 5 combined standard errors, since
torch and jax.random draw different numbers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.ops import distributions as jd  # noqa: E402
from bayesfmmm_torch.ops import distributions as td  # noqa: E402

N = 20000


def _same_moments(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    for xa, xb in ((a, b), ((a - a.mean(0)) ** 2, (b - b.mean(0)) ** 2)):
        se = np.sqrt(xa.var(0) / len(xa) + xb.var(0) / len(xb))
        assert np.all(np.abs(xa.mean(0) - xb.mean(0)) <= 5 * se + 1e-12), \
            (xa.mean(0), xb.mean(0), se)


@pytest.mark.parametrize("mean,sd", [(2.0, 0.05), (0.05, 0.05), (0.3, 1.0),
                                     (-0.1, 0.05)])
def test_truncnorm_sample_moments_match_jax(mean, sd):
    """Including a lower bound of +2 sd (mean -0.1, sd 0.05), where the
    truncated mass is 2 %."""
    jx = jax.jit(jax.vmap(lambda k: jd.truncnorm_sample(k, mean, sd)))(
        jax.random.split(jax.random.PRNGKey(3), N))
    tx = td.truncnorm_sample(torch.Generator().manual_seed(3),
                             torch.full((N,), mean), sd)
    assert tx.dtype == torch.float32 and bool((tx >= 0).all())
    _same_moments(jx, tx.numpy())


def test_truncnorm_sample_far_tail_is_exact():
    """Lower bound 20 sd above the mean: float64 special functions keep
    the draw a proper tail sample (mean ~ lower + 1/lower)."""
    x = td.truncnorm_sample(torch.Generator().manual_seed(0),
                            torch.full((N,), -1.0, dtype=torch.float64), 0.05)
    z = (x.numpy() + 1.0) / 0.05
    assert z.min() >= 20.0 - 1e-9
    assert abs(z.mean() - 20.0494) < 0.005     # E[Z | Z > 20]


def test_densities_match_jax():
    rng = np.random.default_rng(0)
    x = rng.dirichlet(np.ones(4), size=6).astype(np.float32)
    alpha = rng.uniform(0.2, 30.0, size=(6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        td.log_multi_beta(torch.from_numpy(alpha)).numpy(),
        jd.log_multi_beta(alpha), rtol=1e-5)
    np.testing.assert_allclose(
        td.dirichlet_logpdf_unnormalized(torch.from_numpy(x),
                                         torch.from_numpy(alpha)).numpy(),
        jd.dirichlet_logpdf_unnormalized(x, alpha), rtol=1e-5, atol=1e-4)
    # means down to -12 sd: the normalizer's lower tail must not underflow
    v = np.stack([rng.uniform(0.01, 3.0, size=50),
                  rng.uniform(-0.6, 3.0, size=50)]).astype(np.float32)
    for sd in (0.05, 1.0):
        np.testing.assert_allclose(
            td.truncnorm_logpdf(torch.from_numpy(v[0]),
                                torch.from_numpy(v[1]), sd).numpy(),
            jd.truncnorm_logpdf(v[0], v[1], sd), rtol=1e-5, atol=1e-4)


def test_gamma_underflow_gives_exact_zero_like_jax():
    """Tiny Dirichlet concentrations (a_Z_PM * Z with Z near 0) underflow:
    both packages return exactly 0 at the same rate, so Z's boundary and
    NaN-reject rules see the same states."""
    alpha = np.array([1e-3, 5.0], np.float32)
    jz = jax.random.dirichlet(jax.random.PRNGKey(0), alpha, shape=(N,))
    tz = td.rdirichlet(torch.Generator().manual_seed(0),
                       torch.from_numpy(alpha).expand(N, 2).contiguous())
    jzero, tzero = np.asarray(jz == 0).mean(0), (tz == 0).double().mean(0)
    se = np.sqrt(2 * jzero * (1 - jzero) / N)
    assert np.all(np.abs(jzero - tzero.numpy()) <= 5 * se)
    assert 0.85 < tzero[0] < 0.97 and tzero[1] == 0
    # the reference's guard: a non-positive concentration is floored at 10
    g = td.rdirichlet(torch.Generator().manual_seed(1),
                      torch.tensor([[0.0, -1.0, 10.0]]).expand(N, 3))
    _same_moments(g.numpy(), td.rdirichlet(
        torch.Generator().manual_seed(2), torch.full((N, 3), 10.0)).numpy())


def test_mvn_from_chol_moments():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(5, 5))
    prec = (X @ X.T + 5 * np.eye(5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    L = td.chol_precision(torch.from_numpy(prec).expand(N, 5, 5))
    s, mean = td.mvn_from_chol(torch.Generator().manual_seed(0), L,
                               torch.from_numpy(b).expand(N, 5))
    _, jmean = jd.mvn_from_chol(jax.random.PRNGKey(0),
                                jd.chol_precision(jnp.asarray(prec)), b)
    np.testing.assert_allclose(mean[0].numpy(), jmean, rtol=1e-5, atol=1e-6)
    cov = np.linalg.inv(prec.astype(np.float64))
    np.testing.assert_allclose(s.double().numpy().mean(0), cov @ b,
                               atol=5 * np.sqrt(np.diag(cov).max() / N))
    np.testing.assert_allclose(np.cov(s.double().numpy().T), cov, atol=0.01)
