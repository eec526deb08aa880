"""Plain versions of the port's kernels K1 (chol_solve) and K2 (mean_rss)
against the JAX package's Pallas kernels, run in interpret mode on the CPU,
on identical inputs made with numpy.

Tolerances: K1 5e-5 on the mean and 5e-4 on the noise, those of the JAX
package's own kernel test (tests/test_linalg.py:118-121); K2 2e-5 on mu and
1e-5 relative on the RSS (f32 rounding of one P-term matvec and one sum).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from bayesfmmm_tpu.ops.linalg import precision_draw_pair  # noqa: E402
from bayesfmmm_torch.ops import kernels, linalg  # noqa: E402


def _spd_problem(seed, C, D, diag=50.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(C, D, D))
    A = (X @ np.swapaxes(X, -1, -2) + diag * np.eye(D)).astype(np.float32)
    b = rng.normal(size=(C, D)).astype(np.float32)
    z = rng.normal(size=(C, D)).astype(np.float32)
    return A, b, z


def _plain_k1(A, b, z):
    mean, noise = kernels.chol_solve_plain(*map(torch.from_numpy, (A, b, z)))
    return mean.numpy(), noise.numpy()


def test_chol_solve_plain_matches_jax_precision_draw_pair():
    A, b, z = _spd_problem(0, 9, 48)
    mean_j, noise_j = jax.jit(jax.vmap(precision_draw_pair))(A, b, z)
    mean, noise = _plain_k1(A, b, z)
    np.testing.assert_allclose(mean, mean_j, atol=5e-5)
    np.testing.assert_allclose(noise, noise_j, atol=5e-4)


@pytest.mark.parametrize("C,D", [(128, 48), (128, 96), (128, 13)])
def test_chol_solve_plain_matches_pallas_kernel(C, D):
    A, b, z = _spd_problem(D, C, D)
    mean_T, noise_T = pk.chol_solve_batch_minor(
        jnp.moveaxis(A, 0, -1), jnp.moveaxis(b, 0, -1),
        jnp.moveaxis(z, 0, -1))
    mean, noise = _plain_k1(A, b, z)
    np.testing.assert_allclose(mean, np.moveaxis(np.asarray(mean_T), -1, 0),
                               atol=5e-5)
    np.testing.assert_allclose(noise, np.moveaxis(np.asarray(noise_T), -1, 0),
                               atol=5e-4)


def _mean_rss_case(seed, C, N, L, P, pad_from=None):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(N, L, P)).astype(np.float32)
    y = rng.normal(size=(N, L)).astype(np.float32)
    if pad_from is not None:
        B[:, pad_from:, :] = 0.0
        y[:, pad_from:] = 0.0
    w = rng.normal(size=(C, N, P)).astype(np.float32)
    return B, y, w


@pytest.mark.parametrize("N,L,P,pad_from", [(13, 24, 6, None),
                                            (6, 16, 4, 10)])
def test_mean_rss_plain_matches_pallas_kernel(N, L, P, pad_from):
    """The cases of tests/test_pallas_kernels.py (non-tile-aligned shapes,
    and a zero-padded tail), batched over 3 chains."""
    B, y, w = _mean_rss_case(N, 3, N, L, P, pad_from)
    rss, mu = kernels.mean_rss_plain(torch.from_numpy(B), torch.from_numpy(y),
                                     torch.from_numpy(w), want_mu=True)
    for c in range(3):
        mu_j, rss_j = pk.fused_mean_rss(B, w[c], y, tile_n=4)
        np.testing.assert_allclose(mu[c].numpy(), np.asarray(mu_j),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(rss[c]), float(rss_j), rtol=1e-5)
    if pad_from is not None:
        assert bool((mu[:, :, pad_from:] == 0).all())


def test_mvn_from_precision_fused_moments():
    """Draws of the port's fused precision draw (4000 chains of one
    problem) have the conjugate mean and covariance."""
    A, b, _ = _spd_problem(5, 1, 16, diag=20.0)
    A64, b64 = A[0].astype(np.float64), b[0].astype(np.float64)
    n = 4000
    g = torch.Generator().manual_seed(0)
    At = torch.from_numpy(A).expand(n, 16, 16)
    bt = torch.from_numpy(b).expand(n, 16)
    samp, mean = linalg.mvn_from_precision_fused(g, At, bt)
    target = np.linalg.solve(A64, b64)
    np.testing.assert_allclose(mean[0].numpy(), target, atol=1e-4)
    s = samp.double().numpy()
    np.testing.assert_allclose(s.mean(0), target, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), np.linalg.inv(A64), atol=0.05)
