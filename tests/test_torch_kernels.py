"""Plain versions of the port's kernels K1 (chol_solve), K2 (mean_rss) and
K3 (weighted_gram) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, on identical inputs made with numpy.

K1's register-tiled kernel is held here through ``chol_solve_tiled_plain``,
its algorithm step by step in PyTorch, so the algorithm is proved on the CPU
before the card sees it.

Tolerances: K1 5e-5 on the mean and 5e-4 on the noise, those of the JAX
package's own kernel test (tests/test_linalg.py:118-121); K2 2e-5 on mu and
1e-5 relative on the RSS (f32 rounding of one P-term matvec and one sum);
K3 2e-5 relative and absolute, that of tests/test_pallas_kernels.py:46-47,
with the absolute part scaled by N/21 (f32 rounding of an N-term sum).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.ops import pallas_kernels as pk  # noqa: E402
from bayesfmmm_tpu.ops import linalg as jlinalg  # noqa: E402
from bayesfmmm_tpu.ops.linalg import precision_draw_pair  # noqa: E402
from bayesfmmm_torch.ops import kernels, linalg  # noqa: E402
from bayesfmmm_torch.ops.gibbs import _weighted_gram  # noqa: E402


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


def _tiled_k1(A, b, z, jitter=0.0):
    mean, noise = kernels.chol_solve_tiled_plain(
        *map(torch.from_numpy, (A, b, z)), jitter)
    return mean.numpy(), noise.numpy()


K1_SHAPES = [(128, 96), (128, 48), (5, 13), (3, 1)]


@pytest.mark.parametrize("C,D", K1_SHAPES)
def test_chol_solve_tiled_plain_matches_plain(C, D):
    """The tiled kernel's algorithm leaves its inputs alone and computes
    the plain version's function."""
    A, b, z = _spd_problem(D + 1, C, D)
    A0, b0, z0 = A.copy(), b.copy(), z.copy()
    mean, noise = _tiled_k1(A, b, z)
    assert (A == A0).all() and (b == b0).all() and (z == z0).all()
    mean_p, noise_p = _plain_k1(A, b, z)
    np.testing.assert_allclose(mean, mean_p, atol=5e-5)
    np.testing.assert_allclose(noise, noise_p, atol=5e-4)


@pytest.mark.parametrize("C,D", K1_SHAPES)
def test_chol_solve_tiled_plain_matches_jax_precision_draw_pair(C, D):
    A, b, z = _spd_problem(D + 2, C, D)
    mean_j, noise_j = jax.jit(jax.vmap(precision_draw_pair))(A, b, z)
    mean, noise = _tiled_k1(A, b, z)
    np.testing.assert_allclose(mean, mean_j, atol=5e-5)
    np.testing.assert_allclose(noise, noise_j, atol=5e-4)


@pytest.mark.parametrize("C,D", [(128, 96), (128, 48)])
def test_chol_solve_tiled_plain_matches_pallas_kernel(C, D):
    """Against the Pallas kernel in interpret mode, at the shapes its gate
    takes (D a multiple of 8, 128 chains on the lanes)."""
    A, b, z = _spd_problem(D + 3, C, D)
    mean_T, noise_T = pk.chol_solve_batch_minor(
        jnp.moveaxis(A, 0, -1), jnp.moveaxis(b, 0, -1),
        jnp.moveaxis(z, 0, -1))
    mean, noise = _tiled_k1(A, b, z)
    np.testing.assert_allclose(mean, np.moveaxis(np.asarray(mean_T), -1, 0),
                               atol=5e-5)
    np.testing.assert_allclose(noise, np.moveaxis(np.asarray(noise_T), -1, 0),
                               atol=5e-4)


def _jax_jittered(A, jitter):
    """A + jitter * (tr(A) / D + 1) * I, the JAX package's formula
    (ops/linalg.py:325-326), applied outside."""
    D = A.shape[-1]
    scale = jnp.trace(A, axis1=-2, axis2=-1) / D + 1.0
    return A + (jitter * scale)[..., None, None] * jnp.eye(D, dtype=A.dtype)


@pytest.mark.parametrize("C,D", K1_SHAPES)
@pytest.mark.parametrize("which", ["tiled_plain", "plain", "wrapper"])
def test_chol_solve_jitter_matches_jax_formula(which, C, D):
    """jitter=1e-6 inside the port's K1 functions equals the JAX package's
    jitter applied outside; a jitter large enough to see (1e-2) moves the
    result as it moves JAX's."""
    A, b, z = _spd_problem(D + 4, C, D)
    fn = {"tiled_plain": kernels.chol_solve_tiled_plain,
          "plain": kernels.chol_solve_plain,
          "wrapper": kernels.chol_solve}[which]
    for jitter in (1e-6, 1e-2):
        Aj = _jax_jittered(jnp.asarray(A), jitter)
        mean_j, noise_j = jax.jit(jax.vmap(precision_draw_pair))(Aj, b, z)
        mean, noise = fn(*map(torch.from_numpy, (A, b, z)), jitter)
        np.testing.assert_allclose(mean.numpy(), mean_j, atol=5e-5)
        np.testing.assert_allclose(noise.numpy(), noise_j, atol=5e-4)
    mean_0, _ = fn(*map(torch.from_numpy, (A, b, z)))
    assert np.abs(mean.numpy() - mean_0.numpy()).max() > 1e-6


def test_precision_draw_pair_keeps_batch_axes_and_default_jitter():
    """The port's precision_draw_pair flattens leading axes into K1's chain
    axis, and at the default jitter is the function it was."""
    A, b, z = _spd_problem(9, 6, 12)
    At, bt, zt = map(torch.from_numpy, (A, b, z))
    mean, noise = linalg.precision_draw_pair(
        At.reshape(2, 3, 12, 12), bt.reshape(2, 3, 12), zt.reshape(2, 3, 12))
    assert mean.shape == noise.shape == (2, 3, 12)
    mean_p, noise_p = kernels.chol_solve_plain(At, bt, zt)
    assert torch.equal(mean.reshape(6, 12), mean_p)
    assert torch.equal(noise.reshape(6, 12), noise_p)
    mean_j, _ = linalg.precision_draw_pair(At, bt, zt, jitter=1e-2)
    torch.testing.assert_close(
        mean_j, kernels.chol_solve_plain(kernels.add_jitter(At, 1e-2), bt,
                                         zt)[0], rtol=0, atol=5e-5)


@pytest.mark.parametrize("C,D", [(7, 36), (3, 96)])
def test_mvn_from_precision_fused_matches_jax(monkeypatch, C, D):
    """The port's fused precision draw against the JAX one on the same A
    and b with the same z injected into both generators."""
    A, b, z = _spd_problem(D + 5, C, D)
    monkeypatch.setattr(jlinalg.jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(z[0], dtype))
    monkeypatch.setattr(linalg.torch, "randn",
                        lambda shape, **kw: torch.from_numpy(z).clone())
    samp, mean = linalg.mvn_from_precision_fused(
        torch.Generator(), torch.from_numpy(A), torch.from_numpy(b))
    assert samp.shape == mean.shape == (C, D)
    for c in range(C):
        monkeypatch.setattr(
            jlinalg.jax.random, "normal",
            lambda key, shape, dtype, c=c: jnp.asarray(z[c], dtype))
        samp_j, mean_j = jlinalg.mvn_from_precision_fused(
            jax.random.PRNGKey(0), jnp.asarray(A[c]), jnp.asarray(b[c]))
        np.testing.assert_allclose(mean[c].numpy(), mean_j, atol=5e-5)
        np.testing.assert_allclose(samp[c].numpy(), samp_j, atol=5e-4)


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


@pytest.mark.parametrize("R,N,P", [(5, 21, 8), (4, 13, 6), (3, 100, 8),
                                   (2, 130, 16)])
def test_weighted_gram_plain_matches_pallas_kernel(R, N, P):
    """Each row of W against its own call of the Pallas kernel (ragged N,
    P 6, 8 and 16)."""
    rng = np.random.default_rng(N)
    G = rng.normal(size=(N, P, P)).astype(np.float32)
    W = rng.uniform(size=(R, N)).astype(np.float32)
    out = kernels.weighted_gram_plain(torch.from_numpy(W), torch.from_numpy(G))
    assert out.shape == (R, P, P)
    for r in range(R):
        ref = np.asarray(pk.weighted_gram(jnp.asarray(G), jnp.asarray(W[r]),
                                          tile_n=8))
        np.testing.assert_allclose(out[r].numpy(), ref, rtol=2e-5,
                                   atol=2e-5 * N / 21)


def test_weighted_gram_keeps_leading_axes():
    """The port's _weighted_gram flattens W's leading (chain, feature) axes
    into K3's rows and restores them."""
    rng = np.random.default_rng(0)
    G = torch.from_numpy(rng.normal(size=(7, 5, 5)).astype(np.float32))
    W = torch.from_numpy(rng.uniform(size=(3, 2, 7)).astype(np.float32))
    out = _weighted_gram(SimpleNamespace(G=G), W.transpose(0, 1))
    assert out.shape == (2, 3, 5, 5)
    torch.testing.assert_close(out, torch.einsum("kcn,npq->kcpq",
                                                 W.transpose(0, 1), G))
