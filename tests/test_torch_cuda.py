"""The CUDA kernels K1 and K2 on the card, against their plain versions.

These need an NVIDIA card with nvcc and skip elsewhere.  The file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from bayesfmmm_torch.ops import kernels  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spd(g, C, D, dev, diag=50.0):
    X = torch.randn(C, D, D, generator=g, device=dev)
    A = X @ X.mT + diag * torch.eye(D, device=dev)
    return (A, torch.randn(C, D, generator=g, device=dev),
            torch.randn(C, D, generator=g, device=dev))


@pytest.mark.parametrize("C,D", [(256, 96), (3, 13), (2, 1), (5, 129)])
def test_chol_solve_kernel_matches_plain(dev, C, D):
    g = torch.Generator(device=dev).manual_seed(D)
    A, b, z = _spd(g, C, D, dev)
    before = kernels.LAUNCHES["chol_solve"]
    mean, noise = kernels.chol_solve(A, b, z)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chol_solve"] == before + 1
    mean_p, noise_p = kernels.chol_solve_plain(A, b, z)
    torch.testing.assert_close(mean, mean_p, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise, noise_p, rtol=0, atol=5e-4)


def test_chol_solve_rejects_oversize_dimension(dev):
    D = kernels.chol_solve_max_dim() + 1
    A = torch.eye(D, device=dev)[None]
    b = torch.zeros(1, D, device=dev)
    with pytest.raises(NotImplementedError, match="large-D"):
        kernels.chol_solve(A, b, b)


@pytest.mark.parametrize("C,N,L,P,pad", [(256, 100, 100, 8, None),
                                         (3, 13, 24, 6, 16)])
def test_mean_rss_kernel_matches_plain(dev, C, N, L, P, pad):
    g = torch.Generator(device=dev).manual_seed(N)
    B = torch.randn(N, L, P, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    if pad is not None:
        B[:, pad:] = 0.0
        y[:, pad:] = 0.0
    w = torch.randn(C, N, P, generator=g, device=dev)
    rss, mu = kernels.mean_rss(B, y, w, want_mu=True)
    rss2, _ = kernels.mean_rss(B, y, w)
    rss_p, mu_p = kernels.mean_rss_plain(B, y, w, want_mu=True)
    torch.cuda.synchronize()
    assert torch.equal(rss, rss2)      # deterministic: same bits
    torch.testing.assert_close(rss, rss_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(mu, mu_p, rtol=2e-5, atol=2e-5)
