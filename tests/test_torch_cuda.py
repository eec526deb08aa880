"""The CUDA kernels K1, K2 and K3 on the card, against their plain versions.

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


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("C,D", [(256, 96), (3, 13), (2, 240), (5, 129),
                                 (4, 16), (2, 1), (7, 128), (257, 64),
                                 (3, 97), (9, 93)])
def test_chol_solve_kernel_matches_plain(dev, C, D, jitter):
    """The main path's shape, shapes of both kernels (register-tiled up to
    its reach, shared-memory above), ragged D that pads the tiles and
    takes the 4-byte loads, an odd chain count; without and with the jitter;
    the same bits from two calls, one launch counted a call."""
    g = torch.Generator(device=dev).manual_seed(D)
    A, b, z = _spd(g, C, D, dev)
    before = kernels.LAUNCHES["chol_solve"]
    mean, noise = kernels.chol_solve(A, b, z, jitter)
    mean2, noise2 = kernels.chol_solve(A, b, z, jitter)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chol_solve"] == before + 2
    assert torch.equal(mean, mean2) and torch.equal(noise, noise2)
    mean_p, noise_p = kernels.chol_solve_plain(A, b, z, jitter)
    torch.testing.assert_close(mean, mean_p, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise, noise_p, rtol=0, atol=5e-4)


def test_chol_solve_kernel_every_tiled_dimension(dev):
    """Every D the register-tiled kernel serves, at a ragged chain count."""
    g = torch.Generator(device=dev).manual_seed(0)
    for D in range(1, kernels.chol_solve_max_dim() + 1):
        if kernels.chol_solve_plan(3, D)["kernel"] != "tiled":
            continue
        A, b, z = _spd(g, 3, D, dev)
        mean, noise = kernels.chol_solve(A, b, z, 1e-6)
        mean_p, noise_p = kernels.chol_solve_plain(A, b, z, 1e-6)
        torch.testing.assert_close(mean, mean_p, rtol=0, atol=5e-5)
        torch.testing.assert_close(noise, noise_p, rtol=0, atol=5e-4)


def test_chol_solve_kernel_jitter_is_the_plain_one(dev):
    """A jitter large enough to see moves the kernel's result as it moves
    the plain version's; the default is no jitter."""
    g = torch.Generator(device=dev).manual_seed(5)
    A, b, z = _spd(g, 8, 96, dev)
    mean_0, _ = kernels.chol_solve(A, b, z)
    mean_j, _ = kernels.chol_solve(A, b, z, 1e-2)
    mean_p, _ = kernels.chol_solve_plain(A, b, z, 1e-2)
    torch.testing.assert_close(mean_j, mean_p, rtol=0, atol=5e-5)
    assert (mean_j - mean_0).abs().max().item() > 1e-4
    assert torch.equal(mean_0, kernels.chol_solve(A, b, z, 0.0)[0])


def test_chol_solve_kernel_takes_unaligned_views(dev):
    """A that starts 4 bytes off a 16-byte boundary is staged with 4-byte
    copies and gives the aligned call's bits."""
    g = torch.Generator(device=dev).manual_seed(2)
    C, D = 5, 96
    A, b, z = _spd(g, C, D, dev)
    flat = torch.empty(C * D * D + 1, device=dev)
    flat[1:] = A.reshape(-1)
    Av = flat[1:].view(C, D, D)
    assert Av.data_ptr() % 16 != 0
    mean, noise = kernels.chol_solve(Av, b, z)
    mean_a, noise_a = kernels.chol_solve(A.contiguous(), b, z)
    torch.cuda.synchronize()
    assert torch.equal(mean, mean_a) and torch.equal(noise, noise_a)


def test_precision_draw_launches_k1_and_no_matrix_sized_op(dev):
    """mvn_from_precision_fused on the card: one K1 launch, and no other
    kernel that touches a (C, D, D) tensor (none whose grid could: the
    profiler's kernels besides K1 are the randn and the final add, both on
    (C, D))."""
    from torch.profiler import ProfilerActivity, profile

    from bayesfmmm_torch.ops import linalg
    g = torch.Generator(device=dev).manual_seed(3)
    A, b, _ = _spd(g, 64, 96, dev)
    linalg.mvn_from_precision_fused(g, A, b)        # builds, warms
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["chol_solve"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        samp, mean = linalg.mvn_from_precision_fused(g, A, b)
        torch.cuda.synchronize()
    assert kernels.LAUNCHES["chol_solve"] == before + 1
    assert samp.shape == mean.shape == b.shape
    # no (C, D, D) temporary was allocated: the peak stays below one A
    assert torch.cuda.max_memory_allocated() - base < A.numel() * 4
    names = [ev.key for ev in prof.key_averages()]
    assert sum("chol_tiled_kernel" in n for n in names) == 1, names


def test_chol_solve_rejects_oversize_dimension(dev):
    D = kernels.chol_solve_max_dim() + 1
    A = torch.eye(D, device=dev)[None]
    b = torch.zeros(1, D, device=dev)
    with pytest.raises(NotImplementedError, match="large-D"):
        kernels.chol_solve(A, b, b)


@pytest.mark.parametrize("C,N,L,P,pad", [(256, 100, 100, 8, None),
                                         (512, 100, 100, 8, None),
                                         (3, 13, 24, 6, 16),
                                         (1, 100, 100, 8, None),
                                         (37, 7, 1500, 8, None),
                                         (5, 300, 3, 5, None),
                                         (20, 9, 11, 12, None),
                                         (200, 100, 100, 8, None),
                                         (400, 100, 100, 8, None),
                                         (50, 100, 100, 6, None)])
def test_mean_rss_kernel_matches_plain(dev, C, N, L, P, pad):
    """The main path's two shapes (C chains and the MGP-scale moves' 2C
    rows), a padded one, one chain, tiles ragged in chains and points with
    more points than a thread holds at once, widths other than 8 (the
    general instantiation), and chain counts that take the 8-, 24- and
    40-chain tiles; with mu (the 8-chain tile) and without, the same bits
    each time."""
    g = torch.Generator(device=dev).manual_seed(N)
    B = torch.randn(N, L, P, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    if pad is not None:
        B[:, pad:] = 0.0
        y[:, pad:] = 0.0
    w = torch.randn(C, N, P, generator=g, device=dev)
    before = kernels.LAUNCHES["mean_rss"]
    rss, mu = kernels.mean_rss(B, y, w, want_mu=True)
    rss2, none = kernels.mean_rss(B, y, w)
    rss_p, mu_p = kernels.mean_rss_plain(B, y, w, want_mu=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mean_rss"] == before + 2
    assert none is None
    assert torch.equal(rss, rss2)      # deterministic: same bits
    torch.testing.assert_close(rss, rss_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(mu, mu_p, rtol=2e-5, atol=2e-5)


def test_mean_rss_kernel_takes_unaligned_views(dev):
    """B and w that start 4 bytes off a 16-byte boundary take the 4-byte
    loads and give the aligned call's bits."""
    g = torch.Generator(device=dev).manual_seed(0)
    N, L, P, C = 10, 30, 8, 5
    B = torch.randn(N * L * P + 1, generator=g, device=dev)
    w = torch.randn(C * N * P + 1, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    Bv, wv = B[1:].view(N, L, P), w[1:].view(C, N, P)
    assert Bv.data_ptr() % 16 != 0 and wv.data_ptr() % 16 != 0
    rss, mu = kernels.mean_rss(Bv, y, wv, want_mu=True)
    rss_a, mu_a = kernels.mean_rss(Bv.clone(), y, wv.clone(), want_mu=True)
    torch.cuda.synchronize()
    assert torch.equal(rss, rss_a) and torch.equal(mu, mu_a)


@pytest.mark.parametrize("R,N,P", [(768, 100, 8), (5, 21, 8), (7, 130, 16),
                                   (1, 100, 8), (3, 40, 20), (50, 33, 6),
                                   (9, 3000, 8), (4, 17, 5)])
def test_weighted_gram_kernel_matches_plain(dev, R, N, P):
    """The main path's shape (R = 256 chains x 3 features), a ragged one,
    a wider P, one row, and P*P above one block's 256 (p, q) columns; rows
    that are not 16-byte aligned (N odd), G beyond a block's shared memory
    and P*P not a multiple of 4 (the chunked kernel)."""
    g = torch.Generator(device=dev).manual_seed(R + N)
    G = torch.randn(N, P, P, generator=g, device=dev)
    W = torch.rand(R, N, generator=g, device=dev)
    before = kernels.LAUNCHES["weighted_gram"]
    out = kernels.weighted_gram(W, G)
    out2 = kernels.weighted_gram(W, G)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["weighted_gram"] == before + 2
    assert torch.equal(out, out2)      # deterministic: same bits
    torch.testing.assert_close(out, kernels.weighted_gram_plain(W, G),
                               rtol=2e-5, atol=2e-5 * N / 21)


def test_weighted_gram_kernel_takes_unaligned_views(dev):
    """W and G that start 4 bytes off a 16-byte boundary are staged with
    4-byte copies and give the aligned call's bits."""
    g = torch.Generator(device=dev).manual_seed(1)
    R, N, P = 40, 100, 8
    W = torch.rand(R * N + 1, generator=g, device=dev)
    G = torch.randn(N * P * P + 1, generator=g, device=dev)
    Wv, Gv = W[1:].view(R, N), G[1:].view(N, P, P)
    assert Wv.data_ptr() % 16 != 0 and Gv.data_ptr() % 16 != 0
    out = kernels.weighted_gram(Wv, Gv)
    out_a = kernels.weighted_gram(Wv.clone(), Gv.clone())
    torch.cuda.synchronize()
    assert torch.equal(out, out_a)


def test_empty_shapes_launch_nothing(dev):
    """Empty inputs on the card give zeros on the card, with no launch and
    no plain version."""
    before = dict(kernels.LAUNCHES)
    B, y = torch.zeros(4, 0, 3, device=dev), torch.zeros(4, 0, device=dev)
    rss, mu = kernels.mean_rss(B, y, torch.ones(2, 4, 3, device=dev),
                               want_mu=True)
    assert rss.is_cuda and rss.tolist() == [0.0, 0.0]
    assert mu.is_cuda and mu.shape == (2, 4, 0)
    rss, mu = kernels.mean_rss(torch.zeros(4, 5, 3, device=dev),
                               torch.zeros(4, 5, device=dev),
                               torch.ones(0, 4, 3, device=dev))
    assert rss.is_cuda and rss.shape == (0,) and mu is None
    out = kernels.weighted_gram(torch.ones(2, 0, device=dev),
                                torch.zeros(0, 3, 3, device=dev))
    assert out.is_cuda and out.shape == (2, 3, 3) and not bool(out.any())
    assert kernels.LAUNCHES == before


def test_empty_kernel_launches(dev):
    before = dict(kernels.LAUNCHES)
    kernels.empty_launch(dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before


def test_weighted_gram_rejects_bad_inputs(dev):
    G = torch.randn(10, 8, 8, device=dev)
    W = torch.rand(4, 10, device=dev)
    with pytest.raises(ValueError, match="float32"):
        kernels.weighted_gram(W.double(), G)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.weighted_gram(torch.rand(10, 4, device=dev).mT, G)
    with pytest.raises(ValueError, match="shape"):
        kernels.weighted_gram(W, G[:9])
