"""The CUDA kernels K1, K2 (and K2's backward) and K3 on the card, against
their plain versions.

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
    its reach, the blocked one above), ragged D that pads the tiles and
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


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("C,D", [(16, 256), (64, 256), (256, 256), (3, 251),
                                 (2, 241), (2, 334), (3, 333), (5, 129),
                                 (3, 130), (2, 200), (2, 336)])
def test_chol_solve_blocked_kernel_matches_plain(dev, C, D, jitter):
    """The blocked kernel (128 < D <= 336): the joint xi and hd Phi draws'
    D = 256 at the chain counts of the repo's configurations, odd D, the
    smallest and the largest, against torch.linalg to the tiled kernel's
    tolerances; the same bits from two calls; and, for two chains, against
    its own plain version, which repeats its arithmetic a panel at a
    time."""
    assert kernels.chol_solve_plan(C, D)["kernel"] == "blocked"
    g = torch.Generator(device=dev).manual_seed(D + C)
    A, b, z = _spd(g, C, D, dev)
    kernels.reset_launch_counts()
    mean, noise = kernels.chol_solve(A, b, z, jitter)
    mean2, noise2 = kernels.chol_solve(A, b, z, jitter)
    assert kernels.LAUNCHES["chol_solve"] == 2
    assert torch.equal(mean, mean2) and torch.equal(noise, noise2)
    mean_p, noise_p = kernels.chol_solve_plain(A, b, z, jitter)
    torch.testing.assert_close(mean, mean_p, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise, noise_p, rtol=0, atol=5e-4)
    mean_t, noise_t = kernels.chol_solve_blocked_plain(
        A[:2].cpu(), b[:2].cpu(), z[:2].cpu(), jitter)
    torch.testing.assert_close(mean[:2].cpu(), mean_t, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise[:2].cpu(), noise_t, rtol=0, atol=5e-4)


def test_kernel_wrappers_refuse_float64_on_the_card(dev):
    """The kernels take float32 only; a float64 tensor on the card raises
    by name at every wrapper, it is not cast silently (on the CPU the plain
    versions take it)."""
    f64 = dict(dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="chol_solve.*float32"):
        kernels.chol_solve(torch.eye(8, **f64)[None], torch.ones(1, 8, **f64),
                           torch.ones(1, 8, **f64))
    with pytest.raises(ValueError, match="mean_rss.*float32"):
        kernels.mean_rss(torch.ones(3, 4, 8, **f64), torch.ones(3, 4, **f64),
                         torch.ones(2, 3, 8, **f64))
    with pytest.raises(ValueError, match="weighted_gram.*float32"):
        kernels.weighted_gram(torch.ones(2, 3, **f64),
                              torch.ones(3, 8, 8, **f64))
    with pytest.raises(ValueError, match="mean_rss_grad.*float32"):
        kernels.mean_rss_grad(torch.ones(3, 4, 8, **f64),
                              torch.ones(3, 4, **f64),
                              torch.ones(2, 3, 8, **f64), torch.ones(2, **f64))
    mean, _ = kernels.chol_solve(torch.eye(8, dtype=torch.float64)[None] * 2,
                                 torch.ones(1, 8, dtype=torch.float64),
                                 torch.ones(1, 8, dtype=torch.float64))
    assert mean.dtype == torch.float64


def test_mean_rss_wide_p_raises_on_the_card(dev):
    """A P too wide for a block's tile of w: no kernel serves it, and on the
    card the wrapper raises; it does not give way to the plain version."""
    P = 2000
    g = torch.Generator(device=dev).manual_seed(0)
    B = torch.randn(4, 5, P, generator=g, device=dev)
    y = torch.randn(4, 5, generator=g, device=dev)
    w = torch.randn(3, 4, P, generator=g, device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="too wide"):
        kernels.mean_rss(B, y, w, want_mu=True)
    assert kernels.LAUNCHES["mean_rss"] == 0


def test_chol_solve_rejects_oversize_dimension(dev):
    """A D above the joint draws' ceiling (4,096) raises on the card and
    says why; nothing is launched and nothing goes to torch.linalg."""
    D = kernels.K1_MAX_DIM + 1
    A = torch.eye(D, device=dev)[None]
    b = torch.zeros(1, D, device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="4097 exceeds 4096"):
        kernels.chol_solve(A, b, b, 1e-6)
    assert kernels.LAUNCHES["chol_solve"] == 0


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("C,D", [(2, 337), (3, 401), (2, 1000), (1, 4096),
                                 (66, 401), (67, 401)])
def test_chol_solve_panels_kernel_matches_plain(dev, C, D, jitter):
    """The panels kernel (336 < D <= 4,096): its smallest D, D neither a
    multiple of 4 nor of 32, a last panel of 104 columns, the largest D at
    one chain (a cluster of 16), and a chain count on each side of the
    plan's cluster boundary (66 chains: two blocks a chain and the update
    for one block an SM; 67: one block a chain and two); against
    torch.linalg to K1's tolerances and, for two chains, against its order
    of work (``chol_solve_panels_plain``); the same bits from two calls, one
    launch counted a call; A left as it was."""
    plan = kernels.chol_solve_plan(C, D)
    assert plan["kernel"] == "panels"
    g = torch.Generator(device=dev).manual_seed(D + C)
    A, b, z = _spd(g, C, D, dev)
    A0 = A.clone()
    kernels.reset_launch_counts()
    mean, noise = kernels.chol_solve(A, b, z, jitter)
    mean2, noise2 = kernels.chol_solve(A, b, z, jitter)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chol_solve"] == 2
    assert torch.equal(mean, mean2) and torch.equal(noise, noise2)
    assert torch.equal(A, A0)
    mean_p, noise_p = kernels.chol_solve_plain(A, b, z, jitter)
    torch.testing.assert_close(mean, mean_p, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise, noise_p, rtol=0, atol=5e-4)
    mean_t, noise_t = kernels.chol_solve_panels_plain(
        A[:2].cpu(), b[:2].cpu(), z[:2].cpu(), jitter)
    torch.testing.assert_close(mean[:2].cpu(), mean_t, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise[:2].cpu(), noise_t, rtol=0, atol=5e-4)


@pytest.mark.parametrize("panel,cluster,update_blocks", [
    (64, 1, 1), (64, 16, 2), (128, 1, 2), (128, 4, 1), (128, 8, 2),
    (128, 16, 1)])
def test_chol_solve_panels_kernel_other_configurations(dev, panel, cluster,
                                                       update_blocks):
    """Every configuration the C entry point takes (the panel widths, the
    clusters, the update's blocks an SM), which the timings compare, gives
    the plan's answer to K1's tolerances at a ragged D."""
    C, D = 3, 1001
    g = torch.Generator(device=dev).manual_seed(D)
    A, b, z = _spd(g, C, D, dev)
    plan = dict(kernels.chol_solve_plan(C, D), panel=panel, cluster=cluster,
                update_blocks=update_blocks)
    mean, noise = torch.empty_like(b), torch.empty_like(b)
    assert kernels.panels_launch(A, b, z, mean, noise, 1e-6, plan) == 0
    mean_p, noise_p = kernels.chol_solve_plain(A, b, z, 1e-6)
    torch.testing.assert_close(mean, mean_p, rtol=0, atol=5e-5)
    torch.testing.assert_close(noise, noise_p, rtol=0, atol=5e-4)


@pytest.mark.parametrize("C,N,L,P,pad", [(256, 100, 100, 8, None),
                                         (512, 100, 100, 8, None),
                                         (3, 13, 24, 6, 16),
                                         (1, 100, 100, 8, None),
                                         (37, 7, 1500, 8, None),
                                         (5, 300, 3, 5, None),
                                         (20, 9, 11, 12, None),
                                         (200, 100, 100, 8, None),
                                         (400, 100, 100, 8, None),
                                         # the hd family: P = 16, L = 144
                                         (64, 64, 144, 16, None),
                                         (128, 64, 144, 16, None),
                                         (4, 64, 144, 16, None),
                                         (5, 9, 11, 16, 7),
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


@pytest.mark.parametrize("C,N,L,P", [(64, 100, 100, 8), (1, 100, 100, 8),
                                     (64, 64, 144, 16), (37, 7, 1500, 8),
                                     (300, 5, 3, 5), (3, 4, 9, 1280),
                                     (4, 100, 100, 8), (1, 64, 144, 16),
                                     (5, 9, 33, 10), (3, 4, 2000, 16),
                                     (5, 6, 50, 100), (2, 3, 20, 1280)])
def test_mean_rss_grad_kernel_matches_plain(dev, C, N, L, P):
    """K2's backward at the HMC path's shapes (64 chains and one), config
    5's P = 16, more points than a chunk, more chains than a tile, the
    widest P K2 serves, ADVI's 4 rows, one chain at P = 16, a general P of
    10, L in six chunks at P = 16, P split over 8 lanes, and the widest P
    in chunks: against its plain version and autograd through the plain
    forward, the same bits from two calls and through MeanRSS, one launch
    counted a call."""
    g = torch.Generator(device=dev).manual_seed(C + P)
    B = torch.randn(N, L, P, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    w = torch.randn(C, N, P, generator=g, device=dev)
    gv = torch.randn(C, generator=g, device=dev)
    before = kernels.LAUNCHES["mean_rss_grad"]
    got = kernels.mean_rss_grad(B, y, w, gv)
    assert torch.equal(got, kernels.mean_rss_grad(B, y, w, gv))
    wf = w.clone().requires_grad_()
    via_fn, = torch.autograd.grad(
        (kernels.MeanRSS.apply(B, y, wf) * gv).sum(), wf)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mean_rss_grad"] == before + 3
    assert torch.equal(via_fn, got)
    wa = w.clone().requires_grad_()
    auto, = torch.autograd.grad(
        (kernels.mean_rss_plain(B, y, wa)[0] * gv).sum(), wa)
    scale = auto.abs().max().item()
    for ref in (kernels.mean_rss_grad_plain(B, y, w, gv), auto):
        assert (got - ref).abs().max().item() <= 2e-5 * scale


@pytest.mark.parametrize("P", [8, 16])
def test_mean_rss_grad_kernel_takes_unaligned_views(dev, P):
    """B and w that start 4 bytes off a 16-byte boundary take the 4-byte
    copies and loads of the general instantiation, whose sums run in the
    same order: the aligned call's bits."""
    g = torch.Generator(device=dev).manual_seed(P)
    N, L, C = 10, 30, 5
    B = torch.randn(N * L * P + 1, generator=g, device=dev)
    w = torch.randn(C * N * P + 1, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    gv = torch.randn(C, generator=g, device=dev)
    Bv, wv = B[1:].view(N, L, P), w[1:].view(C, N, P)
    assert Bv.data_ptr() % 16 != 0 and wv.data_ptr() % 16 != 0
    got = kernels.mean_rss_grad(Bv, y, wv, gv)
    aligned = kernels.mean_rss_grad(Bv.clone(), y, wv.clone(), gv)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    plain = kernels.mean_rss_grad_plain(Bv, y, wv, gv)
    assert (got - plain).abs().max().item() <= 2e-5 * plain.abs().max().item()


@pytest.mark.parametrize("C,N,L,P", [(64, 100, 100, 8), (1, 64, 144, 16),
                                     (5, 9, 33, 10), (3, 4, 2000, 16),
                                     (5, 6, 50, 100)])
def test_mean_rss_grad_kernel_sums_in_the_twins_order(dev, C, N, L, P):
    """The kernel against ``mean_rss_grad_tiled_plain`` on the CPU, its
    order of sums with float32 fused multiply-adds formed in float64: equal
    to 1e-6 of max |grad| (the twin rounds twice where fmaf rounds once,
    which differs only in rare ties)."""
    g = torch.Generator(device=dev).manual_seed(L + P)
    B = torch.randn(N, L, P, generator=g, device=dev)
    y = torch.randn(N, L, generator=g, device=dev)
    w = torch.randn(C, N, P, generator=g, device=dev)
    gv = torch.randn(C, generator=g, device=dev)
    got = kernels.mean_rss_grad(B, y, w, gv).cpu()
    twin = kernels.mean_rss_grad_tiled_plain(B.cpu(), y.cpu(), w.cpu(),
                                             gv.cpu())
    assert (got - twin).abs().max().item() <= 1e-6 * twin.abs().max().item()


def test_mean_rss_grad_wide_p_raises_on_the_card(dev):
    B = torch.zeros(4, 5, 1281, device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="P=1281"):
        kernels.mean_rss_grad(B, torch.zeros(4, 5, device=dev),
                              torch.zeros(2, 4, 1281, device=dev),
                              torch.ones(2, device=dev))
    assert kernels.LAUNCHES["mean_rss_grad"] == 0


def test_log_joint_gradient_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The log-joint's value and gradient on the card equal the CPU's at
    one point (float32: 1e-4 relative, 1e-3 relative norm), one evaluation
    launching K2 forward and backward once each, no plain version."""
    from bayesfmmm_torch.config import ModelConfig, Priors
    from bayesfmmm_torch.models import logjoint
    from bayesfmmm_torch.samplers import hmc
    from bayesfmmm_torch.utils.simulate import simulate_functional

    def evaluate(where):
        data, _ = simulate_functional(seed=7, N=30, K=3, P=8, M=4,
                                      n_time=(40, 50), device=where)
        lj = logjoint.make_log_joint(data, Priors(),
                                     torch.full((3,), 10.0, device=where))
        u = logjoint.UncState(**{f: t.to(where) for f, t in vars(unc).items()})
        return hmc.value_and_grad(lambda q: lj(logjoint.unflatten(q, u)),
                                  logjoint.flatten(u))

    cpu_data, _ = simulate_functional(seed=7, N=30, K=3, P=8, M=4,
                                      n_time=(40, 50), device="cpu")
    unc = logjoint.init_unc(torch.Generator().manual_seed(1),
                            ModelConfig(K=3, P=8, M=4), cpu_data, 16)
    v0, g0 = evaluate("cpu")

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(kernels, "mean_rss_plain", refuse)
    monkeypatch.setattr(kernels, "mean_rss_grad_plain", refuse)
    kernels.reset_launch_counts()
    v1, g1 = evaluate(dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"chol_solve": 0, "mean_rss": 1,
                                "mean_rss_grad": 1, "weighted_gram": 0}
    v1, g1 = v1.cpu(), g1.cpu()
    assert ((v1 - v0).abs() / v0.abs()).max() < 1e-4
    assert ((g1 - g0).norm(dim=1) / g0.norm(dim=1)).max() < 1e-3


def test_fit_hmc_runs_on_the_card_by_default(dev):
    """A short fit_hmc with no device given, both methods: the data goes to
    the card, K2 forward and backward launch once a gradient evaluation,
    K1 and K3 never, and the draws are finite."""
    import numpy as np

    from bayesfmmm_torch import api
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=91, N=24, K=2, P=6, M=2,
                                  n_time=(25, 30), device="cpu")
    for method in ("hmc", "nuts"):
        kernels.reset_launch_counts()
        res = api.fit_hmc(data, K=2, M=2, n_warmup=20, n_samples=10,
                          n_chains=4, n_leapfrog=8, max_depth=4,
                          method=method)
        torch.cuda.synchronize()
        assert res.data.device.type == "cuda"
        assert res.final_state.Z.device.type == "cuda"
        d = res.hmc_diagnostics
        evals = 1 + int(d["n_steps"].max(0).sum() if method == "hmc" else
                        (2 ** d["depth"].max(0).astype(np.int64) - 1).sum())
        assert kernels.LAUNCHES == {"chol_solve": 0, "mean_rss": evals + 1,
                                    "mean_rss_grad": evals,
                                    "weighted_gram": 0}
        assert np.isfinite(res.all_chain_loglik).all()


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


# ---------------------------------------------------------------------------
# The fit pipeline on the card
# ---------------------------------------------------------------------------

def test_two_resumes_from_one_checkpoint_give_the_same_bits(dev, tmp_path):
    """The warm-ensemble protocol on the card: 16 chains of the production
    census with a tempered excursion, checkpointed, resumed twice (equal
    bits), and split against unbroken (equal bits)."""
    import numpy as np

    from bayesfmmm_torch import api
    from bayesfmmm_torch.io.checkpoint import load_checkpoint
    from bayesfmmm_torch.models.state import STATE_FIELDS
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=5, N=20, K=2, P=6, M=2,
                                  n_time=(20, 24))
    assert data.device.type == "cuda"
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, n_try=2)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, n_try=2)
    assert r1.final_state.Z.device.type == "cuda"
    ck = str(tmp_path / "ens.npz")
    kw = dict(kernels="production", n_temp_trans=60, N_t=2, beta_N_t=0.5,
              progress=False)
    whole = api.fit_warm_start(r1, r2, tot_mcmc_iters=200, n_chains=16,
                               seed=3, **kw)
    first = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, n_chains=16,
                               seed=3, checkpoint_to=ck, **kw)
    a = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                           **kw)
    b = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                           progress_every=30, **kw)
    assert load_checkpoint(ck, dev)[1].device.type == "cuda"
    with pytest.raises(ValueError, match="'cuda' generator.*'cpu'"):
        load_checkpoint(ck, "cpu")
    np.testing.assert_array_equal(a.all_chain_loglik, b.all_chain_loglik)
    np.testing.assert_array_equal(
        np.concatenate([first.all_chain_loglik, a.all_chain_loglik], 1),
        whole.all_chain_loglik)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.ensemble_state, f),
                           getattr(b.ensemble_state, f)), f
        assert torch.equal(getattr(a.ensemble_state, f),
                           getattr(whole.ensemble_state, f)), f
    for f in a.traces:
        np.testing.assert_array_equal(a.traces[f], b.traces[f])
    assert float((a.ensemble_state.nu - first.ensemble_state.nu)
                 .abs().max()) > 1e-6


def test_excursion_on_the_card_matches_the_cpu(dev):
    """The same excursion with a stub sweep on the card (pz_unit through K2)
    and on the CPU (through its plain version): logA to rtol 2e-4 / atol
    2e-3 (a sum of large terms that cancel), 2 N_t + 1 K2 launches."""
    from bayesfmmm_torch import convert
    from bayesfmmm_torch.config import Priors
    from bayesfmmm_torch.samplers import drivers
    from bayesfmmm_torch.utils.simulate import simulate_functional

    def stub(generator, st, data, hp, c, beta=1.0):
        return st.replace(nu=st.nu * 1.05 + 0.2 * beta,
                          sigma2=st.sigma2 * (1.0 + 0.1 * beta))

    out = {}
    for d in ("cpu", dev):
        data, truth = simulate_functional(seed=7, N=12, K=2, P=5, M=2,
                                          n_time=(8, 12), sigma2=0.5,
                                          device=d)
        st = convert.state_from_numpy(truth, chains=5, device=d)
        st = st.replace(sigma2=st.sigma2 * torch.linspace(0.5, 2.0, 5,
                                                          device=d))
        kernels.reset_launch_counts()
        new, acc, logA = drivers.tempered_excursion(
            torch.Generator(device=d).manual_seed(0), st, data, Priors(),
            None, drivers.make_temperature_ladder(0.25, 3), sweep_fn=stub)
        out[str(d)] = (new, acc, logA, kernels.LAUNCHES["mean_rss"])
    assert out["cpu"][3] == 0 and out[str(dev)][3] == 7
    assert out[str(dev)][2].device.type == "cuda"
    torch.testing.assert_close(out[str(dev)][2].cpu(), out["cpu"][2],
                               rtol=2e-4, atol=2e-3)


def test_config_4_checkpoint_split_equals_the_unbroken_run(dev, tmp_path):
    """The covariate-adjusted covariance model at the suite's config-4 width
    (K=2, P=8, M=16, N=80, D=1; 16 chains): Phi and xi both drawn jointly at
    D = 256 by the blocked kernel, twice a sweep; 100 + 100 sweeps of the
    production census through a checkpoint give the bits of one 200-sweep
    run, an excursion included, and the resume keeps covariate_cov."""
    import numpy as np

    from bayesfmmm_torch import api
    from bayesfmmm_torch.models.state import STATE_FIELDS
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=7, N=80, K=2, P=8, M=16, D=1,
                                  n_time=(100, 100), with_eta=True,
                                  with_xi=True)
    r1 = api.fit_nu_z(data=data, K=2, M=16, tot_mcmc_iters=100, n_try=1,
                      init="spectral")
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, covariate_cov=True)
    assert r2.config.covariate_cov and r2.final_state.xi.device.type == "cuda"
    ck = str(tmp_path / "c4.npz")
    kw = dict(kernels="production", n_temp_trans=60, N_t=2, beta_N_t=0.7,
              progress=False)
    whole = api.fit_warm_start(r1, r2, tot_mcmc_iters=200, n_chains=16,
                               seed=3, **kw)
    kernels.reset_launch_counts()
    first = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, n_chains=16,
                               seed=3, checkpoint_to=ck, **kw)
    # 99 sweeps and one excursion of 4: K1 twice each, at the blocked
    # kernel's D = 256
    assert kernels.LAUNCHES["chol_solve"] == 2 * (99 + 4)
    assert kernels.chol_solve_plan(16, 256)["kernel"] == "blocked"
    rest = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                              **kw)
    assert rest.config == r2.config
    np.testing.assert_array_equal(
        np.concatenate([first.all_chain_loglik, rest.all_chain_loglik], 1),
        whole.all_chain_loglik)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(rest.ensemble_state, f),
                           getattr(whole.ensemble_state, f)), f
    assert bool(rest.ensemble_state.xi.any())


# ---------------------------------------------------------------------------
# Post-processing: CPO on the card
# ---------------------------------------------------------------------------

def test_cpo_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The Woodbury CPO computed on the card equals the CPU's for the same
    traces within the float32 tolerance of tests/test_torch_post.py, at the
    covariate model (eta and xi, ragged masks), in chunks and whole."""
    import numpy as np

    from bayesfmmm_torch.post import cpo_fast
    from bayesfmmm_torch.utils.simulate import (simulate_draws,
                                                simulate_functional)

    kw = dict(N=12, K=3, P=6, M=3, D=1, n_time=(15, 24), with_eta=True,
              with_xi=True)
    data_c, truth = simulate_functional(seed=5, device="cpu", **kw)
    data_g, _ = simulate_functional(seed=5, device=dev, **kw)
    traces = simulate_draws(truth, 40, seed=11)
    X = data_c.X.numpy()
    want = cpo_fast.marginal_loglik_matrix(traces, data_c, X)
    for chunk in (None, 7):
        if chunk is not None:       # chunks of 7 draws
            monkeypatch.setattr(cpo_fast, "CHUNK_VALUES",
                                chunk * data_g.N * 3 * data_g.L)
        got = cpo_fast.marginal_loglik_matrix(traces, data_g, X)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(
        cpo_fast.cpo_fast(traces, data_g, X=X, burnin_prop=0.2),
        cpo_fast.cpo_fast(traces, data_c, X=X, burnin_prop=0.2),
        rtol=0, atol=2e-3)
    bad = dict(traces, sigma2=-traces["sigma2"])
    with pytest.raises(np.linalg.LinAlgError, match="positive definite"):
        cpo_fast.cpo_fast(bad, data_g)


def test_cpo_without_a_device_needs_the_card(tmp_path, monkeypatch):
    """ConditionalPredictiveOrdinates builds its data on the card when no
    device is given, and where there is no card it raises: it never falls
    back to the CPU.  Runs on any machine (the card is hidden)."""
    import numpy as np

    from bayesfmmm_torch import api, reference_api
    from bayesfmmm_torch.config import ModelConfig
    from bayesfmmm_torch.utils.simulate import (functional_lists,
                                                simulate_draws,
                                                simulate_functional)

    data, truth = simulate_functional(seed=1, N=6, K=2, P=6, M=2,
                                      n_time=(8, 10), device="cpu")
    Y, t = functional_lists(data, seed=1, n_time=(8, 10))
    api.export_traces(str(tmp_path), simulate_draws(truth, 10),
                      ModelConfig(K=2, P=6, M=2))
    args = (str(tmp_path), 1, 3, [0, 1], np.linspace(0, 1, 4)[1:-1], t, Y)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        reference_api.ConditionalPredictiveOrdinates(*args)
    assert reference_api.ConditionalPredictiveOrdinates(
        *args, device="cpu").shape == (6,)


# ---------------------------------------------------------------------------
# Parallel tempering and SMC: per-chain temperatures on the card
# ---------------------------------------------------------------------------

def _small_model(device, C, D=0):
    from bayesfmmm_torch.config import ModelConfig
    from bayesfmmm_torch.models.state import init_state
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=4, N=20, K=3, P=8, M=4, D=D,
                                  n_time=(30, 40), with_eta=D > 0,
                                  with_xi=D > 0, device=device)
    st = init_state(torch.Generator(device=device).manual_seed(1),
                    ModelConfig(K=3, P=8, M=4, D=D, covariate_mean=D > 0,
                                covariate_cov=D > 0), data, chains=C)
    return data, st, dict(covariate_mean=D > 0, covariate_cov=D > 0)


@pytest.mark.parametrize("census", ["reference", "production"])
@pytest.mark.parametrize("D", [0, 1])
def test_equal_tensor_beta_gives_the_float_bits_on_the_card(dev, census, D):
    """Two sweeps at a (C,) beta of equal entries b and at the float b give
    the same bits on the card, K1, K2 and K3 all launched."""
    from bayesfmmm_torch import api
    from bayesfmmm_torch.config import Priors
    from bayesfmmm_torch.models.state import STATE_FIELDS
    from bayesfmmm_torch.ops import gibbs

    flags = api.PRODUCTION_FLAGS if census == "production" else {}
    data, st, cov = _small_model(dev, 6, D)
    c = torch.full((3,), 10.0, device=dev)
    b = 0.375
    out = []
    kernels.reset_launch_counts()
    for beta in (b, torch.full((6,), b, device=dev)):
        g = torch.Generator(device=dev).manual_seed(7)
        s = st
        for _ in range(2):
            s = gibbs.sweep_full(g, s, data, Priors(), c, beta=beta, **cov,
                                 **flags)
        out.append(s)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in ("chol_solve", "mean_rss",
                                                  "weighted_gram")), \
        kernels.LAUNCHES
    assert kernels.LAUNCHES["mean_rss_grad"] == 0
    for f in STATE_FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


@pytest.mark.parametrize("name", ["z", "phi", "nu", "z_chi", "mgp_scale",
                                  "noise_scale", "phi_mala"])
def test_mixed_beta_gives_each_chain_its_float_on_the_card(dev, name):
    """At a mixed (C,) beta on the card, chain i is chain i of the
    same-seed call at the float beta[i], to f32 rounding."""
    from bayesfmmm_torch.config import Priors
    from bayesfmmm_torch.models.state import STATE_FIELDS
    from bayesfmmm_torch.ops import gibbs
    from bayesfmmm_torch.ops.mean import build_cache

    fns = {
        "z": gibbs.update_z, "phi": gibbs.update_phi, "nu": gibbs.update_nu,
        "z_chi": gibbs.update_z_chi, "mgp_scale": gibbs.update_mgp_scale,
        "noise_scale": gibbs.update_noise_scale,
        "phi_mala": gibbs.update_phi_mala}
    data, st, _ = _small_model(dev, 4)
    betas = (0.25, 1.0, 0.5, 0.75)
    v = torch.tensor(betas, device=dev)

    def run(beta):
        return fns[name](torch.Generator(device=dev).manual_seed(3), st,
                         data, Priors(), build_cache(data, st), beta)

    mixed = run(v)
    for i, b in enumerate(betas):
        one = run(b)
        for f in STATE_FIELDS:
            torch.testing.assert_close(getattr(mixed[0], f)[i],
                                       getattr(one[0], f)[i], rtol=1e-5,
                                       atol=1e-5)


def test_swap_and_resampling_helpers_on_the_card_match_the_cpu(dev):
    """The swap phase, systematic resampling (an index past the last
    particle clamped by take_chains, no device assert), the ESS and the
    next-beta bisection: the card's results are the CPU's."""
    from bayesfmmm_torch.models.state import take_chains
    from bayesfmmm_torch.parallel import tempering
    from bayesfmmm_torch.samplers import smc

    g = torch.Generator().manual_seed(0)
    E = torch.randn(9, generator=g) * 3 - 500
    ladder = tempering.geometric_ladder(9, 0.3)
    u = torch.rand(9, generator=g)
    for parity in (0, 1):
        cpu = tempering.swap_phase(E, ladder, parity, u)
        gpu = tempering.swap_phase(E.to(dev), ladder.to(dev), parity,
                                   u.to(dev))
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())
    ll = torch.randn(256, generator=g) * 40 - 9000
    for beta in (0.0, 0.2, 0.9):
        b = torch.tensor(beta)
        assert torch.equal(smc._next_beta(b, ll, 0.7, 256),
                           smc._next_beta(b.to(dev), ll.to(dev), 0.7,
                                          256).cpu())
    lw = torch.randn(256, generator=g)
    torch.testing.assert_close(smc.ess_from_log_weights(lw.to(dev)).cpu(),
                               smc.ess_from_log_weights(lw), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(
        smc.resample_from_uniform(torch.tensor(0.3, device=dev),
                                  lw.to(dev)).cpu(),
        smc.resample_from_uniform(torch.tensor(0.3), lw))
    # an index of N (a float32 sum ending below the last position)
    data, st, _ = _small_model(dev, 5)
    out = take_chains(st, torch.tensor([4, 5, 0], device=dev))
    torch.cuda.synchronize()
    assert torch.equal(out.sigma2, st.sigma2[[4, 4, 0]])


def test_fit_pt_and_fit_smc_run_on_the_card_by_default(dev):
    """A short fit_pt from phase results on the card and a short fit_smc
    with no device given: results on the card, finite, beta at 1."""
    import warnings

    import numpy as np

    from bayesfmmm_torch import api
    from bayesfmmm_torch.utils.simulate import functional_lists, \
        simulate_functional

    data, _ = simulate_functional(seed=3, N=20, K=2, P=5, M=2,
                                  n_time=(20, 25))
    assert data.device.type == "cuda"
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = api.fit_pt(r1, r2, tot_mcmc_iters=100, max_replicas=6,
                         beta_min=0.5, kernels="production")
    assert res.final_state.Z.device.type == "cuda"
    assert np.all(np.isfinite(res.loglik)) and res.traces["Z"].shape[0] == 100
    assert 2 <= len(res.ladder) <= 6 and 0.0 <= res.swap_rate <= 1.0
    Y, t = functional_lists(data, seed=3, n_time=(20, 25))
    s = api.fit_smc(Y, t, K=2, M=2, n_particles=32, internal_knots=[0.5],
                    boundary_knots=[0, 1], basis_degree=2)
    assert s["data"].device.type == "cuda"
    assert s["particles"].Z.device.type == "cuda"
    assert s["final_beta"] == 1.0 and np.isfinite(s["log_evidence"])


def test_fit_advi_init_runs_on_the_card_by_default(dev):
    """A short fit_advi_init with no device given: the data goes to the
    card, K2 forward and backward launch once an ADVI step, then the warm
    start's reference census 1/2/1 a sweep counted at its warm-up sweep and
    its capture (the other 99 sweeps replay the graph), and every draw is
    finite."""
    import numpy as np

    from bayesfmmm_torch import api
    from bayesfmmm_torch.samplers import drivers
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=3, N=20, K=2, P=5, M=2,
                                  n_time=(12, 16), device="cpu")
    kernels.reset_launch_counts()
    before = dict(drivers.SWEEP_GRAPHS)
    res = api.fit_advi_init(data, K=2, M=2, advi_steps=40, warm_iters=100,
                            n_chains=3)
    torch.cuda.synchronize()
    assert res.data.device.type == "cuda"
    n = drivers.WARMUP_SWEEPS + 1
    assert drivers.SWEEP_GRAPHS == dict(
        before, captures=before["captures"] + 1,
        replays=before["replays"] + 100 - drivers.WARMUP_SWEEPS,
        eager=before["eager"] + drivers.WARMUP_SWEEPS)
    assert kernels.LAUNCHES == {"chol_solve": n, "mean_rss": 40 + 2 * n,
                                "mean_rss_grad": 40, "weighted_gram": n}
    assert np.all(np.isfinite(res.elbo_trace))
    assert np.all(np.isfinite(res.all_chain_loglik))


@pytest.mark.parametrize("D", [0, 1])
def test_default_off_sweep_on_the_card(dev, D):
    """sweep_full with every default-off flag on the card: K1 1 (2 with
    xi), K2 11 and its backward 3 a sweep (7 of the production census,
    update_phi_chi's RSS, 1 + hmc_steps log-joint evaluations), K3 1 (2
    with eta), no plain K2; finite, Z on the simplex, xi moved only with
    covariate_cov."""
    from bayesfmmm_torch.config import ModelConfig, Priors
    from bayesfmmm_torch.models.state import STATE_FIELDS, init_state
    from bayesfmmm_torch.ops import gibbs
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=3, N=20, K=2, P=5, M=2, D=D,
                                  with_eta=D > 0, with_xi=D > 0,
                                  n_time=(12, 16), device=dev)
    cfg = ModelConfig(K=2, P=5, M=2, D=D, covariate_mean=D > 0)
    g = torch.Generator(device=dev).manual_seed(0)
    st = init_state(g, cfg, data, chains=8)
    c = torch.full((2,), 10.0, device=dev)
    kernels.reset_launch_counts()
    for _ in range(3):
        st = gibbs.sweep_full(g, st, data, Priors(), c, covariate_mean=D > 0,
                              collapsed_z=True, gauge=True, phi_mala_steps=4,
                              phi_chi_moves=2, z_anchor=True, hmc_steps=2)
    torch.cuda.synchronize()
    # no loglik probe here: 6 of the production census's 7 K2 launches
    assert kernels.LAUNCHES == {"chol_solve": 3, "mean_rss": 3 * 10,
                                "mean_rss_grad": 3 * 3,
                                "weighted_gram": 3 * (1 + D)}
    for f in STATE_FIELDS:
        assert bool(torch.isfinite(getattr(st, f)).all()), f
    torch.testing.assert_close(st.Z.sum(-1), torch.ones_like(st.Z[..., 0]))
    assert not st.xi.any()


# ---------------------------------------------------------------------------
# The captured sweep (samplers/drivers.py): replays against the eager loop
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_graphs(monkeypatch):
    """No graph held when the test starts, so that it captures its own."""
    from bayesfmmm_torch.samplers import drivers
    monkeypatch.setattr(drivers, "_GRAPH", None)
    return drivers


def _eager_run(monkeypatch, fn):
    """``fn()`` with run_chain on its eager loop."""
    from bayesfmmm_torch.samplers import drivers
    with monkeypatch.context() as m:
        m.setattr(drivers, "replays_sweep", lambda *a: False)
        return fn()


def _same_run(a, b):
    from bayesfmmm_torch.models.state import STATE_FIELDS
    for f in STATE_FIELDS:
        assert torch.equal(a.traces[f], b.traces[f]), f
        assert torch.equal(getattr(a.final_state, f),
                           getattr(b.final_state, f)), f
    assert torch.equal(a.loglik, b.loglik)


def _graph_model(dev, C, family="headline"):
    """(data, state, c, sweep flags): the headline model (K=3, P=8, M=4,
    N=100 curves of 100 points), config 4's covariate-adjusted model at two
    covariates (xi's joint draw at D = 512, K1's panels kernel with its
    cluster launch), or the multivariate family (identity basis)."""
    from bayesfmmm_torch.config import ModelConfig
    from bayesfmmm_torch.models.state import init_state
    from bayesfmmm_torch.utils.simulate import (simulate_functional,
                                                simulate_multivariate)
    if family == "headline":
        data, _ = simulate_functional(seed=11, N=100, K=3, P=8, M=4,
                                      n_time=(100, 100), device=dev)
        cfg = ModelConfig(K=3, P=8, M=4)
    elif family == "covariates":
        data, _ = simulate_functional(seed=7, N=80, K=2, P=8, M=16, D=2,
                                      n_time=(100, 100), with_eta=True,
                                      with_xi=True, device=dev)
        cfg = ModelConfig(K=2, P=8, M=16, D=2, covariate_mean=True,
                          covariate_cov=True)
    else:
        data, _ = simulate_multivariate(seed=7, N=200, K=2, P=10, M=3,
                                        device=dev)
        cfg = ModelConfig(K=2, P=10, M=3, family="multivariate")
    st = init_state(torch.Generator(device=dev).manual_seed(1), cfg, data,
                    chains=C)
    c = torch.full((cfg.K,), 10.0, device=dev)
    return data, st, c, dict(covariate_mean=cfg.covariate_mean,
                             covariate_cov=cfg.covariate_cov)


@pytest.mark.parametrize("C,thin", [(1, 1), (1, 2), (8, 1), (8, 2)])
def test_captured_reference_run_gives_the_eager_bits(dev, fresh_graphs,
                                                     monkeypatch, C, thin):
    """Seven sweeps of the headline model's reference census, captured and
    replayed, against the eager loop from the same generator state: every
    trace, the log-likelihoods, the final state and the generator's state
    afterwards bit for bit; one capture, the rest replays; K1, K2 and K3
    launched (counted at the warm-up and the capture)."""
    from bayesfmmm_torch.config import Priors
    drivers = fresh_graphs
    data, st, c, flags = _graph_model(dev, C)

    def run(seed_gen):
        return seed_gen, drivers.phase_warm_start(
            seed_gen, st, data, Priors(), c, n_iters=7, thin=thin, **flags)

    g_e, want = _eager_run(monkeypatch, lambda: run(
        torch.Generator(device=dev).manual_seed(3)))
    before = dict(drivers.SWEEP_GRAPHS)
    kernels.reset_launch_counts()
    g_r, got = run(torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    assert {k: drivers.SWEEP_GRAPHS[k] - before[k] for k in before} == {
        "captures": 1, "replays": 7 - drivers.WARMUP_SWEEPS,
        "eager": drivers.WARMUP_SWEEPS}
    # the warm-up sweeps with their kept draws' log-likelihoods, and the
    # capture's sweep and log-likelihood
    W = drivers.WARMUP_SWEEPS
    kept = sum((i + 1) % thin == 0 for i in range(W))
    assert kernels.LAUNCHES == {"chol_solve": W + 1,
                                "mean_rss": W + kept + 2,
                                "mean_rss_grad": 0, "weighted_gram": W + 1}
    _same_run(got, want)
    assert got.loglik.shape == (C, 7 // thin)
    assert torch.equal(g_r.get_state(), g_e.get_state())


# K1, K2 (without the run loop's log-likelihood) and K3 launches of one
# production sweep, by family: Phi's joint draw (and xi's), sigma's RSS, 4
# MGP-scale moves and MALA's RSS, nu's Gram (and eta's)
PRODUCTION_SWEEP = {"headline": (1, 6, 1), "covariates": (2, 6, 2),
                    "multivariate": (1, 0, 0)}


@pytest.mark.parametrize("family,C,thin", [
    ("headline", 8, 1), ("headline", 8, 2), ("covariates", 8, 1),
    ("covariates", 8, 2), ("multivariate", 2, 1)])
def test_captured_production_run_gives_the_eager_bits(
        dev, fresh_graphs, monkeypatch, family, C, thin):
    """Seven sweeps of the production census (collapsed (Z, chi), gauge,
    interweaves, four MALA steps with autograd's gradient), captured and
    replayed, against the eager loop from the same generator state: every
    trace, the log-likelihoods, the final state and the generator's state
    afterwards bit for bit; one capture, the rest replays; the hand kernels
    launched at the warm-up and the capture, K1's panels kernel among them
    at the covariate model's xi draw (D = 512)."""
    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.config import Priors
    drivers = fresh_graphs
    data, st, c, flags = _graph_model(dev, C, family)
    flags = dict(flags, **PRODUCTION_FLAGS)
    if family == "covariates":
        assert kernels.chol_solve_plan(C, 512)["kernel"] == "panels"

    def run(seed_gen):
        return seed_gen, drivers.phase_warm_start(
            seed_gen, st, data, Priors(), c, n_iters=7, thin=thin, **flags)

    g_e, want = _eager_run(monkeypatch, lambda: run(
        torch.Generator(device=dev).manual_seed(3)))
    before = dict(drivers.SWEEP_GRAPHS)
    kernels.reset_launch_counts()
    g_r, got = run(torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    assert {k: drivers.SWEEP_GRAPHS[k] - before[k] for k in before} == {
        "captures": 1, "replays": 7 - drivers.WARMUP_SWEEPS,
        "eager": drivers.WARMUP_SWEEPS}
    W = drivers.WARMUP_SWEEPS
    kept = sum((i + 1) % thin == 0 for i in range(W))
    k1, k2, k3 = PRODUCTION_SWEEP[family]
    probe = 1 if k2 else 0
    assert kernels.LAUNCHES == {"chol_solve": k1 * (W + 1),
                                "mean_rss": k2 * (W + 1)
                                + probe * (kept + 1),
                                "mean_rss_grad": 0,
                                "weighted_gram": k3 * (W + 1)}
    _same_run(got, want)
    assert got.loglik.shape == (C, 7 // thin)
    assert torch.equal(g_r.get_state(), g_e.get_state())


def test_each_census_captures_its_own_graph_on_the_card(dev, fresh_graphs,
                                                         monkeypatch):
    """One process runs the reference census, then the production census,
    then the reference again on the same data: each run captures its own
    graph in place of the one held, and each gives the eager run's bits
    and generator state."""
    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.config import Priors
    drivers = fresh_graphs
    data, st, c, ref = _graph_model(dev, 8)
    before = drivers.SWEEP_GRAPHS["captures"]
    for flags in (ref, dict(ref, **PRODUCTION_FLAGS), ref):
        def run():
            g = torch.Generator(device=dev).manual_seed(5)
            return g, drivers.phase_warm_start(g, st, data, Priors(), c,
                                               n_iters=4, **flags)

        g_e, want = _eager_run(monkeypatch, run)
        g_r, got = run()
        assert drivers._GRAPH.flags == flags
        _same_run(got, want)
        assert torch.equal(g_r.get_state(), g_e.get_state())
    assert drivers.SWEEP_GRAPHS["captures"] == before + 3


@pytest.mark.parametrize("census", ["reference", "production"])
def test_captured_runs_resume_through_a_checkpoint(dev, fresh_graphs,
                                                   monkeypatch, tmp_path,
                                                   census):
    """Two captured runs of 5 sweeps, the second resumed from the first's
    checkpoint (io.checkpoint: state and generator), give the bits of one
    eager run of 10, in either census; the second replays the cached
    graph."""
    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.config import Priors
    from bayesfmmm_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from bayesfmmm_torch.models.state import STATE_FIELDS
    drivers = fresh_graphs
    C = 1 if census == "reference" else 8
    data, st, c, flags = _graph_model(dev, C)
    if census == "production":
        flags = dict(flags, **PRODUCTION_FLAGS)
    whole = _eager_run(monkeypatch, lambda: drivers.phase_warm_start(
        torch.Generator(device=dev).manual_seed(4), st, data, Priors(), c,
        n_iters=10, **flags))
    g = torch.Generator(device=dev).manual_seed(4)
    first = drivers.phase_warm_start(g, st, data, Priors(), c, n_iters=5,
                                     **flags)
    ck = str(tmp_path / "graph.npz")
    save_checkpoint(ck, first.final_state, g, iteration=5)
    st2, g2, it, _ = load_checkpoint(ck, dev)
    before = dict(drivers.SWEEP_GRAPHS)
    rest = drivers.phase_warm_start(g2, st2, data, Priors(), c, n_iters=5,
                                    start_iter=it, **flags)
    assert drivers.SWEEP_GRAPHS == dict(before,
                                        replays=before["replays"] + 5)
    assert torch.equal(torch.cat([first.loglik, rest.loglik], 1),
                       whole.loglik)
    for f in STATE_FIELDS:
        assert torch.equal(torch.cat([first.traces[f], rest.traces[f]], 1),
                           whole.traces[f]), f
        assert torch.equal(getattr(rest.final_state, f),
                           getattr(whole.final_state, f)), f


@pytest.mark.parametrize("family", ["covariates", "multivariate"])
def test_captured_run_of_other_families_gives_the_eager_bits(
        dev, fresh_graphs, monkeypatch, family):
    """The covariate-adjusted reference census (eta and xi; xi's joint
    draw on K1's panels kernel, launched with a cluster) and the
    multivariate family (identity basis: no K2, no K3) replay too, with
    the eager loop's bits."""
    from bayesfmmm_torch.config import Priors
    drivers = fresh_graphs
    data, st, c, flags = _graph_model(dev, 2, family)
    if family == "covariates":
        assert kernels.chol_solve_plan(2, 512)["kernel"] == "panels"

    def run():
        g = torch.Generator(device=dev).manual_seed(6)
        return g, drivers.phase_warm_start(g, st, data, Priors(), c,
                                           n_iters=4, **flags)

    g_e, want = _eager_run(monkeypatch, run)
    before = drivers.SWEEP_GRAPHS["captures"]
    g_r, got = run()
    assert drivers.SWEEP_GRAPHS["captures"] == before + 1
    _same_run(got, want)
    assert torch.equal(g_r.get_state(), g_e.get_state())


@pytest.mark.parametrize("census", ["reference", "production"])
def test_capture_and_replays_under_the_profiler(dev, fresh_graphs,
                                                monkeypatch, census):
    """A run captured and replayed under torch.profiler, in either census:
    the eager run's bits; one capture span; a sweep span for every sweep
    outside it (the warm-up's and each replay's); one cudaGraphLaunch a
    replay; and K1, K2 and K3 of every replay on the profiler's device
    timeline."""
    from torch.profiler import ProfilerActivity, profile

    from bayesfmmm_torch.api import PRODUCTION_FLAGS
    from bayesfmmm_torch.config import Priors
    from bayesfmmm_torch.utils import observability as obs
    drivers = fresh_graphs
    C = 1 if census == "reference" else 8
    data, st, c, flags = _graph_model(dev, C)
    if census == "production":
        flags = dict(flags, **PRODUCTION_FLAGS)

    def run():
        g = torch.Generator(device=dev).manual_seed(2)
        return g, drivers.phase_warm_start(g, st, data, Priors(), c,
                                           n_iters=6, **flags)

    g_e, want = _eager_run(monkeypatch, run)
    obs.clear_spans()
    before = dict(drivers.SWEEP_GRAPHS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g_r, got = run()
        torch.cuda.synchronize()
    n_replays = 6 - drivers.WARMUP_SWEEPS
    assert {k: drivers.SWEEP_GRAPHS[k] - before[k] for k in before} == {
        "captures": 1, "replays": n_replays, "eager": drivers.WARMUP_SWEEPS}
    _same_run(got, want)
    assert torch.equal(g_r.get_state(), g_e.get_state())
    spans = obs.recorded_spans()
    cap = [s for s in spans if s.name == "samplers.drivers.capture_sweep"]
    assert len(cap) == 1
    outside = [s for s in spans if s.name == "ops.gibbs.sweep_full"
               and not cap[0].start_ns <= s.start_ns <= cap[0].end_ns]
    assert len(outside) == 6
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key == "cudaGraphLaunch")
    assert launches == n_replays
    # the warm-up sweep's and each replay's: K1 once, K2 twice in the
    # reference census (the sweep's sigma2 and the log-likelihood) and 7
    # times in the production census, K3 once
    k2 = 2 if census == "reference" else PRODUCTION_SWEEP["headline"][1] + 1
    for name, per_sweep in (("chol_tiled_kernel", 1),
                            ("mean_rss_tile_kernel", k2),
                            ("weighted_gram", 1)):
        n = sum(e.count for e in events if name in e.key)
        assert n == per_sweep * (n_replays + drivers.WARMUP_SWEEPS), (name, n)
