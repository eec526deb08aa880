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
    its reach, the packed triangle above), ragged D that pads the tiles and
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
                                 (3, 130), (2, 200)])
def test_chol_solve_packed_kernel_matches_plain(dev, C, D, jitter):
    """The packed kernel (128 < D <= 334): the joint xi and hd Phi draws'
    D = 256 at the chain counts of the repo's configurations, an odd D, the
    smallest and the largest, against torch.linalg to the tiled kernel's
    tolerances; the same bits from two calls; and, for two chains, against
    its own plain version, which repeats its arithmetic."""
    assert kernels.chol_solve_plan(C, D)["kernel"] == "packed"
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
    mean_t, noise_t = kernels.chol_solve_packed_plain(
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
    """A D above every kernel raises on the card and names the queued
    item; nothing is launched and nothing goes to torch.linalg."""
    D = kernels.chol_solve_max_dim() + 1
    A = torch.eye(D, device=dev)[None]
    b = torch.zeros(1, D, device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="large-D"):
        kernels.chol_solve(A, b, b, 1e-6)
    assert kernels.LAUNCHES["chol_solve"] == 0


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
    D = 256 by the packed kernel, twice a sweep; 100 + 100 sweeps of the
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
    # 99 sweeps and one excursion of 4: K1 twice each, at the packed
    # kernel's D = 256
    assert kernels.LAUNCHES["chol_solve"] == 2 * (99 + 4)
    assert kernels.chol_solve_plan(16, 256)["kernel"] == "packed"
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
