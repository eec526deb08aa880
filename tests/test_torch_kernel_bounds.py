"""What surrounds the CUDA kernels and runs on the CPU: the bounds of K1, K2
and K3 from their shapes, the kernel and thread layout K1 is launched with,
the tile plans K2 and K3 are launched with, and the port's device default.

The bounds are held against values worked out by hand for the main path's
shapes (256 chains of the headline model).  The plans are held to covering
every chain, observation and row exactly once, ragged shapes included, and
the plain versions evaluated tile by tile in the kernels' order are held
against the untiled ones to 1e-6 relative (float64, so only the order of
the sums differs).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.models import state as tstate  # noqa: E402
from bayesfmmm_torch.ops import kernels  # noqa: E402
from bayesfmmm_torch.utils import simulate as tsim  # noqa: E402

US = 1e-3   # ms per microsecond


@pytest.mark.parametrize("name,shape,nbytes,flop,bound_us,by", [
    # one triangle of the symmetric A 256*(96*97/2)*4 = 4,767,744 + (b, z,
    # mean, noise) 4*256*96*4 = 393,216; D^3/3 + 3 D^2 a chain
    ("chol_solve", dict(C=256, D=96), 5_160_960, 82_575_360, 1.541, "bytes"),
    # B 320,000 + y 40,000 + w 819,200 + rss 1,024; 19 FLOP a chain and point
    ("mean_rss", dict(C=256, N=100, L=100, P=8), 1_180_224, 48_640_000,
     0.726, "operations"),
    ("mean_rss", dict(C=512, N=100, L=100, P=8), 2_000_448, 97_280_000,
     1.452, "operations"),
    # W 307,200 + G 25,600 + out 196,608; 2 * 768 * 100 * 64
    ("weighted_gram", dict(R=768, N=100, P=8), 529_408, 9_830_400, 0.158,
     "bytes"),
])
def test_kernel_bound_main_path_shapes(name, shape, nbytes, flop, bound_us,
                                       by):
    b = kernels.kernel_bound(name, **shape)
    assert b["bytes"] == nbytes
    assert b["flop"] == flop
    assert b["bound_by"] == by
    assert b["bound_ms"] == pytest.approx(bound_us * US, rel=1e-3)
    assert b["bound_ms"] == pytest.approx(
        1e3 * max(nbytes / 3.35e12, flop / 67e12), rel=1e-12)


def test_kernel_bound_counts_mu_and_rejects_unknown():
    base = kernels.kernel_bound("mean_rss", C=4, N=5, L=6, P=3)
    with_mu = kernels.kernel_bound("mean_rss", C=4, N=5, L=6, P=3,
                                   want_mu=True)
    assert with_mu["bytes"] - base["bytes"] == 4 * 4 * 5 * 6
    assert with_mu["flop"] == base["flop"]
    with pytest.raises(KeyError):
        kernels.kernel_bound("no_such_kernel", C=1)


# ---------------------------------------------------------------------------
# K1's routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 3, 256, 1000])
def test_chol_solve_plan_owns_every_entry_once(C):
    """Over D = 1..240: the tiled kernel's cyclic layout gives every entry
    on or below the diagonal to exactly one (thread, register) pair, the
    grid covers every chain, and shared memory fits one block."""
    top = kernels.chol_solve_max_dim()
    assert top == 240
    for D in range(1, top + 1):
        plan = kernels.chol_solve_plan(C, D)
        assert plan["smem"] <= kernels.SMEM_PER_BLOCK
        assert plan["grid"] == C                # one chain a block
        if plan["kernel"] == "shared":
            assert plan["tile"] is None
            assert plan["smem"] == 4 * (D * D + 2 * D)
            continue
        assert plan["kernel"] == "tiled"
        (TR, TC), (RT, CT) = plan["threads"], plan["tile"]
        assert TR * RT == TC * CT >= D        # a square that covers A
        assert RT in kernels.K1_TILES and TR == TC == kernels.K1_GRID
        assert TR * TC <= 1024 and (TR * TC) % 32 == 0
        i, k = np.tril_indices(D)
        owner = ((i % TR) * TC + k % TC) * RT * CT + (i // TR) * CT + k // TC
        assert len(np.unique(owner)) == len(i)  # one owner each
        assert (i // TR < RT).all() and (k // TC < CT).all()


def test_chol_solve_plan_main_path_and_limits():
    """D = 96 takes the register-tiled kernel with 16 x 16 threads and 6 x 6
    tiles, one chain a block, two blocks an SM; above the tiled kernel's
    reach the shared-memory one; above 240 nothing."""
    plan = kernels.chol_solve_plan(256, 96)
    assert plan["kernel"] == "tiled" and plan["threads"] == (16, 16)
    assert plan["tile"] == (6, 6) and plan["grid"] == 256
    assert 2 * plan["smem"] <= kernels.SMEM_PER_BLOCK
    assert plan["smem"] == 4 * (96 * 100 + 2 * 100 + 2 * 96 + 8)
    for D in (1, 13, 48, 95):
        assert kernels.chol_solve_plan(5, D)["tile"] == (6, 6)
    for D in (97, 128):
        assert kernels.chol_solve_plan(5, D)["tile"] == (8, 8)
    for D in (129, 200, 240):
        assert kernels.chol_solve_plan(5, D)["kernel"] == "shared"
    with pytest.raises(NotImplementedError, match="K1 large-D"):
        kernels.chol_solve_plan(2, 241)
    with pytest.raises(ValueError):
        kernels.chol_solve_plan(0, 96)


def test_chol_solve_rejects_oversize_dimension_on_any_device():
    """The wrapper's CPU route takes any D (the plain version); the plan,
    which the CUDA route asks, names the queued large-D item."""
    D = kernels.chol_solve_max_dim() + 1
    A = torch.eye(D)[None] * 2.0
    b = torch.ones(1, D)
    mean, noise = kernels.chol_solve(A, b, b)
    torch.testing.assert_close(mean, b / 2.0)
    torch.testing.assert_close(noise, b / 2.0 ** 0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.chol_solve_plan(1, D)


def test_k1_probe_patches_match_the_source():
    """Each knock-out of utils/k1_probe.py patches csrc/chol_solve.cu in
    exactly one place, and changes it."""
    from bayesfmmm_torch.utils import k1_probe
    text = (kernels._CSRC / "chol_solve.cu").read_text()
    sources = k1_probe.patched_sources(text)
    assert set(sources) == set(k1_probe.KNOCK_OUTS) and sources["whole"] == text
    assert all(src != text for name, src in sources.items()
               if name != "whole")
    with pytest.raises(RuntimeError, match="not once"):
        k1_probe.patched_sources(text.replace("rsqrtf(d)", "rsqrtf(d + 0)"))


def _mean_rss_tiled(B, y, w, plan):
    """rss in K2's order: one partial sum per (point tile, chain), then the
    point tiles added in index order."""
    TN = plan["TN"]
    partial = torch.stack([
        kernels.mean_rss_plain(B[n0:n0 + TN], y[n0:n0 + TN],
                               w[:, n0:n0 + TN])[0]
        for n0 in range(0, B.shape[0], TN)])
    assert tuple(partial.shape) == plan["scratch"]
    rss = torch.zeros_like(partial[0])
    for t in range(partial.shape[0]):
        rss = rss + partial[t]
    return rss


@pytest.mark.parametrize("C,N,L,P", [
    (256, 100, 100, 8), (512, 100, 100, 8), (1, 100, 100, 8), (3, 13, 24, 6),
    (37, 7, 1500, 8), (5, 300, 3, 5), (700, 1, 1, 1), (20, 50, 100, 300),
    (200, 100, 100, 8), (400, 100, 100, 8), (1024, 100, 100, 8)])
@pytest.mark.parametrize("want_mu", [False, True])
def test_mean_rss_plan_covers_every_chain_and_point_once(C, N, L, P, want_mu):
    plan = kernels.mean_rss_plan(C, N, L, P, want_mu)
    TC, TN = plan["TC"], plan["TN"]
    assert TN >= 1 and TC in ((kernels.K2_MU_CHAIN_TILE,) if want_mu
                              else kernels.K2_CHAIN_TILES)
    assert plan["smem"] == 4 * TC * TN * P <= kernels.K2_W_SMEM
    seen = np.zeros((C, N), dtype=int)
    for bx, by in itertools.product(*map(range, plan["grid"])):
        assert bx * TC < C and by * TN < N          # no empty block
        seen[bx * TC:(bx + 1) * TC, by * TN:(by + 1) * TN] += 1
    assert (seen == 1).all()
    assert plan["scratch"] == (plan["grid"][1], C)


def test_mean_rss_plan_main_path_tiles():
    """At both main-path shapes the grid is one wave of at least 100 blocks
    and B is read from L2 11 and 13 times a call, not once per chain."""
    for C, TC, chain_tiles in ((256, 24, 11), (512, 40, 13)):
        plan = kernels.mean_rss_plan(C, 100, 100, 8)
        assert plan["TC"] == TC and plan["TN"] == 10
        assert plan["grid"] == (chain_tiles, 10)
        assert 100 <= chain_tiles * 10 <= kernels.SM_COUNT
        assert plan["TN"] * 100 <= kernels.K2_TILE_POINTS
    assert kernels.mean_rss_plan(100, 100, 100, 8)["TC"] == 8
    assert kernels.mean_rss_plan(200, 100, 100, 8)["TC"] == 24
    assert kernels.mean_rss_plan(400, 100, 100, 8)["TC"] == 40
    assert kernels.mean_rss_plan(1024, 100, 100, 8)["grid"] == (26, 10)
    # with mu the small tile, and the same point tiles: the same bits of rss
    with_mu = kernels.mean_rss_plan(512, 100, 100, 8, want_mu=True)
    assert with_mu["TC"] == kernels.K2_MU_CHAIN_TILE and with_mu["TN"] == 10
    with pytest.raises(NotImplementedError, match="too wide"):
        kernels.mean_rss_plan(4, 10, 10, 2000)
    with pytest.raises(ValueError):
        kernels.mean_rss_plan(0, 10, 10, 8)


@pytest.mark.parametrize("C,N,L,P", [(256, 100, 100, 8), (3, 13, 24, 6),
                                     (37, 7, 150, 8), (1, 5, 3, 4)])
def test_mean_rss_tile_by_tile_equals_untiled(C, N, L, P):
    rng = np.random.default_rng(C + N)
    B = torch.from_numpy(rng.normal(size=(N, L, P)))
    y = torch.from_numpy(rng.normal(size=(N, L)))
    w = torch.from_numpy(rng.normal(size=(C, N, P)))
    tiled = _mean_rss_tiled(B, y, w, kernels.mean_rss_plan(C, N, L, P))
    torch.testing.assert_close(tiled, kernels.mean_rss_plain(B, y, w)[0],
                               rtol=1e-6, atol=0)


def _weighted_gram_tiled(W, G, plan):
    """out in K3's order: each (row tile, column tile) from its rows of W
    and its columns of G, summed over n chunk after chunk."""
    R, N = W.shape
    PP = G.shape[-1] ** 2
    Gf = G.reshape(N, PP)
    TR, QT, NC = plan["TR"], plan["QT"], plan["NC"]
    out = torch.full((R, PP), float("nan"), dtype=W.dtype)
    for bi, bj in itertools.product(*map(range, plan["grid"])):
        rows = slice(bi * TR, min(R, (bi + 1) * TR))
        cols = slice(bj * QT, min(PP, (bj + 1) * QT))
        assert bi * TR < R and bj * QT < PP         # no empty block
        acc = 0.0
        for n0 in range(0, N, NC):
            acc = acc + W[rows, n0:n0 + NC] @ Gf[n0:n0 + NC, cols]
        assert bool(out[rows, cols].isnan().all())  # each output once
        out[rows, cols] = acc
    assert not bool(out.isnan().any())              # and every output
    return out.reshape(R, *G.shape[1:])


@pytest.mark.parametrize("R,N,P,tiled", [
    (768, 100, 8, True), (1, 100, 8, True), (5, 21, 8, True),
    (7, 130, 16, True), (4, 13, 6, True), (3, 40, 20, False),
    (5, 21, 5, False), (9, 3000, 8, False), (2, 13000, 3, False)])
def test_weighted_gram_plan_covers_every_output_once(R, N, P, tiled):
    """The tiled kernel for P <= 16 with P*P a multiple of 4 and G within a
    block's shared memory, the chunked one otherwise; either way a plain
    version evaluated block by block equals the untiled one."""
    plan = kernels.weighted_gram_plan(R, N, P)
    assert plan["tiled"] == tiled
    if tiled:
        assert plan["grid"][1] == 1 and plan["NC"] == N
        assert plan["threads"] == kernels.K3_THREADS
        assert plan["TR"] == plan["threads"] // (P * P // 4)
        assert plan["smem"] <= kernels.SMEM_PER_BLOCK
    else:
        assert plan["TR"] * plan["QT"] <= plan["threads"]
        assert plan["smem"] <= 4 * kernels.K3_CHUNK_FLOATS
    rng = np.random.default_rng(R + N)
    W = torch.from_numpy(rng.uniform(size=(R, N)))
    G = torch.from_numpy(rng.normal(size=(N, P, P)))
    torch.testing.assert_close(_weighted_gram_tiled(W, G, plan),
                               kernels.weighted_gram_plain(W, G),
                               rtol=1e-6, atol=1e-9)


def test_weighted_gram_plan_main_path_tiles():
    """R = 768 is one wave of 96 blocks of 8 rows: G staged 96 times."""
    plan = kernels.weighted_gram_plan(768, 100, 8)
    assert plan["grid"] == (96, 1) and plan["TR"] == 8
    assert plan["grid"][0] <= kernels.SM_COUNT
    assert plan["smem"] == 4 * (100 * 64 + 8 * 100)
    with pytest.raises(ValueError):
        kernels.weighted_gram_plan(0, 100, 8)


def test_empty_shapes_launch_nothing():
    """Empty inputs give empty or zero outputs without a plan."""
    B, y = torch.zeros(4, 0, 3), torch.zeros(4, 0)
    rss, mu = kernels.mean_rss(B, y, torch.ones(2, 4, 3), want_mu=True)
    assert rss.tolist() == [0.0, 0.0] and mu.shape == (2, 4, 0)
    out = kernels.weighted_gram(torch.ones(2, 0), torch.zeros(0, 3, 3))
    assert out.shape == (2, 3, 3) and not bool(out.any())
    with pytest.raises(ValueError):
        kernels.mean_rss_plan(2, 4, 0, 3)


def test_kernel_bench_loads_another_revision_beside_this_one(tmp_path):
    """An earlier revision's package directory gives a kernels module of
    its own, with its own build directory, and its wrappers' signatures."""
    from pathlib import Path

    from bayesfmmm_torch.utils import kernel_bench
    pkg = Path(kernels.__file__).resolve().parent.parent
    other = kernel_bench._baseline_kernels(pkg)
    assert other is not kernels and other.LAUNCHES is not kernels.LAUNCHES
    assert other._BUILD_DIR == kernels._BUILD_DIR
    W, G = torch.rand(3, 5), torch.rand(5, 2, 2)
    torch.testing.assert_close(other.weighted_gram(W, G),
                               kernels.weighted_gram(W, G))
    with pytest.raises(RuntimeError, match="no ops/kernels.py"):
        kernel_bench._baseline_kernels(tmp_path)


# ---------------------------------------------------------------------------
# The device default of the port's entry points
# ---------------------------------------------------------------------------

_SIM = dict(seed=3, N=6, K=2, P=5, M=2, n_time=(8, 10))


def _entry_points():
    data, truth = tsim.simulate_functional(**_SIM, device="cpu")
    mask = data.mask.numpy() > 0
    t_list = [np.linspace(0.0, 1.0, int(m.sum())) for m in mask]
    y_list = [data.y.numpy()[i][mask[i]] for i in range(len(mask))]
    jax_like = type("JaxModelData", (), dict(
        identity_basis=False,
        **{f: getattr(data, f).numpy()
           for f in ("y", "mask", "B", "X", "G", "pen", "u", "yy")}))()
    return {
        "simulate_functional":
            lambda **kw: tsim.simulate_functional(**_SIM, **kw)[0].y,
        "make_functional_data":
            lambda **kw: tstate.make_functional_data(
                y_list, t_list, basis_degree=3, internal_knots=[0.5],
                boundary_knots=[0.0, 1.0], **kw).y,
        "data_from_jax": lambda **kw: convert.data_from_jax(jax_like, **kw).y,
        "state_from_numpy":
            lambda **kw: convert.state_from_numpy(truth, chains=2, **kw).Z,
    }


@pytest.mark.parametrize("name", ["simulate_functional",
                                  "make_functional_data", "data_from_jax",
                                  "state_from_numpy"])
def test_entry_point_defaults_to_the_card(name):
    """No device given: tensors on the card, or the helper's RuntimeError
    where there is none (never a silent CPU run); device="cpu" works."""
    call = _entry_points()[name]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
        assert tstate.default_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tstate.default_device()
    assert tstate.default_device("cpu") == torch.device("cpu")
