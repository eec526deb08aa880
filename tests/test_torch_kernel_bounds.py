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
    """Over D = 1..336: the tiled kernel's cyclic layout gives every entry
    on or below the diagonal to exactly one (thread, register) pair, the
    blocked kernel's packed storage one float to every entry of the
    triangle and of b, the grid covers every chain, and shared memory fits
    one block."""
    top = kernels.chol_solve_max_dim()
    assert top == 336
    for D in range(1, top + 1):
        plan = kernels.chol_solve_plan(C, D)
        assert plan["smem"] <= kernels.SMEM_PER_BLOCK
        assert plan["grid"] == C                # one chain a block
        if plan["kernel"] == "blocked":
            assert plan["tile"] is None and D > 128
            assert plan["threads"] == (kernels.K1_BLOCKED_THREADS,)
            assert plan["panel"] == kernels.K1_PANEL
            assert kernels.chol_solve_code(plan) == -kernels.K1_PANEL
            i, k = np.tril_indices(D + 1)
            i, k = i[k < D], k[k < D]           # row D is b: no diagonal
            off = kernels.packed_row(i) + k
            assert len(np.unique(off)) == len(off)
            assert off.max() < kernels.packed_row(D + 1)
            assert (kernels.packed_row(np.arange(D + 2)) % 4 == 0).all()
            assert plan["smem"] == 4 * (kernels.packed_row(D + 1) + D)
            continue
        assert plan["kernel"] == "tiled" and plan["panel"] is None
        (TR, TC), (RT, CT) = plan["threads"], plan["tile"]
        assert kernels.chol_solve_code(plan) == RT
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
    reach the blocked one; above 336 the panels kernel, up to the joint
    draws' ceiling of 4,096, above which the plan raises."""
    plan = kernels.chol_solve_plan(256, 96)
    assert plan["kernel"] == "tiled" and plan["threads"] == (16, 16)
    assert plan["tile"] == (6, 6) and plan["grid"] == 256
    assert 2 * plan["smem"] <= kernels.SMEM_PER_BLOCK
    assert plan["smem"] == 4 * (96 * 100 + 2 * 100 + 2 * 96 + 8)
    for D in (1, 13, 48, 95):
        assert kernels.chol_solve_plan(5, D)["tile"] == (6, 6)
    for D in (97, 128):
        assert kernels.chol_solve_plan(5, D)["tile"] == (8, 8)
    for D in (129, 200, 240, 241, 250, 256, 334, 336):
        assert kernels.chol_solve_plan(2, D)["kernel"] == "blocked"
    assert kernels.chol_solve_plan(2, 337)["kernel"] == "panels"
    with pytest.raises(NotImplementedError, match="4097 exceeds 4096"):
        kernels.chol_solve_plan(2, 4097)
    with pytest.raises(ValueError):
        kernels.chol_solve_plan(0, 96)


def _blocked_update_tiles(D, s, warps=kernels.K1_BLOCKED_THREADS // 32):
    """The trailing update's 4 x 4 tiles at a panel whose trailing part
    starts at s, as csrc/chol_solve.cu::update_trailing divides them: the
    groups (ga, gb) of 4 x 8 tiles on or below the diagonal, row of groups
    by row of groups, go to the warps in turn, and lane l of a warp owns
    tile (4 ga + l % 4, 8 gb + l // 4) of its group.  Returns (warp, first
    row, first column) of every tile that some lane updates."""
    n_rows, n_cols = (D - s) // 4 + 1, (D - s + 3) // 4
    ga = np.arange(-(-n_rows // 4))
    n_groups = np.minimum((4 * ga + 3) // 8 + 1, (n_cols + 7) // 8)
    g_a = np.repeat(ga, n_groups)
    g_b = np.concatenate([np.arange(n) for n in n_groups])
    lane = np.arange(32)
    ta = 4 * g_a[:, None] + lane % 4
    tb = 8 * g_b[:, None] + lane // 4
    warp = np.broadcast_to((np.arange(len(g_a)) % warps)[:, None], ta.shape)
    keep = (tb <= ta) & (ta < n_rows) & (tb < n_cols)
    return warp[keep], s + 4 * ta[keep], s + 4 * tb[keep]


def test_chol_blocked_panels_own_every_entry_once():
    """Over every D the blocked kernel serves, panel by panel: the diagonal
    block's rows go to the lanes of warp 0, the rows below it (row D, b,
    among them) to one thread each, and the 4 x 4 tiles of the trailing
    update own every entry (i, k) with s <= k <= min(i, D - 1), i <= D,
    exactly once; a tile's entries past the diagonal fall into its row's
    own pad (the row's 16-byte groups)."""
    threads, panel = kernels.K1_BLOCKED_THREADS, kernels.K1_PANEL
    for D in range(129, kernels.chol_solve_max_dim() + 1):
        width = np.diff(kernels.packed_row(np.arange(D + 2)))  # row + pad
        for k0 in range(0, D, panel):
            nb = min(panel, D - k0)
            s = k0 + nb
            assert k0 % 4 == 0 and (nb == panel or s == D)
            assert nb <= 32                     # one lane a row of the block
            rows = np.arange(s, D + 1)          # one thread a row
            assert len(rows) <= threads
            # the panel's 16-byte groups stay inside their rows
            assert (k0 + 4 * -(-nb // 4) <= width[rows]).all()
            if s == D:
                continue
            warp, i0, c0 = _blocked_update_tiles(D, s)
            assert ((0 <= warp) & (warp < threads // 32)).all()
            i = (i0[:, None, None] + np.arange(4)[None, :, None]).repeat(
                4, 2)
            k = (c0[:, None, None] + np.arange(4)[None, None, :]).repeat(
                4, 1)
            stored = i <= D                     # rows past D: not stored
            assert (c0[:, None] + 4 <= width[np.minimum(
                i[:, :, 0], D)]).all()
            own = np.zeros((D + 1, D + 4), dtype=int)
            np.add.at(own, (i[stored], k[stored]), 1)
            ii, kk = np.nonzero(own)
            assert (own[ii, kk] == 1).all()
            want = np.zeros_like(own, dtype=bool)
            for r in range(s, D + 1):
                want[r, s:min(r, D - 1) + 1] = True
            assert (own[want] == 1).all()
            pad = (own > 0) & ~want             # past the diagonal: its pad
            pi, pk = np.nonzero(pad)
            assert (pk > np.minimum(pi, D - 1)).all()
            assert (pk < width[pi]).all()


def test_chol_solve_rejects_oversize_dimension_on_any_device():
    """The wrapper's CPU route takes any D (the plain version) and counts
    nothing; the plan, which the CUDA route asks, refuses a D above the
    joint draws' ceiling and says why."""
    D = kernels.K1_MAX_DIM + 1
    A = torch.eye(D)[None] * 2.0
    b = torch.ones(1, D)
    kernels.reset_launch_counts()
    mean, noise = kernels.chol_solve(A, b, b)
    torch.testing.assert_close(mean, b / 2.0)
    torch.testing.assert_close(noise, b / 2.0 ** 0.5)
    assert kernels.LAUNCHES["chol_solve"] == 0
    with pytest.raises(NotImplementedError, match="one after another"):
        kernels.chol_solve_plan(1, D)


@pytest.mark.parametrize("which", ["tiled", "blocked", "panels"])
def test_k1_probe_patches_match_the_source(which):
    """Each knock-out of utils/k1_probe.py, of the register kernel, the
    blocked one (csrc/chol_solve.cu) and the panels one
    (csrc/chol_solve_panels.cu), patches its source in exactly one place,
    and changes it; a source in which one patch's text has moved on is
    refused."""
    from bayesfmmm_torch.utils import k1_probe
    text = (kernels._CSRC / k1_probe.SOURCES[which]).read_text()
    outs = k1_probe.KNOCK_OUTS[which]
    sources = k1_probe.patched_sources(text, outs,
                                       f"csrc/{k1_probe.SOURCES[which]}")
    assert set(sources) == set(outs) and sources["whole"] == text
    assert all(src != text for name, src in sources.items()
               if name != "whole")
    for name, patches in outs.items():
        for old, _ in patches:
            broken = text.replace(old, old[:-1] + "#" + old[-1])
            with pytest.raises(RuntimeError, match="not once"):
                k1_probe.patched_sources(broken, {name: patches})


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
        identity_basis=False, family="functional",
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


# ---------------------------------------------------------------------------
# The shapes of the covariate-adjusted models and the hd family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,nbytes,flop,bound_us,by", [
    # a triangle of A 256*257/2 = 32,896 floats and 4 vectors of 256 a
    # chain: 33,920 floats; D^3/3 + 3 D^2 = 5,789,013.3 FLOP a chain
    (16, 2_170_880, 16 * (256 ** 3 / 3 + 3 * 256 ** 2), 1.382, "operations"),
    (64, 8_683_520, 64 * (256 ** 3 / 3 + 3 * 256 ** 2), 5.530, "operations"),
    (256, 34_734_080, 256 * (256 ** 3 / 3 + 3 * 256 ** 2), 22.119,
     "operations"),
])
def test_kernel_bound_of_the_256_dimensional_draws(C, nbytes, flop, bound_us,
                                                   by):
    b = kernels.kernel_bound("chol_solve", C=C, D=256)
    assert b["bytes"] == nbytes
    assert b["flop"] == pytest.approx(flop, rel=1e-12)
    assert b["bound_by"] == by
    assert b["bound_ms"] == pytest.approx(bound_us * US, rel=1e-3)
    assert b["bound_ms"] == pytest.approx(
        1e3 * max(nbytes / 3.35e12, flop / 67e12), rel=1e-12)


def test_plans_at_the_new_main_path_shapes():
    """What the plans choose where slice 6 first puts them on a main path: K1
    at D = 256 the blocked kernel with its triangle, b and z in 135,184 bytes
    (one block an SM); K2 at the hd family's P = 16, L = 144 the kernel, its
    tile of w inside the budget; K3 the tiled kernel at update_eta's rows, at
    the sequential scan's and at P = 16 (66 KB at N = 64)."""
    for C in (16, 64, 256):
        plan = kernels.chol_solve_plan(C, 256)
        assert plan["kernel"] == "blocked" and plan["grid"] == C
        assert plan["smem"] == 135_184
        assert 2 * plan["smem"] > kernels.SMEM_PER_BLOCK
    assert kernels.chol_solve_plan(4, 60)["tile"] == (6, 6)     # config 1
    assert kernels.chol_solve_plan(8, 72)["tile"] == (6, 6)     # config 3
    for C in (4, 64, 128):
        plan = kernels.mean_rss_plan(C, 64, 144, 16)
        assert plan["smem"] == 4 * plan["TC"] * plan["TN"] * 16 \
            <= kernels.K2_W_SMEM
        assert plan["grid"][0] * plan["TC"] >= C
        assert plan["grid"][1] * plan["TN"] >= 64
    for R, N, P in ((48, 100, 8), (512, 80, 8), (32, 80, 8), (256, 64, 16),
                    (16, 64, 16)):
        plan = kernels.weighted_gram_plan(R, N, P)
        assert plan["tiled"] and plan["grid"][0] * plan["TR"] >= R
        assert plan["smem"] == 4 * (N * P * P + plan["TR"] * N) \
            <= kernels.SMEM_PER_BLOCK
    assert kernels.weighted_gram_plan(256, 64, 16)["smem"] == 66_048


def test_reset_launch_counts_clears_every_counter():
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 3
    kernels.reset_launch_counts()
    assert kernels.LAUNCHES == {"chol_solve": 0, "mean_rss": 0,
                                "mean_rss_grad": 0, "weighted_gram": 0}
