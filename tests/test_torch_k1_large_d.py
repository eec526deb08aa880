"""K1 for the joint draws of 337 to 4,096 dimensions: the panels kernel's
plan, a transcription of its launches, its plain version, and the path
that reaches it (config 4's model at two covariates, whose joint xi draw
has K*M*D*P = 512 dimensions), against the JAX package on the CPU.

The CUDA kernels (csrc/chol_solve_panels.cu) run only on the card
(tests/test_torch_cuda.py).  Here their launches are transcribed in NumPy,
block by block and with the kernels' masks, on a workspace that starts as
NaN (what torch.empty may hand over), and held against torch.linalg: the
first diagonal block, the panel products with the inverse of each diagonal
block, the trailing updates tile by tile (the first read from A, the corner
tile factoring the next diagonal block), and the back substitutions over a
cluster of blocks, each owning its panels' rows; the plain version the card
checks them against (``chol_solve_panels_plain``) is held to torch.linalg
at the same dimensions; the port's precision draw,
``distributions.mvn_from_precision``, ``update_xi`` and a few reference
sweeps at the 512-dimensional draw are held to the JAX package's on the
same inputs (made with numpy from a seed) and, where a draw is taken, the
same injected noise.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.config import Priors  # noqa: E402
from bayesfmmm_tpu.models.likelihood import (  # noqa: E402
    log_likelihood as jlog_likelihood)
from bayesfmmm_tpu.ops import distributions as jdist  # noqa: E402
from bayesfmmm_tpu.ops import gibbs as jg  # noqa: E402
from bayesfmmm_tpu.ops import linalg as jlinalg  # noqa: E402
from bayesfmmm_tpu.ops.mean import build_cache as jcache  # noqa: E402
from bayesfmmm_tpu.utils.simulate import simulate_functional  # noqa: E402
from bayesfmmm_torch import convert  # noqa: E402
from bayesfmmm_torch.config import Priors as TPriors  # noqa: E402
from bayesfmmm_torch.models.likelihood import log_likelihood  # noqa: E402
from bayesfmmm_torch.models.state import STATE_FIELDS  # noqa: E402
from bayesfmmm_torch.ops import distributions as tdist  # noqa: E402
from bayesfmmm_torch.ops import gibbs as tg  # noqa: E402
from bayesfmmm_torch.ops import kernels, linalg  # noqa: E402
from bayesfmmm_torch.ops.mean import build_cache as tcache  # noqa: E402

from test_torch_covariates import (  # noqa: E402,F401
    _close, _jstate, _random_states, injected_noise)

K1_TOL = {"mean": 5e-5, "noise": 5e-4}     # tests/test_linalg.py:101-102
TILE, ROWS = kernels.K1_PANELS_TILE, kernels.K1_PANELS_ROWS
# config 4's model (benchmarks/suite.py:37-38) at config 3's two covariates
CONFIG4_D2 = dict(seed=7, K=2, P=8, M=16, D=2, with_eta=True, with_xi=True)


def _spd(seed, C, D, diag=40.0):
    """C SPD (D, D) matrices X X^T + diag * I and two right-hand sides,
    float32, from numpy."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(C, D, D))
    A = X @ X.transpose(0, 2, 1) + diag * np.eye(D)
    return (A.astype(np.float32), rng.normal(size=(C, D)).astype(np.float32),
            rng.normal(size=(C, D)).astype(np.float32))


def _plain(A, b, z, jitter):
    mean, noise = kernels.chol_solve_plain(*map(torch.from_numpy, (A, b, z)),
                                           jitter)
    return mean.numpy(), noise.numpy()


# ---------------------------------------------------------------------------
# (a) The plan and the bound
# ---------------------------------------------------------------------------

def test_k1_ceiling_is_the_joint_draws_ceiling():
    """K1 serves every joint draw the Gibbs updaters take, in both
    packages, and no more."""
    assert kernels.K1_MAX_DIM == tg._JOINT_MAX_DIM == jg._JOINT_MAX_DIM
    assert kernels.chol_solve_max_dim() < kernels.K1_MAX_DIM


@pytest.mark.parametrize("C,D,launches,ld,cluster", [
    (16, 512, 9, 512, 4), (256, 512, 9, 512, 1), (64, 400, 9, 400, 2),
    (2, 337, 7, 340, 2), (3, 401, 9, 404, 4), (2, 1000, 17, 1000, 8),
    (4, 1024, 17, 1024, 8), (2, 2048, 33, 2048, 16),
    (1, 4096, 65, 4096, 16)])
def test_chol_solve_plan_panels_shapes(C, D, launches, ld, cluster):
    """Above the blocked kernel every D up to 4,096 plans the panels kernel:
    panels of 128, 128 x 128 update tiles, 64 rows a panel-product block,
    256 threads a block, the row stride D rounded up to 4 floats; the first
    diagonal block, a panel product a panel, an update for every panel but
    the last and the back substitutions, over a cluster of the largest
    power of two of blocks, up to 16 and the panels, that keeps C of them
    on the 132 SMs; the workspace (C, D + 1, LD) and the jitter a chain;
    each launch's shared memory within a block's, the back substitutions'
    within the 48 KB a block has without opting in; the update compiled for
    two blocks an SM from 66 chains on, one below."""
    plan = kernels.chol_solve_plan(C, D)
    nb = plan["panel"]
    assert plan["kernel"] == "panels" and nb == 128
    assert plan["tile"] == (128, 128) and plan["rows"] == 64
    assert plan["grid"] == C and plan["threads"] == 256
    assert plan["ld"] == ld and ld % 4 == 0 and ld >= D
    assert plan["launches"] == launches == 2 * math.ceil(D / nb) + 1
    assert plan["cluster"] == cluster
    assert plan["update_blocks"] == (2 if C >= 66 else 1)
    assert C * cluster <= kernels.SM_COUNT or cluster == 1
    assert cluster <= min(16, math.ceil(D / nb))
    assert plan["workspace"] == 4 * C * ((D + 1) * ld + 1)
    smem = plan["smem_by_launch"]
    # the factor's scratch: 32 rows of nb and a column
    assert smem == {"first": 4 * (nb * (nb + 4) + 32 * nb + 32),
                    "panel": 4 * (nb + 64) * (nb + 4),
                    "update": 4 * (128 * 132 + 32 * nb + 32),
                    "solve": 4 * (2 * math.ceil(math.ceil(D / nb) / cluster)
                                  * nb + 6 * nb + 8 * 256)}
    assert plan["smem"] == max(smem.values()) <= kernels.SMEM_PER_BLOCK
    assert smem["solve"] <= kernels.SMEM_DEFAULT


@pytest.mark.parametrize("C,nb,cluster", [
    (1, 128, 16), (1, 64, 16), (8, 128, 16), (9, 128, 8), (16, 128, 8),
    (17, 128, 4), (33, 128, 4), (34, 128, 2), (66, 128, 2), (67, 128, 1),
    (256, 128, 1), (66, 64, 2)])
def test_panels_cluster_boundaries(C, nb, cluster):
    """The back substitutions' cluster at D = 4,096 (32 panels of 128):
    the largest power of two up to 16 with C of them on the 132 SMs; one
    block a chain from 67 chains on."""
    assert kernels.panels_cluster(C, -(-4096 // nb)) == cluster
    assert kernels.panels_cluster(C, 3) <= 2


def test_chol_solve_plan_workspace_at_the_top_of_the_range():
    """The bytes say what a call costs: 269 MB of workspace at the slice's
    production shape, 67 MB at one chain of D = 4,096 and 17.2 GB at 256
    of them (beside the 17.2 GB of A), which no path asks for; above 4,096
    the plan raises."""
    assert kernels.chol_solve_plan(256, 512)["workspace"] == 268_960_768
    assert kernels.chol_solve_plan(1, 4096)["workspace"] == 67_125_252
    assert kernels.chol_solve_plan(256, 4096)["workspace"] == 17_184_064_512
    assert kernels.chol_solve_plan(2, 4096)["kernel"] == "panels"
    with pytest.raises(NotImplementedError, match="4097 exceeds 4096"):
        kernels.chol_solve_plan(1, 4097)


@pytest.mark.parametrize("C,D,nbytes,flop,bound_us", [
    # a triangle of A, b, z, mean and noise; D^3/3 + 3 D^2 a chain
    (16, 512, 8_536_064, 728_410_795, 10.872),
    (256, 512, 136_577_024, 11_654_572_715, 173.949),
    (64, 400, 20_940_800, 1_396_053_333, 20.837),
    (4, 1024, 8_462_336, 1_444_238_677, 21.556),
    (1, 4096, 33_628_160, 22_956_823_893, 342.639)])
def test_kernel_bound_panels_shapes(C, D, nbytes, flop, bound_us):
    b = kernels.kernel_bound("chol_solve", C=C, D=D)
    assert b["bytes"] == nbytes
    assert b["flop"] == pytest.approx(flop, abs=1)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(bound_us * 1e-3, rel=1e-4)


def _tile_of(t, nC):
    """csrc/chol_solve_panels.cu::tile_of, in float32 as the card takes the
    square root."""
    tri = nC * (nC + 1) // 2
    if t < tri:
        rt = int((np.sqrt(np.float32(8.0) * np.float32(t) + np.float32(1.0))
                  - np.float32(1.0)) * np.float32(0.5))
        while rt * (rt + 1) // 2 > t:
            rt -= 1
        while (rt + 1) * (rt + 2) // 2 <= t:
            rt += 1
        return rt, t - rt * (rt + 1) // 2
    return nC + (t - tri) // nC, (t - tri) % nC


def _update_tiles(D, s):
    """The trailing update's grid at a panel whose trailing part starts at
    s, as bfmmm_chol_solve_panels sizes it: [(row tile, column tile)]."""
    nC = -(-(D - s) // TILE)
    nR = -(-(D + 1 - s) // TILE)
    tiles = nC * (nC + 1) // 2 + (nR - nC) * nC
    return [_tile_of(t, nC) for t in range(tiles)]


@pytest.mark.parametrize("D", [337, 400, 401, 449, 512, 513, 1000, 1024,
                               2049])
def test_panels_update_tiles_own_every_entry_once(D):
    """Panel by panel, the update's tiles own every entry (i, j) with s <=
    j <= min(i, D - 1), i <= D, exactly once and no tile is idle: a 128 x
    128 tile stores where i <= D, j < D and j <= i, and the tiles of a row
    tile that holds row D alone store row D's columns; the panel product's
    blocks own the rows s..D once each; the corner tile holds the next
    diagonal block."""
    NB = kernels.chol_solve_plan(1, D)["panel"]
    for k0 in range(0, D - NB, NB):
        s = k0 + NB
        rows = (s + np.arange(-(-(D + 1 - s) // ROWS))[:, None] * ROWS
                + np.arange(ROWS)[None, :]).ravel()
        assert np.array_equal(np.sort(rows[rows <= D]), np.arange(s, D + 1))
        tiles = _update_tiles(D, s)
        assert len(set(tiles)) == len(tiles)
        own = np.zeros((D + 1, D), dtype=int)
        for rt, ct in tiles:
            assert ct <= rt
            i = s + TILE * rt + np.arange(TILE)[:, None]
            j = s + TILE * ct + np.arange(TILE)[None, :]
            if s + TILE * rt == D:
                keep = (j < D) & (i == D)
            else:
                keep = (i <= D) & (j < D) & (j <= i)
            assert keep.any()
            np.add.at(own, (np.broadcast_to(i, keep.shape)[keep],
                            np.broadcast_to(j, keep.shape)[keep]), 1)
        want = np.zeros_like(own, dtype=bool)
        for r in range(s, D + 1):
            want[r, s:min(r, D - 1) + 1] = True
        assert (own[want] == 1).all() and (own[~want] == 0).all()
        assert tiles[0] == (0, 0) and min(NB, D - s) <= TILE


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_panels_solve_clusters_own_every_row_once(cs):
    """The back substitutions' blocks of a cluster of cs own the panels
    rank, rank + cs, ...: before each panel's step, every panel above it is
    owned by exactly one block, which keeps its entries in at most
    ceil(panels / cs) slots of shared memory; the panel itself belongs to
    its owner, p mod cs."""
    for D, nb in ((4096, 128), (1000, 128), (4096, 64)):
        n_panels = -(-D // nb)
        slots = -(-n_panels // cs)
        for p in range(n_panels):
            owned = [q for rank in range(cs)
                     for q in kernels.panels_owned(p, rank, cs)]
            assert sorted(owned) == list(range(p))
            assert p in range(p % cs, n_panels, cs)
        for rank in range(cs):
            assert len(range(rank, n_panels, cs)) <= slots
            mine = kernels.panels_owned(n_panels, rank, cs)
            assert all(q % cs == rank for q in mine)


def _factor_block(S):
    """csrc/chol_solve_panels.cu::factor_diagonal_block in NumPy float32 on
    the lower triangle of an nb x nb block: per 32 columns, factor_32's
    column steps (one reciprocal square root each, the diagonal taken down
    as the columns go, the inverse's columns beside), the rows below times
    the inverse transposed, the rest of the block less their product, and
    the inverse's block row -(L^-1[I][I] L[I][<I]) L^-1[<I][<I].  Returns
    the block as the kernel leaves it: L below the diagonal, 1 / L_jj on
    it, L^-1 transposed above."""
    f32 = np.float32
    n = S.shape[0]
    S = np.tril(S).astype(f32)
    Y = np.zeros((n, n), f32)
    for q0 in range(0, n, 32):
        q1 = min(n, q0 + 32)
        m = q1 - q0
        x = S[q0:q1, q0:q1].copy()
        dg = np.diag(x).copy()
        y = np.eye(m, dtype=f32)                   # y[:, c]: column c
        for j in range(m):
            inv = f32(1.0) / np.sqrt(dg[j])
            col = np.zeros(m, f32)
            col[j + 1:] = x[j + 1:, j] * inv
            x[:, j] = col
            x[j, j] = inv
            y[j] *= inv
            x[:, j + 1:] -= col[:, None] * col[None, j + 1:]
            dg[j + 1:] -= col[j + 1:] * col[j + 1:]
            y[j + 1:] -= col[j + 1:, None] * y[j][None, :]
        S[q0:q1, q0:q1] = np.tril(x)
        Y[q0:q1, q0:q1] = np.tril(y)
        if q1 < n:
            X = S[q1:, q0:q1] @ Y[q0:q1, q0:q1].T
            S[q1:, q0:q1] = X
            S[q1:, q1:] -= np.tril(X @ X.T)
        if q0 > 0:
            M = Y[q0:q1, q0:q1] @ S[q0:q1, :q0]
            Y[q0:q1, :q0] = -(M @ Y[:q0, :q0])
    return np.tril(S) + np.triu(Y.T, 1)


def _store_diagonal_block(Wc, B, k0):
    """store_diagonal_block: L^-T of the factored block, zeros below its
    diagonal and past nb to the end of the 16-byte group."""
    n = B.shape[0]
    g = 4 * -(-n // 4)
    out = np.zeros((n, g), np.float32)
    out[:, :n] = np.triu(B)
    Wc[k0:k0 + n, k0:k0 + g] = out


def _panels_transcription(A, b, z, jitter, cs=None):
    """csrc/chol_solve_panels.cu in NumPy float32, launch by launch and
    block by block, with the kernels' masks and the plan's panel width and
    cluster (or ``cs``).  The workspace and the jitter buffer start as NaN,
    so a read of a place no launch wrote reaches the result.  Returns
    (mean, noise, launches)."""
    C, D = b.shape
    plan = kernels.chol_solve_plan(C, D)
    NB, LD = plan["panel"], plan["ld"]
    cs = cs or plan["cluster"]
    f32 = np.float32
    W = np.full((C, D + 1, LD), np.nan, f32)
    eps = np.full(C, np.nan, f32)
    # panels_first: the jitter and the first diagonal block, from A
    launches = 1
    for c in range(C):
        eps[c] = f32(jitter * (A[c].diagonal().sum(dtype=f32) / D + 1.0)) \
            if jitter else f32(0.0)
        B = A[c, :NB, :NB].copy()
        B[np.diag_indices(NB)] += eps[c]
        _store_diagonal_block(W[c], _factor_block(B), 0)
    for k0 in range(0, D, NB):
        nb = min(NB, D - k0)
        s = k0 + nb
        g = 4 * -(-nb // 4)
        # panels_panel: rows s..D of the panel times L11^-T, 64 a block
        launches += 1
        for c in range(C):
            LT = np.zeros((NB, NB), f32)
            LT[:nb, :g] = W[c, k0:k0 + nb, k0:k0 + g]
            for r0 in range(s, D + 1, ROWS):
                i = np.arange(r0, min(r0 + ROWS, D + 1))
                X = np.zeros((len(i), NB), f32)
                if k0 == 0:
                    X[i < D] = A[c, i[i < D], :NB]
                    X[i == D] = b[c, :NB]
                else:
                    X[:, :g] = W[c, i, k0:k0 + g]
                    X[:, nb:] = 0.0
                W[c, i, k0:k0 + g] = (X @ LT)[:, :g]
        if s == D:
            continue
        # panels_update: the trailing part, tile by tile; the first from A
        launches += 1
        nbn = min(NB, D - s)
        for c in range(C):
            for rt, ct in _update_tiles(D, s):
                i = s + TILE * rt + np.arange(TILE)
                j = s + TILE * ct + np.arange(TILE)
                if s + TILE * rt == D:
                    jj = j[j < D]
                    src = b[c, jj] if k0 == 0 else W[c, D, jj]
                    W[c, D, jj] = src - W[c, jj, k0:s] @ W[c, D, k0:s]
                    continue
                Xr = np.where((i <= D)[:, None], W[c, np.minimum(i, D), k0:s],
                              f32(0.0))
                Xc = Xr if rt == ct else np.where(
                    (j < D)[:, None], W[c, np.minimum(j, D), k0:s], f32(0.0))
                acc = Xr @ Xc.T
                keep = (i[:, None] <= D) & (j[None, :] < D) \
                    & (j[None, :] <= i[:, None])
                ii, jj = np.nonzero(keep)
                if k0 == 0:
                    src = np.where(i[ii] < D,
                                   A[c, np.minimum(i[ii], D - 1), j[jj]],
                                   b[c, j[jj]])
                    src = src + np.where(i[ii] == j[jj], eps[c], f32(0.0))
                else:
                    src = W[c, i[ii], j[jj]]
                W[c, i[ii], j[jj]] = src - acc[ii, jj]
                if rt == ct == 0:
                    B = W[c, s:s + nbn, s:s + nbn]
                    _store_diagonal_block(W[c], _factor_block(np.tril(B)), s)
    # panels_solve: a cluster of cs blocks a chain, block r owning panels
    # r, r + cs, ...
    launches += 1
    n_panels = -(-D // NB)
    mean, noise = np.empty_like(b), np.empty_like(b)
    for c in range(C):
        wz = np.zeros((2, n_panels * NB), f32)
        wz[0, :D], wz[1, :D] = W[c, D, :D], z[c]
        U = {q: wz[:, q * NB:(q + 1) * NB].copy() for q in range(n_panels)}
        updated = np.zeros(n_panels, int)
        for p in range(n_panels - 1, -1, -1):
            k0 = p * NB
            nb = min(NB, D - k0)
            assert updated[p] == n_panels - 1 - p
            x = np.triu(W[c, k0:k0 + nb, k0:k0 + nb]) @ U[p][:, :nb].T
            U[p][:, :nb] = x.T
            for rank in range(cs):
                for q in kernels.panels_owned(p, rank, cs):
                    U[q] -= (W[c, k0:k0 + nb, q * NB:(q + 1) * NB].T @ x).T
                    updated[q] += 1
        out = np.concatenate([U[q] for q in range(n_panels)], 1)[:, :D]
        mean[c], noise[c] = out
    return mean, noise, launches


@pytest.mark.parametrize("C,D,cs", [(2, 337, None), (2, 401, None),
                                    (1, 1000, None), (1, 1000, 1)])
@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_panels_transcription_matches_plain(C, D, cs, jitter):
    """The kernels' launches as transcribed above give torch.linalg's draw
    within K1's tolerances, read nothing that no launch wrote (the result
    is finite from a NaN workspace), and make as many launches as the plan
    says: the smallest D, D neither a multiple of 4 nor of 32 (a last panel
    of 17 columns), and D with a last panel of 104 and a row D in a tile
    of its own, with the plan's cluster (2, 2, 8) and one block a chain."""
    A, b, z = _spd(D + C, C, D)
    mean, noise, launches = _panels_transcription(A, b, z, jitter, cs)
    assert launches == kernels.chol_solve_plan(C, D)["launches"]
    assert np.isfinite(mean).all() and np.isfinite(noise).all()
    mean_p, noise_p = _plain(A, b, z, jitter)
    assert np.abs(mean - mean_p).max() <= K1_TOL["mean"]
    assert np.abs(noise - noise_p).max() <= K1_TOL["noise"]


def test_panels_transcription_carries_a_failed_pivot():
    """A matrix that is not positive definite gives NaN, which reaches the
    draw: nothing is clamped."""
    A, b, z = _spd(5, 1, 337)
    A[0, 200, 200] = -1e4
    with np.errstate(invalid="ignore"):
        mean, noise, _ = _panels_transcription(A, b, z, 0.0)
    assert np.isnan(mean).any() and np.isnan(noise).any()


@pytest.mark.parametrize("n", [17, 64, 100, 128])
def test_factor_diagonal_block_matches_torch(n):
    """The kernel's factor of a diagonal block (ops/kernels.py in PyTorch,
    the transcription above in NumPy) gives the Cholesky factor and its
    inverse: in float64 to rounding, in float32 to 1e-5 of the identity."""
    A, _, _ = _spd(n, 1, n)
    L, Y = kernels.factor_diagonal_block(torch.from_numpy(A).double())
    Lt = L[0].tril(-1) + torch.diag(1.0 / L[0].diagonal())
    Lref = torch.linalg.cholesky(torch.from_numpy(A[0]).double())
    torch.testing.assert_close(Lt, Lref, rtol=0, atol=1e-10)
    torch.testing.assert_close(Y[0] @ Lref, torch.eye(n, dtype=torch.float64),
                               rtol=0, atol=1e-12)
    B = _factor_block(A[0])
    L32 = np.tril(B, -1) + np.diag(1.0 / np.diag(B))
    np.testing.assert_allclose(np.triu(B, 1).T + np.diag(np.diag(B)),
                               np.tril(Y[0].numpy()), rtol=0, atol=1e-5)
    assert np.abs(np.tril(B.T, -1) + np.diag(np.diag(B))
                  - Y[0].numpy()).max() < 1e-5
    assert np.abs(L32 @ L32.T - A[0]).max() < 1e-3 * np.abs(A[0]).max()


# ---------------------------------------------------------------------------
# (b) The plain version the card holds the kernel's first chains to
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,panel", [(337, None), (401, None), (512, None),
                                     (1000, None), (401, 64), (1000, 64)])
@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_panels_plain_matches_plain(D, panel, jitter):
    """The panels kernel's order of work (``chol_solve_panels_plain``, the
    plan's width of 128 and the other width the C entry point takes), which
    the card holds the kernel's first two chains to, against torch.linalg
    within K1's tolerances."""
    A, b, z = _spd(D, 2, D)
    mean, noise = kernels.chol_solve_panels_plain(
        *map(torch.from_numpy, (A, b, z)), jitter, panel)
    mean_p, noise_p = _plain(A, b, z, jitter)
    assert np.abs(mean.numpy() - mean_p).max() <= K1_TOL["mean"]
    assert np.abs(noise.numpy() - noise_p).max() <= K1_TOL["noise"]


@pytest.mark.parametrize("D", [337, 401, 512, 1000])
@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_blocked_plain_matches_plain_at_large_d(D, jitter):
    A, b, z = _spd(D, 2, D)
    mean, noise = kernels.chol_solve_blocked_plain(
        *map(torch.from_numpy, (A, b, z)), jitter)
    mean_p, noise_p = _plain(A, b, z, jitter)
    assert np.abs(mean.numpy() - mean_p).max() <= K1_TOL["mean"]
    assert np.abs(noise.numpy() - noise_p).max() <= K1_TOL["noise"]


# ---------------------------------------------------------------------------
# (c) The precision draw against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [400, 512])
def test_precision_draw_pair_matches_jax(D):
    """linalg.precision_draw_pair against jax.vmap(precision_draw_pair)
    (stock Cholesky and blocked_tri_solves on the CPU) on identical A, b
    and z: the hd Phi draw on a 5 x 5 basis and the slice's xi draw."""
    A, b, z = _spd(7 * D, 3, D)
    mean, noise = linalg.precision_draw_pair(
        *map(torch.from_numpy, (A, b, z)))
    jmean, jnoise = jax.jit(jax.vmap(jlinalg.precision_draw_pair))(A, b, z)
    np.testing.assert_allclose(mean.numpy(), jmean, rtol=0,
                               atol=K1_TOL["mean"])
    np.testing.assert_allclose(noise.numpy(), jnoise, rtol=0,
                               atol=K1_TOL["noise"])


@pytest.mark.parametrize("D", [8, 512])
def test_mvn_from_precision_matches_jax(injected_noise, D):
    """distributions.mvn_from_precision (the jittered Cholesky, then
    mvn_from_chol) against the JAX package's on the same noise: the sample
    and the mean, for one precision and a batch of two."""
    A, b, _ = _spd(D + 1, 2, D)
    for sl in (0, slice(None)):
        samp, mean = tdist.mvn_from_precision(
            None, torch.from_numpy(A[sl]), torch.from_numpy(b[sl]))
        jsamp, jmean = jdist.mvn_from_precision(
            jax.random.PRNGKey(0), jnp.asarray(A[sl]), jnp.asarray(b[sl]))
        assert samp.shape == mean.shape == b[sl].shape
        np.testing.assert_allclose(mean.numpy(), jmean, rtol=0,
                                   atol=K1_TOL["mean"])
        np.testing.assert_allclose(samp.numpy(), jsamp, rtol=0,
                                   atol=K1_TOL["noise"])


# ---------------------------------------------------------------------------
# (d, e) The path: config 4's model at two covariates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def config4_d2():
    """Config 4's model at D = 2 on 10 curves: xi (K, P, D, M) = (2, 8, 2,
    16), drawn jointly at 512 dimensions."""
    jdata, truth = simulate_functional(N=10, n_time=(20, 30), **CONFIG4_D2)
    assert truth.xi.shape == (2, 8, 2, 16)
    return jdata, truth, convert.data_from_jax(jdata, device="cpu")


def test_update_xi_at_512_dimensions_matches_jax(config4_d2, injected_noise):
    """update_xi's joint draw at K*M*D*P = 512 with the same noise in both
    packages, two random chains: the draw and the running coefficients it
    leaves agree to the rounding of the (512 x 512) solve, 2e-4 of their
    scale, as at config 4's 256 (tests/test_torch_covariates.py)."""
    jdata, _, tdata = config4_d2
    d = _random_states(4, 2, 10, 2, 8, 16, 2)
    shapes = []
    chol = kernels.chol_solve

    def recorded(A, b, z, jitter=0.0):
        shapes.append(tuple(b.shape))
        return chol(A, b, z, jitter)
    kernels.chol_solve = recorded
    try:
        for i in range(2):
            js = _jstate(d, i)
            jnew, jc = jax.jit(lambda k, s: jg.update_xi(
                k, s, jdata, Priors(), jcache(jdata, s), 0.7))(
                    jax.random.PRNGKey(0), js)
            ts = convert.state_from_numpy({f: d[f][i] for f in STATE_FIELDS},
                                          chains=1, device="cpu")
            tnew, tc = tg.update_xi(None, ts, tdata, TPriors(),
                                    tcache(tdata, ts), 0.7)
            _close(tnew.xi[0].numpy(), jnew.xi, "update_xi xi", rtol=2e-4)
            _close(tc.w[0].numpy(), jc.w, "update_xi cache", rtol=2e-4)
            assert float((tnew.xi - ts.xi).abs().max()) > 1e-3
    finally:
        kernels.chol_solve = chol
    assert shapes == [(1, 512), (1, 512)]


def test_reference_sweeps_at_512_dimensions_match_jax(config4_d2):
    """Five reference-census sweeps (sweep_full with eta and xi) of eight
    chains from the truth in both packages on the same data: K1 drawn at
    (8, 512) and (8, 256) every sweep; every field finite; the ensembles'
    median log-likelihoods within 0.1 nats a point of each other and 0.25
    of the truth's, their median sigma2 within a factor 1.25 of each other.
    Over ten seeds of each package the medians lay 0.07 to 0.13 nats a
    point below the truth's (the means of the seeds' medians 0.103 and
    0.101), a port's and a JAX median differed by 0.057 at most, and
    sigma2 by a factor 1.09."""
    jdata, truth, tdata = config4_d2
    C, S = 8, 5
    c = jnp.full((2,), 10.0)

    def run(k, s):
        def body(s, kk):
            return jg.sweep_full(kk, s, jdata, Priors(), c,
                                 covariate_mean=True,
                                 covariate_cov=True), None
        return jax.lax.scan(body, s, jax.random.split(k, S))[0]
    jfinal = jax.jit(jax.vmap(run, in_axes=(0, None)))(
        jax.random.split(jax.random.PRNGKey(0), C), truth)
    jll = np.asarray(jax.vmap(lambda s: jlog_likelihood(s, jdata))(jfinal))

    ts = convert.state_from_numpy(jax.tree.map(np.asarray, truth), chains=C,
                                  device="cpu")
    g = torch.Generator().manual_seed(0)
    shapes = []
    chol = kernels.chol_solve

    def recorded(A, b, z, jitter=0.0):
        shapes.append(tuple(b.shape))
        return chol(A, b, z, jitter)
    kernels.chol_solve = recorded
    try:
        for _ in range(S):
            ts = tg.sweep_full(g, ts, tdata, TPriors(),
                               torch.full((2,), 10.0), covariate_mean=True,
                               covariate_cov=True)
    finally:
        kernels.chol_solve = chol
    assert shapes.count((C, 512)) == S and shapes.count((C, 256)) == S
    ll = log_likelihood(ts, tdata).numpy()
    n = float(np.asarray(jdata.mask).sum())
    ll_truth = float(jlog_likelihood(truth, jdata))
    assert np.isfinite(ll).all() and np.isfinite(jll).all()
    for f in STATE_FIELDS:
        assert torch.isfinite(getattr(ts, f)).all(), f
    med, jmed = float(np.median(ll)), float(np.median(jll))
    assert abs(med - jmed) < 0.1 * n, (med, jmed)
    assert abs(med - ll_truth) < 0.25 * n and abs(jmed - ll_truth) < 0.25 * n
    s2 = float(ts.sigma2.median())
    js2 = float(np.median(np.asarray(jfinal.sigma2)))
    assert 1 / 1.25 < s2 / js2 < 1.25, (s2, js2)
