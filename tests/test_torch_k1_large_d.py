"""K1 for the joint draws of 337 to 4,096 dimensions: the panels kernel's
plan, a transcription of its launches, its plain version, and the path
that reaches it (config 4's model at two covariates, whose joint xi draw
has K*M*D*P = 512 dimensions), against the JAX package on the CPU.

The CUDA kernels (csrc/chol_solve_panels.cu) run only on the card
(tests/test_torch_cuda.py).  Here their launches are transcribed in NumPy,
tile by tile and with the kernels' masks, on a workspace that starts as NaN
(what torch.empty may hand over), and held against torch.linalg; the
plain version the card checks them against (``chol_solve_blocked_plain``)
is held to torch.linalg at the same dimensions; the port's precision draw,
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
NB, TILE = kernels.K1_PANEL, kernels.K1_PANELS_TILE
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


@pytest.mark.parametrize("C,D,launches,ld", [
    (16, 512, 33, 512), (256, 512, 33, 512), (64, 400, 27, 400),
    (2, 337, 23, 340), (3, 401, 27, 404), (2, 1000, 65, 1000),
    (4, 1024, 65, 1024), (2, 2048, 129, 2048), (1, 4096, 257, 4096)])
def test_chol_solve_plan_panels_shapes(C, D, launches, ld):
    """Above the blocked kernel every D up to 4,096 plans the panels kernel:
    panels of 32, 64 x 64 update tiles, the row stride D rounded up to 4
    floats, a prologue, a panel solve a panel, an update for every panel
    but the last and the back substitutions; the workspace (C, D + 1, LD)
    and the (C, 32, 32) diagonal-block buffer."""
    plan = kernels.chol_solve_plan(C, D)
    assert plan["kernel"] == "panels" and plan["panel"] == 32
    assert plan["tile"] == (64, 64) and plan["grid"] == C
    assert plan["threads"] == {"prologue": 256, "panel": 128,
                               "update": 256, "solve": 512}
    assert plan["ld"] == ld and ld % 4 == 0 and ld >= D
    assert plan["launches"] == launches == 2 * math.ceil(D / 32) + 1
    assert plan["workspace"] == 4 * C * ((D + 1) * ld + 32 * 32)
    # u and v of the back substitutions within the 48 KB of a block
    assert plan["smem"] == max(4 * 2 * 64 * 33, 8 * D) <= 48 * 1024


def test_chol_solve_plan_workspace_at_the_top_of_the_range():
    """The bytes say what a call costs: 268 MB of workspace at the slice's
    production shape, 67 MB at one chain of D = 4,096 and 17.2 GB at 256
    of them (beside the 17.2 GB of A), which no path asks for; above 4,096
    the plan raises."""
    assert kernels.chol_solve_plan(256, 512)["workspace"] == 270_008_320
    assert kernels.chol_solve_plan(1, 4096)["workspace"] == 67_129_344
    assert kernels.chol_solve_plan(256, 4096)["workspace"] == 17_185_112_064
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
    """Panel by panel, the update's tiles (each 64 x 64, stored where
    i <= D, j < D and j <= i) own every entry (i, j) with s <= j <= min(i,
    D - 1), i <= D, exactly once, and no tile is idle; the panel solve's
    blocks own the rows s..D once each; the corner tile holds the next
    diagonal block."""
    threads = kernels.K1_PANELS_THREADS["panel"]
    for k0 in range(0, D - NB, NB):
        s = k0 + NB
        rows = (s + np.arange(-(-(D + 1 - s) // threads))[:, None] * threads
                + np.arange(threads)[None, :]).ravel()
        assert np.array_equal(np.sort(rows[rows <= D]), np.arange(s, D + 1))
        tiles = _update_tiles(D, s)
        assert len(set(tiles)) == len(tiles)
        own = np.zeros((D + 1, D), dtype=int)
        for rt, ct in tiles:
            assert ct <= rt
            i = s + TILE * rt + np.arange(TILE)[:, None]
            j = s + TILE * ct + np.arange(TILE)[None, :]
            keep = (i <= D) & (j < D) & (j <= i)
            assert keep.any()
            np.add.at(own, (np.broadcast_to(i, keep.shape)[keep],
                            np.broadcast_to(j, keep.shape)[keep]), 1)
        want = np.zeros_like(own, dtype=bool)
        for r in range(s, D + 1):
            want[r, s:min(r, D - 1) + 1] = True
        assert (own[want] == 1).all() and (own[~want] == 0).all()
        assert tiles[0] == (0, 0) and min(NB, D - s) <= TILE


def _panels_transcription(A, b, z, jitter):
    """csrc/chol_solve_panels.cu in NumPy float32, launch by launch and
    block by block, with the kernels' masks.  The workspace and the
    diagonal-block buffer start as NaN, so a read of a place no launch
    wrote reaches the result.  Returns (mean, noise, launches)."""
    C, D = b.shape
    LD = kernels.panels_ld(D)
    f32 = np.float32
    W = np.full((C, D + 1, LD), np.nan, f32)
    Dg = np.full((C, NB, NB), np.nan, f32)
    lanes = np.arange(NB)
    launches = 1
    # the prologue
    lower = np.tril(np.ones((D, D), bool))
    for c in range(C):
        eps = f32(jitter * (A[c].diagonal().sum(dtype=f32) / D + 1.0)) \
            if jitter else f32(0.0)
        Wc = W[c, :D, :D]
        Wc[lower] = A[c][lower]
        Wc[np.diag_indices(D)] += eps
        W[c, D, :D] = b[c]
        n = min(NB, D)
        Dg[c][np.tril(np.ones((n, n), bool))] = Wc[:n, :n][np.tril(
            np.ones((n, n), bool))]
    for k0 in range(0, D, NB):
        nb = min(NB, D - k0)
        s = k0 + nb
        # launch a: the diagonal block from the buffer, by one warp (lane r
        # holds row r; only k <= r < nb is loaded)
        launches += 1
        for c in range(C):
            keep = (lanes[:, None] < nb) & (lanes[None, :] <= lanes[:, None])
            x = np.where(keep, Dg[c], f32(0.0))
            for j in range(nb):
                inv = f32(1.0) / np.sqrt(x[j, j])
                l = np.where(lanes > j, x[:, j] * inv, f32(0.0))
                x[:, j] = np.where(lanes == j, inv, l)
                x[:, j + 1:] -= l[:, None] * l[None, j + 1:]
            # the first block's write: 16-byte groups up to the diagonal
            for r in range(nb):
                g = 4 * (r // 4 + 1)
                W[c, k0 + r, k0:k0 + g] = x[r, :g]
            # every block's rows below: x <- x L11^-T
            width = 4 * -(-nb // 4)
            X = W[c, s:D + 1, k0:k0 + width].copy()
            X[:, nb:] = 0.0
            for j in range(nb):
                X[:, j] = (X[:, j] - X[:, :j] @ x[j, :j]) * x[j, j]
            W[c, s:D + 1, k0:k0 + width] = X
        if s == D:
            continue
        # launch b: the trailing update, tile by tile
        launches += 1
        nb_next = min(NB, D - s)
        for c in range(C):
            for rt, ct in _update_tiles(D, s):
                i = s + TILE * rt + np.arange(TILE)
                j = s + TILE * ct + np.arange(TILE)
                Xr = np.where((i <= D)[:, None],
                              W[c, np.minimum(i, D), k0:s], f32(0.0))
                Xc = np.where((j < D)[:, None],
                              W[c, np.minimum(j, D), k0:s], f32(0.0))
                acc = Xr @ Xc.T
                keep = (i[:, None] <= D) & (j[None, :] < D) \
                    & (j[None, :] <= i[:, None])
                ii, jj = np.nonzero(keep)
                W[c, i[ii], j[jj]] -= acc[ii, jj]
                if rt == ct == 0:
                    corner = keep & (i[:, None] - s < nb_next)
                    ii, jj = np.nonzero(corner)
                    Dg[c, ii, jj] = W[c, i[ii], j[jj]]
    # the back substitutions, a panel at a time from the last
    launches += 1
    mean, noise = np.empty_like(b), np.empty_like(b)
    for c in range(C):
        u, v = W[c, D, :D].copy(), z[c].copy()
        for k0 in range((D - 1) // NB * NB, -1, -NB):
            nb = min(NB, D - k0)
            blk = W[c, k0:k0 + nb, k0:k0 + nb]
            lc = np.where(np.tril(np.ones((nb, nb), bool), -1), blk,
                          f32(0.0))                  # lc[j, lane], j > lane
            ri = blk.diagonal()
            yu, yv = u[k0:k0 + nb].copy(), v[k0:k0 + nb].copy()
            for j in range(nb - 1, -1, -1):
                xu, xv = yu[j] * ri[j], yv[j] * ri[j]
                yu[:j] -= lc[j, :j] * xu
                yv[:j] -= lc[j, :j] * xv
                yu[j], yv[j] = xu, xv
            u[k0:k0 + nb], v[k0:k0 + nb] = yu, yv
            rows = W[c, k0:k0 + nb, :k0]
            u[:k0] -= yu @ rows
            v[:k0] -= yv @ rows
        mean[c], noise[c] = u, v
    return mean, noise, launches


@pytest.mark.parametrize("C,D", [(2, 337), (2, 401), (1, 1000)])
@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_panels_transcription_matches_plain(C, D, jitter):
    """The kernels' launches as transcribed above give torch.linalg's draw
    within K1's tolerances, read nothing that no launch wrote (the result
    is finite from a NaN workspace), and make as many launches as the plan
    says: the smallest D, D neither a multiple of 4 nor of 32, and D with
    a last panel of 8 columns and a row D in a tile of its own."""
    A, b, z = _spd(D + C, C, D)
    mean, noise, launches = _panels_transcription(A, b, z, jitter)
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
    mean, noise, _ = _panels_transcription(A, b, z, 0.0)
    assert np.isnan(mean).any() and np.isnan(noise).any()


# ---------------------------------------------------------------------------
# (b) The plain version the card holds the kernel's first chains to
# ---------------------------------------------------------------------------

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
