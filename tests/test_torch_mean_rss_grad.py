"""K2's backward (``mean_rss_grad``) as its CUDA kernel computes it, on the
CPU: ``kernels.mean_rss_grad_tiled_plain``, the kernel's order of sums in
PyTorch, against ``mean_rss_grad_plain`` and against ``jax.grad`` of the JAX
package's ``rss_from_coeffs`` (its einsum path) vmapped over chains, on the
same numpy inputs; the twin against a lane-by-lane transcription of
csrc/mean_rss.cu's kernel loops (the same bits); and the plan's layout.

Tolerance against the plain version and JAX: 2e-5 of max |grad|, the card's
(chip_smoke.py's K2_GRAD_TOL): float32 sums of L products of order 1-10
each, taken in another order (measured here: ~3e-7).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesfmmm_tpu.ops import mean as jmean  # noqa: E402
from bayesfmmm_torch.ops import kernels  # noqa: E402

TOL = 2e-5


def _inputs(C, N, L, P, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((N, L, P), (N, L), (C, N, P), (C,)))


# (C, N, L, P): P = 8 and 16 on one lane (the kernel's 16-byte
# instantiations), an odd P, P split over 8 and over 32 lanes (40 floats a
# lane), and L in several chunks at P = 8 and 16
SHAPES = [(4, 6, 30, 8), (3, 5, 40, 16), (4, 6, 9, 5), (3, 4, 25, 100),
          (2, 3, 10, 600), (2, 3, 1600, 8), (2, 2, 800, 16)]


@pytest.mark.parametrize("C,N,L,P", SHAPES)
def test_tiled_plain_matches_plain_and_jax(C, N, L, P):
    B, y, w, g = _inputs(C, N, L, P, seed=C + L + P)
    got = kernels.mean_rss_grad_tiled_plain(*map(torch.from_numpy,
                                                 (B, y, w, g)))
    plain = kernels.mean_rss_grad_plain(*map(torch.from_numpy, (B, y, w, g)))
    jdata = SimpleNamespace(B=jnp.asarray(B), y=jnp.asarray(y),
                            identity_basis=False)
    jgrad = jax.vmap(jax.grad(lambda wc: jmean.rss_from_coeffs(jdata, wc)))(
        jnp.asarray(w))
    want = np.asarray(jgrad) * g[:, None, None]
    scale = np.abs(want).max()
    assert got.dtype == torch.float32 and got.shape == (C, N, P)
    assert np.abs(got.numpy() - plain.numpy()).max() <= TOL * scale
    assert np.abs(got.numpy() - want).max() <= TOL * scale


def _fma(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _kernel_by_lane(B, y, w, g):
    """csrc/mean_rss.cu's mean_rss_grad_kernel transcribed loop for loop,
    one chain and observation at a time, its S = SP x SL lanes side by side
    (numpy float32; a fused multiply-add as ``kernels._fma`` rounds it):
    the chunks, U points a loop step, the SP lanes' xor tree per point, the SL
    lanes' xor tree at the end, and which lane writes which output.
    Returns grad and the number of writes of each output."""
    C, N, P = w.shape
    L = B.shape[1]
    plan = kernels.mean_rss_grad_plan(C, N, L, P)
    SP, SL, LC = plan["SP"], plan["SL"], plan["LC"]
    KP = plan["KP"]
    vec = SP == 1 and P == KP          # float4 writes (aligned, as here)
    U = 4 if KP <= 8 else (2 if KP <= 16 else 1)
    S = SP * SL
    q = np.arange(S)
    sp, sl = q % SP, q // SP
    pk = sp[:, None] + SP * np.arange(KP)[None, :]          # (S, KP)
    out = np.zeros((C, N, P), np.float32)
    writes = np.zeros((C, N, P), np.int64)
    for c in range(C):
        for n in range(N):
            wr = np.where(pk < P, w[c, n, np.minimum(pk, P - 1)], 0)
            wr = wr.astype(np.float32)
            acc = np.zeros((S, KP), np.float32)
            for l0 in range(0, L, LC):
                lc = min(LC, L - l0)
                Bc, yc = B[n, l0:l0 + lc], y[n, l0:l0 + lc]
                for j0 in range(0, lc, U * SL):
                    b = np.zeros((U, S, KP), np.float32)
                    yv = np.zeros((U, S), np.float32)
                    m = np.zeros((U, S), np.float32)
                    for u in range(U):
                        i = j0 + u * SL + sl                 # (S,)
                        ok = i < lc
                        for s in range(S):
                            if ok[s]:
                                b[u, s] = np.where(
                                    pk[s] < P, Bc[i[s], np.minimum(pk[s],
                                                                   P - 1)], 0)
                                yv[u, s] = yc[i[s]]
                        for k in range(KP):
                            m[u] = [_fma(b[u, s, k], wr[s, k], m[u, s])
                                    for s in range(S)]
                    o = 1
                    while o < SP:                            # shfl_xor
                        m = (m + m[:, q ^ o]).astype(np.float32)
                        o <<= 1
                    for u in range(U):
                        r = (yv[u] - m[u]).astype(np.float32)
                        for k in range(KP):
                            acc[:, k] = [_fma(r[s], b[u, s, k], acc[s, k])
                                         for s in range(S)]
            o = SP
            while o < S:
                acc = (acc + acc[q ^ o]).astype(np.float32)
                o <<= 1
            scale = np.float32(-2.0) * g[c]
            for s in range(S):
                for k in range(KP):
                    p = pk[s, k]
                    mine = ((k // 4) % SL if vec else k % SL) == sl[s]
                    if p < P and mine:
                        out[c, n, p] = scale * acc[s, k]
                        writes[c, n, p] += 1
    return out, writes


@pytest.mark.parametrize("C,N,L,P", [(2, 3, 40, 8), (1, 2, 37, 16),
                                     (2, 2, 11, 5), (1, 2, 20, 40),
                                     (1, 1, 1500, 8)])
def test_tiled_plain_follows_the_kernel_lane_by_lane(C, N, L, P):
    """The twin gives the bits of the kernel's loops transcribed lane by
    lane (one lane of 32 at P = 8 and 16, an odd P in rows padded to 8,
    P = 40 split over 4 lanes, and L = 1,500 in three chunks), and the
    kernel's lanes write every output once."""
    B, y, w, g = _inputs(C, N, L, P, seed=L)
    want, writes = _kernel_by_lane(B, y, w, g)
    got = kernels.mean_rss_grad_tiled_plain(*map(torch.from_numpy,
                                                 (B, y, w, g)))
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C,N,L,P,SL", [
    (64, 100, 100, 8, 4),         # fit_hmc's 64 chains: 25,600 threads
    (4, 100, 100, 8, 32),         # ADVI's 4 draws: a warp a chain
    (1, 100, 100, 8, 32),
    (64, 64, 144, 16, 4),         # config 5 under fit_hmc
    (256, 100, 100, 8, 1),        # chains enough on their own
    (2, 3, 3, 8, 4),              # no more lanes than points
])
def test_mean_rss_grad_plan_lanes_fill_the_card(C, N, L, P, SL):
    plan = kernels.mean_rss_grad_plan(C, N, L, P)
    assert plan["SL"] == SL and plan["SP"] == 1
    fills = C * N * SL >= kernels.K2_GRAD_WANT
    assert fills or SL == 32 or SL >= L
    assert SL == 1 or C * N * SL // 2 < kernels.K2_GRAD_WANT
    other = kernels.mean_rss_grad_plan(C, N, L, P, lanes=8)
    assert other["SL"] == 8 and other["threads"] == other["TC"] * 8


@pytest.mark.parametrize("lanes", [0, 3, 64])
def test_mean_rss_grad_plan_refuses_other_lanes(lanes):
    with pytest.raises(ValueError, match="lanes"):
        kernels.mean_rss_grad_plan(4, 5, 6, 8, lanes=lanes)
    with pytest.raises(ValueError, match="lanes"):       # 16 split P = 600
        kernels.mean_rss_grad_plan(4, 5, 6, 600, lanes=4)


@pytest.mark.parametrize("P", [1, 5, 8, 16, 17, 100, 512, 513, 1280])
@pytest.mark.parametrize("L", [3, 100, 5000])
def test_mean_rss_grad_plan_layout(L, P):
    """Lanes covering P within a warp, whole warps, chunks within shared
    memory and a multiple of the point lanes, at every P to K2_MAX_P."""
    for C, N in ((1, 7), (64, 100)):
        plan = kernels.mean_rss_grad_plan(C, N, L, P)
        SP, SL, KP = plan["SP"], plan["SL"], plan["KP"]
        assert SP * SL <= 32 and KP * SP >= P
        assert SP == 1 or KP * (SP // 2) < P          # the fewest P lanes
        assert SP & (SP - 1) == 0 and SL & (SL - 1) == 0
        assert plan["threads"] % 32 == 0 \
            and plan["threads"] <= kernels.K2_GRAD_THREADS
        assert plan["grid"][1] * plan["TC"] >= C
        assert plan["smem"] <= kernels.K2_GRAD_SMEM
        if plan["buffers"] == 2:
            assert plan["LC"] % SL == 0 and SL <= plan["LC"] < L
        else:
            assert plan["LC"] == L


def test_k2_grad_probe_patches_match_the_source():
    """Each knock-out and alternative of utils/k2_grad_probe.py patches
    csrc/mean_rss.cu in exactly one place, and changes it; a source in
    which one patch's text has moved on is refused."""
    from bayesfmmm_torch.utils import k2_grad_probe
    text = (kernels._CSRC / "mean_rss.cu").read_text()
    outs = k2_grad_probe.KNOCK_OUTS
    sources = k2_grad_probe.patched_sources(text, outs, "csrc/mean_rss.cu")
    assert set(sources) == set(outs) and sources["whole"] == text
    assert all(src != text for name, src in sources.items()
               if name != "whole")
    for name, patches in outs.items():
        for old, _ in patches:
            broken = text.replace(old, old[:-1] + "#" + old[-1])
            with pytest.raises(RuntimeError, match="not once"):
                k2_grad_probe.patched_sources(broken, {name: patches})
