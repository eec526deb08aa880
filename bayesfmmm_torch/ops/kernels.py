"""Hand-written CUDA kernels of the sweep, their plain versions and bindings.

Counterpart of ``bayesfmmm_tpu/ops/pallas_kernels.py``:

  * K1 ``chol_solve`` — per-chain Cholesky of an SPD (D, D) precision and
    the two triangular solves of the joint Phi and xi draws (replaces
    ``chol_solve_batch_minor``).  Sources: csrc/chol_solve.cu (D <= 336,
    one launch) and csrc/chol_solve_panels.cu (up to ``K1_MAX_DIM``, a
    workspace in device memory and a chain of launches).
  * K2 ``mean_rss``   — mu = B w and rss = sum (y - mu)^2 in one pass over
    B, batched over chains (replaces ``fused_mean_rss``).  Source:
    csrc/mean_rss.cu.  Its backward ``mean_rss_grad`` (the gradient of rss
    with respect to w, in the same file) serves ``MeanRSS``, the
    ``torch.autograd.Function`` the log-joint's gradient goes through.
  * K3 ``weighted_gram`` — sum_n W[r, n] G[n] for every row r of W, the
    data-precision block of the blocked updates (replaces
    ``weighted_gram``).  Source: csrc/weighted_gram.cu.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
for CUDA tensors launches its kernel or raises: nothing gives way to the
plain version on the card, whether a kernel failed to build or to launch or
no kernel serves the shape (K1 above ``K1_MAX_DIM``, K2 at a P too wide
for a block's tile of w: both raise NotImplementedError).  The kernels
are compiled by nvcc for sm_90a at first use, from the sources in
``csrc/``, into ``_build/`` (keyed by a hash of sources and flags), and
bound with ctypes; each C entry point launches on PyTorch's current stream,
allocates nothing and returns cudaGetLastError().

``LAUNCHES`` counts kernel launches (one per launch, nowhere else), so a
run can show that its main path went through the kernels.  A sweep that a
CUDA graph replays (samplers/drivers.py) launches its kernels from the
graph: they are counted once, when the graph is captured, and not at its
replays (``drivers.SWEEP_GRAPHS`` counts those).

What surrounds the CUDA code is kept here, where the CPU tests reach it:
``chol_solve_plan`` chooses which of K1's three kernels serves a shape, and
its thread grid or panel width (and the panels kernel's workspace and
launches), ``mean_rss_plan`` and ``weighted_gram_plan`` choose
the tile sizes, the grid and the scratch shape that K2 and K3 are launched
with, ``mean_rss_grad_plan`` the lanes, chains and chunks of K2's backward
(``mean_rss_grad_tiled_plain`` is that kernel's order of sums, for the
tests), and ``kernel_bound`` gives the bytes, the FLOP and the least time the
card could take for a call of each kernel, from its shapes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Opt-in shared memory of one thread block on H100/H200 (227 KB).  K1's
# blocked kernel keeps the lower triangle of the (D, D) matrix there.
SMEM_PER_BLOCK = 232_448

# One H100 SXM has 132 streaming multiprocessors; the plans want at least
# one block on each.
SM_COUNT = 132
# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

LAUNCHES = {"chol_solve": 0, "mean_rss": 0, "mean_rss_grad": 0,
            "weighted_gram": 0}

_lib = None


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _largest_dim(smem_floats):
    D = 1
    while 4 * smem_floats(D + 1) <= SMEM_PER_BLOCK:
        D += 1
    return D


def packed_row(i):
    """Offset of row i in K1's packed triangle (int or integer tensor): row
    i holds its i + 1 entries and is padded to a multiple of 4 floats, so
    that every row starts on 16 bytes: four rows of 4 floats, four of 8,
    and so on."""
    g, r = i >> 2, i & 3
    return 4 * (g + 1) * (2 * g + r)


def _blocked_floats(D):
    """Shared memory of K1's blocked kernel: the packed lower triangle of A
    with b as one more row (rows 0..D), then z."""
    return packed_row(D + 1) + D


def chol_solve_max_dim():
    """Largest D of K1's blocked kernel, whose lower triangle of A fits one
    block's shared memory up to it; the panels kernel serves the D above it
    up to ``K1_MAX_DIM``."""
    return _largest_dim(_blocked_floats)


# The largest joint draw there is: the Gibbs updaters draw Phi and xi
# jointly up to this dimension (ops/gibbs.py::_JOINT_MAX_DIM, which a test
# holds equal) and block by block above it, so K1 serves D up to here.
K1_MAX_DIM = 4096


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _find_nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    return shutil.which("nvcc")


def _library_path():
    """Path of the shared library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libbfmmm_kernels_{h.hexdigest()[:16]}.so"


def compile_library(sources, out):
    """Compile each of ``sources`` with nvcc, all at once, and link them
    into the shared library ``out``; what ptxas said of each kernel
    (registers, spills) goes to ``out``'s ``.log``.  Raises RuntimeError
    without nvcc or when a source does not compile."""
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of bayesfmmm_torch are built from "
            "bayesfmmm_torch/csrc at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources:
        obj = out.with_name(f"{tag}.{src.stem}.o")
        log = obj.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as f:
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))
    tmp = out.with_name(f"{tag}.tmp")
    try:
        said = []
        for cmd, _, log, proc in jobs:
            rc = proc.wait()
            said.append(log.read_text())
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                                   f"{said[-1]}")
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        out.with_suffix(".log").write_text("".join(said))
        os.replace(tmp, out)
    finally:
        for _, obj, log, proc in jobs:
            proc.wait()
            obj.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
    return out


def build():
    """Compile csrc/*.cu unless the library for these sources exists;
    returns its path.  Raises RuntimeError without nvcc."""
    out = _library_path()
    if out.exists():
        return out
    return compile_library(sorted(_CSRC.glob("*.cu")), out)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bfmmm_chol_solve.argtypes = [p, p, p, p, p, i, i, ctypes.c_float,
                                         i, p]
        lib.bfmmm_chol_solve.restype = i
        lib.bfmmm_chol_solve_panels.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                ctypes.c_float, i, i, i, p]
        lib.bfmmm_chol_solve_panels.restype = i
        lib.bfmmm_mean_rss.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.bfmmm_mean_rss.restype = i
        lib.bfmmm_mean_rss_grad.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            i, i, i, p]
        lib.bfmmm_mean_rss_grad.restype = i
        lib.bfmmm_weighted_gram.argtypes = [p, p, p, i, i, i, i, p]
        lib.bfmmm_weighted_gram.restype = i
        lib.bfmmm_empty.argtypes = [p]
        lib.bfmmm_empty.restype = i
        _lib = lib
    return _lib


def _check_cuda(name, tensors, shapes):
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: every tensor must be float32 on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _route(name, t):
    """True for the CUDA kernel, False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"{name}: no kernel for device {t.device}")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{torch.cuda.CudaError(rc)}")
    LAUNCHES[name] += 1


def empty_launch(device):
    """Launch the empty kernel on ``device``'s current stream: the launch
    floor that kernel timings are read against.  Not part of the sampler
    and not counted in ``LAUNCHES``."""
    with torch.cuda.device(device):
        rc = _library().bfmmm_empty(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: "
                           f"{torch.cuda.CudaError(rc)}")


def kernel_bound(name, **shape):
    """Bytes, FLOP and the least time one H100 could take for one call.

    Every input is read once and every output written once (float32; of
    K1's symmetric A the one triangle that defines it); the bound is the
    larger of bytes over ``PEAK_BYTES_PER_S`` and FLOP over
    ``PEAK_F32_FLOP_PER_S``.  Shapes by keyword: ``chol_solve`` C, D;
    ``mean_rss`` C, N, L, P and want_mu; ``mean_rss_grad`` C, N, L, P;
    ``weighted_gram`` R, N, P.
    Returns {"bytes", "flop", "bound_ms", "bound_by"}.
    """
    if name == "chol_solve":
        C, D = shape["C"], shape["D"]
        # a triangle of A, b and z in; mean and noise out
        floats = C * (D * (D + 1) // 2 + 4 * D)
        # factor D^3/3; forward solve of b, back solves of w and z: 3 D^2
        flop = C * (D ** 3 / 3 + 3 * D * D)
    elif name == "mean_rss":
        C, N, L, P = (shape[k] for k in "CNLP")
        floats = N * L * P + N * L + C * N * P + C     # B, y, w in; rss out
        if shape.get("want_mu", False):
            floats += C * N * L
        # per chain and point: P multiply-adds, the residual, its square
        # and the sum
        flop = C * N * L * (2 * P + 3)
    elif name == "mean_rss_grad":
        C, N, L, P = (shape[k] for k in "CNLP")
        # B, y, w and g in; grad_w out
        floats = N * L * P + N * L + 2 * C * N * P + C
        # per chain and point: the residual's P multiply-adds and its
        # difference, then P multiply-adds into grad_w (the -2 g scaling
        # is once an output)
        flop = C * N * L * (4 * P + 1)
    elif name == "weighted_gram":
        R, N, P = shape["R"], shape["N"], shape["P"]
        floats = R * N + N * P * P + R * P * P         # W, G in; out
        flop = 2 * R * N * P * P
    else:
        raise KeyError(name)
    t_bytes = 4 * floats / PEAK_BYTES_PER_S
    t_flop = flop / PEAK_F32_FLOP_PER_S
    return {"bytes": 4 * floats, "flop": flop,
            "bound_ms": 1e3 * max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations"}


# ---------------------------------------------------------------------------
# K1: Cholesky factor-and-solve
# ---------------------------------------------------------------------------

# K1's register-tiled kernel: threads a side of the block's square grid,
# and the tile sides csrc/chol_solve.cu is instantiated for.  A tile side TS
# serves D <= K1_GRID * TS; the smallest that covers D is taken.
K1_GRID = 16
K1_TILES = (6, 8)
# K1's blocked kernel: threads a block, and the panel width (columns
# factored at a time; 16 was slower on the card, utils/k1_probe.py)
K1_BLOCKED_THREADS = 512
K1_PANEL = 32
# K1's panels kernels (csrc/chol_solve_panels.cu): the panel widths the C
# entry point is instantiated for and the plan's (128 halves the passes over
# the trailing triangle and the launches against 64, and was as fast or
# faster at the five timed shapes: utils/kernel_bench.py --sweep), threads a
# block of every launch, the side of a trailing-update tile, the columns a
# cp.async stage of it holds, the rows a panel-product block takes, and the
# most blocks of a back substitutions' cluster (above 8 a cluster is opt-in
# on the H100)
K1_PANELS_WIDTHS = (64, 128)
K1_PANELS_WIDTH = 128
K1_PANELS_THREADS = 256
K1_PANELS_TILE = 128
K1_PANELS_CHUNK = 32
K1_PANELS_ROWS = 64
K1_PANELS_MAX_CLUSTER = 16
# the most shared memory a block takes without opting in
SMEM_DEFAULT = 48 * 1024


def panels_ld(D):
    """Row stride of the panels kernel's workspace: D rounded up to a
    multiple of 4 floats, so that every row starts on 16 bytes."""
    return -(-D // 4) * 4


def panels_cluster(C, n_panels):
    """Blocks a chain of the panels kernel's back substitutions: the largest
    power of two cs up to ``K1_PANELS_MAX_CLUSTER`` and up to the panels
    with C * cs blocks on the card's SMs; 1 above C = SM_COUNT / 2."""
    cs = 1
    while (2 * cs <= min(K1_PANELS_MAX_CLUSTER, n_panels)
           and C * 2 * cs <= SM_COUNT):
        cs *= 2
    return cs


def panels_update_blocks(C, D):
    """Trailing-update blocks an SM the panels kernel is compiled for: 2
    (128 registers a thread) from SM_COUNT / 2 chains on, where a launch's
    tiles fill the card over and over; 1 (up to 255 registers, fewer
    spills) below, where a launch is a wave or two and a tile's latency
    counts (utils/kernel_bench.py --sweep times both)."""
    return 2 if C >= SM_COUNT // 2 else 1


def panels_owned(p, rank, cs):
    """Panels above panel p whose entries of u and v block ``rank`` of a
    back substitutions' cluster of ``cs`` keeps and updates: the panels
    rank, rank + cs, ... below p."""
    return list(range(rank, p, cs))


def panels_smem(D, nb, cs):
    """Shared memory a block of each of the panels kernel's launches takes,
    in bytes, rows padded to nb + 4 floats: the diagonal block and the
    factor's scratch; L11^-T and a block's rows; the update's two stages of
    two 128 x 32 operand slices (rows of 36 floats), or its tile of the
    matrix and the factor's scratch; the back substitutions' u and v of the
    panels a block owns, x_p published in two buffers and its copy, and the
    partial sums of an update (8 a thread)."""
    slots = -(-(-(-D // nb)) // cs)
    # the factor's scratch beside the block: M (32 rows of nb) and a column
    scratch = 32 * nb + 32
    tile = K1_PANELS_TILE * (K1_PANELS_TILE + 4)
    return {"first": 4 * (nb * (nb + 4) + scratch),
            "panel": 4 * (nb + K1_PANELS_ROWS) * (nb + 4),
            "update": 4 * max(2 * 2 * K1_PANELS_TILE * (K1_PANELS_CHUNK + 4),
                              tile + scratch),
            "solve": 4 * (2 * slots * nb + 6 * nb + 8 * K1_PANELS_THREADS)}


def chol_solve_plan(C, D):
    """Which of K1's kernels serves A (C, D, D), and how it is launched.

    ``"tiled"`` keeps the matrix in registers: ``threads`` (16, 16) a chain
    in a cyclic layout, thread (r, c) owning the entries (i, k) with
    i % 16 == r and k % 16 == c, a ``tile`` of (TS, TS); D below 16 * TS is
    padded with the identity in registers.  ``"blocked"`` keeps the packed
    lower triangle in shared memory and factors it a ``panel`` of columns
    at a time, for every other D up to ``chol_solve_max_dim()``.  One chain
    a block in both, one launch a call.  ``"panels"`` serves the D above
    that up to ``K1_MAX_DIM``: panels of ``panel`` columns
    (``K1_PANELS_WIDTH``), the matrix in a workspace (C, D + 1, ``ld``) in
    device memory, many blocks a chain (``threads`` a block of every
    launch; ``tile`` the trailing update's, ``rows`` a panel-product
    block's), the back substitutions over a ``cluster`` of blocks a chain
    (``panels_cluster``), and ``launches`` launches a call.  A larger D
    raises NotImplementedError.  Returns {"kernel", "threads", "tile" (None
    for the blocked kernel), "panel" (None for the tiled kernel), "smem":
    bytes a block at most, "grid": chains (an axis of every launch's grid),
    "ld" (None but for the panels kernel), "workspace": bytes of scratch
    the wrapper allocates, "launches"}, and for the panels kernel "rows",
    "cluster", "update_blocks" (``panels_update_blocks``) and
    "smem_by_launch".
    """
    if min(C, D) < 1:
        raise ValueError(f"chol_solve_plan: empty shape {(C, D)}")
    if D > K1_MAX_DIM:
        raise NotImplementedError(
            f"chol_solve: D={D} exceeds {K1_MAX_DIM}, the largest joint draw "
            f"of the Gibbs updaters, which draw the blocks one after "
            f"another above it")
    if D > chol_solve_max_dim():
        ld, nb = panels_ld(D), K1_PANELS_WIDTH
        n_panels = -(-D // nb)
        cs = panels_cluster(C, n_panels)
        smem = panels_smem(D, nb, cs)
        return {"kernel": "panels", "threads": K1_PANELS_THREADS,
                "tile": (K1_PANELS_TILE, K1_PANELS_TILE), "panel": nb,
                "rows": K1_PANELS_ROWS, "cluster": cs,
                "update_blocks": panels_update_blocks(C, D),
                "smem": max(smem.values()), "smem_by_launch": smem,
                "grid": C, "ld": ld,
                # the workspace and the jitter a chain
                "workspace": 4 * C * ((D + 1) * ld + 1),
                # the first diagonal block, a panel product a panel, a
                # trailing update for every panel but the last, the back
                # substitutions
                "launches": 2 * n_panels + 1}
    for TS in K1_TILES:
        DP = K1_GRID * TS
        if D <= DP:
            # L with padded rows, two column buffers of 8-byte rows and w_j,
            # 1 / L_jj and w, the warps' sums of the trace
            buf = K1_GRID * (TS + TS % 2) + 4
            floats = DP * (DP + 4) + 2 * buf + 2 * DP + K1_GRID ** 2 // 32
            return {"kernel": "tiled", "threads": (K1_GRID, K1_GRID),
                    "tile": (TS, TS), "panel": None, "smem": 4 * floats,
                    "grid": C, "ld": None, "workspace": 0, "launches": 1}
    return {"kernel": "blocked", "threads": (K1_BLOCKED_THREADS,),
            "tile": None, "panel": K1_PANEL, "smem": 4 * _blocked_floats(D),
            "grid": C, "ld": None, "workspace": 0, "launches": 1}


def chol_solve_code(plan):
    """The kernel code of csrc/chol_solve.cu's entry point for a plan: the
    tile side of the register-tiled kernel, or minus the panel width of the
    blocked one.  The panels kernel has an entry point of its own."""
    return plan["tile"][0] if plan["kernel"] == "tiled" else -plan["panel"]


def add_jitter(A, jitter):
    """A + jitter * (tr(A) / D + 1) * I, the contract of the JAX package's
    ``mvn_from_precision_fused``, as a tensor of its own: what the plain
    version factors, and what K1 forms on chip instead."""
    D = A.shape[-1]
    scale = A.diagonal(dim1=-2, dim2=-1).sum(-1) / D + 1.0
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    return A + (jitter * scale)[..., None, None] * eye


def chol_solve_plain(A, b, z, jitter=0.0):
    """mean = A^-1 b and noise = chol(A)^-T z for A (C, D, D), b/z (C, D);
    with ``jitter`` A + jitter * (tr(A) / D + 1) * I takes A's place."""
    if jitter != 0.0:
        A = add_jitter(A, jitter)
    L = torch.linalg.cholesky_ex(A).L
    w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    rhs = torch.cat([w, z[..., None]], dim=-1)
    out = torch.linalg.solve_triangular(L.mT, rhs, upper=True)
    return out[..., 0], out[..., 1]


def chol_solve_tiled_plain(A, b, z, jitter=0.0):
    """The tiled kernel's algorithm, step by step in float32: the jitter on
    the diagonal, b carried as one more row of the matrix, right-looking
    column steps with one reciprocal square root each (rows above the
    diagonal published as zeros), then both back substitutions by
    multiplication with the stored reciprocals.  Same function as
    ``chol_solve_plain``; nothing on the main path calls it."""
    C, D = b.shape
    M = A.clone()
    if jitter != 0.0:
        diag = M.diagonal(dim1=-2, dim2=-1)
        diag += (jitter * (diag.sum(-1) / D + 1.0))[:, None]
    wb = b.clone()                       # the row b, turned into L^-1 b
    L = torch.zeros_like(M)
    rinv = torch.empty_like(b)
    w = torch.empty_like(b)
    for j in range(D):
        inv = torch.rsqrt(M[:, j, j])
        col = M[:, :, j] * inv[:, None]
        col[:, :j] = 0.0
        L[:, :, j] = col
        rinv[:, j] = inv
        w[:, j] = wb[:, j] * inv
        M = torch.addcmul(M, col[:, :, None], col[:, None, :], value=-1.0)
        wb = torch.addcmul(wb, w[:, j, None], col, value=-1.0)
    u, v = w, z.clone()
    for j in range(D - 1, -1, -1):
        u[:, j] *= rinv[:, j]
        v[:, j] *= rinv[:, j]
        u[:, :j] -= L[:, j, :j] * u[:, j, None]
        v[:, :j] -= L[:, j, :j] * v[:, j, None]
    return u, v


def chol_solve_blocked_plain(A, b, z, jitter=0.0):
    """The blocked kernel's algorithm, a panel of ``K1_PANEL`` columns at
    a time: the jitter on the diagonal, b carried as row D of the matrix; per
    panel the diagonal block by column steps with one reciprocal square
    root each, the rows below it (row D among them) by forward substitution
    with multiplication by those reciprocals, and the trailing part by one
    product; then both back substitutions by multiplication with the
    reciprocals.  Same function as ``chol_solve_plain``; nothing on the
    main path calls it.  The blocked kernel (csrc/chol_solve.cu) repeats
    this order of work; the panels kernel's is
    ``chol_solve_panels_plain``."""
    C, D = b.shape
    M = torch.cat([A, b[:, None, :]], 1).tril()      # rows 0..D; row D is b
    if jitter != 0.0:
        diag = M.diagonal(dim1=-2, dim2=-1)
        diag += (jitter * (diag.sum(-1) / D + 1.0))[:, None]
    rinv = torch.empty_like(b)
    for k0 in range(0, D, K1_PANEL):
        s = min(D, k0 + K1_PANEL)
        blk = M[:, k0:s, k0:s].clone()
        for j in range(s - k0):
            inv = torch.rsqrt(blk[:, j, j])
            col = blk[:, :, j] * inv[:, None]
            col[:, :j + 1] = 0.0
            blk[:, :, j] = col
            blk[:, :, j + 1:] = torch.addcmul(
                blk[:, :, j + 1:], col[:, :, None], col[:, None, j + 1:],
                value=-1.0)
            rinv[:, k0 + j] = inv
        L11 = blk.tril(-1)
        X = M[:, s:, k0:s].clone()                    # rows s..D
        for j in range(s - k0):
            dot = (X[:, :, :j] * L11[:, None, j, :j]).sum(-1)
            X[:, :, j] = (X[:, :, j] - dot) * rinv[:, k0 + j, None]
        M[:, s:, k0:s] = X
        M[:, s:, s:] -= X @ X[:, :D - s].mT
        M[:, k0:s, k0:s] = L11
    u, v = M[:, D].clone(), z.clone()
    for j in range(D - 1, -1, -1):
        u[:, j] *= rinv[:, j]
        v[:, j] *= rinv[:, j]
        u[:, :j] -= M[:, j, :j] * u[:, j, None]
        v[:, :j] -= M[:, j, :j] * v[:, j, None]
    return u, v


def factor_diagonal_block(blk):
    """The panels kernel's factor of a diagonal block (csrc/
    chol_solve_panels.cu::factor_diagonal_block), batched: blk (C, n, n),
    its lower triangle read.  32 columns at a time, the block by column
    steps with one reciprocal square root each, its inverse by forward
    substitution, the rows below it within the block times that inverse
    transposed, the rest of the block less their product; and the
    inverse's blocks below the diagonal, a block row I at a time, as
    -(Linv[I][I] L[I][<I]) Linv[<I][<I].  Returns (L with 1 / L_jj on the
    diagonal, the inverse of L)."""
    C, n, _ = blk.shape
    S = blk.tril().clone()
    Y = torch.zeros_like(S)
    for q0 in range(0, n, 32):
        q1 = min(n, q0 + 32)
        sub = S[:, q0:q1, q0:q1]
        for j in range(q1 - q0):
            inv = torch.rsqrt(sub[:, j, j])
            col = sub[:, :, j] * inv[:, None]
            col[:, :j + 1] = 0.0
            sub[:, :, j + 1:] = torch.addcmul(
                sub[:, :, j + 1:], col[:, :, None], col[:, None, j + 1:],
                value=-1.0)
            sub[:, :, j] = col
            sub[:, j, j] = inv
        L, rinv = sub.tril(-1), sub.diagonal(dim1=-2, dim2=-1)
        inv_sub = torch.zeros_like(sub)
        for i in range(q1 - q0):
            e = torch.zeros_like(inv_sub[:, i])
            e[:, i] = 1.0
            inv_sub[:, i] = (e - (L[:, i, None, :i] @ inv_sub[:, :i])[:, 0]) \
                * rinv[:, i, None]
        Y[:, q0:q1, q0:q1] = inv_sub
        X = S[:, q1:, q0:q1] @ inv_sub.mT
        S[:, q1:, q0:q1] = X
        S[:, q1:, q1:] -= X @ X.mT
    S = S.tril()
    for r0 in range(32, n, 32):
        r1 = min(n, r0 + 32)
        M = Y[:, r0:r1, r0:r1] @ S[:, r0:r1, :r0]
        Y[:, r0:r1, :r0] = -(M @ Y[:, :r0, :r0])
    return S, Y


def chol_solve_panels_plain(A, b, z, jitter=0.0, panel=None):
    """The panels kernel's order of work (csrc/chol_solve_panels.cu), in
    PyTorch a panel of ``panel`` columns at a time (the plan's width by
    default): the jitter on the diagonal, b carried as row D of the matrix;
    per panel the diagonal block by ``factor_diagonal_block``, the rows
    below it (row D among them) times its inverse transposed, the trailing
    part less their product; then x <- L^-T x for w and z a panel at a time
    from the last, x_p = L11^-T y_p from the stored inverse and the rows
    above less L_p^T x_p.  Same function as ``chol_solve_plain``; nothing
    on the main path calls it (float32 and float64)."""
    C, D = b.shape
    nb = panel or K1_PANELS_WIDTH
    M = torch.cat([A, b[:, None, :]], 1).tril()      # rows 0..D; row D is b
    if jitter != 0.0:
        diag = M.diagonal(dim1=-2, dim2=-1)
        diag += (jitter * (diag.sum(-1) / D + 1.0))[:, None]
    inverses = []
    for k0 in range(0, D, nb):
        s = min(D, k0 + nb)
        L11, Y = factor_diagonal_block(M[:, k0:s, k0:s])
        X = M[:, s:, k0:s] @ Y.mT                     # rows s..D
        M[:, s:, k0:s] = X
        M[:, s:, s:] -= X @ X[:, :D - s].mT
        M[:, k0:s, k0:s] = L11
        inverses.append(Y)
    u, v = M[:, D].clone(), z.clone()
    for k0, Y in reversed(list(zip(range(0, D, nb), inverses))):
        s = min(D, k0 + nb)
        x = torch.stack([u[:, k0:s], v[:, k0:s]], -1)
        x = Y.mT @ x
        u[:, k0:s], v[:, k0:s] = x[..., 0], x[..., 1]
        rows = M[:, k0:s, :k0]
        u[:, :k0] -= (rows.mT @ x[..., 0, None])[..., 0]
        v[:, :k0] -= (rows.mT @ x[..., 1, None])[..., 0]
    return u, v


def panels_launch(A, b, z, mean, noise, jitter, plan):
    """The panels kernel on the card's current stream as ``plan`` says (its
    "panel", "cluster" and "update_blocks"; ``chol_solve_plan``'s, or
    another for a timing), its workspace and jitter buffer allocated here;
    writes mean and noise and returns the C entry point's code.  Counts no
    launch: ``chol_solve`` is the entry the package calls."""
    C, D = b.shape
    work = torch.empty(C, D + 1, plan["ld"], dtype=b.dtype, device=b.device)
    eps = torch.empty(C, dtype=b.dtype, device=b.device)
    return _library().bfmmm_chol_solve_panels(
        A.data_ptr(), b.data_ptr(), z.data_ptr(), mean.data_ptr(),
        noise.data_ptr(), work.data_ptr(), eps.data_ptr(), C, D, plan["ld"],
        float(jitter), plan["panel"], plan["cluster"], plan["update_blocks"],
        torch.cuda.current_stream().cuda_stream)


def chol_solve(A, b, z, jitter=0.0):
    """(mean, noise) of the precision draw, per chain: A (C, D, D) SPD,
    b and z (C, D) -> mean = A^-1 b, noise = chol(A)^-T z, both (C, D).
    With ``jitter`` > 0 the kernel factors A + jitter * (tr(A) / D + 1) * I,
    adding to the diagonal it holds.  On the card a D above ``K1_MAX_DIM``
    raises NotImplementedError.  A call counts one launch in ``LAUNCHES``,
    however many the panels kernel makes inside it; that kernel's
    workspace is allocated here, and A is never written."""
    if not _route("chol_solve", A):
        return chol_solve_plain(A, b, z, jitter)
    C, D = b.shape
    _check_cuda("chol_solve", (A, b, z), ((C, D, D), (C, D), (C, D)))
    mean, noise = torch.empty_like(b), torch.empty_like(b)
    if C == 0:
        return mean, noise
    plan = chol_solve_plan(C, D)
    with torch.cuda.device(A.device):
        if plan["kernel"] == "panels":
            rc = panels_launch(A, b, z, mean, noise, jitter, plan)
        else:
            rc = _library().bfmmm_chol_solve(
                A.data_ptr(), b.data_ptr(), z.data_ptr(), mean.data_ptr(),
                noise.data_ptr(), C, D, float(jitter), chol_solve_code(plan),
                torch.cuda.current_stream().cuda_stream)
    _launched("chol_solve", rc)
    return mean, noise


# ---------------------------------------------------------------------------
# K2: fused mean and residual sum of squares
# ---------------------------------------------------------------------------

def mean_rss_plain(B, y, w, want_mu=False):
    """rss (C,) = sum_{n,l} (y - mu)^2 with mu (C, N, L) = B w per chain."""
    mu = torch.einsum("nlp,cnp->cnl", B, w)
    r = y - mu
    return (r * r).sum((1, 2)), (mu if want_mu else None)


# A K2 block has 256 threads, each holding 4 points in registers at once
# (2 at P = 16).
K2_TILE_POINTS = 1024
# Shared memory a K2 block may fill with its tile of w: within the 48 KB a
# block has without opting in, beside the reduction's few hundred bytes.
K2_W_SMEM = 40 * 1024
# Chains a K2 block may own, the instantiations of csrc/mean_rss.cu: the
# tiles that the main path's C = 256 and 512 select, and a small one.
K2_CHAIN_TILES = (8, 24, 40)
# With mu a thread holds more, and the larger tiles would spill registers.
K2_MU_CHAIN_TILE = 8


def mean_rss_plan(C, N, L, P, want_mu=False):
    """Tiles of K2 for w (C, N, P), B (N, L, P): a block owns ``TC`` chains
    (one of ``K2_CHAIN_TILES``, one accumulator a thread each) and ``TN``
    observations (about ``K2_TILE_POINTS`` points).  B is read once per
    chain tile, and the card is fastest with one wave of blocks, so TC is
    the smallest that keeps the grid within one block per SM, or the
    largest there is; with mu it is ``K2_MU_CHAIN_TILE``.  The tile of w
    stays within ``K2_W_SMEM``; a P so wide that one row of the smallest
    tile does not raises NotImplementedError.  Returns {"TC", "TN", "grid":
    (chain tiles, point tiles), "scratch": shape of the per-tile partial
    sums, "smem": bytes}.
    """
    if min(C, N, L, P) < 1:
        raise ValueError(f"mean_rss_plan: empty shape {(C, N, L, P)}")
    TN = max(1, min(N, K2_TILE_POINTS // L))
    one_wave = -(-C // max(1, SM_COUNT // -(-N // TN)))   # chains a block
    fits = [TC for TC in K2_CHAIN_TILES if TC >= one_wave]
    TC = fits[0] if fits else K2_CHAIN_TILES[-1]
    if want_mu:
        TC = K2_MU_CHAIN_TILE
    while 4 * TC * TN * P > K2_W_SMEM:       # a wide P: fewer rows, chains
        if TN > 1:
            TN = -(-TN // 2)
        elif TC > K2_CHAIN_TILES[0] and not want_mu:
            TC = K2_CHAIN_TILES[K2_CHAIN_TILES.index(TC) - 1]
        else:
            raise NotImplementedError(
                f"mean_rss: P={P} is too wide for one block's tile of w "
                f"({4 * TC * P} bytes of shared memory a row, "
                f"{K2_W_SMEM} allowed)")
    grid = (-(-C // TC), -(-N // TN))
    return {"TC": TC, "TN": TN, "grid": grid, "scratch": (grid[1], C),
            "smem": 4 * TC * TN * P}


def mean_rss(B, y, w, want_mu=False):
    """B (N, L, P) and y (N, L) shared, zeroed at padded points; w (C, N, P)
    per chain.  Returns (rss (C,), mu (C, N, L) or None)."""
    if not _route("mean_rss", w):
        return mean_rss_plain(B, y, w, want_mu)
    N, L, P = B.shape
    C = w.shape[0]
    _check_cuda("mean_rss", (B, y, w), ((N, L, P), (N, L), (C, N, P)))
    mu = (torch.empty(C, N, L, dtype=w.dtype, device=w.device)
          if want_mu else None)
    if min(C, N, L, P) == 0:                 # empty sums; nothing to launch
        if want_mu:
            mu.zero_()
        return torch.zeros(C, dtype=w.dtype, device=w.device), mu
    plan = mean_rss_plan(C, N, L, P, want_mu)
    rss = torch.empty(C, dtype=w.dtype, device=w.device)
    partial = torch.empty(plan["scratch"], dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        rc = _library().bfmmm_mean_rss(
            B.data_ptr(), y.data_ptr(), w.data_ptr(), rss.data_ptr(),
            mu.data_ptr() if want_mu else None, partial.data_ptr(), C, N, L,
            P, plan["TC"], plan["TN"],
            torch.cuda.current_stream().cuda_stream)
    _launched("mean_rss", rc)
    return rss, mu


# The widest P a K2 block's tile of w takes: one row of the smallest chain
# tile within K2_W_SMEM.  The backward refuses what the forward refuses.
K2_MAX_P = K2_W_SMEM // (4 * K2_CHAIN_TILES[0])
# K2's backward (csrc/mean_rss.cu's kGradThreads, kGradSmem): threads a
# block at most, and the shared memory a block's chunks of B[n] and y[n]
# fill, within the 48 KB a block has without opting in.
K2_GRAD_THREADS = 256
K2_GRAD_SMEM = 48 * 1024
# Threads the backward wants on the card: the lanes of a chain split its
# points until the card holds this many, so that one chain and four take a
# warp each and 64 chains a few lanes (more lanes cost more in shuffles,
# and in blocks that stage the same B[n], than they save in points a lane).
K2_GRAD_WANT = 16_384
# Floats of w (and of accumulators) a lane holds, the instantiations of
# csrc/mean_rss.cu: 8 or 16 (P <= 16 on one lane, B's rows padded to 8 or
# 16 floats), 16 (P <= 512 split over up to 32 lanes) and 40 (P <= 1,280
# over 16 or 32 lanes).
K2_GRAD_LANE_FLOATS = (8, 16, 40)


def mean_rss_grad_plan(C, N, L, P, lanes=None):
    """Layout of K2's backward for w (C, N, P), B (N, L, P): a block owns
    one observation and ``TC`` chains; a chain is owned by ``SP`` x ``SL``
    lanes of one warp: ``SP`` lanes split P (1 for P <= 16; lane sp holds
    p = sp, sp + SP, ..., ``KP`` of them at most), ``SL`` lanes split the
    points (lane sl takes l = sl, sl + SL, ...).  SL is the smallest power
    of two that puts ``K2_GRAD_WANT`` threads on the card, within a warp and
    no more lanes than points; ``lanes`` sets it instead (the bench tries
    others).  B[n] and y[n] go to shared memory ``LC`` points at a time,
    rows ``KP`` floats apart for P <= 16 and P apart above: all L in one
    buffer where they fit ``K2_GRAD_SMEM``, else two buffers of a multiple
    of SL points.  A P above ``K2_MAX_P`` raises NotImplementedError, as
    the forward does.  Returns {"KP", "SP", "SL", "TC", "threads", "LC",
    "buffers", "grid": (observations, chain tiles), "smem": bytes}."""
    if min(C, N, L, P) < 1:
        raise ValueError(f"mean_rss_grad_plan: empty shape {(C, N, L, P)}")
    if P > K2_MAX_P:
        raise NotImplementedError(
            f"mean_rss_grad: P={P} is wider than K2 serves ({K2_MAX_P})")
    if P <= 16:
        SP, KP = 1, (8 if P <= 8 else 16)
    else:
        KP = 16 if P <= 32 * 16 else 40
        SP = 2
        while KP * SP < P:
            SP *= 2
    if lanes is None:
        SL = 1
        while SP * SL < 32 and SL < L and C * N * SP * SL < K2_GRAD_WANT:
            SL *= 2
    else:
        SL = lanes
        if SL < 1 or SL & (SL - 1) or SP * SL > 32:
            raise ValueError(f"mean_rss_grad_plan: {lanes} lanes a chain "
                             f"with {SP} splitting P={P}")
    S = SP * SL
    TC = min(C, K2_GRAD_THREADS // S)
    threads = -(-TC * S // 32) * 32          # whole warps
    TC = threads // S
    row = (KP if SP == 1 else P) + 1         # floats a point: B's row, y
    if 4 * L * row <= K2_GRAD_SMEM:
        LC, buffers = L, 1
    else:
        LC, buffers = K2_GRAD_SMEM // (8 * row) // SL * SL, 2
    return {"KP": KP, "SP": SP, "SL": SL, "TC": TC, "threads": threads,
            "LC": LC, "buffers": buffers, "grid": (N, -(-C // TC)),
            "smem": 4 * buffers * LC * row}


def mean_rss_grad_plain(B, y, w, g):
    """grad_w (C, N, P) of rss = sum (y - B w)^2 for an upstream gradient g
    (C,): -2 g[c] sum_l B[n, l, p] (y[n, l] - mu[c, n, l]), the residual
    formed anew as the kernel does."""
    r = y - torch.einsum("nlp,cnp->cnl", B, w)
    return (-2.0 * g)[:, None, None] * torch.einsum("nlp,cnl->cnp", B, r)


def _fma(a, b, c):
    """a * b + c rounded once, as fmaf: the float32 product is exact in
    float64, and the sum is rounded to float64 and then to c's type (two
    roundings, which differ from one only in rare ties)."""
    return (a.double() * b.double() + c.double()).to(c.dtype)


def _xor_tree(a):
    """The sum over the last axis (a power of two) as an xor-shuffle tree
    leaves it in lane 0: neighbours first, then pairs of pairs."""
    while a.shape[-1] > 1:
        a = a[..., 0::2] + a[..., 1::2]
    return a[..., 0]


def mean_rss_grad_tiled_plain(B, y, w, g):
    """K2's backward in the kernel's order of sums, for the CPU tests: per
    chain and observation, each of the plan's SP lanes forms its share of
    the dot product (p = sp, sp + SP, ..., one fused multiply-add each) and
    the shares meet in the xor tree; each of the SL lanes adds r B[l, :]
    over its points l = sl, sl + SL, ... in order, and the lanes' sums meet
    in the xor tree; then the -2 g scaling.  The chunks of points leave the
    order alone (a chunk is a multiple of SL points), and the lanes' spare
    slots past P and L add exact zeros.  Same function as
    ``mean_rss_grad_plain``; nothing on the main path calls it."""
    N, L, P = B.shape
    C = w.shape[0]
    plan = mean_rss_grad_plan(C, N, L, P)
    SP, SL = plan["SP"], plan["SL"]
    KS, LS = -(-P // SP), -(-L // SL)        # p a lane, points a lane
    pad = torch.nn.functional.pad
    Bk = pad(B, (0, KS * SP - P)).reshape(N, L, KS, SP)
    wk = pad(w, (0, KS * SP - P)).reshape(C, N, 1, KS, SP)
    share = torch.zeros(C, N, L, SP, dtype=w.dtype, device=w.device)
    for k in range(KS):
        share = _fma(Bk[None, :, :, k], wk[:, :, :, k], share)
    r = y - _xor_tree(share)                                  # (C, N, L)
    rj = pad(r, (0, LS * SL - L)).reshape(C, N, LS, SL, 1)
    Bj = pad(B, (0, 0, 0, LS * SL - L)).reshape(N, LS, SL, P)
    acc = torch.zeros(C, N, SL, P, dtype=w.dtype, device=w.device)
    for j in range(LS):
        acc = _fma(rj[:, :, j], Bj[None, :, j], acc)
    return (-2.0 * g)[:, None, None] * _xor_tree(acc.transpose(2, 3))


def mean_rss_grad(B, y, w, g):
    """K2's backward: B (N, L, P) and y (N, L) shared, w (C, N, P), g (C,)
    -> grad_w (C, N, P), the gradient of g . rss with respect to w."""
    if not _route("mean_rss_grad", w):
        return mean_rss_grad_plain(B, y, w, g)
    N, L, P = B.shape
    C = w.shape[0]
    _check_cuda("mean_rss_grad", (B, y, w, g),
                ((N, L, P), (N, L), (C, N, P), (C,)))
    if min(C, N, L, P) == 0:                 # empty sums; nothing to launch
        return torch.zeros_like(w)
    plan = mean_rss_grad_plan(C, N, L, P)
    grad = torch.empty_like(w)
    with torch.cuda.device(w.device):
        rc = _library().bfmmm_mean_rss_grad(
            B.data_ptr(), y.data_ptr(), w.data_ptr(), g.data_ptr(),
            grad.data_ptr(), C, N, L, P, plan["KP"], plan["SP"], plan["SL"],
            plan["TC"], plan["LC"], torch.cuda.current_stream().cuda_stream)
    _launched("mean_rss_grad", rc)
    return grad


class MeanRSS(torch.autograd.Function):
    """rss (C,) of ``mean_rss`` with a gradient for w: forward K2 (the
    same bits as ``mean_rss``), backward ``mean_rss_grad``; none for B and
    y, which are data.  On CPU tensors both run their plain versions.  Each
    reads the current stream when it launches, so the backward, which runs
    on the autograd engine's thread, launches where the engine put it."""

    @staticmethod
    def forward(ctx, B, y, w):
        ctx.save_for_backward(B, y, w)
        return mean_rss(B, y, w)[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        B, y, w = ctx.saved_tensors
        return None, None, mean_rss_grad(B, y, w, g.contiguous())


# ---------------------------------------------------------------------------
# K3: weighted Gram sums
# ---------------------------------------------------------------------------

def weighted_gram_plain(W, G):
    """out (R, P, P) = sum_n W[r, n] G[n] for W (R, N), G (N, P, P)."""
    return torch.einsum("rn,npq->rpq", W, G)


# K3's tiled kernel: threads a block, each summing one row of W by four
# (p, q) columns.
K3_THREADS = 128
# K3's chunked kernel: threads a block, and floats of shared memory (48 KB).
K3_CHUNK_THREADS = 256
K3_CHUNK_FLOATS = 48 * 1024 // 4


def weighted_gram_plan(R, N, P):
    """Tiles of K3 for W (R, N), G (N, P, P).  The tiled kernel serves
    P <= 16 with P*P a multiple of 4 when G and a block's ``TR`` rows of W
    fit one block's shared memory; a block then takes every (p, q) column.
    Anything else goes to the chunked kernel: one output a thread, ``QT``
    columns and ``TR`` rows a block, N staged ``NC`` at a time.  Returns
    {"tiled", "threads", "TR", "QT", "NC", "grid": (row tiles, column
    tiles), "smem": bytes}.
    """
    if min(R, N, P) < 1:
        raise ValueError(f"weighted_gram_plan: empty shape {(R, N, P)}")
    PP = P * P
    if PP % 4 == 0 and P <= 16:
        TR = K3_THREADS // (PP // 4)
        smem = 4 * (N * PP + TR * N)
        if smem <= SMEM_PER_BLOCK:
            return {"tiled": True, "threads": K3_THREADS, "TR": TR,
                    "QT": PP, "NC": N, "grid": (-(-R // TR), 1),
                    "smem": smem}
    threads = K3_CHUNK_THREADS
    QT = min(PP, threads)
    TR = threads // QT
    NC = max(1, min(N, K3_CHUNK_FLOATS // (QT + TR)))
    return {"tiled": False, "threads": threads, "TR": TR, "QT": QT, "NC": NC,
            "grid": (-(-R // TR), -(-PP // QT)), "smem": 4 * NC * (QT + TR)}


def weighted_gram(W, G):
    """W (R, N) row weights, G (N, P, P) shared -> (R, P, P), one sum per
    row."""
    if not _route("weighted_gram", W):
        return weighted_gram_plain(W, G)
    R, N = W.shape
    P = G.shape[-1]
    _check_cuda("weighted_gram", (W, G), ((R, N), (N, P, P)))
    if min(R, N, P) == 0:
        return torch.zeros(R, P, P, dtype=W.dtype, device=W.device)
    out = torch.empty(R, P, P, dtype=W.dtype, device=W.device)
    plan = weighted_gram_plan(R, N, P)
    with torch.cuda.device(W.device):
        rc = _library().bfmmm_weighted_gram(
            W.data_ptr(), G.data_ptr(), out.data_ptr(), R, N, P,
            int(plan["tiled"]), torch.cuda.current_stream().cuda_stream)
    _launched("weighted_gram", rc)
    return out
