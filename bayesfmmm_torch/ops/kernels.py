"""Hand-written CUDA kernels of the sweep, their plain versions and bindings.

Counterpart of ``bayesfmmm_tpu/ops/pallas_kernels.py``:

  * K1 ``chol_solve`` — per-chain Cholesky of an SPD (D, D) precision and
    the two triangular solves of the joint Phi draw (replaces
    ``chol_solve_batch_minor``).  Source: csrc/chol_solve.cu.
  * K2 ``mean_rss``   — mu = B w and rss = sum (y - mu)^2 in one pass over
    B, batched over chains (replaces ``fused_mean_rss``).  Source:
    csrc/mean_rss.cu.
  * K3 ``weighted_gram`` — sum_n W[r, n] G[n] for every row r of W, the
    data-precision block of the blocked updates (replaces
    ``weighted_gram``).  Source: csrc/weighted_gram.cu.

Each wrapper takes its plain PyTorch version for tensors on the CPU, and
for CUDA tensors launches its kernel or raises: there is no fallback.  The
kernels are compiled by nvcc for sm_90a at first use, from the sources in
``csrc/``, into ``_build/`` (keyed by a hash of sources and flags), and
bound with ctypes; each C entry point launches on PyTorch's current stream,
allocates nothing and returns cudaGetLastError().

``LAUNCHES`` counts kernel launches (one per launch, nowhere else), so a
run can show that its main path went through the kernels.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Opt-in shared memory of one thread block on H100/H200 (227 KB).  K1 keeps
# the whole (D, D) matrix and two D-vectors there.
SMEM_PER_BLOCK = 232_448

LAUNCHES = {"chol_solve": 0, "mean_rss": 0, "weighted_gram": 0}

_lib = None


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def chol_solve_max_dim():
    """Largest D whose (D*D + 2*D) f32 values fit one block's shared memory."""
    D = 1
    while 4 * ((D + 1) ** 2 + 2 * (D + 1)) <= SMEM_PER_BLOCK:
        D += 1
    return D


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


def build():
    """Compile csrc/*.cu with nvcc unless the library for these sources
    exists; returns its path.  Raises RuntimeError without nvcc."""
    out = _library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of bayesfmmm_torch are built from "
            "bayesfmmm_torch/csrc at first use")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(_CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bfmmm_chol_solve.argtypes = [p, p, p, p, p, i, i, p]
        lib.bfmmm_chol_solve.restype = i
        lib.bfmmm_mean_rss.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.bfmmm_mean_rss.restype = i
        lib.bfmmm_weighted_gram.argtypes = [p, p, p, i, i, i, p]
        lib.bfmmm_weighted_gram.restype = i
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


# ---------------------------------------------------------------------------
# K1: Cholesky factor-and-solve
# ---------------------------------------------------------------------------

def chol_solve_plain(A, b, z):
    """mean = A^-1 b and noise = chol(A)^-T z for A (C, D, D), b/z (C, D)."""
    L = torch.linalg.cholesky_ex(A).L
    w = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    rhs = torch.cat([w, z[..., None]], dim=-1)
    out = torch.linalg.solve_triangular(L.mT, rhs, upper=True)
    return out[..., 0], out[..., 1]


def chol_solve(A, b, z):
    """(mean, noise) of the precision draw, per chain: A (C, D, D) SPD,
    b and z (C, D) -> mean = A^-1 b, noise = chol(A)^-T z, both (C, D)."""
    if not _route("chol_solve", A):
        return chol_solve_plain(A, b, z)
    C, D = b.shape
    if D > chol_solve_max_dim():
        raise NotImplementedError(
            f"chol_solve: D={D} exceeds {chol_solve_max_dim()}, the largest "
            f"dimension whose matrix fits one block's shared memory; the "
            f"large-D path is ROADMAP item 'K1 large-D'")
    _check_cuda("chol_solve", (A, b, z), ((C, D, D), (C, D), (C, D)))
    mean, noise = torch.empty_like(b), torch.empty_like(b)
    if C == 0:
        return mean, noise
    with torch.cuda.device(A.device):
        rc = _library().bfmmm_chol_solve(
            A.data_ptr(), b.data_ptr(), z.data_ptr(), mean.data_ptr(),
            noise.data_ptr(), C, D, torch.cuda.current_stream().cuda_stream)
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


def mean_rss(B, y, w, want_mu=False):
    """B (N, L, P) and y (N, L) shared, zeroed at padded points; w (C, N, P)
    per chain.  Returns (rss (C,), mu (C, N, L) or None)."""
    if not _route("mean_rss", w):
        return mean_rss_plain(B, y, w, want_mu)
    N, L, P = B.shape
    C = w.shape[0]
    _check_cuda("mean_rss", (B, y, w), ((N, L, P), (N, L), (C, N, P)))
    rss = torch.empty(C, dtype=w.dtype, device=w.device)
    mu = (torch.empty(C, N, L, dtype=w.dtype, device=w.device)
          if want_mu else None)
    if C == 0:
        return rss, mu
    with torch.cuda.device(w.device):
        rc = _library().bfmmm_mean_rss(
            B.data_ptr(), y.data_ptr(), w.data_ptr(), rss.data_ptr(),
            mu.data_ptr() if want_mu else None, C, N, L, P,
            torch.cuda.current_stream().cuda_stream)
    _launched("mean_rss", rc)
    return rss, mu


# ---------------------------------------------------------------------------
# K3: weighted Gram sums
# ---------------------------------------------------------------------------

def weighted_gram_plain(W, G):
    """out (R, P, P) = sum_n W[r, n] G[n] for W (R, N), G (N, P, P)."""
    return torch.einsum("rn,npq->rpq", W, G)


def weighted_gram(W, G):
    """W (R, N) row weights, G (N, P, P) shared -> (R, P, P), one sum per
    row."""
    if not _route("weighted_gram", W):
        return weighted_gram_plain(W, G)
    R, N = W.shape
    P = G.shape[-1]
    _check_cuda("weighted_gram", (W, G), ((R, N), (N, P, P)))
    out = torch.empty(R, P, P, dtype=W.dtype, device=W.device)
    if R == 0 or P == 0:
        return out
    with torch.cuda.device(W.device):
        rc = _library().bfmmm_weighted_gram(
            W.data_ptr(), G.data_ptr(), out.data_ptr(), R, N, P,
            torch.cuda.current_stream().cuda_stream)
    _launched("weighted_gram", rc)
    return out
