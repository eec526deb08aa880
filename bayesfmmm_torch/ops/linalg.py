"""Small-matrix linear algebra and the fused precision draw.

Port of the parts of ``bayesfmmm_tpu/ops/linalg.py`` the sweep uses.  The
JAX package unrolls tiny Cholesky factorizations entry by entry, and its
production updaters pass the M(M+1)/2 entries of an (M, M) matrix as
separate arrays (the "entries interface", linalg.py:338-403), so that no
trailing (M, M) tensor is padded to the TPU's (8, 128) tiles.  On the GPU a
packed (..., M, M) tensor costs one batched ``torch.linalg`` launch where
the entries form costs ~30 elementwise ones, so the port keeps the packed
form only; ``cholesky_ex`` is used so that no info check syncs the host.

The joint Phi draw — one D = K*M*P dimensional precision per chain per
sweep — goes through ``precision_draw_pair``, which sends CUDA tensors to
the hand-written factor-and-solve kernel K1 (ops/kernels.py::chol_solve).
"""

from __future__ import annotations

import torch

from bayesfmmm_torch.ops import kernels


def small_chol(A):
    """Lower Cholesky factor of SPD (..., M, M)."""
    return torch.linalg.cholesky_ex(A).L


def small_solve_lower(L, b):
    """x with L x = b; L (..., M, M) lower-triangular, b (..., M)."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def small_solve_upper_t(L, b):
    """x with L^T x = b for lower-triangular L."""
    return torch.linalg.solve_triangular(L.mT, b[..., None],
                                         upper=True)[..., 0]


def small_chol_logdet(L):
    """log det of the SPD matrix whose Cholesky factor is L (..., M, M)."""
    return 2.0 * torch.log(L.diagonal(dim1=-2, dim2=-1)).sum(-1)


def precision_draw_pair(A, b, z, jitter=0.0):
    """(mean, noise) with mean = A^-1 b and noise = chol(A)^-T z; with
    ``jitter`` > 0, A + jitter * (tr(A) / D + 1) * I takes A's place, formed
    inside the kernel.

    A (..., D, D) SPD, b and z (..., D); the batch axes (the chain axis) are
    flattened into the kernel's one."""
    D = A.shape[-1]
    batch = b.shape[:-1]
    mean, noise = kernels.chol_solve(A.reshape(-1, D, D).contiguous(),
                                     b.reshape(-1, D).contiguous(),
                                     z.reshape(-1, D).contiguous(), jitter)
    return mean.reshape(batch + (D,)), noise.reshape(batch + (D,))


def mvn_from_precision_fused(generator, A, b, *, jitter=1e-6):
    """Sample N(A^-1 b, A^-1) with the jitter contract of
    distributions.chol_precision (A + jitter * (tr(A) / D + 1) * I, as at
    linalg.py:325-326 of the JAX package; K1 adds it to the diagonal it
    holds on chip, so no (..., D, D) tensor is built here); returns
    (sample, mean)."""
    z = torch.randn(b.shape, generator=generator, dtype=b.dtype,
                    device=b.device)
    mean, noise = precision_draw_pair(A, b, z, jitter)
    return mean + noise, mean
