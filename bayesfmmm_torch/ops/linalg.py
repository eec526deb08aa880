"""Small-matrix linear algebra and the fused precision draw.

Port of the parts of ``bayesfmmm_tpu/ops/linalg.py`` the reference sweep
uses.  The JAX package unrolls tiny Cholesky factorizations entry by entry
to dodge the TPU's (8, 128) tile padding; on the GPU the batched
``torch.linalg`` routines serve, and ``cholesky_ex`` is used so that no
info check syncs the host.

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


def precision_draw_pair(A, b, z):
    """(mean, noise) with mean = A^-1 b and noise = chol(A)^-T z.

    A (..., D, D) SPD, b and z (..., D); the batch axes (the chain axis) are
    flattened into the kernel's one."""
    D = A.shape[-1]
    batch = b.shape[:-1]
    mean, noise = kernels.chol_solve(A.reshape(-1, D, D).contiguous(),
                                     b.reshape(-1, D).contiguous(),
                                     z.reshape(-1, D).contiguous())
    return mean.reshape(batch + (D,)), noise.reshape(batch + (D,))


def mvn_from_precision_fused(generator, A, b, *, jitter=1e-6):
    """Sample N(A^-1 b, A^-1) with the jitter contract of
    distributions.chol_precision (jitter added outside the kernel, as at
    linalg.py:325-326 of the JAX package); returns (sample, mean)."""
    D = A.shape[-1]
    scale = A.diagonal(dim1=-2, dim2=-1).sum(-1) / D + 1.0
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    Aj = A + (jitter * scale)[..., None, None] * eye
    z = torch.randn(b.shape, generator=generator, dtype=b.dtype,
                    device=b.device)
    mean, noise = precision_draw_pair(Aj, b, z)
    return mean + noise, mean
