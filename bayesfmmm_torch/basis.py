"""B-spline bases and penalties (host, NumPy f64): the 1-D basis and RW(1)
penalty of the functional family, the tensor-product basis and its graph
penalty of the hd family.

The functions of ``bayesfmmm_tpu.basis``, restated so that the port loads
nothing of the JAX package; ``tests/test_torch_state.py`` and
``tests/test_torch_families.py`` hold them equal to the originals.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bspline_basis", "rw1_penalty", "mixed_radix_indices",
           "tensor_bspline_basis", "tensor_penalty"]


def _knot_vector(internal_knots, degree, boundary_knots):
    """Clamped knot vector: boundary knots repeated ``degree + 1`` times."""
    lo, hi = float(boundary_knots[0]), float(boundary_knots[1])
    internal_knots = np.asarray(internal_knots, dtype=np.float64).ravel()
    return np.concatenate([np.full(degree + 1, lo), internal_knots,
                           np.full(degree + 1, hi)])


def bspline_basis(t, degree, internal_knots, boundary_knots):
    """Complete (intercept-including) B-spline basis evaluated at ``t``.

    Matches ``splines2::BSpline(t, internal_knots, degree, boundary)
    .basis(true)`` (BFMMM.h:1392-1399): P = len(internal_knots) + degree + 1
    columns, right-closed at the upper boundary.  Returns (n, P) float64.
    """
    t = np.asarray(t, dtype=np.float64).ravel()
    knots = _knot_vector(internal_knots, degree, boundary_knots)
    n_basis = len(knots) - degree - 1
    hi = float(boundary_knots[1])

    # Cox-de Boor recursion, vectorized over evaluation points.
    n_seg = len(knots) - 1
    B = np.zeros((t.shape[0], n_seg), dtype=np.float64)
    for j in range(n_seg):
        left, right = knots[j], knots[j + 1]
        if right > left:
            sel = (t >= left) & ((t < right) | ((t == hi) & (right == hi)))
            B[sel, j] = 1.0

    for d in range(1, degree + 1):
        B_next = np.zeros((t.shape[0], n_seg - d), dtype=np.float64)
        for j in range(n_seg - d):
            denom1 = knots[j + d] - knots[j]
            denom2 = knots[j + d + 1] - knots[j + 1]
            term = np.zeros_like(t)
            if denom1 > 0:
                term = term + (t - knots[j]) / denom1 * B[:, j]
            if denom2 > 0:
                term = term + (knots[j + d + 1] - t) / denom2 * B[:, j + 1]
            B_next[:, j] = term
        B = B_next

    assert B.shape[1] == n_basis
    return B


def rw1_penalty(P):
    """First-order random-walk (tridiagonal) penalty (BFMMM.h:1402-1412):
    diag = [1, 2, ..., 2, 1], off-diagonal = -1."""
    M = 2.0 * np.eye(P) - np.eye(P, k=1) - np.eye(P, k=-1)
    M[0, 0] = M[P - 1, P - 1] = 1.0
    return M


def mixed_radix_indices(sizes):
    """Multi-indices of the tensor-basis columns, last dimension fastest
    (the mixed-radix walk of BSplines.h:38-59): column i has the
    per-dimension basis indices (i // stride_l) % sizes[l] with
    stride_l = prod(sizes[l+1:]).  Returns a (P, dim) int array."""
    sizes = list(sizes)
    P = int(np.prod(sizes))
    strides = np.ones(len(sizes), dtype=np.int64)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    cols = np.arange(P, dtype=np.int64)
    return np.stack([(cols // strides[l]) % sizes[l]
                     for l in range(len(sizes))], axis=1)


def tensor_bspline_basis(t, degrees, internal_knots_list, boundary_knots):
    """Tensor-product B-spline basis at the points t (n, dim)
    (TensorBSpline, BSplines.h:18-62): each column is a product over the
    dimensions of 1-D basis functions, in mixed-radix order.
    ``boundary_knots`` is (dim, 2).  Returns (n, prod(P_l)) float64."""
    t = np.asarray(t, dtype=np.float64)
    if t.ndim == 1:
        t = t[:, None]
    bases = [bspline_basis(t[:, l], int(degrees[l]), internal_knots_list[l],
                           np.asarray(boundary_knots)[l])
             for l in range(t.shape[1])]
    idx = mixed_radix_indices([b.shape[1] for b in bases])
    B = np.ones((t.shape[0], idx.shape[0]), dtype=np.float64)
    for l, b in enumerate(bases):
        B *= b[:, idx[:, l]]
    return B


def tensor_penalty(degrees, internal_knots_list):
    """Graph-difference penalty C'C of a tensor-product basis (GetP,
    BSplines.h:70-120): C has one row e_i - e_j for every pair of columns
    whose multi-indices differ by +1 in exactly one dimension."""
    sizes = [len(np.asarray(internal_knots_list[l]).ravel())
             + int(degrees[l]) + 1 for l in range(len(degrees))]
    idx = mixed_radix_indices(sizes)
    P = idx.shape[0]
    diff = idx[None, :, :] - idx[:, None, :]          # [i, j] = idx_j - idx_i
    i, j = np.nonzero((diff.sum(-1) == 1) & (np.abs(diff).sum(-1) == 1))
    C = np.zeros((len(i), P), dtype=np.float64)
    C[np.arange(len(i)), i] = 1.0
    C[np.arange(len(i)), j] = -1.0
    return C.T @ C
