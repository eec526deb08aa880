"""B-spline basis and RW(1) penalty for 1-D functional data (host, NumPy f64).

The functions of ``bayesfmmm_tpu.basis`` that the functional family needs,
restated so that the port loads nothing of the JAX package;
``tests/test_torch_state.py`` holds them equal to the originals.  The
tensor-domain bases arrive with the hd family (ROADMAP item
'covariate-adjusted models and the other families').
"""

from __future__ import annotations

import numpy as np

__all__ = ["bspline_basis", "rw1_penalty"]


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
