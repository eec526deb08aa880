"""B-spline design matrices from raw points and the penalties of nu's prior.

``design``: a 1-D basis by SciPy's ``BSpline`` with identity
coefficients: column j is the j-th basis function of the clamped knot
vector (boundary knots repeated degree + 1 times), evaluated at every
point, the upper boundary included.  ``tensor_design``: the products of
one such column per axis, for surfaces.  ``rw1_penalty`` is the
functional family's first-order random walk, ``tensor_penalty`` the hd
family's graph of first differences on the grid of coefficients."""

from __future__ import annotations

import numpy as np
from scipy.interpolate import BSpline


def knot_vector(degree, internal_knots, boundary_knots):
    lo, hi = (float(b) for b in boundary_knots)
    return np.concatenate([np.full(degree + 1, lo),
                           np.asarray(internal_knots, np.float64).ravel(),
                           np.full(degree + 1, hi)])


def design(t, degree, internal_knots, boundary_knots):
    """(n, P) float64 basis at the points ``t``, P = len(internal) +
    degree + 1."""
    knots = knot_vector(degree, internal_knots, boundary_knots)
    P = len(knots) - degree - 1
    spline = BSpline(knots, np.eye(P), degree, extrapolate=False)
    B = spline(np.asarray(t, np.float64).ravel())
    if not np.all(np.isfinite(B)):
        raise ValueError("time points outside the boundary knots")
    return B


def basis_sizes(degrees, internal_list):
    """Functions per axis of a tensor basis: len(internal) + degree + 1."""
    return [len(np.ravel(k)) + int(d) + 1
            for d, k in zip(degrees, internal_list)]


def rw1_penalty(P):
    """D'D for the first differences D of P coordinates."""
    D = np.diff(np.eye(P), axis=0)
    return D.T @ D


def tensor_design(points, degrees, internal_list, boundary_list):
    """(n, prod P_l) float64 tensor-product basis at the points (n, dim):
    each column the product of one ``design`` column per axis, the columns
    in upstream's mixed-radix walk with the last axis fastest
    (``TensorBSpline``, BayesFMMM's BSplines.h:18-62), so that column
    i_0 P_1 ... P_{dim-1} + ... + i_{dim-1} is prod_l B_l[:, i_l]."""
    points = np.asarray(points, np.float64)
    points = points.reshape(len(points), -1)
    if points.shape[1] != len(degrees):
        raise ValueError(f"points of {points.shape[1]} axes, "
                         f"{len(degrees)} bases")
    B = np.ones((len(points), 1))
    for axis, degree in enumerate(degrees):
        Bl = design(points[:, axis], int(degree), internal_list[axis],
                    boundary_list[axis])
        B = (B[:, :, None] * Bl[:, None, :]).reshape(len(points), -1)
    return B


def tensor_penalty(sizes):
    """C'C over a tensor basis of ``sizes`` functions per axis (upstream's
    ``GetP``, BSplines.h:70-120): C has one row e_i - e_j for each pair of
    columns whose multi-indices differ by +1 in exactly one axis, that is
    the first differences along each axis of the grid of coefficients,
    columns numbered as ``tensor_design`` numbers them."""
    sizes = [int(s) for s in sizes]
    rows = []
    for axis, n in enumerate(sizes):
        before = int(np.prod(sizes[:axis]))
        after = int(np.prod(sizes[axis + 1:]))
        first = np.diff(np.eye(n), axis=0)
        rows.append(np.kron(np.kron(np.eye(before), first), np.eye(after)))
    C = np.vstack(rows)
    return C.T @ C
