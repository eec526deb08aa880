"""Cubic B-spline design matrices from raw time points, by SciPy's
``BSpline`` with identity coefficients: column j is the j-th basis
function of the clamped knot vector (boundary knots repeated degree + 1
times), evaluated at every point, the upper boundary included."""

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
