"""Observability: progress streams and NaN debugging.

Port of ``bayesfmmm_tpu/utils/observability.py``.  The reference's
observability is Rcpp::Rcout prints of iteration count and rolling mean
log-likelihood (BFMMM.h:200-204, :870-875):

  * ``ProgressStream``      — rolling-loglik diagnostic stream as a
    first-class callback (host-side, fed with each chunk's loglik)
  * ``assert_finite_state`` — host-side NaN/Inf check of a sampler state

The JAX package's ``trace_profile`` and ``debug_nans`` wrap JAX's profiler
and configuration and have no counterpart here yet.
"""

from __future__ import annotations

import time

import numpy as np

from bayesfmmm_torch.models.state import STATE_FIELDS

__all__ = ["ProgressStream", "assert_finite_state", "rolling_loglik"]


class ProgressStream:
    """Rolling log-likelihood progress reporting (BFMMM.h:870-875 analog)."""

    def __init__(self, every=100, window=5, printer=print):
        self.every = every
        self.window = window
        self.printer = printer
        self._t0 = time.time()
        self.history = []

    def update(self, iteration, loglik_values):
        """Feed the latest loglik values (array-like); prints every `every`."""
        vals = np.atleast_1d(np.asarray(loglik_values))
        self.history.extend(vals.tolist())
        if (iteration + 1) % self.every == 0:
            tail = self.history[-self.window:]
            rate = (iteration + 1) / (time.time() - self._t0)
            self.printer(
                f"Iteration: {iteration + 1}  "
                f"Log-likelihood: {np.mean(tail):.2f}  "
                f"({rate:.1f} it/s)")


def rolling_loglik(loglik_trace, window=5):
    """Rolling mean over the trailing window (the reference's statistic)."""
    ll = np.asarray(loglik_trace)
    if len(ll) < window:
        return float(ll.mean())
    return float(ll[-window:].mean())


def assert_finite_state(state, where=""):
    """Host-side NaN/Inf check over a GibbsState; raises with field names."""
    bad = [f for f in STATE_FIELDS
           if getattr(state, f).numel()
           and not bool(getattr(state, f).isfinite().all())]
    if bad:
        raise FloatingPointError(
            f"non-finite values in state fields {bad} {where}")
    return True
