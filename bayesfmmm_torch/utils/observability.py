"""Observability: progress streams, profiling, NaN debugging.

Port of ``bayesfmmm_tpu/utils/observability.py``.  The reference's
observability is Rcpp::Rcout prints of iteration count and rolling mean
log-likelihood (BFMMM.h:200-204, :870-875):

  * ``ProgressStream``      — rolling-loglik diagnostic stream as a
    first-class callback (host-side, fed with each chunk's loglik)
  * ``trace_profile``       — a torch.profiler region written as a Chrome
    trace
  * ``assert_finite_state`` / ``debug_nans`` — NaN debugging hooks
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from bayesfmmm_torch.models.state import STATE_FIELDS

__all__ = ["ProgressStream", "trace_profile", "assert_finite_state",
           "debug_nans", "rolling_loglik"]


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


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Profile a region with torch.profiler (the host, and the CUDA card
    when there is one) and write it into ``logdir`` as a Chrome trace,
    ``trace_<pid>_<ns>.json`` (chrome://tracing, Perfetto).  Yields the
    profiler, whose ``key_averages()`` tabulate the region."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def debug_nans(enable=True):
    """Scoped autograd anomaly detection (the JAX package's scoped
    jax_debug_nans).  Inside, a backward function that returns a NaN
    raises a RuntimeError naming it, with the traceback of the forward
    operation that made it: the log-joint's gradient in HMC, NUTS, ADVI
    and the Phi MALA.  Forward values are not checked (use
    ``assert_finite_state``).  The previous setting comes back on exit."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)


def assert_finite_state(state, where=""):
    """Host-side NaN/Inf check over a GibbsState; raises with field names."""
    bad = [f for f in STATE_FIELDS
           if getattr(state, f).numel()
           and not bool(getattr(state, f).isfinite().all())]
    if bad:
        raise FloatingPointError(
            f"non-finite values in state fields {bad} {where}")
    return True
