"""Observability: progress streams, profiling, spans, NaN debugging.

Port of ``bayesfmmm_tpu/utils/observability.py``.  The reference's
observability is Rcpp::Rcout prints of iteration count and rolling mean
log-likelihood (BFMMM.h:200-204, :870-875):

  * ``ProgressStream``      — rolling-loglik diagnostic stream as a
    first-class callback (host-side, fed with each chunk's loglik)
  * ``trace_profile``       — a torch.profiler region written as a Chrome
    trace, with the program's spans on a track of their own
  * ``span`` / ``traced``   — the program's layers (fit calls, checkpoint,
    host copies, chain runs, sweeps, updaters) as spans on the profiler's
    clock, recorded only while torch.profiler records on the thread;
    ``recorded_spans`` and ``clear_spans`` read and empty them
  * ``assert_finite_state`` / ``debug_nans`` — NaN debugging hooks
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from bayesfmmm_torch.models.state import STATE_FIELDS

__all__ = ["ProgressStream", "trace_profile", "assert_finite_state",
           "debug_nans", "rolling_loglik", "span", "traced", "Span",
           "recorded_spans", "clear_spans", "dropped_spans"]


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


# ---------------------------------------------------------------------------
# Spans: the program's layers on the profiler's clock
# ---------------------------------------------------------------------------
#
# A span is one stretch of a layer's work: a fit call, a checkpoint's load
# or save, a copy to the host, a chain run, a sweep, an updater.  Spans
# record only while torch.profiler records on the calling thread, and only
# into this process's memory.  None is a ``record_function`` range, so none
# enters the profiler's own events (where a range also gets a mirror on the
# device's timeline); none touches a tensor, a generator or the stream, so
# every draw has the same bits with the profiler on or off.  They are timed
# on the clock of the profiler's events (Unix time in ns), so a reader sets
# them beside the profiler's host and device events.  While the profiler is
# off a span costs one read of its flag.

MAX_SPANS = 1_000_000
_profiling = torch._C._autograd._profiler_enabled
_clock = time.time_ns


class Span(NamedTuple):
    """One recorded span.  ``parent`` is the index, in the list
    ``recorded_spans`` returns, of the span open around this one, and
    ``call`` that of the outermost ``api.fit_*`` span it lies in (its own
    for that span): the spans of one fit call share it.  Either is -1
    where there is none.  ``end_ns`` is None while the span is open;
    ``counts`` holds integers such as ``bytes`` or ``sweeps``, or a name
    such as ``family``."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    call: int
    counts: dict


class _Log:
    """Every span of the process, at most ``MAX_SPANS``; those dropped for
    want of room are counted.  ``clear_spans`` starts a new generation:
    spans open across it are not recorded."""

    def __init__(self):
        self.spans, self.dropped, self.generation = [], 0, 0
        self.lock = threading.Lock()
        self.local = threading.local()


_LOG = _Log()


def _open_stack():
    """(index, call, generation) of each span open on this thread."""
    try:
        return _LOG.local.stack
    except AttributeError:
        _LOG.local.stack = []
        return _LOG.local.stack


class _Recording:
    """A span being recorded; ``set`` adds counts to it."""

    __slots__ = ("name", "counts", "index", "generation")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def set(self, **counts):
        self.counts.update(counts)

    def __enter__(self):
        start = _clock()
        stack = _open_stack()
        with _LOG.lock:
            self.generation = _LOG.generation
            parent, call, gen = stack[-1] if stack else (-1, -1, -1)
            if gen != self.generation:
                parent = call = -1
            if len(_LOG.spans) >= MAX_SPANS:
                _LOG.dropped += 1
                self.index = -1
            else:
                self.index = len(_LOG.spans)
                if call < 0 and self.name.startswith("api.fit_"):
                    call = self.index
                _LOG.spans.append(Span(self.name, start, None, parent, call,
                                       self.counts))
        # a dropped span's children hang from its nearest recorded parent
        stack.append((self.index if self.index >= 0 else parent, call,
                      self.generation))
        return self

    def __exit__(self, *exc):
        end = _clock()
        _open_stack().pop()
        with _LOG.lock:
            if self.index >= 0 and self.generation == _LOG.generation:
                _LOG.spans[self.index] = \
                    _LOG.spans[self.index]._replace(end_ns=end)
        return False


class _Inert:
    """What ``span`` gives while the profiler is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts):
        pass


_INERT = _Inert()


def span(name, **counts):
    """A context manager that records its body as the span ``name``, with
    the ``counts`` (integers, or a name), while torch.profiler records on
    this thread, and does nothing otherwise.  What it yields takes further
    counts by ``set(**counts)``."""
    if not _profiling():
        return _INERT
    return _Recording(name, counts)


def traced(name):
    """Decorator: every call of the function is a span ``name``, as
    ``span``.  The wrapper keeps the function's name, docstring and
    signature."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _Recording(name, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def recorded_spans():
    """A copy of the list of spans recorded since the last
    ``clear_spans``, in the order they opened."""
    with _LOG.lock:
        return list(_LOG.spans)


def dropped_spans():
    """How many spans found the list full since the last ``clear_spans``."""
    return _LOG.dropped


def clear_spans():
    """Empty the list of spans; spans open now are not recorded."""
    with _LOG.lock:
        _LOG.spans, _LOG.dropped = [], 0
        _LOG.generation += 1


def _write_spans(path, spans):
    """Add ``spans`` to the Chrome trace at ``path`` as complete events on
    a track of their own, sorted above the profiler's."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = "bayesfmmm_torch spans"
    events = trace.setdefault("traceEvents", [])
    events += [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": pid}},
               {"ph": "M", "name": "process_sort_index", "pid": pid,
                "tid": 0, "args": {"sort_index": -1}}]
    events += [{"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                "tid": 0, "ts": (s.start_ns - base) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.counts}
               for s in spans]
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Profile a region with torch.profiler (the host, and the CUDA card
    when there is one) and write it into ``logdir`` as a Chrome trace,
    ``trace_<pid>_<ns>.json`` (chrome://tracing, Perfetto), with the
    program's spans of the region on a track of their own.  Yields the
    profiler, whose ``key_averages()`` tabulate the region."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    t0 = _clock()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        t1 = _clock()
        path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _write_spans(path, [s for s in recorded_spans()
                            if s.end_ns is not None and s.start_ns >= t0
                            and s.end_ns <= t1])


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
