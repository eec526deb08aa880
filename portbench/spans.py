"""The program's own spans in the traced slice, for the readers that
split the traced call by the program's layers.

``bayesfmmm_torch.utils.observability`` records spans while torch.profiler
records: a fit call, its checkpoint and host copies, its chain runs, their
sweeps and updaters.  They are timed on the clock of the profiler's events
and kept in the program's memory, outside the profiler's events.
``of_slice`` keeps those that overlap the slice's span ``portbench.call``,
cut to it, which leaves out spans of earlier profiled calls in the
process.  A program that records no spans gives None, and so does every
reader of them.
"""

from __future__ import annotations

import bisect

FIT = "api.fit_warm_start"
RUN = "samplers.drivers.run_chain"
SWEEPS = ("ops.gibbs.sweep_full", "ops.gibbs.sweep_nu_z",
          "ops.gibbs.sweep_theta")
EXCURSION = "samplers.drivers.tempered_excursion"


def of_slice(slice_):
    """[(name, start ns, end ns)] of the program's closed spans that
    overlap the slice, cut to it; None where the program records none
    there."""
    if slice_ is None:
        return None
    try:
        from bayesfmmm_torch.utils.observability import recorded_spans
    except ImportError:
        return None
    out = [(s.name, max(s.start_ns, slice_.t0), min(s.end_ns, slice_.t1))
           for s in recorded_spans()
           if s.end_ns is not None and s.end_ns > slice_.t0
           and s.start_ns < slice_.t1]
    return out or None


def merged(spans, names):
    """The union of the named spans as sorted, disjoint (start, end)."""
    out = []
    for s, e in sorted((s, e) for n, s, e in spans if n in names):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def length(intervals):
    return sum(e - s for s, e in intervals)


def intersect(a, b):
    """The intersection of two sorted, disjoint lists of intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def count_inside(times, intervals):
    """How many of ``times`` lie inside one of the sorted, disjoint
    ``intervals``."""
    starts = [s for s, _ in intervals]
    n = 0
    for t in times:
        k = bisect.bisect_right(starts, t) - 1
        n += k >= 0 and t < intervals[k][1]
    return n
