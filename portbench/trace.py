"""The traced slice of a run: one call of the window under
``torch.profiler``, reduced to device operations, host operations and the
counts the per-layer metrics read.

The slice is the benchmark's own span ``portbench.call`` around the call.
Device operations are the card's kernels, copies and fills; the device is
busy where any of them runs (the union of their intervals) and idle
elsewhere in the span.  Host launches are the CUDA runtime's and driver's
launch calls.  An idle gap is named by what the host was doing at its
middle: the innermost host operation then open, or ``python`` where none
was.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SPAN = "portbench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchKernelEx", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaLaunchCooperativeKernel")


@dataclass
class Event:
    name: str
    kind: str
    start: int          # ns
    end: int            # ns


def events_from_profiler(prof):
    """Every event of a finished ``torch.profiler.profile`` as ``Event``s,
    from the profiler's raw results (which skips building its Python event
    tree).  Where an event does not say its kind (PyTorch 2.11), one on
    the device counts as a kernel and one on the host as a host
    operation."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else (
            "kernel" if "CUDA" in str(e.device_type()) else "cpu_op")
        out.append(Event(e.name(), str(kind), start,
                         start + e.duration_ns()))
    return out


def _union_seconds(intervals):
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9


def short_name(name, width=120):
    """A kernel's name without its return type and arguments."""
    name = name.split("(")[0] if "(" in name else name
    if name.startswith("void "):
        name = name[5:]
    return name[:width]


@dataclass
class TraceSlice:
    events: list
    t0: int = 0
    t1: int = 0
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    def __post_init__(self):
        spans = [e for e in self.events
                 if e.name == SPAN and e.kind == "user_annotation"]
        if not spans:
            spans = [e for e in self.events if e.name == SPAN]
        if not spans:
            raise ValueError(f"the trace holds no {SPAN!r} span")
        self.t0, self.t1 = spans[0].start, spans[0].end
        inside = [e for e in self.events
                  if e.end > self.t0 and e.start < self.t1]
        # the span's mirror on the device's timeline is no operation
        self.device = [Event(e.name, e.kind, max(e.start, self.t0),
                             min(e.end, self.t1))
                       for e in inside
                       if e.kind in DEVICE_KINDS and e.name != SPAN]
        self.host = [e for e in inside
                     if e.kind in HOST_KINDS and e.name != SPAN]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self):
        return _union_seconds((e.start, e.end) for e in self.device)

    def launches(self):
        return sum(1 for e in self.host if e.name in LAUNCH_NAMES)

    def device_seconds(self, names):
        """Device seconds of the operations whose names contain any of
        ``names``, and how many there were."""
        hits = [e for e in self.device if any(n in e.name for n in names)]
        return sum(e.end - e.start for e in hits) * 1e-9, len(hits)

    def idle_gaps(self):
        """(start, end) ns of every stretch of the span with no device
        operation running."""
        gaps, cur = [], self.t0
        for s, e in sorted((e.start, e.end) for e in self.device):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        return gaps

    def idle_by_host(self):
        """{host operation: idle seconds} over the idle gaps, each gap
        named by the innermost host operation open at its middle."""
        host = sorted(self.host, key=lambda e: (e.start, -e.end))
        starts = [e.start for e in host]
        out, stack, i = {}, [], 0
        for s, e in sorted(self.idle_gaps(), key=lambda g: g[0] + g[1]):
            mid = (s + e) // 2
            j = bisect.bisect_right(starts, mid)
            while i < j:
                stack.append(host[i])
                i += 1
            while stack and stack[-1].end <= mid:
                stack.pop()
            name = stack[-1].name if stack else "python"
            out[name] = out.get(name, 0.0) + (e - s) * 1e-9
        return out

    def breakdown(self, top=10):
        ops = {}
        for e in self.device:
            k = short_name(e.name)
            ops[k] = ops.get(k, 0.0) + (e.end - e.start) * 1e-9
        idle = self.idle_by_host()
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:top]}
