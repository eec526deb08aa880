"""One run of one cell: set-up, the measured window, the check, the line.

``run`` makes the data from the seed, lets the cell's entry set up and warm
up, then keeps starting timed calls until ``seconds`` have passed; the
window ends when the last call returns.  The end-to-end rate is the work
of all the window's calls over the seconds they took.  With ``trace`` one
call runs under ``torch.profiler`` before the window (the slice the
per-layer metrics read), and the window's calls give the rates the
per-layer metrics need.  Once the window has closed the peak memory is
read, the program's state freed, and the reference judges every call.
"""

from __future__ import annotations

import tempfile
import time

from portbench import datagen, spec
from portbench.reference import check, model
from portbench.trace import SPAN, TraceSlice, events_from_profiler


class Context:
    """What a per-layer metric's ``read`` gets: the cell and its
    configuration, the traced slice and the sizes of its call, and the
    work and seconds of the window's calls after it."""

    def __init__(self, cell, config, slice_, slice_call, rest):
        self.cell, self.config = cell, config
        self.slice, self.slice_call, self.rest = slice_, slice_call, rest


def curves_of(raw):
    return model.Curves.from_raw(raw)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(entry, device):
    t = time.perf_counter()
    info = entry.call()
    _sync(device)
    return time.perf_counter() - t, info


def _profiled(entry, device):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            dt, info = _timed(entry, device)
    return dt, info, TraceSlice(events_from_profiler(prof))


def _sum_calls(calls):
    rest = {"seconds": sum(dt for dt, _ in calls)}
    for _, info in calls:
        for k, v in info.items():
            rest[k] = rest.get(k, 0) + v
    return rest


def run(bench, cell, config, *, seed, seconds, trace, device, t0,
        root=spec.ROOT):
    """(the result line's dict, whose last key ``check`` is the check's
    table; the seconds of each untraced call).  ``root`` is the checkout
    the cell's files are in."""
    import torch
    raw = datagen.from_config(config, seed)
    mod = spec.load_entry(cell["entry"], root)
    e2e = spec.metrics_of(bench, cell["name"], "end_to_end")
    for m in e2e:
        if m["name"] not in ("setup_s", mod.RATE_METRIC):
            raise ValueError(f"entry {cell['entry']!r} does not measure "
                             f"{m['name']!r}")
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        entry = mod.Entry(cell, config, raw, seed, device, work)
        entry.setup()
        _sync(device)
        setup_s = time.perf_counter() - t0

        calls, traced, traced_call = [], None, None
        if trace:
            _, traced_call, traced = _profiled(entry, device)
        # the window starts after the traced call and its trace's reading,
        # and holds at least one call
        start = time.perf_counter()
        while time.perf_counter() - start < seconds or not calls:
            calls.append(_timed(entry, device))
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        answers = entry.answers()
        entry.free()
    del entry
    if on_card:
        torch.cuda.empty_cache()

    per_call = check.readings(answers, curves_of(raw), device=device,
                              zfields=check.zfields_of(cell["limits"]))
    correct, failed, table = check.judge(per_call, cell["limits"])

    metrics = {}
    if not trace:
        rest = _sum_calls(calls)
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" \
                else rest["work"] / rest["seconds"]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = Context(cell, config, traced, traced_call, _sum_calls(calls))
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            v = spec.load_reader(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": len(per_call),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["check"] = table
    return result, [dt for dt, _ in calls]
