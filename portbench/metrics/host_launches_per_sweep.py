"""Kernel launches the host makes a sweep of the ensemble: the CUDA
runtime's and driver's launch calls in the traced call, over its sweeps.
The eager host path of ``ops.gibbs`` and ``samplers.drivers`` pays for
each; fewer launches a sweep (fused or captured) should raise
``chain_sweeps_per_s``."""

UNIT = "launches/sweep"
LAYER = "ops.gibbs and samplers.drivers, the eager host path"
MOVES = "chain_sweeps_per_s"


def read(ctx):
    n = ctx.slice.launches() if ctx.slice is not None else 0
    sweeps = ctx.slice_call.get("sweeps", 0) if ctx.slice_call else 0
    if not n or not sweeps:
        return None
    return n / sweeps
