"""Host synchronisations a sweep: the CUDA runtime calls in the traced
call that make the host wait for the device (``SYNCS``: a stream, the
device or an event synchronised, or a blocking copy) and start inside a
sweep span of the program, over the number of sweep spans.  A sync inside
a sweep drains the launch queue and keeps the sweep from being captured
as a graph; fewer raise ``chain_sweeps_per_s``.  None where the slice
holds no CUDA runtime call (a run on the CPU) or the program records no
sweep spans."""

from portbench import spans as sp

UNIT = "syncs/sweep"
LAYER = "ops.gibbs sweeps, their updaters"
MOVES = "chain_sweeps_per_s"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(ctx):
    spans = sp.of_slice(ctx.slice)
    if spans is None or not any(e.name.startswith("cuda")
                                for e in ctx.slice.host):
        return None
    n_sweeps = sum(1 for name, _, _ in spans if name in sp.SWEEPS)
    if not n_sweeps:
        return None
    syncs = [e.start for e in ctx.slice.host if e.name in SYNCS]
    return sp.count_inside(syncs, sp.merged(spans, sp.SWEEPS)) / n_sweeps
