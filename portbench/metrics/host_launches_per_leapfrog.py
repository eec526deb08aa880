"""Kernel launches the host makes a batched leapfrog step of ``fit_hmc``:
the CUDA runtime's and driver's launch calls in the traced call over the
call's batched steps (each iteration runs the longest of its chains'
trajectory lengths).  The call's own set-up and its final
log-likelihoods are in the count.  Fewer launches a step should raise
``grad_evals_per_s``."""

UNIT = "launches/step"
LAYER = "models.logjoint and samplers.hmc, the host path"
MOVES = "grad_evals_per_s"


def read(ctx):
    n = ctx.slice.launches() if ctx.slice is not None else 0
    steps = ctx.slice_call.get("leapfrog_steps", 0) if ctx.slice_call else 0
    if not n or not steps:
        return None
    return n / steps
