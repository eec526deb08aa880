"""Kernel K2's share of its roofline in the traced ``fit_hmc`` call, its
forward and its backward together.  The work: one forward and one
backward on the C chains' rows for every batched leapfrog step and for
the gradient at each call's start, and one forward over every chain's
samples (the call's final log-likelihoods).  Bounds from
``counts/kernel_bound.py`` (``mean_rss``, ``mean_rss_grad``), over the
device time of the kernels named here.  None where they did not run."""

from portbench.counts.kernel_bound import kernel_bound

UNIT = "%"
LAYER = "ops.kernels K2 mean_rss"
MOVES = "grad_evals_per_s"
KERNELS = ("mean_rss_tile_kernel", "mean_rss_sum_kernel",
           "mean_rss_grad_kernel")


def read(ctx):
    if ctx.slice is None or not ctx.slice_call:
        return None
    seconds, n = ctx.slice.device_seconds(KERNELS)
    if not n or seconds <= 0:
        return None
    cfg, C = ctx.config, ctx.cell["chains"]
    shape = dict(N=cfg["N"], L=cfg["n_time"][1], P=cfg["P"])
    per_eval = (kernel_bound("mean_rss", C=C, **shape)["bound_ms"]
                + kernel_bound("mean_rss_grad", C=C, **shape)["bound_ms"])
    evals = ctx.slice_call["leapfrog_steps"] + 1
    final = kernel_bound("mean_rss", C=ctx.slice_call["samples"],
                         **shape)["bound_ms"]
    return 100.0 * (per_eval * evals + final) * 1e-3 / seconds
