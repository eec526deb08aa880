"""Kernel K2's share of its roofline in the traced Gibbs call.  The work
is the mean/RSS evaluations a sweep needs (``ops/gibbs.py`` as of commit
29f7e3a7): the reference census two on the ensemble's C rows (sigma2's
draw and the driver's log-likelihood); the production census three on C
rows (sigma2, the log-likelihood, MALA's RSS of the mean-only
coefficients) and four on 2C rows (the MGP-scale moves' stacked pair).
Each bound is ``counts/kernel_bound.py``'s ``mean_rss`` without the mean;
their sum times the call's sweeps is divided by the device time of K2's
kernels.  None where they did not run."""

from portbench.counts.kernel_bound import kernel_bound

UNIT = "%"
LAYER = "ops.kernels K2 mean_rss"
MOVES = "chain_sweeps_per_s"
KERNELS = ("mean_rss_tile_kernel", "mean_rss_sum_kernel")
# census -> ((rows as a multiple of the chains, evaluations a sweep), ...)
EVALUATIONS = {"reference": ((1, 2),), "production": ((1, 3), (2, 4))}


def read(ctx):
    if ctx.slice is None or not ctx.slice_call:
        return None
    seconds, n = ctx.slice.device_seconds(KERNELS)
    if not n or seconds <= 0:
        return None
    cfg, C = ctx.config, ctx.cell["chains"]
    bound_ms = sum(k * kernel_bound("mean_rss", C=r * C, N=cfg["N"],
                                    L=cfg["n_time"][1], P=cfg["P"])["bound_ms"]
                   for r, k in EVALUATIONS[ctx.cell["kernels"]])
    return 100.0 * bound_ms * 1e-3 * ctx.slice_call["sweeps"] / seconds
