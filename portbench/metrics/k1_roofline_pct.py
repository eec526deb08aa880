"""Kernel K1's share of its roofline in the traced call: the least time
one H100 needs for the joint draws a sweep makes (``counts/
kernel_bound.py``'s ``chol_solve`` at every chain: Phi at D = K M P, and
with the covariance's covariates xi at D = K M D P), times the call's
sweeps, over the device time of the kernels named here, whichever of them
ran.  None where none of them ran."""

from portbench.counts.kernel_bound import kernel_bound

UNIT = "%"
LAYER = "ops.kernels K1 chol_solve"
MOVES = "chain_sweeps_per_s"
KERNELS = ("chol_tiled_kernel", "chol_blocked_kernel", "panels_first",
           "panels_panel", "panels_update", "panels_solve")


def draws(config):
    """The dimensions of the joint draws of one sweep."""
    K, P, M, D = (config[k] for k in "KPMD")
    dims = [K * M * P]
    if D and config["covariate_cov"]:
        dims.append(K * M * D * P)
    return dims


def read(ctx):
    if ctx.slice is None or not ctx.slice_call:
        return None
    seconds, n = ctx.slice.device_seconds(KERNELS)
    if not n or seconds <= 0:
        return None
    C = ctx.cell["chains"]
    bound_ms = sum(kernel_bound("chol_solve", C=C, D=d)["bound_ms"]
                   for d in draws(ctx.config))
    return 100.0 * bound_ms * 1e-3 * ctx.slice_call["sweeps"] / seconds
