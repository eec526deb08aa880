"""Share of the traced ``fit_hmc`` call in which no device operation
runs: 100 minus the union of the card's kernels, copies and fills over
the call's span."""

UNIT = "%"
LAYER = "device"
MOVES = "grad_evals_per_s"


def read(ctx):
    if ctx.slice is None or not ctx.slice.device or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
