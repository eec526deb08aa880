"""Share of the traced Gibbs call in which no device operation runs: 100
minus the union of the card's kernels, copies and fills over the call's
span.  The idle share is what a host that launches faster gives back to
``chain_sweeps_per_s``."""

UNIT = "%"
LAYER = "device"
MOVES = "chain_sweeps_per_s"


def read(ctx):
    if ctx.slice is None or not ctx.slice.device or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
