"""The whole sweep's share of the card's float32 peak: the benchmark's
analytic FLOP of one chain-sweep (``counts/flops.py``: ``sweep_full`` in
the cell's census with the driver's log-likelihood, MALA included) times
the chain-sweeps of the window's calls after the traced one, over their
seconds, against 67 TFLOP/s (float32 outside the tensor cores: the port
runs float32 with TF32 off).  Published peak at 700 W; the card's power
limit is not read here."""

from portbench.counts.flops import chain_sweep_flops
from portbench.counts.kernel_bound import PEAK_F32_FLOP_PER_S

UNIT = "%"
LAYER = "the whole sweep: ops.gibbs.sweep_full and the driver's log-likelihood"
MOVES = "chain_sweeps_per_s"


def read(ctx):
    seconds = ctx.rest.get("seconds", 0.0)
    work = ctx.rest.get("chain_sweeps", 0)
    if seconds <= 0 or not work:
        return None
    flop = chain_sweep_flops(ctx.config, ctx.cell["kernels"]) * work
    return 100.0 * flop / seconds / PEAK_F32_FLOP_PER_S
