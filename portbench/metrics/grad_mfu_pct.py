"""One value and gradient of the log-joint as a share of the card's
float32 peak: the benchmark's analytic FLOP of one evaluation
(``counts/logjoint.py``, K2's backward as its own term) times the useful
gradient evaluations of the window's calls after the traced one, over
their seconds, against 67 TFLOP/s (float32 outside the tensor cores).
Published peak at 700 W."""

from portbench.counts.kernel_bound import PEAK_F32_FLOP_PER_S
from portbench.counts.logjoint import grad_eval_flops

UNIT = "%"
LAYER = "one value and gradient of models.logjoint"
MOVES = "grad_evals_per_s"


def read(ctx):
    seconds = ctx.rest.get("seconds", 0.0)
    work = ctx.rest.get("grad_evals", 0)
    if seconds <= 0 or not work:
        return None
    return 100.0 * grad_eval_flops(ctx.config) * work / seconds \
        / PEAK_F32_FLOP_PER_S
