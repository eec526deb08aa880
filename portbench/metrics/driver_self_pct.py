"""Share of the traced ``api.fit_warm_start`` call that its chain runs
spend outside their sweeps and tempered excursions: the union of the
``run_chain`` spans less the union of the sweep and excursion spans in
them, over the fit span.  That is the driver's own host time: each kept
draw's log-likelihood, the trace appends and their stacking.  A host-time
share of a traced call, as ``api_self_pct``.  Less of it raises
``chain_sweeps_per_s``."""

from portbench import spans as sp

UNIT = "%"
LAYER = "samplers.drivers.run_chain, around the sweeps"
MOVES = "chain_sweeps_per_s"


def read(ctx):
    spans = sp.of_slice(ctx.slice)
    if spans is None:
        return None
    fit = sp.merged(spans, (sp.FIT,))
    total = sp.length(fit)
    if total <= 0:
        return None
    runs = sp.intersect(sp.merged(spans, (sp.RUN,)), fit)
    inner = sp.intersect(sp.merged(spans, sp.SWEEPS + (sp.EXCURSION,)), runs)
    return 100.0 * (sp.length(runs) - sp.length(inner)) / total
