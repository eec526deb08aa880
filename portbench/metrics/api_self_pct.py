"""Share of the traced ``api.fit_warm_start`` call that lies outside its
chain runs: the fit span less the union of its ``run_chain`` spans, over
the fit span.  That is the api's own host time: loading and saving the
checkpoint, copying the traces to the host, picking the best chain and
building the result.  The profiler slows op-heavy host code about twice
and copies or file IO hardly, so this share understates an untraced
call's.  Less of it raises ``chain_sweeps_per_s``."""

from portbench import spans as sp

UNIT = "%"
LAYER = "api.fit_warm_start and io.checkpoint, around the chain runs"
MOVES = "chain_sweeps_per_s"


def read(ctx):
    spans = sp.of_slice(ctx.slice)
    if spans is None:
        return None
    fit = sp.merged(spans, (sp.FIT,))
    total = sp.length(fit)
    if total <= 0:
        return None
    runs = sp.length(sp.intersect(sp.merged(spans, (sp.RUN,)), fit))
    return 100.0 * (total - runs) / total
