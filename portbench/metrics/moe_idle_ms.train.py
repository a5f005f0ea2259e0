"""Device-idle ms a traced step while one of the program's expert-layer
spans (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``)
was the innermost open: the forward's routing, dispatch, grouped products
and combine, summed over a step's layers and microbatches."""
from portbench.harness import phases

SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(ctx):
    parts = [phases.idle_ms(ctx, s) for s in SPANS]
    if any(p is None for p in parts):
        return None
    return sum(parts)
