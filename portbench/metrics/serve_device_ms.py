"""Device kernel ms a predict_batch call, over the traced calls."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels():
        return None
    ms = sum(e - s for _, s, e in ctx.trace.kernels()) * 1e-3
    return ms / ctx.trace.units
