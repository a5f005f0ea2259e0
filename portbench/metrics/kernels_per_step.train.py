"""CUDA kernels (copies and fills not counted) in the traced steps, over
the steps traced."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels():
        return None
    return len(ctx.trace.kernels()) / ctx.trace.units
