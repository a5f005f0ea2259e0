"""Host ms a step spent waiting for TrainPipeline's next batch, by the
benchmark's clock, over the untraced window of a --trace 1 run."""


def read(ctx):
    return ctx.window["data_wait_s"] * 1e3 if "data_wait_s" in ctx.window else None
