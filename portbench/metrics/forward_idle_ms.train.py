"""Device-idle ms a traced step while the program's ``train.forward`` span
was the innermost open: the forward of a microbatch (the loss function's
walk over the blocks)."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "train.forward")
