"""Device-idle ms a traced step while the program's ``train.accumulate``
span was the innermost open: the gradient accumulation (zeros_like, the
g / acc and add_ loop, the loss and score sums)."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "train.accumulate")
