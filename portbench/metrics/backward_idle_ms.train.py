"""Device-idle ms a traced step while the program's ``train.backward`` span
was the innermost open: the backward of a microbatch (autograd.grad)."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "train.backward")
