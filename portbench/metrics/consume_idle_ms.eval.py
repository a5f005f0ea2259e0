"""Device-idle ms a traced pass while the program's ``eval.consume`` span
was the innermost open: the wait for a batch's predictions and their
scoring on the host."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "eval.consume")
