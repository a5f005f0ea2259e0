"""Device-idle ms a traced pass while the program's ``eval.assemble`` span
was the innermost open: a batch's assembly on the host and its copy to
the device."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "eval.assemble")
