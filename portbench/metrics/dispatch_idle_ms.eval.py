"""Device-idle ms a traced pass while the program's ``eval.dispatch`` span
was the innermost open: a batch's forward issued and its predictions'
copy to the host started."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "eval.dispatch")
