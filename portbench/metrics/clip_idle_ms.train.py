"""Device-idle ms a traced step while the program's ``train.clip`` span was
the innermost open: the gradient mask and the global norm."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "train.clip")
