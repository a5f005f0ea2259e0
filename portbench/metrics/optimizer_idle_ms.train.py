"""Device-idle ms a traced step while the program's ``train.optimizer``
span was the innermost open: the optimizer's update and the parameters'
add_ loop."""
from portbench.harness import phases


def read(ctx):
    return phases.idle_ms(ctx, "train.optimizer")
