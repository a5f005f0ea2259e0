"""Host ms from the benchmark's call of the train step to its return, with
no synchronisation, over the untraced window: the host's issue of a step's
kernels, or the launch queue's back-pressure where the device paces it."""


def read(ctx):
    return ctx.window["issue_s"] * 1e3 if "issue_s" in ctx.window else None
