"""95th percentile of a predict_batch call's service time, from its start to
its return with the answers on the host, over the untraced window's calls.
In a cell offered more than the Predictor sustains the latency from a call's
due time grows with the backlog; the service time does not."""


def read(ctx):
    return ctx.window.get("call_p95_ms")
