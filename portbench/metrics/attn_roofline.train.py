"""The training attention core's least time at the cell's shapes (forward
and backward of each layer and microbatch, harness/flops.attention_core,
bf16 operands) over the device time of the kernels that compute it:
today B1's forward and backward, whose names contain these."""

KERNELS = ("attn_train",)


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.time_s(KERNELS)
    if busy <= 0:
        return None
    d, t = ctx.d, ctx.traffic
    S, H = d["text"] + d["regions"], d["heads"]
    calls = ctx.trace.units * t["acc"] * d["layers"]
    least = sum(ctx.peaks.bound_s(*ctx.flops.attention_core(
        t["mbs"], S, H, d["H"] // H, 2, backward)) for backward in (False, True))
    return 100.0 * calls * least / busy
