"""The eval attention core's least time at the cell's shapes (the forward
of each layer and batch of a pass, harness/flops.attention_core, bf16
operands) over the device time of the kernels that compute it: today K1's,
whose names contain these."""

KERNELS = ("attn_eval", "flat_attention_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.time_s(KERNELS)
    if busy <= 0:
        return None
    d, t = ctx.d, ctx.traffic
    S, H = d["text"] + d["regions"], d["heads"]
    batches = -(-t["questions_per_pass"] // t["batch_size"])
    calls = ctx.trace.units * batches * d["layers"]
    least = ctx.peaks.bound_s(*ctx.flops.attention_core(
        t["batch_size"], S, H, d["H"] // H, 2, False))
    return 100.0 * calls * least / busy
