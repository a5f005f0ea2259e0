"""The training step's model FLOPs (3 x the forward's matrix and attention
products of a QA, harness/flops.py) times the untraced window's QA/s, as a
share of one H100's published dense bf16 peak."""


def read(ctx):
    if ctx.window.get("qa", 0) == 0:
        return None
    rate = ctx.window["qa"] / ctx.window["seconds"]
    return 100.0 * ctx.flops.train_flops(ctx.d) * rate / ctx.peaks.BF16_FLOP_PER_S
