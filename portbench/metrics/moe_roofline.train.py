"""The grouped expert products' least time at the group sizes the traced
steps routed (the program's ``moe.pairs`` counter, one reading an expert
layer and microbatch; each forward and backward product bf16 at
harness/peaks.bound_s, the family's ``grouped_products``) over the device
time of the kernels that compute them (``grouped_gemm``'s rows and wgrad
kernels)."""

KERNELS = ("grouped_gemm::",)


def _pairs():
    """The counted pairs of the traced steps, or None where the program
    keeps no counters."""
    from clg_vqa_tpu_torch.utils import profiling
    read = getattr(profiling, "counter_records", None)
    if read is None:
        return None
    return [int(c.values) for c in read() if c.name == "moe.pairs"]


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.time_s(KERNELS)
    pairs = _pairs()
    if busy <= 0 or not pairs:
        return None
    from portbench.harness import manifest
    fam = manifest.family(ctx.flops.ROOT, ctx.d["model"])
    products = getattr(fam, "grouped_products", None)
    if products is None:
        return None
    least = sum(ctx.peaks.bound_s(b, f) for n in pairs for b, f in products(ctx.d, n))
    return 100.0 * least / busy
