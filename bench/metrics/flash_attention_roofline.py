"""The flash attention kernel's share of its roofline in the profiled
slice: per launch the larger of its causal operations over the bf16 peak
and its bytes over HBM's (``work.flash_work`` at the tower's rows),
divided by the launches' device time."""


def read(ctx):
    s = ctx.slice
    att = ctx.fam.attention(ctx.miss_budget, ctx.traffic.history_len)
    if s is None or att is None:
        return None
    t = s.kernel_seconds("flash_attention")
    if t <= 0:
        return None
    per_call, ops, io = att
    w = ctx.work
    least = s.kernel_launches("flash_attention") * w.roofline_seconds(
        ops, io, w.PEAKS[ctx.fam.peak])
    return 100.0 * least / t
