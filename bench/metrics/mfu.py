"""The whole step's share of the chip's peak: useful tower operations
(tower inferences x the operations a row needs, counted from the
configuration's widths, only the routed experts) over the seconds they
took x the peak of the configuration's precision. The operations are
counted over every batch of the window; a batch's seconds are the mean
of the batches outside the profiled slice (the device's work a batch has
one shape whatever rows are useful, and profiled batches run slower)."""


def read(ctx):
    o = ctx.outside
    n = ctx.counters["tower_inferences"][ctx.window].sum()
    ops = n * ctx.fam.row_flops(ctx.traffic.history_len)
    secs = ctx.batch_s[o].mean() * len(ctx.window)
    return float(100.0 * ops / (secs * ctx.work.PEAKS[ctx.fam.peak]))
