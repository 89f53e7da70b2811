"""The dual probe's share of its roofline in the profiled slice: the
least bytes its launches need (``work.probe_bytes`` at each batch's hits
in both tiers, from the reference) over HBM's rate, divided by the
launches' device time."""


def read(ctx):
    s = ctx.slice
    if s is None:
        return None
    t = s.kernel_seconds("cache_probe")
    if t <= 0:
        return None
    c, w = ctx.cell.cfg["cache"], ctx.work
    need = sum(w.probe_bytes(ctx.traffic.batch, int(ctx.report.hits_d[i]),
                             int(ctx.report.hits_f[i]), c["ways"],
                             c["failover_ways"], ctx.fam.value_dim, 4)
               for i in ctx.slice_batches)
    return 100.0 * need / w.PEAKS["hbm_bytes_per_s"] / t
