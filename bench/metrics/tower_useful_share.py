"""Share of the tower's rows that serve a request: tower inferences over
(batches x miss budget), from the program's counters over the window."""


def read(ctx):
    n = ctx.counters["tower_inferences"][ctx.window].sum()
    return float(100.0 * n / (len(ctx.window) * ctx.miss_budget))
