"""Host ms a batch to stage its ids, features, clock and failure mask on
the device (the harness's ``stage`` span), over the window's batches
outside the profiled slice."""


def read(ctx):
    return float(ctx.stage_s[ctx.outside].mean() * 1e3)
