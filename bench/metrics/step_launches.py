"""Device kernels a batch in the profiled slice (copies and memsets not
counted)."""


def read(ctx):
    s = ctx.slice
    if s is None or not s.device_ops:
        return None
    return s.launches() / s.n_batches
