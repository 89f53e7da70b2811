"""Share of the profiled slice's wall in which no operation ran on the
device: 1 - busy / wall over the slice (``device.busy_s`` and
``device.window_s``). Under CUPTI a CUDA graph's launch takes longer on
the host, so where the host bounds a batch this reads higher than an
unprofiled batch's idle share would."""


def read(ctx):
    s = ctx.slice
    if s is None or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s())
