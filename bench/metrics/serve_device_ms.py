"""Device ms a batch of the serve step, from the profiled slice: every
kernel, memset and device-to-device copy (the harness's host copies left
out), less the tower's device ms."""


def read(ctx):
    s = ctx.slice
    if s is None or not s.device_ops or ctx.tower_device_ms is None:
        return None
    return s.call_device_s() / s.n_batches * 1e3 - ctx.tower_device_ms
