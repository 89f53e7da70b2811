"""Device ms of one tower call at the cell's miss budget of rows, outside
the server: the call captured once as a CUDA graph and its replays timed
with CUDA events, so the host's enqueue is not in the time."""


def read(ctx):
    return ctx.tower_device_ms
