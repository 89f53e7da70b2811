"""Host ms inside the compiled entry before the harness waits: the
inputs' copy into the graph's buffers, the replay's enqueue and the
outputs' clone (the harness's ``call`` span), outside the profiled
slice."""


def read(ctx):
    return float(ctx.call_s[ctx.outside].mean() * 1e3)
