"""Host ms a batch copying the inputs into the graph's buffers (the
program's ``entry.load`` span), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "entry.load")
