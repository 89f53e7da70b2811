"""Host ms a batch cloning the outputs out of the graph's pool (the
program's ``entry.clone`` span), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "entry.clone")
