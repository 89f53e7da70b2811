"""Host ms a batch in ``graph.replay()`` and the launch counts (the
program's ``entry.replay`` span), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "entry.replay")
