"""Host ms a batch in the compiled entry's static key (the program's
``entry.key`` span: the state's and inputs' flatten, signatures, address
key, graph lookup), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.host_ms(ctx, "entry.key")
