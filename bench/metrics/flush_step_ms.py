"""Device ms a batch of the flush (the program's ``step.flush`` phase,
summed over the call's flushes), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "step.flush")
