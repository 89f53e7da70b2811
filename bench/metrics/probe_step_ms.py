"""Device ms a batch of the serve step's probe, steps (1)-(1e) (the
program's ``step.probe`` phase, event-timed inside the replayed graph),
outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "step.probe")
