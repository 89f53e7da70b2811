"""Device ms a batch of the tower inside the serve step (the program's
``step.tower`` phase: the ``tower_fn`` call at the miss budget's rows),
outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "step.tower")
