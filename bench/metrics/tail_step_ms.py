"""Device ms a batch of the serve step's tail: compaction and row gather
before the tower, placement, failover, fallback, provenance, counters and
the ring append after it (the program's ``step.tail`` phase, its two
intervals summed), outside the profiled slice."""
from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "step.tail")
